"""Twelve queries over the TPC-H tables that carry the relational surface
beyond the 22 benchmark texts: set operations (U), grouping sets (G),
RIGHT / FULL joins (J) and the scalar, string and statistical functions
(F).  Dashboards roll up with ROLLUP / CUBE, reconcile with UNION / EXCEPT
and keep customers without orders through outer joins; these texts give
each of those shapes one query at the TPC-H widths.

``KERNELS`` names, per query, the hand-written kernels its plan must
launch on a CUDA device (``hash_insert``: grouping on keys that are not
small dictionary codes, set operations, join indexes; ``hash_probe``: a
join build with duplicate keys; ``masked_segment_sum_f32``: a REAL sum
into at most 64 groups).
"""

SURFACE_QUERIES: dict[str, str] = {
    # UNION DISTINCT: group by the one BIGINT channel over both inputs
    "U1": "select count(*) from (select l_orderkey from lineitem union "
          "select o_orderkey from orders)",
    # UNION ALL into a hash group-by
    "U2": "select k, count(*) from (select l_suppkey k from lineitem "
          "union all select ps_suppkey from partsupp) group by k "
          "order by 2 desc, 1 limit 10",
    # EXCEPT
    "U3": "select count(*) from (select o_custkey from orders except "
          "select c_custkey from customer where c_mktsegment = 'BUILDING')",
    # INTERSECT ALL: least(l, r) copies of each key through Replicate
    "U4": "select count(*) from (select l_partkey from lineitem "
          "intersect all select ps_partkey from partsupp)",
    # ROLLUP of three dictionary keys: GroupId's $groupid makes it a hash
    # group-by over four copies of lineitem
    "G1": "select l_returnflag, l_linestatus, l_shipmode, "
          "grouping(l_returnflag, l_linestatus, l_shipmode), "
          "sum(l_quantity), sum(l_extendedprice), avg(l_discount), count(*) "
          "from lineitem group by rollup(l_returnflag, l_linestatus, "
          "l_shipmode) order by 1, 2, 3",
    "G2": "select c_mktsegment, c_nationkey, count(*), sum(c_acctbal) "
          "from customer group by cube(c_mktsegment, c_nationkey) "
          "order by 1, 2",
    # REAL sums into 8 groups (7 line numbers and the grand total)
    "G3": "select l_linenumber, sum(cast(l_quantity as real)), "
          "sum(cast(l_extendedprice as real)) from lineitem "
          "group by rollup(l_linenumber) order by 1",
    # FULL: customers without orders come from the build's epilogue
    "J1": "select count(*), count(o_orderkey), count(c_custkey) "
          "from orders full join customer on o_custkey = c_custkey",
    # Q13 with the outer join written as a RIGHT join
    "J2": "select c_count, count(*) as custdist from (select c_custkey, "
          "count(o_orderkey) as c_count from orders right outer join "
          "customer on c_custkey = o_custkey and o_comment not like "
          "'%special%requests%' group by c_custkey) as c_orders "
          "group by c_count order by custdist desc, c_count desc",
    # FULL self-join over a build with duplicate keys, with a residual:
    # unmatched rows on both sides
    "J3": "select count(*), count(a.o_orderkey), count(b.o_orderkey) "
          "from orders a full join orders b on a.o_custkey = b.o_custkey "
          "and a.o_totalprice > 2 * b.o_totalprice",
    "F1": "select date_trunc('month', l_shipdate), "
          "day_of_week(l_shipdate), "
          "round(sum(abs(-l_extendedprice) * (1 - l_discount)), 2), "
          "stddev(l_quantity), var_samp(l_discount), "
          "bool_and(l_quantity > 0), count(*) from lineitem "
          "group by 1, 2 order by 1, 2",
    "F2": "select upper(substr(p_type, 1, 5)), length(p_name), "
          "concat(p_brand, '/', p_container), count(*) from part "
          "where strpos(p_name, 'green') > 0 group by 1, 2, 3 "
          "order by 4 desc, 1, 2, 3 limit 20",
}

KERNELS: dict[str, tuple[str, ...]] = {
    "U1": ("hash_insert",), "U2": ("hash_insert",), "U3": ("hash_insert",),
    "U4": ("hash_insert",), "G1": ("hash_insert",), "G2": ("hash_insert",),
    "G3": ("masked_segment_sum_f32",), "J1": ("hash_insert",),
    "J2": ("hash_insert",), "J3": ("hash_insert", "hash_probe"),
    "F1": ("hash_insert",), "F2": ("hash_insert",),
}
