"""Eight window queries and one row-pattern query over the TPC-H tables.

Window functions are much of what dashboards send beyond a plain GROUP BY:
top-N per group (W1), running totals (W2), rank bands (W3), period over
period (W4), moving averages (W5), per-partition min / max and navigation
(W6), percentile bands (W7) and a row's share of its partition (W8).  M1
finds a V shape in each customer's order prices with MATCH_RECOGNIZE.
Each text runs at the TPC-H widths.

M1 reads the table ``ORD``: :func:`m1_text` names the table it runs over
(``orders`` itself at a small scale; a CTAS cut of it, :data:`M1_CUT`, at
SF 1, because pattern matching is host Python and takes about 1 s per 10 k
rows).

``KERNELS`` names, per query, the hand-written kernels its plan must
launch on a CUDA device: ``hash_insert`` for the join index and the hash
group-bys under W3, W5 and W7.  The window evaluation itself is torch ops
(exec/window_kernels.py) and launches none.
"""

_SPEC = "over (partition by s_nationkey order by rev desc)"

WINDOW_QUERIES: dict[str, str] = {
    # top-N per group
    "W1": "select count(*), sum(o_totalprice) from (select o_custkey, "
          "o_totalprice, row_number() over (partition by o_custkey order by "
          "o_totalprice desc, o_orderkey) rn from orders) t where rn <= 3",
    # running total: exact DECIMAL prefix sums over every lineitem row
    "W2": "select count(*), sum(rs), max(rs) from (select "
          "sum(l_extendedprice * (1 - l_discount)) over (partition by "
          "l_orderkey order by l_linenumber rows between unbounded preceding "
          "and current row) rs from lineitem) t",
    # rank bands over a join and a group-by
    "W3": "select s_nationkey, s_suppkey, rev, "
          f"rank() {_SPEC} rk, dense_rank() {_SPEC} drk, "
          f"percent_rank() {_SPEC} pr, cume_dist() {_SPEC} cd "
          "from (select s_nationkey, s_suppkey, sum(l_extendedprice) rev "
          "from lineitem join supplier on l_suppkey = s_suppkey "
          "group by s_nationkey, s_suppkey) t "
          "order by s_nationkey, rk, s_suppkey limit 20",
    # period over period
    "W4": "select count(*), sum(case when prv is null then 1 else 0 end), "
          "sum(o_totalprice - prv), sum(nxt) from (select o_totalprice, "
          "lag(o_totalprice) over (partition by o_custkey order by "
          "o_orderdate, o_orderkey) prv, lead(o_totalprice, 2, 0) over "
          "(partition by o_custkey order by o_orderdate, o_orderkey) nxt "
          "from orders) t",
    # moving average and a centred sum over daily revenue
    "W5": "select l_shipdate, rev, avg(rev) over (order by l_shipdate rows "
          "between 6 preceding and current row) ma7, sum(rev) over (order by "
          "l_shipdate rows between 3 preceding and 3 following) c7 from "
          "(select l_shipdate, sum(l_extendedprice) rev from lineitem group "
          "by l_shipdate) t order by l_shipdate limit 30",
    # min / max / navigation per partition: the segmented scans
    "W6": "select count(*), sum(mn), sum(mx), sum(fv), sum(lv), count(nv) "
          "from (select min(l_extendedprice) over (partition by l_orderkey "
          "order by l_linenumber) mn, max(l_extendedprice) over (partition "
          "by l_orderkey) mx, first_value(l_quantity) over (partition by "
          "l_orderkey order by l_linenumber) fv, last_value(l_quantity) over "
          "(partition by l_orderkey order by l_linenumber rows between "
          "unbounded preceding and unbounded following) lv, "
          "nth_value(l_quantity, 3) over (partition by l_orderkey order by "
          "l_linenumber rows between unbounded preceding and unbounded "
          "following) nv from lineitem) t",
    # percentile bands: one partition of every order
    "W7": "select t, count(*), min(o_totalprice), max(o_totalprice) from "
          "(select o_totalprice, ntile(100) over (order by o_totalprice, "
          "o_orderkey) t from orders) x group by t order by t",
    # share of a partition: two window specs
    "W8": "select l_suppkey, l_orderkey, l_linenumber, l_quantity, "
          "sum(l_quantity) over (partition by l_suppkey) sq, count(*) over () "
          "n, 100.0 * l_quantity / sum(l_quantity) over (partition by "
          "l_suppkey) share from lineitem order by share desc, l_orderkey, "
          "l_linenumber limit 10",
}

_M1 = ("select count(*), sum(n), max(mno) from ORD match_recognize "
       "(partition by o_custkey order by o_orderdate, o_orderkey measures "
       "match_number() as mno, count(*) as n, first(a.o_totalprice) as p0, "
       "last(up.o_totalprice) as p1 one row per match after match skip past "
       "last row pattern (a down+ up+) define down as o_totalprice < "
       "prev(o_totalprice), up as o_totalprice > prev(o_totalprice))")

# the cut M1 runs over at SF 1: 1 % of the customers (~15 k orders)
M1_MAX_CUSTKEY = 1500
M1_CUT = f"select * from orders where o_custkey <= {M1_MAX_CUSTKEY}"


def m1_text(table: str) -> str:
    """M1 over ``table`` (the grammar takes MATCH_RECOGNIZE only right after
    a table name, so the cut is a table of its own)."""
    return _M1.replace("ORD", table)


KERNELS: dict[str, tuple[str, ...]] = {
    "W1": (), "W2": (), "W3": ("hash_insert",), "W4": (),
    "W5": ("hash_insert",), "W6": (), "W7": ("hash_insert",), "W8": (),
    "M1": (),
}
