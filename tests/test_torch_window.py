"""Window functions through the torch port against the JAX reference: every
query of tests/test_window.py (the reference holds them to sqlite; here
the reference's rows are the oracle), the "OVER" error, the window queries
W1-W8 of connectors/window_queries.py with their hash_insert calls, a few
shapes the operator must handle (empty input, a lag default from another
dictionary, NULL order keys from an outer join), and EXPLAIN of W3 and W8
line for line.

The reference is pinned as in test_torch_iterative_queries.py; the port
runs on the CPU.  Rows are equal, doubles to rtol 1e-9; a query without an
outer ORDER BY is compared as a multiset.
"""

import pytest

from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls, _same_rows
from test_torch_setops import same_rows_any_order
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.window_queries import (KERNELS,
                                                       WINDOW_QUERIES)
from trino_tpu_torch.runner import StandaloneQueryRunner

SF = 0.01


@pytest.fixture(scope="module", autouse=True)
def _map_headroom():
    """The reference compiles one XLA program per window spec; drop the
    executables other modules left in this process first (as
    tests/test_window.py does)."""
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def catalogs():
    return default_catalog(SF), ref_catalog(SF)


@pytest.fixture(scope="module")
def port(catalogs):
    return StandaloneQueryRunner(catalogs[0], device="cpu")


@pytest.fixture
def reference(catalogs, monkeypatch):
    _pin(monkeypatch)
    return RefRunner(catalogs[1])


def check(port, reference, sql, ordered):
    got = port.execute(sql).rows()
    want = reference.execute(sql).rows()
    if ordered:
        _same_rows(got, want)
    else:
        same_rows_any_order(got, want)
    return got


# the queries of tests/test_window.py: (text, outer ORDER BY fixes the order)
REFERENCE_QUERIES = {
    "row_number": ("""
        select n_name, row_number() over (order by n_name) rn from nation
        order by n_name""", True),
    "row_number_partitioned": ("""
        select n_name, n_regionkey,
               row_number() over (partition by n_regionkey order by n_name) rn
        from nation order by n_regionkey, n_name""", True),
    "rank_dense_rank": ("""
        select o_orderpriority,
               rank() over (order by o_orderpriority) rk,
               dense_rank() over (order by o_orderpriority) drk
        from orders""", False),
    "rank_no_order": ("""
        select n_name, rank() over (partition by n_regionkey) rk,
               count(*) over (partition by n_regionkey) c
        from nation""", False),
    "running_sum_range": ("""
        select o_orderkey, o_custkey,
               sum(o_totalprice) over (partition by o_custkey
                                       order by o_orderkey) s
        from orders""", False),
    "running_sum_rows": ("""
        select o_orderkey,
               sum(o_totalprice) over (order by o_orderkey
                   rows between unbounded preceding and current row) s
        from orders""", False),
    "sliding_window_sum_avg": ("""
        select o_orderkey,
               sum(o_totalprice) over (order by o_orderkey
                   rows between 3 preceding and 1 following) s,
               avg(o_totalprice) over (order by o_orderkey
                   rows between 2 preceding and 2 following) a,
               count(*) over (order by o_orderkey
                   rows between 3 preceding and 1 following) c
        from orders where o_orderkey < 1000""", False),
    "whole_partition_agg": ("""
        select o_orderkey, o_custkey,
               sum(o_totalprice) over (partition by o_custkey) s,
               count(*) over () c
        from orders""", False),
    "min_max_running": ("""
        select o_orderkey,
               min(o_totalprice) over (partition by o_orderpriority
                                       order by o_orderkey) mn,
               max(o_totalprice) over (partition by o_orderpriority
                                       order by o_orderkey) mx
        from orders""", False),
    "min_max_whole_partition": ("""
        select n_name,
               min(n_name) over (partition by n_regionkey) mn,
               max(n_name) over (partition by n_regionkey) mx
        from nation""", False),
    "lag_lead": ("""
        select o_orderkey,
               lag(o_totalprice) over (order by o_orderkey) l1,
               lag(o_totalprice, 2) over (order by o_orderkey) l2,
               lead(o_totalprice) over (order by o_orderkey) d1,
               lag(o_totalprice, 1, 0.0) over (order by o_orderkey) ld
        from orders where o_orderkey < 500""", False),
    "lag_partitioned": ("""
        select o_custkey, o_orderkey,
               lag(o_orderkey) over (partition by o_custkey
                                     order by o_orderkey) prev
        from orders""", False),
    "first_last_value": ("""
        select o_orderkey,
               first_value(o_totalprice) over (partition by o_orderpriority
                                               order by o_orderkey) f,
               last_value(o_totalprice) over (partition by o_orderpriority
                   order by o_orderkey
                   rows between unbounded preceding
                            and unbounded following) l
        from orders where o_orderkey < 1000""", False),
    "nth_value": ("""
        select o_orderkey,
               nth_value(o_totalprice, 3) over (order by o_orderkey
                   rows between unbounded preceding
                            and unbounded following) v
        from orders where o_orderkey < 300""", False),
    "ntile": ("""
        select n_name, ntile(4) over (order by n_name) t from nation""",
              False),
    "ntile_more_buckets_than_rows": ("""
        select r_name, ntile(10) over (order by r_name) t from region""",
                                     False),
    "percent_rank_cume_dist": ("""
        select o_orderpriority,
               percent_rank() over (order by o_orderpriority) pr,
               cume_dist() over (order by o_orderpriority) cd
        from orders where o_orderkey < 2000""", False),
    "window_over_group_by": ("""
        select o_orderpriority, count(*) cnt,
               rank() over (order by count(*) desc) rk
        from orders group by o_orderpriority""", False),
    "window_with_join": ("""
        select n_name, r_name,
               row_number() over (partition by r_name order by n_name) rn
        from nation, region where n_regionkey = r_regionkey""", False),
    "window_then_order_limit": ("""
        select o_orderkey,
               rank() over (order by o_totalprice desc) rk
        from orders order by rk, o_orderkey limit 10""", True),
    "multiple_window_specs": ("""
        select o_orderkey,
               row_number() over (order by o_totalprice desc) a,
               row_number() over (order by o_orderkey) b,
               sum(o_totalprice) over (partition by o_custkey) c
        from orders where o_orderkey < 1000""", False),
    "window_desc_order": ("""
        select o_orderkey,
               row_number() over (order by o_totalprice desc, o_orderkey) rn
        from orders where o_orderkey < 500""", False),
    "window_in_subquery": ("""
        select o_orderkey, rk from (
            select o_orderkey,
                   rank() over (order by o_totalprice desc) rk
            from orders) t
        where rk <= 5""", False),
    "avg_over_decimal": ("""
        select l_orderkey, l_linenumber,
               avg(l_quantity) over (partition by l_orderkey) a
        from lineitem where l_orderkey < 100""", False),
    "count_column_with_nulls_semantics": ("""
        select o_orderkey,
               count(o_clerk) over (order by o_orderkey) c
        from orders where o_orderkey < 300""", False),
}


@pytest.mark.parametrize("case", list(REFERENCE_QUERIES))
def test_reference_window_queries(port, reference, case):
    sql, ordered = REFERENCE_QUERIES[case]
    assert check(port, reference, sql, ordered)


def test_window_requires_over(port, reference):
    sql = "select rank() from nation"
    with pytest.raises(Exception, match="OVER"):
        reference.execute(sql)
    with pytest.raises(Exception, match="OVER"):
        port.execute(sql)


# hash_insert calls of W1-W8 on the port's path at SF 0.01 (the join index
# and the group-by of W3, the group-bys under W5 and W7)
INSERTS = {"W1": 0, "W2": 0, "W3": 2, "W4": 0, "W5": 1, "W6": 0, "W7": 1,
           "W8": 0}


@pytest.mark.parametrize("name", list(WINDOW_QUERIES))
def test_window_queries_match_reference(port, reference, monkeypatch, name):
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(WINDOW_QUERIES[name]).rows()
    assert calls == {"insert": INSERTS[name], "probe": 0, "segment_sum": 0}
    assert (INSERTS[name] > 0) == ("hash_insert" in KERNELS[name])
    assert got
    _same_rows(got, reference.execute(WINDOW_QUERIES[name]).rows())


SHAPES = {
    # no input row reaches the Window operator: an empty batch of its types
    "empty_input": ("""
        select o_orderkey, row_number() over (order by o_orderkey) rn,
               sum(o_totalprice) over (partition by o_custkey) s
        from orders where o_orderkey < 0""", False),
    # a lag / lead default from another dictionary column
    "lag_default_other_dictionary": ("""
        select n_nationkey, lag(n_name, 2, r_name) over (partition by
               n_regionkey order by n_nationkey) l,
               lead(r_name, 1, n_name) over (order by n_nationkey) d
        from nation join region on n_regionkey = r_regionkey
        order by n_nationkey""", True),
    # NULL order keys (customers without orders), NULLS FIRST and LAST
    "null_order_keys": ("""
        select c_custkey, o_orderkey,
               row_number() over (partition by c_nationkey
                   order by o_orderdate nulls first, c_custkey,
                   o_orderkey) a,
               rank() over (order by o_totalprice desc nulls last) b,
               first_value(o_orderkey) over (partition by c_nationkey
                   order by o_orderdate, c_custkey, o_orderkey) f
        from customer left join orders on c_custkey = o_custkey
             and o_orderkey < 3000
        where c_custkey < 400
        order by c_custkey, o_orderkey""", True),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_window_operator_shapes(port, reference, case):
    sql, ordered = SHAPES[case]
    rows = check(port, reference, sql, ordered)
    assert (len(rows) == 0) == (case == "empty_input")


@pytest.mark.parametrize("name", ["W3", "W8"])
def test_explain_matches_reference(port, reference, name):
    got = [r[0] for r in port.execute(
        "EXPLAIN " + WINDOW_QUERIES[name]).rows()]
    want = [r[0] for r in reference.execute(
        "EXPLAIN " + WINDOW_QUERIES[name]).rows()]
    assert got == want
    assert any("Window[" in line for line in got)
