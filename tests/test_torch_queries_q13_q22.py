"""TPC-H Q13-Q22, the REAL-sum queries R1/R2 and the semantics of the
ported joins, through the torch port against the JAX reference.

The fixtures and the row comparison come from test_torch_queries.py (the
same SF 0.01 data, the reference pinned to the paths that run here).  The
REAL sums of R1/R2 are float32 sums taken in different orders by the two
packages (a scatter-add in the port, a prefix-sum difference in the
reference); at SF 0.01 they differ by about 5e-6 relative, so they are
held to rtol 1e-4, the tolerance of the reference's own kernel test.
"""

import pytest

from test_torch_queries import (  # noqa: F401 — fixtures
    _count_plain_calls, _same_rows, check_query, port, reference)
from trino_tpu.spi.errors import TrinoError as RefTrinoError
from trino_tpu_torch.spi.errors import TrinoError
from trino_tpu_torch.caching import result_cache

R1 = ("select l_linenumber, sum(cast(l_quantity as real)), "
      "sum(cast(l_extendedprice as real)) from lineitem "
      "group by l_linenumber order by l_linenumber")
R2 = ("select l_quantity, sum(cast(l_extendedprice as real)) from lineitem "
      "group by l_quantity order by l_quantity")


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


# Q18 groups lineitem by l_orderkey (a hash_insert over every row); Q21
# probes the non-unique lineitem build of its EXISTS / NOT EXISTS with a
# residual (hash_probe); Q16 counts DISTINCT under a 3-key group-by; Q13
# is a LEFT join with a residual; Q22 a keyless SINGLE join (a scalar
# subquery) and a NOT EXISTS
@pytest.mark.parametrize("q,inserts,probes", [
    (13, 3, 1), (14, 1, 0), (15, 3, 0), (16, 2, 0), (17, 3, 0), (18, 4, 0),
    (19, 1, 0), (20, 5, 1), (21, 5, 1), (22, 1, 1)])
def test_query_matches_reference(port, reference, monkeypatch, q, inserts,
                                 probes):
    check_query(port, reference, monkeypatch, q, inserts, probes)


@pytest.mark.parametrize("sql,launches", [(R1, 2), (R2, 1)])
def test_real_sum_query_matches_reference(port, reference, monkeypatch, sql,
                                          launches):
    # R1: 7 groups on an integer key (cap 8), two REAL sums; R2: 50 groups
    # on a decimal key (cap 64, the route's upper edge)
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(sql).rows()
    assert calls["segment_sum"] == launches
    want = reference.execute(sql).rows()
    assert len(want) in (7, 50)
    _same_rows(got, want, rel_tol=1e-4)


_CASE_NULL = "case when n_nationkey = 3 then null else n_regionkey end"


@pytest.mark.parametrize("sql", [
    # NOT IN over a build holding a NULL key: never TRUE
    "select n_name from nation where n_regionkey not in (select case when "
    "r_regionkey = 1 then null else r_regionkey end from region "
    "where r_regionkey < 3) order by n_name",
    # a NULL probe key: NOT IN is NULL (row dropped) ...
    f"select n_name from nation where {_CASE_NULL} not in (select "
    "r_regionkey from region where r_regionkey < 2) order by n_name",
    # ... but IN over the empty set is FALSE, so NOT IN keeps it
    f"select n_name from nation where {_CASE_NULL} not in (select "
    "r_regionkey from region where r_name = 'NOPE') order by n_name",
    f"select n_name from nation where {_CASE_NULL} in (select r_regionkey "
    "from region where r_regionkey < 2) order by n_name",
    # keyless semi-join: EXISTS with only a non-equi correlation
    "select s_name from supplier where exists (select * from nation where "
    "n_nationkey <> s_nationkey and n_regionkey = 1) order by s_name",
    # LEFT joins with a residual, unique and non-unique builds
    "select c_custkey, count(o_orderkey) from customer left join orders on "
    "c_custkey = o_custkey and o_totalprice > 300000 group by c_custkey "
    "order by 2 desc, 1 limit 5",
    "select n_name, r_name from nation left join region on "
    "n_regionkey = r_regionkey and r_name like 'A%' order by n_name",
    # keyless SINGLE joins: one row, no row
    "select n_name from nation where n_nationkey > (select max(r_regionkey) "
    "* 4 from region) order by n_name",
    "select n_name from nation where n_regionkey = (select r_regionkey from "
    "region where r_name = 'NOPE')",
    # DISTINCT aggregates: global and grouped
    "select count(distinct o_custkey), count(distinct o_orderpriority), "
    "sum(distinct o_shippriority) from orders",
    "select o_orderpriority, count(distinct o_custkey) from orders "
    "group by o_orderpriority order by o_orderpriority",
    # calendar fields and substring on a dictionary column
    "select year(o_orderdate), quarter(o_orderdate), month(o_orderdate), "
    "day(o_orderdate), substring(o_orderpriority, 3), substr(o_clerk, -3, 2) "
    "from orders where o_orderkey < 40 order by o_orderkey",
])
def test_join_and_function_semantics_match_reference(port, reference, sql):
    _same_rows(port.execute(sql).rows(), reference.execute(sql).rows())


def test_scalar_subquery_with_many_rows_raises(port, reference):
    sql = "select n_name from nation where n_regionkey = (select r_regionkey " \
          "from region)"
    with pytest.raises(TrinoError, match="SUBQUERY_MULTIPLE_ROWS"):
        port.execute(sql)
    with pytest.raises(RefTrinoError, match="SUBQUERY_MULTIPLE_ROWS"):
        reference.execute(sql)
