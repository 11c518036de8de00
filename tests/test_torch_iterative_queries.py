"""TPC-H under the port's default optimizer, the iterative one, against the
reference's iterative optimizer; EXPLAIN [ANALYZE]; the Values operator and
``$coalesce`` that its rules make the port run.

The reference is pinned as in test_torch_queries.py, but to
``TRINO_TPU_OPTIMIZER=iterative`` and ``TRINO_TPU_HBO=0``.  At SF 0.01 the
iterative plans of 9 of the 22 queries differ from the legacy ones; their
rows are held to the reference's, with the hash_insert / hash_probe calls
the new plans make (on the CPU the wrappers take their plain versions).
"""

import re

import pytest

from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.caching import result_cache

SF = 0.01


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def catalogs():
    return default_catalog(SF), ref_catalog(SF)


@pytest.fixture
def port(catalogs):
    return StandaloneQueryRunner(catalogs[0], device="cpu")


@pytest.fixture
def reference(catalogs, monkeypatch):
    _pin(monkeypatch)
    return RefRunner(catalogs[1])


# (query, hash_insert calls, hash_probe calls) of the 9 queries whose
# iterative plan differs from the legacy one at SF 0.01: the new plans make
# the same calls as the legacy ones (Q18 and Q21 narrow the semi-join
# inputs, which changes the calls' widths, not their number).  A probe call
# is one per probe batch: the default scan coalesces lineitem's four split
# batches into one, so Q21 probes its two non-unique builds twice (six
# times with IngestConfig(enabled=False))
DIFFERING = [(2, 9, 0), (6, 0, 0), (8, 8, 0), (9, 6, 0), (15, 3, 0),
             (17, 3, 0), (18, 4, 0), (20, 5, 1), (21, 5, 2)]


def test_plans_differ_from_legacy_where_listed(port, catalogs):
    legacy = StandaloneQueryRunner(catalogs[0], device="cpu",
                                   optimizer="legacy")
    differ = [q for q in sorted(QUERIES)
              if port.explain(QUERIES[q]) != legacy.explain(QUERIES[q])]
    assert differ == [q for q, _, _ in DIFFERING]


@pytest.mark.parametrize("q,inserts,probes", DIFFERING)
def test_iterative_rows_match_reference(port, reference, monkeypatch, q,
                                        inserts, probes):
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(QUERIES[q]).rows()
    assert (calls["insert"], calls["probe"]) == (inserts, probes)
    _same_rows(got, reference.execute(QUERIES[q]).rows())


@pytest.mark.parametrize("q", [3, 21])
def test_explain_matches_reference(port, reference, q):
    got = [r[0] for r in port.execute("EXPLAIN " + QUERIES[q]).rows()]
    want = [r[0] for r in reference.execute("EXPLAIN " + QUERIES[q]).rows()]
    assert got == want
    assert "optimizer: iterative" in " ".join(got)
    assert any(l.startswith("  rule ReorderJoins [reorder] fired x")
               for l in got)


def test_explain_legacy_is_the_plan_alone(catalogs):
    legacy = StandaloneQueryRunner(catalogs[0], device="cpu",
                                   optimizer="legacy")
    lines = [r[0] for r in legacy.execute("explain " + QUERIES[3]).rows()]
    assert lines == legacy.explain(QUERIES[3]).splitlines()


_OP_LINE = re.compile(r"    (\w+): [\d.]+ ms, in (\d+) rows/(\d+) batches, "
                      r"out (\d+) rows/(\d+) batches")


@pytest.mark.parametrize("q", [3, 21])
def test_explain_analyze_counts_the_result_rows(port, q):
    lines = [r[0] for r in
             port.execute("EXPLAIN ANALYZE " + QUERIES[q]).rows()]
    head = next(i for i, l in enumerate(lines) if l.startswith("optimizer:"))
    assert re.fullmatch(r"optimizer: iterative, \d+ rule firings, "
                        r"[\d.]+ms", lines[head])
    total = next(i for i, l in enumerate(lines) if l.startswith("total: "))
    # after the scan, host-sync and encoding roll-ups, one line per operator
    ops = [_OP_LINE.fullmatch(l) for l in lines[total + 1:]
           if not l.startswith(("  pipeline ", "  scan[", "  exec: ",
                                "  encoding: "))]
    assert all(ops)
    # the last pipeline ends Rename -> OutputCollector: what the last
    # operator before the sink hands on is the result
    n = len(port.execute(QUERIES[q]).rows())
    *_, last, sink = ops
    assert int(last.group(4)) == n == int(sink.group(2))
    assert sink.group(1) == "OutputCollector"


def test_query_stats_count_live_rows_once_read():
    """Rows are live rows, read once at the end of the run (masked
    batches: a FilterProject marks rows dead without compacting).  The
    predicate is arithmetic, so the scan does not prune on the host."""
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    st = QueryStats()
    rows = port.execute("select n_name from nation where n_regionkey % 2 = 1",
                        stats=st).rows()
    (pipe,) = st.pipelines
    scan, fp, rename, sink = pipe.operators
    assert (scan.output_rows, fp.input_rows) == (25, 25)
    assert fp.output_rows == rename.output_rows == sink.input_rows == len(
        rows) == 10
    assert all(type(o.input_rows) is int and type(o.output_rows) is int
               for o in pipe.operators)
    assert fp.output_batches == 1 and sink.output_batches == 0


# the Values operator (empty relations the rules fold a FALSE filter or an
# empty join side into, and SELECT without FROM) and $coalesce (COALESCE,
# and the count PushAggregationThroughOuterJoin wraps) against the reference
OPERATOR_CASES = {
    "coalesce_in_projection": (
        "select n_nationkey, coalesce(case when n_regionkey = 1 then null "
        "else n_name end, 'none'), coalesce(case when n_nationkey % 3 = 0 "
        "then null else n_regionkey end, -1) from nation "
        "order by n_nationkey", None),
    "aggregation_through_outer_join": (
        "select f, count(l_orderkey), sum(l_quantity), max(l_shipdate) from "
        "(select substring(n_name, 1, 1) as f from nation) x left join "
        "lineitem on f = l_returnflag group by f order by f",
        "PushAggregationThroughOuterJoin"),
    "false_filter_is_empty_values": (
        "select n_name from nation where false", "RemoveTrivialFilters"),
    "global_aggregate_over_empty_values": (
        "select count(*), sum(n_regionkey), max(n_name) from nation "
        "where false", "RemoveTrivialFilters"),
    "grouped_aggregate_over_empty_values": (
        "select n_regionkey, count(*) from nation where false "
        "group by n_regionkey", "EvaluateZeroInput"),
    "inner_join_with_empty_side": (
        "select n_name, r_name from nation join "
        "(select * from region where false) r on n_regionkey = r_regionkey",
        "EvaluateZeroInput"),
    "left_join_with_empty_build": (
        "select n_name, r_name from nation left join "
        "(select * from region where false) r on n_regionkey = r_regionkey "
        "order by n_name", "RemoveTrivialFilters"),
    "select_without_from": ("select 1, 'a', date '1995-03-15'", None),
}


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_new_operators_match_reference(port, reference, case):
    sql, rule = OPERATOR_CASES[case]
    explain = [r[0] for r in port.execute("explain " + sql).rows()]
    assert explain == [r[0] for r in
                       reference.execute("explain " + sql).rows()]
    if rule is not None:
        assert any(l.startswith(f"  rule {rule} ") for l in explain)
    got = port.execute(sql).rows()
    want = reference.execute(sql).rows()
    _same_rows(got, want)
    if case == "aggregation_through_outer_join":
        # unmatched groups count 0 through the $coalesce, not NULL
        assert any(r[1] == 0 and r[2] is None for r in got)
        assert any(r[1] > 0 for r in got)


def test_lineitem_row_count_is_memoized():
    """row_count("lineitem") is derived once per scale factor (every
    statistics call of the planner asks for it) and equals the sum of the
    per-order line counts."""
    conn = TpchConnector(SF)
    n = conn.row_count("lineitem")
    li = conn._generate("lineitem", ["l_orderkey"], 0,
                        conn.row_count("orders"))
    assert n == li.num_rows == conn._lineitem_rows[SF]
    conn._lineitem_rows[SF] = -1  # the memo, not a recomputation, answers
    assert conn.row_count("lineitem") == -1
    assert TpchConnector(SF).row_count("lineitem") == n


def test_planning_tool_restores_the_memo():
    from trino_tpu_torch.tools.planning_ms import planning_ms

    cat = default_catalog(SF)
    conn = cat.connector("tpch")
    ms = planning_ms(cat, QUERIES[6])
    assert set(ms) == {"legacy", "legacy_recomputed", "iterative",
                       "iterative_recomputed"}
    assert all(v > 0 for v in ms.values())
    assert conn._lineitem_rows == {SF: conn.row_count("lineitem")}
