"""TPC-H Q1-Q12 through the torch port against the JAX reference
(Q13-Q22 and the REAL-sum queries are in test_torch_queries_q13_q22.py,
which shares this module's fixtures).

Both runners read the same generated SF 0.01 data.  The reference is pinned
to the paths that run here (sort-path hashing, no Pallas, no result cache,
the legacy optimizer), and the port runs with ``optimizer="legacy"``.  Integers, decimals, dates and strings must be
exact; doubles (the averages of Q1) agree to rtol 1e-9, because the two
packages sum in different orders.  The port runs on the CPU, where its
kernel wrappers take their plain versions; the routing through
hash_insert / hash_probe is asserted on the way.
"""

import math

import pytest
import torch

from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.runner import StandaloneQueryRunner

SF = 0.01


@pytest.fixture(scope="module")
def port():
    # held to the legacy-pinned reference, so its kernel-call counts are
    # the legacy plans' (tests/test_torch_iterative*.py hold the default,
    # iterative, plans)
    return StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 optimizer="legacy")


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HASH_IMPL", "sort")
    monkeypatch.setenv("TRINO_TPU_PALLAS", "0")
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("TRINO_TPU_OPTIMIZER", "legacy")
    return RefRunner(ref_catalog(SF))


def _same_rows(got, want, rel_tol=1e-9):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rel_tol), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def _count_plain_calls(monkeypatch):
    calls = {"insert": 0, "probe": 0, "segment_sum": 0}
    plain = {"insert": "hash_insert_plain", "probe": "hash_probe_plain",
             "segment_sum": "masked_segment_sum_f32_plain"}
    for key, name in plain.items():
        def spy(*a, _key=key, _fn=getattr(GK, name), **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(GK, name, spy)
    return calls


def check_query(port, reference, monkeypatch, q, inserts, probes):
    """Port rows == reference rows, and the port's plain-kernel calls: an
    exact hash_insert count and at least ``probes`` hash_probe calls (none
    when ``probes`` is 0)."""
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(QUERIES[q]).rows()
    assert calls["insert"] == inserts and calls["probe"] >= probes
    assert (calls["probe"] > 0) == (probes > 0)
    assert calls["segment_sum"] == 0  # no TPC-H query sums a REAL
    want = reference.execute(QUERIES[q]).rows()
    _same_rows(got, want)
    return want


# (query, hash_insert calls, hash_probe calls) on the port's path: Q3 builds
# two join indexes and groups on three numeric keys; Q12 builds one index
# and probes a non-unique (lineitem) build; Q4 and Q7 probe non-unique
# builds too
@pytest.mark.parametrize("q,inserts,probes", [
    (1, 0, 0), (2, 9, 0), (3, 3, 0), (4, 1, 1), (5, 5, 0), (6, 0, 0),
    (7, 6, 1), (8, 8, 0), (9, 6, 0), (10, 4, 0), (11, 5, 0), (12, 1, 1)])
def test_query_matches_reference(port, reference, monkeypatch, q, inserts,
                                 probes):
    want = check_query(port, reference, monkeypatch, q, inserts, probes)
    assert len(want) > 0


# plan shapes off the three queries' path that the ported operators cover:
# a global aggregate (no group keys) and a LIMIT without ORDER BY
@pytest.mark.parametrize("sql", [
    "select count(*), sum(l_quantity), avg(l_discount), min(l_shipdate), "
    "max(l_extendedprice) from lineitem "
    "where l_shipdate < date '1995-01-01'",
    "select o_orderkey, o_totalprice from orders "
    "where o_orderkey % 7 = 3 limit 5",
])
def test_other_plan_shapes_match_reference(port, reference, sql):
    _same_rows(port.execute(sql).rows(), reference.execute(sql).rows())


def test_stats_and_cuda_default(port):
    stats = QueryStats()
    port.execute(QUERIES[12], stats=stats)
    ops = stats.by_operator()
    assert {"ScanOperator", "LookupJoinOperator",
            "HashAggregationOperator"} <= set(ops)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StandaloneQueryRunner(default_catalog(SF))
