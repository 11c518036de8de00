"""Dynamic filtering of the torch port against the JAX reference.

The holders of both packages get the same numpy inputs and must give the
same probe masks; the port's device domain (torch ops, here on the CPU)
must equal the reference's jitted one; and the 22 TPC-H queries and the
reference's selective joins at SF 0.01 must give the reference's rows
under every on / off combination of the runner's three scan arguments,
with the reference's total of probe rows pruned.  The reference is pinned
as ROADMAP "Pinning the reference" says, to the iterative optimizer the
port runs.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dynamic_filter import SELECTIVE_JOINS
from test_torch_queries import _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.exec import kernels as RK
from trino_tpu.exec.dynamic_filter import DynamicFilterHolder as RefHolder
from trino_tpu.exec.local_planner import LocalPlanner as RefPlanner
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.runner import run_pipelines as ref_run
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.dynamic_filter import (MAX_DISTINCT_SET,
                                                 DynamicFilterHolder)
from trino_tpu_torch.exec.kernels import _device_domain
from trino_tpu_torch.exec.local_planner import LocalPlanner
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.exec.prefetch import IngestConfig, default_threads
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


# ---------------------------------------------------------------------------
# holders: the same numpy inputs through both packages

_F = np.float64
HOLDER_CASES = {
    "numeric_set": (np.array([5, 7, 7, 9]), None, None,
                    np.array([4, 5, 6, 7, 9, 10]), None, None,
                    [False, True, False, True, True, False]),
    "null_probe_keys": (np.array([1, 2]), None, None, np.array([1, 2]),
                        np.array([True, False]), None, [True, False]),
    "empty_build": (np.array([], dtype=np.int64), None, None,
                    np.array([1, 2, 3]), None, None, [False] * 3),
    "dictionary_values": (np.array([0, 1, 1]), None,
                          np.array(["AFRICA", "ASIA"], dtype=object),
                          np.array([0, 1, 2]), None,
                          np.array(["AMERICA", "ASIA", "EUROPE"],
                                   dtype=object),
                          [False, True, False]),
    "nan_build": (np.array([1.5, np.nan, 3.0], _F), None, None,
                  np.array([np.nan, 1.5, 2.0, 3.0], _F), None, None,
                  [True, True, False, True]),
    # no range to keep: every probe row passes (None), NaN and all
    "nan_only_build": (np.array([np.nan, np.nan], _F), None, None,
                       np.array([np.nan, 1.0], _F), None, None, None),
    "nan_probe_no_nan_build": (np.array([1.0, 2.0], _F), None, None,
                               np.array([np.nan, 2.0], _F), None, None,
                               [False, True]),
    "null_build_keys": (np.array([1, 5, 9]), np.array([True, False, True]),
                        None, np.array([1, 5, 9]), None, None,
                        [True, False, True]),
}


@pytest.mark.parametrize("case", sorted(HOLDER_CASES))
def test_holder_masks_match_reference(case):
    bd, bv, bdict, pd, pv, pdict, want = HOLDER_CASES[case]
    ref, port = RefHolder(), DynamicFilterHolder()
    ref.fill(bd, bv, bdict)
    port.fill(bd, bv, bdict)
    got = port.probe_mask(pd, pv, pdict)
    np.testing.assert_array_equal(got, ref.probe_mask(pd, pv, pdict))
    assert (None if got is None else list(got)) == want
    assert port.empty == ref.empty


# ---------------------------------------------------------------------------
# a device-sized build: the domain as torch ops vs the reference's program

def _domain_inputs(kind: str, n: int = 100_000):
    rng = np.random.default_rng(7)
    valid = rng.random(n) < 0.9
    live = rng.random(n) < 0.8
    if kind == "int64":
        return rng.integers(-10**12, 10**12, n), valid, live, 0
    if kind == "float64":
        data = rng.normal(size=n) * 1e3
        data[rng.random(n) < 0.01] = np.nan
        return data, valid, live, 0
    if kind == "int32_codes":
        return rng.integers(0, 300, n).astype(np.int32), None, live, 400
    return rng.integers(0, 50, n).astype(np.int32), valid, None, 0


@pytest.mark.parametrize("kind", ["int64", "float64", "int32_codes",
                                  "int32_no_live"])
def test_device_domain_matches_reference(kind):
    data, valid, live, dict_len = _domain_inputs(kind)
    assert data.shape[0] > MAX_DISTINCT_SET
    got = _device_domain(torch.from_numpy(data),
                         None if valid is None else torch.from_numpy(valid),
                         None if live is None else torch.from_numpy(live),
                         dict_len).result()
    want = [np.asarray(x) for x in RK._device_domain(data, valid, live,
                                                     dict_len)]
    assert got[0] == int(want[0]) and got[1] == int(want[1])
    assert got[2] == want[2] and got[3] == want[3]
    np.testing.assert_array_equal(got[4], want[4])


def test_large_build_holder_is_a_range_as_in_reference():
    """More than 65,536 build keys: both packages keep only the range (and
    NaN), so the same probe rows pass."""
    data, valid, live, _ = _domain_inputs("float64", 70_000)
    probe = np.concatenate([data[:5000], [np.nan, 1e9, -1e9]])
    ref, port = RefHolder(), DynamicFilterHolder()
    # device arrays: the reference's device path, as its JoinBuildSink's
    ref.fill_device(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(live),
                    None)
    port.fill_device(torch.from_numpy(data), torch.from_numpy(valid),
                     torch.from_numpy(live), None)
    got = port.probe_mask(probe, None, None)
    np.testing.assert_array_equal(got, ref.probe_mask(probe, None, None))
    assert port.values is None and port.vmin == ref.vmin
    assert port.has_nan and got[-3] and not got[-2]


# ---------------------------------------------------------------------------
# queries: rows under every setting, and the rows pruned

@pytest.fixture(scope="module")
def catalogs():
    return default_catalog(SF), ref_catalog(SF)


def _pruned(pipelines) -> int:
    return sum(h.rows_pruned for p in pipelines for op in p
               if type(op).__name__ == "ScanOperator"
               for _, h in op.dynamic_filters)


def _ordered(sql: str) -> bool:
    return "order by" in sql.lower()


def _rows_equal(got, want, sql):
    if not _ordered(sql):
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    _same_rows(got, want)


SETTINGS = list(itertools.product((True, False), repeat=3))
CASES = ([(f"Q{q}", QUERIES[q]) for q in sorted(QUERIES)]
         + [(f"S{i}", s) for i, s in enumerate(SELECTIVE_JOINS)])


@pytest.mark.parametrize("name,sql", CASES, ids=[n for n, _ in CASES])
def test_rows_and_pruned_match_reference(catalogs, monkeypatch, name, sql):
    """The reference's rows under all eight (dynamic_filtering, ingest,
    encoded_exec) settings; with dynamic filtering on, the reference's
    total of probe rows pruned, and none with it off."""
    _pin(monkeypatch)
    port_cat, ref_cat = catalogs
    ref = RefRunner(ref_cat)
    plan = ref.create_plan(sql)
    lp = RefPlanner(ref_cat).plan(plan)
    ref_run(lp.pipelines, None)
    want_pruned = _pruned(lp.pipelines)
    want = ref.execute(sql).rows()
    for df, ingest_on, encoded in SETTINGS:
        ingest = IngestConfig(enabled=ingest_on,
                              threads=max(1, default_threads()))
        st = QueryStats()
        got = StandaloneQueryRunner(
            port_cat, device="cpu", dynamic_filtering=df, ingest=ingest,
            encoded_exec=encoded).execute(sql, stats=st).rows()
        assert st.scan.rows_pruned == (want_pruned if df else 0), (
            df, ingest_on, encoded)
        _rows_equal(got, want, sql)


def test_probe_rows_actually_pruned(catalogs):
    """EXPLAIN ANALYZE of the Q17-flavoured join: the probe scan of
    lineitem (~60k rows) emits under 6,000."""
    port = StandaloneQueryRunner(catalogs[0], device="cpu")
    out = "\n".join(r[0] for r in port.execute(
        "explain analyze " + SELECTIVE_JOINS[1]).rows())
    scans = [int(m) for m in re.findall(r"ScanOperator.*?out (\d+) rows",
                                        out)]
    assert scans, out
    assert min(scans) < 6000, out


def test_left_and_semi_joins_get_no_filters(catalogs):
    """Only INNER and RIGHT joins attach holders: a LEFT join's and a
    semi-join's probe scan must see every row."""
    port = StandaloneQueryRunner(catalogs[0], device="cpu")
    for sql in ("select count(*) from nation left join region "
                "on n_regionkey = r_regionkey and r_name = 'ASIA'",
                "select count(*) from nation where n_regionkey in "
                "(select r_regionkey from region where r_name = 'ASIA')"):
        local = LocalPlanner(catalogs[0], "cpu").plan(port.create_plan(sql))
        assert not any(op.dynamic_filters for p in local.pipelines
                       for op in p if type(op).__name__ == "ScanOperator")
