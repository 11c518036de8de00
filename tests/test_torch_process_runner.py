"""Worker PROCESSES of the port: tasks created over HTTP (POST /v1/task),
pages pulled with the token-ack results protocol, and the 22 TPC-H
queries plus R1 and R2 through two port worker processes at SF 0.01,
with rows equal to the reference's standalone rows (the reference pinned
to its sort path).

The faults (worker death, drains, PROCESS_EXIT, FTE across processes, the
internal secret, the cross-process trace and profile) are in
tests/test_torch_process_faults.py, so ``--dist loadfile`` runs the two
files on two workers.
"""

import os

import pytest
import torch

from test_torch_distributed import CASES, _same
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefStandalone
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.execution.remote import ProcessDistributedQueryRunner
from trino_tpu_torch.runner import Session

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))
CATALOG_SPEC = {
    "factory": "trino_tpu_torch.connectors.catalog:default_catalog",
    "kwargs": {"scale_factor": SF},
}
# each worker process is one torch process: one intra-op thread, so two
# workers per test file under ``-n 6`` do not oversubscribe the cores
WORKER_ENV = {"OMP_NUM_THREADS": "1", "TRINO_TPU_HBO": "0",
              "TRINO_TPU_RESULT_CACHE": "0"}
SQLS = {name: (sql, ordered) for name, sql, ordered in CASES}


@pytest.fixture(scope="module")
def cluster():
    old = {k: os.environ.get(k) for k, _ in PINS}
    os.environ.update(dict(PINS))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist = ProcessDistributedQueryRunner(
        CATALOG_SPEC, worker_count=2, session=Session(node_count=2),
        env_overrides=WORKER_ENV, device="cpu")
    ref = RefStandalone(ref_catalog(scale_factor=SF))
    try:
        yield dist, ref
    finally:
        dist.close()
        torch.set_num_threads(n)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _no_result_cache():
    with result_cache.disabled(), ref_result_cache.disabled():
        yield


@pytest.mark.parametrize("name", list(SQLS))
def test_tpch_over_processes(cluster, name):
    dist, ref = cluster
    sql, ordered = SQLS[name]
    got = dist.execute(sql).rows()
    want = ref.execute(sql).rows()
    # REAL sums: float32 partial sums in another order than the
    # reference's sort path; rtol 1e-4 as the other R1 / R2 parity tests
    _same(got, want, ordered, 1e-4 if name in ("R1", "R2") else 1e-9)


def test_workers_report_device_and_launches(cluster):
    """GET /v1/info keeps the reference's ``state`` and ``tasks`` and adds
    the worker's device and its kernel launch counts since boot (on the
    CPU the wrappers take their plain versions, which are no launch)."""
    dist, _ = cluster
    dist.execute(SQLS["Q3"][0])
    for w in dist.workers:
        info = w.info()
        assert info["state"] == "ACTIVE" and info["tasks"] > 0
        assert (info["device"], info["device_name"]) == ("cpu", "cpu")
        assert info["launches"] == {"hash_insert": 0, "hash_probe": 0,
                                    "masked_segment_sum_f32": 0}
        assert w.device == "cpu" and w.boot_s > 0
