"""A fresh worker fleet's first statement with and without the replay of
the warm-key journal, in turns.

``python -m trino_tpu_torch.tools.warm_boot [--sf 1] [--device cuda]``

First it fills the journal: TPC-H Q3 (a resident plan) and Q1 (a fused
seam) on an in-process ``DistributedQueryRunner`` (four tasks) on the
device; each query's end writes ``exec_warm.json`` into
``TRINO_TPU_JOURNAL_DIR`` (a new directory under ``build/`` unless the
variable is set).  Then, for each turn of off, on, on, off, it boots a
fresh ``ProcessDistributedQueryRunner`` (two workers) with
``TRINO_TPU_EXEC_WARM`` 0 ("off") or 1 ("on"), starts the statement
server and times the first statement (Q1) through the client.  Each turn
is one JSON line (boot seconds, each worker's replay: keys read, warmed,
skipped, ms; the first statement's ms); the last line gathers the turns
by setting.  The order puts each setting first once and last once, so the
host's warm-up from one boot to the next favours neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

TURNS = ("off", "on", "on", "off")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not os.environ.get("TRINO_TPU_JOURNAL_DIR"):
        os.makedirs("build", exist_ok=True)
        os.environ["TRINO_TPU_JOURNAL_DIR"] = tempfile.mkdtemp(
            prefix="warm-boot-journal-", dir="build")
    for knob in ("TRINO_TPU_HBO", "TRINO_TPU_ADAPTIVE"):
        os.environ.setdefault(knob, "0")

    from ..caching import executable_cache, result_cache
    from ..connectors.catalog import default_catalog
    from ..connectors.tpch_queries import QUERIES
    from ..execution.distributed_runner import DistributedQueryRunner
    from ..execution.remote import ProcessDistributedQueryRunner
    from ..runner import Session
    from ..server import Client, TrinoTpuServer

    spec = {"factory": "trino_tpu_torch.connectors.catalog:default_catalog",
            "kwargs": {"scale_factor": args.sf}}
    sql = QUERIES[1]
    with result_cache.disabled():
        dist = DistributedQueryRunner(default_catalog(args.sf),
                                      worker_count=4,
                                      session=Session(node_count=4),
                                      device=args.device)
        dist.execute(QUERIES[3])
        dist.execute(QUERIES[1])
        del dist
    with open(executable_cache.warm_file_path(), encoding="utf-8") as f:
        keys = json.load(f)["keys"]
    print(json.dumps({"journal": executable_cache.warm_file_path(),
                      "keys": len(keys)}), flush=True)
    walls: dict = {}
    for turn in TURNS:
        t0 = time.perf_counter()
        fleet = ProcessDistributedQueryRunner(
            spec, worker_count=2, device=args.device,
            session=Session(node_count=2),
            env_overrides={"TRINO_TPU_EXEC_WARM":
                           "0" if turn == "off" else "1",
                           "TRINO_TPU_RESULT_CACHE": "0"})
        try:
            boot_s = time.perf_counter() - t0
            server = TrinoTpuServer(fleet).start()
            try:
                host, port = server.address
                warm = [w.info()["warm"] for w in fleet.workers]
                t1 = time.perf_counter()
                Client(host, port).execute(sql)
                ms = (time.perf_counter() - t1) * 1e3
            finally:
                server.stop()
        finally:
            fleet.close()
        walls.setdefault(turn, []).append(ms)
        print(json.dumps({"turn": turn, "boot_s": boot_s, "warm": warm,
                          "first_statement": "Q1",
                          "ms": ms}), flush=True)
    print(json.dumps({"first_statement_ms": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
