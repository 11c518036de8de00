"""Where a warm staged query's host time goes, by function, on one card.

Run as a script from the repository root, so that ``PYTHONPATH`` chooses
which tree's ``trino_tpu_torch`` is profiled (two trees compare in one
call, as with ``path_walls.py``):

    PYTHONPATH=<tree> python trino_tpu_torch/tools/query_overhead.py \\
        [--queries 6,4,3] [--runs 30] [--top 25]

Stages the SF 1 tables on the card, then for each query: two warm-up
runs, ``runs`` timed runs (median wall ms, each ending in
``torch.cuda.synchronize()``), then ``runs`` runs under cProfile.
Prints one JSON object: the tree's package path, the card's name and
power limit, and per query the median wall and the ``top`` functions by
own time, with calls, own ms and cumulative ms per execution.  The caches
follow the ``TRINO_TPU_*_CACHE`` variables (set both tiers to 0 to
profile execution).  Absolute imports only.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import time


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", default="6,4,3")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch

    import trino_tpu_torch
    from trino_tpu_torch.connectors.catalog import default_catalog
    from trino_tpu_torch.connectors.staging import stage_memory_tables
    from trino_tpu_torch.connectors.tpch_queries import QUERIES
    from trino_tpu_torch.runner import StandaloneQueryRunner

    cat = default_catalog(1.0)
    stage_memory_tables(cat, ("region", "nation", "supplier", "customer",
                              "part", "partsupp", "orders", "lineitem"),
                        "cuda")
    runner = StandaloneQueryRunner(cat, default_catalog_name="memory",
                                   splits_per_node=1)

    def run(sql: str) -> None:
        runner.execute(sql)
        torch.cuda.synchronize()

    out = {}
    for q in (int(v) for v in args.queries.split(",")):
        sql = QUERIES[q]
        run(sql)
        run(sql)
        walls = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            run(sql)
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.runs):
            run(sql)
        prof.disable()
        stats = pstats.Stats(prof).stats
        rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:args.top]
        out[f"Q{q}"] = {
            "wall_ms": sorted(walls)[len(walls) // 2],
            "top": [{"fn": f"{f[0].rsplit('/', 2)[-1]}:{f[1]}({f[2]})",
                     "calls": v[1] / args.runs,
                     "own_ms": v[2] * 1e3 / args.runs,
                     "cum_ms": v[3] * 1e3 / args.runs}
                    for f, v in rows]}
    print(json.dumps({"package": trino_tpu_torch.__path__[0],
                      "card": _card(), "runs": args.runs, "queries": out}))


if __name__ == "__main__":
    main()
