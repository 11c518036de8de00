"""Warm wall ms of the 22 TPC-H queries at SF 1 on one card, over the
staged memory tables or the tpch connector.

Run as a script from the repository root, so that ``PYTHONPATH``
chooses which tree's ``trino_tpu_torch`` is timed (two trees compare in
one call, in turns A B B A; the other tree need not hold this script):

    PYTHONPATH=<tree> python trino_tpu_torch/tools/path_walls.py \\
        [--path staged|tpch] [--runs 5]

Each query runs once cold, then ``runs`` times warm; each run ends in
``torch.cuda.synchronize()``.  Prints one JSON object: the tree's package
path, the card's name and power limit (``nvidia-smi``), and per query the
cold ms and the median warm ms, with their sums.  Absolute imports only:
the script must not import the tree it sits in when ``PYTHONPATH`` names
another.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("staged", "tpch"), default="staged")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()

    import torch

    import trino_tpu_torch
    from trino_tpu_torch.connectors.catalog import default_catalog
    from trino_tpu_torch.connectors.staging import stage_memory_tables
    from trino_tpu_torch.connectors.tpch_queries import QUERIES
    from trino_tpu_torch.runner import StandaloneQueryRunner

    cat = default_catalog(1.0)
    if args.path == "staged":
        stage_memory_tables(cat, ("region", "nation", "supplier", "customer",
                                  "part", "partsupp", "orders", "lineitem"),
                            "cuda")
        runner = StandaloneQueryRunner(cat, default_catalog_name="memory",
                                       splits_per_node=1)
    else:
        runner = StandaloneQueryRunner(cat)

    def wall(sql: str) -> float:
        t0 = time.perf_counter()
        runner.execute(sql)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    cold, warm = {}, {}
    for q, sql in QUERIES.items():
        cold[f"Q{q}"] = wall(sql)
        runs = sorted(wall(sql) for _ in range(args.runs))
        warm[f"Q{q}"] = runs[len(runs) // 2]
    print(json.dumps({
        "package": trino_tpu_torch.__path__[0], "card": _card(),
        "path": args.path, "runs": args.runs, "cold_ms": cold,
        "warm_ms": warm, "cold_sum_ms": sum(cold.values()),
        "warm_sum_ms": sum(warm.values())}))


if __name__ == "__main__":
    main()
