"""Device time of a query set on one card, by operation.

Run from the repository root:
    python -m trino_tpu_torch.tools.window_profile [--set windows|nested]
        [NAME ...]

Stages the TPC-H tables at SF 1 on the card (for the ``nested`` set also
``orders_nested``, connectors/nested_queries.py), runs each named query of
the set (default: the window queries of ``connectors/window_queries.py``,
all of them) once to warm it, five more times without the profiler, then
once under ``torch.profiler``, each run with the device synchronized at
its end.  For each query it prints the median wall ms of the unprofiled
runs (the profiler's own host work would inflate the wall of the traced
one, which is printed beside it), the summed device time of the traced
run's kernels, the share of the median unprofiled wall the device was
idle (one stream: kernels do not overlap), and the operations that took
the most device time.  Needs a CUDA card.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from ..connectors.catalog import default_catalog
from ..connectors.staging import stage_memory_tables
from ..runner import StandaloneQueryRunner

TOP = 12
WALL_RUNS = 5


def query_set(name: str) -> tuple:
    """(queries, tables to stage, set-up after staging) of a query set."""
    if name == "windows":
        from ..connectors.window_queries import WINDOW_QUERIES

        return (WINDOW_QUERIES,
                ("nation", "region", "supplier", "orders", "lineitem"),
                None)
    if name == "nested":
        from ..connectors.nested_queries import (NESTED_QUERIES,
                                                 build_orders_nested)

        return (NESTED_QUERIES, ("orders", "lineitem", "customer", "part"),
                build_orders_nested)
    raise ValueError(f"unknown query set {name!r}")


def _device_us(evt) -> float:
    """Self device time of one profiler row, in us (the attribute's name
    changed across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(runner, sql: str) -> tuple:
    """(median unprofiled wall ms, traced wall ms, device ms, rows of (op
    name, device ms, calls))."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    runner.execute(sql)
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        runner.execute(sql)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    # kernels, memcpys and memsets: the events that ran on the device
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in device) / 1e3
    ops = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in
                  prof.key_averages() if _device_us(e) > 0
                  and e.device_type != torch.autograd.DeviceType.CUDA),
                 key=lambda r: -r[1])
    return wall, traced, busy, ops


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("window_profile: CUDA is not available", file=sys.stderr)
        return 2
    set_name = "windows"
    if argv[:1] == ["--set"]:
        set_name, argv = argv[1], argv[2:]
    queries, tables, setup = query_set(set_name)
    names = argv or list(queries)
    cat = default_catalog(1.0)
    stage_memory_tables(cat, tables, "cuda")
    if setup is not None:
        setup(cat, "cuda")
    runner = StandaloneQueryRunner(cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    for name in names:
        wall, traced, busy, ops = profile(runner, queries[name])
        print(f"{name}: median wall {wall:.2f} ms (traced {traced:.2f} ms), "
              f"device busy {busy:.2f} ms, idle {1 - busy / wall:.1%}",
              flush=True)
        for key, ms, calls in ops[:TOP]:
            print(f"  {ms:9.3f} ms  {calls:6d} calls  {key}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
