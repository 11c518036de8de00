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
one, which is printed beside it), the traced run's device time (the
union of its kernels', copies' and sets' intervals), the share of the
median unprofiled wall the device was idle, and the operations that took
the most device time.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
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
    runner.execute(sql)
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        runner.execute(sql)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    traced, busy, ops, _ = trace(runner, sql)
    return statistics.median(walls), traced, busy, ops


def trace(runner, sql: str, stats=None) -> tuple:
    """One run of ``sql`` under ``torch.profiler``: (traced wall ms, device
    ms, rows of (op name, device ms, calls), host-to-device bytes by
    memcpy kind, e.g. "Memcpy HtoD (Pinned -> Device)").  The device ms is
    the union of the device events' intervals (kernels, copies, sets): a
    side stream's copies overlap the compute stream's kernels.  The bytes
    come from the trace's copy events; the trace is written to, read from
    and removed under build/profiles/.  ``stats`` (a QueryStats) is handed
    to the run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql, stats=stats)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in
                  prof.key_averages() if _device_us(e) > 0
                  and e.device_type != torch.autograd.DeviceType.CUDA),
                 key=lambda r: -r[1])
    events = _device_events(prof)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events]
    htod = {k: v for k, v in _copy_bytes(events).items() if "HtoD" in k}
    return traced, _union_ms(spans), ops, htod


def copy_bytes(fn) -> dict:
    """Bytes of every memcpy kind the device ran during one call of ``fn``
    under ``torch.profiler`` (device synchronized at its end), by the
    trace's event name, e.g. "Memcpy DtoH (Device -> Pageable)"."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _copy_bytes(_device_events(prof))


def _device_events(prof) -> list:
    """The trace's device events (kernels, copies, sets); the trace is
    written to, read from and removed under build/profiles/."""
    out = os.path.join("build", "profiles")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]


def _copy_bytes(events) -> dict:
    out: dict = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            name = e.get("name", "")
            out[name] = out.get(name, 0) + int(
                e.get("args", {}).get("bytes", 0))
    return out


# trace-event categories of work on the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_ms(spans) -> float:
    """Total length of the union of [start, end) us intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


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
