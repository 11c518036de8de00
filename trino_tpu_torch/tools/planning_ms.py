"""Planning time of the TPC-H queries under each optimizer, on the host.

Run from the repository root:  python -m trino_tpu_torch.tools.planning_ms [SF]

For each of the 22 TPC-H queries over the tpch connector at scale factor
SF (default 1) it prints the median of 5 ``create_plan`` calls under
``optimizer="legacy"`` and ``"iterative"``, each with the connector's
lineitem row count memoized and recomputed on every statistics call (as
it was before it was memoized).  Planning touches no device: the runners
are made with ``device="cpu"``, so the times are the host's wherever the
tool runs.  ``chip_smoke.py`` takes the same measurements on the card's
host.
"""

from __future__ import annotations

import sys
import time

from ..connectors.catalog import default_catalog
from ..connectors.tpch_queries import QUERIES
from ..runner import StandaloneQueryRunner

REPS = 5


def median_ms(fn, reps: int = REPS) -> float:
    """Median wall ms of ``reps`` calls of ``fn``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


class _Forgetful(dict):
    """A memo that keeps nothing: every statistics call derives the
    lineitem row count anew, as it did before it was memoized."""

    def __setitem__(self, key, value):
        pass


def planning_ms(catalog, sql: str) -> dict:
    """Median planning ms of ``sql`` over ``catalog``'s tpch connector per
    optimizer mode: ``legacy`` and ``iterative`` with the lineitem row
    count memoized, ``legacy_recomputed`` and ``iterative_recomputed``
    deriving it on every statistics call."""
    conn = catalog.connector("tpch")
    out = {}
    for mode in ("legacy", "iterative"):
        runner = StandaloneQueryRunner(catalog, device="cpu", optimizer=mode)
        out[mode] = median_ms(lambda: runner.create_plan(sql))
        memo, conn._lineitem_rows = conn._lineitem_rows, _Forgetful()
        try:
            out[f"{mode}_recomputed"] = median_ms(
                lambda: runner.create_plan(sql))
        finally:
            conn._lineitem_rows = memo
    return out


def main(argv: list[str]) -> int:
    sf = float(argv[0]) if argv else 1.0
    catalog = default_catalog(sf)
    print(f"planning ms at SF {sf:g} (median of {REPS} create_plan "
          "calls), lineitem row count memoized / recomputed per call: "
          "legacy, legacy recomputed, iterative, iterative recomputed")
    for q in sorted(QUERIES):
        ms = planning_ms(catalog, QUERIES[q])
        print(f"Q{q}: {ms['legacy']:.2f} {ms['legacy_recomputed']:.2f} "
              f"{ms['iterative']:.2f} {ms['iterative_recomputed']:.2f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
