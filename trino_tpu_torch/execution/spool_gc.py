"""Spool retention + GC: replaces FTE's unconditional end-of-query rmtree.

The port of the reference ``execution/spool_gc.py``.  The old contract — ``shutil.rmtree(spool_root)`` in a finally — was both
too eager and too weak: too eager because committed stage outputs are the
engine's recovery currency (coordinator crash recovery *and* non-leaf
straggler speculation both re-read them), too weak because a coordinator
killed before the finally leaked the root forever.  This module makes
retention explicit (reference: FileSystemExchangeManager's exchange
lifecycle + its cleanup of abandoned exchange directories):

- every live spool root carries a **lease** (``.lease.json``: owner query
  id, pid, timestamp, TTL) written at query start;
- ``release()`` is the happy-path GC — the query is done, its root is
  reclaimed immediately (byte-accounted through ``trino_fte_spool_*``);
- ``sweep()`` is the boot-time / periodic pass over the spool base dir:
  roots whose owner pid is dead (a crashed coordinator) or whose lease
  expired are reclaimed — EXCEPT roots named in ``keep``, which recovery
  passes for queries it is about to resume (the statement server's boot
  recovery, server/protocol.py ``QueryDispatcher._recover_and_sweep``);
- ``TRINO_TPU_SPOOL_TTL_S`` bounds how long an unleased/abandoned root may
  linger; ``TRINO_TPU_SPOOL_MAX_BYTES`` is the retention budget — once
  retained roots exceed it the sweep reclaims reclaimable roots
  oldest-first (never a root owned by a live pid or under recovery).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Iterable, Optional

from ..spi import knobs
from ..telemetry import metrics as tm
from ..telemetry import profiler

__all__ = ["acquire", "release", "sweep", "dir_bytes", "spool_base",
           "LEASE_FILE", "SPOOL_PREFIX"]

LEASE_FILE = ".lease.json"
SPOOL_PREFIX = "trino-tpu-spool-"


def spool_base() -> str:
    return knobs.get_str("TRINO_TPU_SPOOL_DIR") or tempfile.gettempdir()


def _ttl_s() -> float:
    v = knobs.get_float("TRINO_TPU_SPOOL_TTL_S")
    return 3600.0 if v is None else v


def _max_bytes() -> int:
    v = knobs.get_int("TRINO_TPU_SPOOL_MAX_BYTES")
    return (1 << 30) if v is None else v


def dir_bytes(root: str) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                pass
    return total


def acquire(root: str, query_id: str,
            ttl_s: Optional[float] = None) -> None:
    """Write the root's lease (atomic tmp+rename so a reader never sees a
    torn lease; an existing lease is superseded — recovery re-leases a
    crashed query's root under the new coordinator pid)."""
    lease = {"query_id": query_id, "pid": os.getpid(), "ts": time.time(),
             "ttl_s": _ttl_s() if ttl_s is None else float(ttl_s)}
    tmp = os.path.join(root, LEASE_FILE + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(lease, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, LEASE_FILE))


def _read_lease(root: str) -> Optional[dict]:
    try:
        with open(os.path.join(root, LEASE_FILE), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _pid_alive(pid) -> bool:
    if not isinstance(pid, int) or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _reclaim(root: str, reason: str) -> int:
    """rmtree + byte accounting; returns bytes reclaimed."""
    n = dir_bytes(root)
    shutil.rmtree(root, ignore_errors=True)
    tm.FTE_SPOOL_BYTES_RECLAIMED.inc(n)
    profiler.instant(profiler.RECOVERY, "spool-reclaim",
                     root=os.path.basename(root), reason=reason, bytes=n)
    return n


def release(root: str) -> int:
    """Happy-path GC at query end: reclaim the root now (idempotent)."""
    if not root or not os.path.isdir(root):
        return 0
    return _reclaim(root, "release")


def sweep(base: Optional[str] = None, keep: Iterable[str] = (),
          now: Optional[float] = None) -> dict:
    """One retention pass over every ``trino-tpu-spool-*`` root under
    ``base``.  Returns ``{"kept": [...], "reclaimed": [...],
    "live_bytes": n}`` and refreshes the live-bytes gauge."""
    base = base or spool_base()
    now = time.time() if now is None else now
    keep = {os.path.abspath(k) for k in keep}
    kept: list[tuple[float, str, int, bool]] = []  # (age_ts, root, bytes, pinned)
    reclaimed: list[str] = []
    try:
        names = sorted(os.listdir(base))
    except OSError:
        names = []
    for name in names:
        if not name.startswith(SPOOL_PREFIX):
            continue
        root = os.path.join(base, name)
        if not os.path.isdir(root):
            continue
        if os.path.abspath(root) in keep:
            kept.append((now, root, dir_bytes(root), True))
            continue
        lease = _read_lease(root)
        if lease is not None:
            ttl = float(lease.get("ttl_s") or _ttl_s())
            expired = now - float(lease.get("ts") or 0) > ttl
            if _pid_alive(lease.get("pid")) and not expired:
                kept.append((float(lease.get("ts") or now), root,
                             dir_bytes(root), True))
                continue
            # owner died (crashed coordinator, not under recovery) or the
            # lease ran out: the root is a leak
            reclaimed.append(root)
            _reclaim(root, "dead-owner" if expired is False else "expired")
            continue
        # no lease: a foreign/interrupted mkdtemp — only age can judge it
        try:
            age_ts = os.path.getmtime(root)
        except OSError:
            age_ts = 0.0
        if now - age_ts > _ttl_s():
            reclaimed.append(root)
            _reclaim(root, "ttl")
        else:
            kept.append((age_ts, root, dir_bytes(root), False))
    # retention budget: reclaim unpinned keepers oldest-first
    budget = _max_bytes()
    total = sum(b for _ts, _r, b, _p in kept)
    if total > budget:
        for ts, root, nbytes, pinned in sorted(kept):
            if total <= budget or pinned:
                continue
            reclaimed.append(root)
            _reclaim(root, "budget")
            total -= nbytes
        kept = [k for k in kept if k[1] not in set(reclaimed)]
    live = sum(b for _ts, _r, b, _p in kept)
    tm.FTE_SPOOL_BYTES_LIVE.set(live)
    return {"kept": [r for _ts, r, _b, _p in kept],
            "reclaimed": reclaimed, "live_bytes": live}
