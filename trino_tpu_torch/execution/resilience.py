"""Fleet-shared durable resilience state: the cluster-blacklist store.

The port of the reference ``execution/resilience.py``.  The
:class:`~.speculation.ClusterBlacklist` journals its strikes into the
per-coordinator query journal, which is correct for one coordinator and
wrong for a fleet: two coordinators each
re-seed only their OWN journal, so a worker that fails under coordinator A
gets a clean slate from coordinator B, and a naive shared snapshot file
would be last-writer-wins (B's flush clobbers A's strikes).

:class:`SharedBlacklistStore` fixes both with the engine's usual durable
idiom (telemetry/journal.py, query_state.py): one append-only JSONL file
at ``TRINO_TPU_BLACKLIST_PATH`` shared by every coordinator.  Writes are
single ``O_APPEND`` writes (atomic for these line sizes on POSIX), so two
writers interleave whole records instead of clobbering each other; readers
merge-on-load — each coordinator incrementally tails the file and folds
every unexpired entry (its own AND its peers') into its in-memory table,
back-dated so TTL decay lands at the same wall moment on every member.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from ..spi import knobs

__all__ = ["SharedBlacklistStore", "blacklist_path"]


def blacklist_path() -> str:
    return knobs.get_str("TRINO_TPU_BLACKLIST_PATH")


class SharedBlacklistStore:
    """Append-only shared strike log + incremental merge-on-load reader.

    ``append`` records one strike with a WALL-clock timestamp (monotonic
    clocks do not compare across processes).  ``poll`` returns every
    record appended since the previous poll — by any writer, this process
    included — so a blacklist that feeds its own appends straight back
    through ``poll`` needs no separate local insert path (single source of
    truth, no double counting).  Truncation or replacement of the file
    (operator reset) is detected by shrinkage and re-read from the start.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._offset = 0
        self._buf = b""

    def append(self, worker: str, weight: float, reason: str,
               query_id: str = "", ts: Optional[float] = None) -> None:
        rec = {
            "ts": time.time() if ts is None else float(ts),
            "worker": worker,
            "weight": float(weight),
            "reason": reason,
            "query_id": query_id,
        }
        data = (json.dumps(rec, separators=(",", ":")) + "\n").encode("utf-8")
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)

    def poll(self) -> list[dict]:
        """New records since the last poll, oldest first.  A torn tail
        (a writer mid-append) stays buffered until its newline lands."""
        with self._lock:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                return []
            if size < self._offset:  # truncated/replaced: start over
                self._offset = 0
                self._buf = b""
            if size == self._offset:
                return []
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
            self._offset += len(chunk)
            data = self._buf + chunk
            lines = data.split(b"\n")
            self._buf = lines.pop()  # b"" when the tail ended in newline
            out = []
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "worker" in rec:
                    out.append(rec)
            return out
