"""Durable query journal: rotating JSONL of query lifecycle events.

The port of the reference ``telemetry/journal.py`` (whole): a
``QueryJournal`` is an ``EventListener`` that appends one JSON line per
QueryCreated / QueryCompleted event — the QueryStats roll-up, the
statement's fingerprint and the error code — to a size-bounded, rotating
journal file.  The record schema (version 2), the file name
(``query_journal.jsonl``, rotated to ``.1`` ... ``.N``) and the JSON are
the reference's, so each package reads the other's journal:

- ``system.runtime.query_history`` (connectors/system.py) scans it through
  the ordinary Connector SPI, so queries of an earlier process stay
  SQL-queryable;
- :func:`seeded_peak` gives the largest recent peak device memory of a
  fingerprint's finished runs.

A process writes one stream, ``query_journal.jsonl``; the reader folds
every ``query_journal*.jsonl`` stream of the directory, so the streams a
reference coordinator fleet writes there are read too.

Knobs: ``TRINO_TPU_JOURNAL_DIR`` (location; default a per-uid tempdir),
``TRINO_TPU_JOURNAL_MAX_BYTES`` (rotate threshold per file, default 4 MiB),
``TRINO_TPU_JOURNAL_FILES`` (rotated generations kept, default 3),
``TRINO_TPU_JOURNAL=0`` (disable).  Writers only append, and a reader
skips a torn tail line.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

from ..spi import knobs
from ..spi.eventlistener import (
    EventListener,
    QueryCompletedEvent,
    QueryCreatedEvent,
)

__all__ = [
    "SCHEMA_VERSION", "REQUIRED_FIELDS", "PLAN_STATS_FIELDS", "QueryJournal",
    "default_dir", "journal_dir", "journal_enabled", "get_journal", "history", "seeded_peak",
    "sample_records", "reset_for_test",
]

# v2: adds the per-query ``plan_stats`` event — observed per-plan-node
# stats (rows/bytes/groups/skew keyed by logical node fingerprint) that
# planner/history.py feeds back into the cost model on the next planning
# of the same query shape
SCHEMA_VERSION = 2
# every journal record, of any event type, carries at least these
REQUIRED_FIELDS = ("schema", "event", "ts", "query_id")

# the scalar stats a plan_stats node entry may carry (all optional)
PLAN_STATS_FIELDS = ("rows", "bytes", "groups", "skew")

_FILE = "query_journal.jsonl"


def default_dir() -> str:
    try:
        uid = os.getuid()
    except AttributeError:  # non-POSIX
        uid = 0
    return os.path.join(tempfile.gettempdir(), f"trino-tpu-journal-{uid}")


def journal_dir() -> str:
    """``TRINO_TPU_JOURNAL_DIR``, else :func:`default_dir`."""
    return knobs.get_str("TRINO_TPU_JOURNAL_DIR") or default_dir()


def journal_enabled() -> bool:
    return knobs.switched_on("TRINO_TPU_JOURNAL")


def _record_from_created(ev: QueryCreatedEvent) -> dict:
    return {
        "schema": SCHEMA_VERSION,
        "event": "query_created",
        "ts": ev.create_time,
        "query_id": ev.query_id,
        "sql": ev.sql,
        "user": ev.user,
    }


def _record_from_completed(ev: QueryCompletedEvent) -> dict:
    from . import runtime as rt

    return {
        "schema": SCHEMA_VERSION,
        "event": "query_completed",
        "ts": ev.end_time,
        "query_id": ev.query_id,
        "sql": ev.sql,
        "user": ev.user,
        "state": ev.state,
        "wall_ms": float(ev.wall_ms),
        "cpu_ms": float(ev.cpu_ms),
        "output_rows": int(ev.output_rows),
        "input_rows": int(ev.input_rows),
        "input_bytes": int(ev.input_bytes),
        "retry_count": int(ev.retry_count),
        "peak_memory_bytes": int(ev.peak_memory_bytes),
        "queued_time_ms": float(ev.queued_time_ms),
        "resource_group": ev.resource_group,
        "speculative_wins": int(ev.speculative_wins),
        "error": None if ev.error is None else str(ev.error),
        "error_code": ev.error_code,
        "fingerprint": rt.fingerprint(ev.sql),
    }


def _record_plan_stats(query_id: str, fingerprint: str,
                       nodes: dict, ts: float) -> dict:
    """``nodes`` maps logical plan-node fingerprint (planner/history.py)
    -> {rows, bytes, groups, skew} (each scalar optional)."""
    return {
        "schema": SCHEMA_VERSION,
        "event": "plan_stats",
        "ts": ts,
        "query_id": query_id,
        "fingerprint": fingerprint,
        "nodes": nodes,
    }


def sample_records() -> list[dict]:
    """One representative record per event type the journal can emit —
    the corpus tools/lint_journal_schema.py validates."""
    created = _record_from_created(
        QueryCreatedEvent("q_sample", "SELECT 1", user="lint"))
    ok = _record_from_completed(QueryCompletedEvent(
        "q_sample", "SELECT 1", state="FINISHED", user="lint",
        wall_ms=1.5, output_rows=1, cpu_ms=0.5, peak_memory_bytes=1 << 20,
        input_rows=10, input_bytes=100, retry_count=0, queued_time_ms=0.25,
        resource_group="global.adhoc", speculative_wins=1))
    failed = _record_from_completed(QueryCompletedEvent(
        "q_sample2", "SELECT 1/0", state="FAILED", user="lint",
        error="DIVISION_BY_ZERO: division by zero",
        error_code="DIVISION_BY_ZERO"))
    blacklist = {
        "schema": SCHEMA_VERSION,
        "event": "blacklist_entry",
        "ts": 1700000000.0,
        "query_id": "q_sample2",
        "worker": "worker-1",
        "weight": 1.0,
        "reason": "INTERNAL: injected task failure",
    }
    plan_stats = _record_plan_stats(
        "q_sample", "a2f1c3d4",
        {"e3b0c442": {"rows": 450000, "bytes": 7340032, "skew": 1.25},
         "9f86d081": {"rows": 45000, "bytes": 524288},
         "31b2e8c0": {"groups": 1024}},
        ts=1700000000.0)
    return [created, ok, failed, blacklist, plan_stats]


class QueryJournal(EventListener):
    """Size-bounded rotating JSONL sink + reader."""

    def __init__(self, directory: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 max_files: Optional[int] = None):
        self.directory = directory or journal_dir()
        self.max_bytes = max_bytes if max_bytes is not None else \
            knobs.get_int("TRINO_TPU_JOURNAL_MAX_BYTES")
        self.max_files = max_files if max_files is not None else \
            knobs.get_int("TRINO_TPU_JOURNAL_FILES")
        self.path = os.path.join(self.directory, _FILE)
        self._lock = threading.Lock()
        # first write of this process checks for a torn tail line (a crash
        # mid-write); appending straight onto it would corrupt the next
        # record too, so a newline is inserted first
        self._tail_checked = False
        # the open journal file (unbuffered append) and its inode: reopened
        # when the path names another file (a rotation, by any process)
        self._file = None
        self._ino = None

    # ------------------------------------------------------- listener side
    def query_created(self, event: QueryCreatedEvent) -> None:
        self._write(_record_from_created(event))

    def query_completed(self, event: QueryCompletedEvent) -> None:
        self._write(_record_from_completed(event))

    def plan_stats(self, query_id: str, fingerprint: str,
                   nodes: dict, ts: float) -> None:
        """Append one observed-plan-stats record (history-based
        optimization feed; planner/history.py is both writer and reader)."""
        self._write(_record_plan_stats(query_id, fingerprint, nodes, ts))

    def _write(self, rec: dict) -> None:
        """Append one record as one ``O_APPEND`` write of the whole line, so
        writers in several processes never interleave within a record.
        The file stays open between records: a record costs a ``stat`` of
        the path (its size, and whether another writer rotated it) and the
        write."""
        from . import metrics as tm

        data = (json.dumps(rec, default=str) + "\n").encode("utf-8")
        with self._lock:
            try:
                st = os.stat(self.path)
            except FileNotFoundError:
                st = None
            if st is None or self._file is None or \
                    (st.st_dev, st.st_ino) != self._ino:
                st = self._reopen()
            size = st.st_size
            if not self._tail_checked:
                self._tail_checked = True
                if size and os.pread(self._file.fileno(), 1,
                                     size - 1) != b"\n":
                    data = b"\n" + data
            if size and size + len(data) > self.max_bytes:
                self.close()
                self._rotate()
                self._reopen()
            self._file.write(data)
        tm.JOURNAL_RECORDS.inc()
        tm.JOURNAL_BYTES.inc(len(data))

    def _reopen(self) -> os.stat_result:
        """Open the journal path for appending (creating the directory on
        the first write); returns the open file's status."""
        self.close()
        try:
            f = open(self.path, "a+b", buffering=0)
        except FileNotFoundError:
            os.makedirs(self.directory, exist_ok=True)
            f = open(self.path, "a+b", buffering=0)
        st = os.fstat(f.fileno())
        self._file, self._ino = f, (st.st_dev, st.st_ino)
        return st

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = self._ino = None

    def _rotate(self) -> None:
        """journal.jsonl -> .1 -> .2 ... -> .max_files (dropped)."""
        from . import metrics as tm

        oldest = f"{self.path}.{self.max_files}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        tm.JOURNAL_ROTATIONS.inc()

    # --------------------------------------------------------- reader side
    def files(self) -> list[str]:
        """This member's journal files oldest-first (rotated generations
        then current)."""
        out = [f"{self.path}.{i}" for i in range(self.max_files, 0, -1)]
        out.append(self.path)
        return [p for p in out if os.path.exists(p)]

    def fleet_files(self) -> list[str]:
        """Every fleet member's journal files under the shared directory,
        oldest-first per stream, streams in name order — the READ set.  In
        a single-coordinator deployment this is exactly :meth:`files`; in a
        fleet it additionally folds the sibling ``query_journal-*`` streams
        other coordinators rotate, so journal-seeded admission estimates
        and ``system.runtime.query_history`` see the whole fleet's memory,
        not just the local rotation set."""
        stem = _FILE[:-len(".jsonl")]
        streams: dict[str, list[tuple[int, str]]] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return self.files()
        for name in names:
            if not name.startswith(stem):
                continue
            base, gen = name, 0
            if ".jsonl." in name:
                base, _, suffix = name.rpartition(".")
                if not suffix.isdigit():
                    continue
                gen = int(suffix)
            if not base.endswith(".jsonl"):
                continue
            streams.setdefault(base, []).append(
                (gen, os.path.join(self.directory, name)))
        out = []
        for base in sorted(streams):
            # oldest generation first (highest .N), current (gen 0) last
            for _gen, path in sorted(streams[base], reverse=True):
                out.append(path)
        return out or self.files()

    def read(self, events: Optional[tuple] = None) -> list[dict]:
        """Every parseable record, oldest-first; a torn tail line (crash
        mid-write) is skipped, not fatal — the journal must be readable
        after any kill."""
        out: list[dict] = []
        for path in self.fleet_files():
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if not isinstance(rec, dict) or "schema" not in rec:
                            continue
                        if events is None or rec.get("event") in events:
                            out.append(rec)
            except OSError:
                continue
        return out


# ------------------------------------------------------------ process state

_SINGLETON: Optional[QueryJournal] = None
_SINGLETON_LOCK = threading.Lock()
# fingerprint → [peaks] seed map, keyed by the journal file-set signature
# it was built from: (sig, cache).  Rebuilt only when a journal file
# appears/rotates/grows: a lookup costs a stat() per file, not a re-read
_SEED_CACHE: Optional[tuple] = None
_SEED_LOCK = threading.Lock()


def _journal_signature(j: QueryJournal) -> tuple:
    # the FLEET file set: a peer coordinator's append or rotation must
    # invalidate the admission seed cache exactly like a local one
    sig = []
    for path in j.fleet_files():
        try:
            st = os.stat(path)
        except OSError:
            continue
        sig.append((path, st.st_size, st.st_mtime_ns))
    return tuple(sig)


def get_journal() -> Optional[QueryJournal]:
    """The process-wide journal (one file lock, shared by every runner in
    the process), or None when disabled via TRINO_TPU_JOURNAL=0."""
    global _SINGLETON
    if not journal_enabled():
        return None
    with _SINGLETON_LOCK:
        if _SINGLETON is None:
            _SINGLETON = QueryJournal()
        return _SINGLETON


def history() -> list[dict]:
    """Completed-query records from disk, oldest-first — the
    system.runtime.query_history feed (always re-read: restarts and other
    coordinator processes may have appended)."""
    j = get_journal()
    if j is None:
        return []
    return j.read(events=("query_completed",))


def seeded_peak(fp: str, history_len: int = 5) -> int:
    """Journal-seeded admission estimate: max peak of the fingerprint's
    most recent FINISHED runs on disk, 0 when unknown.  The seed map is
    memoized on the journal file-set signature (path, size, mtime), so
    steady-state admission does a handful of stat() calls and re-reads the
    files only when another coordinator appended or a rotation happened."""
    global _SEED_CACHE
    j = get_journal()
    if j is None:
        return 0
    with _SEED_LOCK:
        sig = _journal_signature(j)
        if _SEED_CACHE is None or _SEED_CACHE[0] != sig:
            cache: dict[str, list[int]] = {}
            for rec in j.read(events=("query_completed",)):
                if rec.get("state") != "FINISHED":
                    continue
                peak = int(rec.get("peak_memory_bytes", 0) or 0)
                if peak <= 0:
                    continue
                cache.setdefault(rec.get("fingerprint", ""), []).append(peak)
            _SEED_CACHE = (sig, cache)
        peaks = _SEED_CACHE[1].get(fp)
    if not peaks:
        return 0
    return max(peaks[-history_len:])


def reset_for_test() -> None:
    """Forget the singleton and the seed cache — the in-process stand-in
    for a coordinator restart (env changes take effect on next use)."""
    global _SINGLETON, _SEED_CACHE
    with _SINGLETON_LOCK:
        if _SINGLETON is not None:
            _SINGLETON.close()
        _SINGLETON = None
    _SEED_CACHE = None
