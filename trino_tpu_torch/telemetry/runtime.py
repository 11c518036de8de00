"""Process-wide query and task registries: the ``system.runtime`` feed.

The port of the reference ``telemetry/runtime.py`` (the DispatchManager
query tracker + SqlTaskManager task list behind the reference's
RuntimeQueriesSystemTable / RuntimeTasksSystemTable): bounded deques of
live and recently finished query and task records, updated by
``runner.run_with_query_events`` and queryable in SQL through
connectors/system.py.  :func:`fingerprint` is the reference's, so a
statement has one fingerprint in both packages' journals.

The registries are process-global on purpose: every runner in the process
lands in one timeline, and a query against ``system.runtime.queries`` sees
itself RUNNING.  A query's record is also the calling thread's *current*
record (:func:`current_record`); threads that work for the query (driver
groups, prefetch threads, executor workers) are handed it explicitly.
"""


from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Optional

__all__ = [
    "QueryRecord", "TaskRecord", "query_started", "query_finished",
    "current_record", "adopt_record", "add_input", "add_retries",
    "add_adaptive",
    "task_started",
    "task_finished", "queries", "tasks", "fingerprint",
]


def fingerprint(sql: str) -> str:
    """Whitespace/case-normalized SQL hash: the key under which the
    journal, the plan cache and ``system.runtime.query_history`` find
    earlier runs of the same statement."""
    norm = " ".join(sql.strip().lower().split())
    return hashlib.sha1(norm.encode("utf-8")).hexdigest()[:16]


class QueryRecord:
    __slots__ = ("query_id", "sql", "user", "state", "create_time",
                 "end_time", "wall_ms", "cpu_ms", "output_rows", "error",
                 "input_rows", "input_bytes", "retry_count",
                 "peak_memory_bytes", "fingerprint", "queued_ms",
                 "resource_group", "speculative_wins", "adaptive_decisions",
                 "_lock")

    def __init__(self, query_id: str, sql: str, user: str):
        self.query_id = query_id
        self.sql = sql
        self.user = user
        self.state = "RUNNING"
        self.create_time = time.time()
        self.end_time: Optional[float] = None
        self.wall_ms = 0.0
        self.cpu_ms = 0.0
        self.output_rows = -1
        self.error: Optional[str] = None
        self.input_rows = 0
        self.input_bytes = 0
        self.retry_count = 0
        self.peak_memory_bytes = 0
        self.fingerprint = fingerprint(sql)
        self.queued_ms = 0.0
        self.resource_group = ""
        self.speculative_wins = 0
        # compact "kind[site]=choice" list, comma-joined — the
        # system.runtime.queries adaptive_decisions column
        self.adaptive_decisions = ""
        self._lock = threading.Lock()


class TaskRecord:
    __slots__ = ("query_id", "task_id", "fragment", "task_index", "worker",
                 "state", "create_time", "wall_ms", "error")

    def __init__(self, query_id: str, task_id: str, fragment: int,
                 task_index: int, worker: str):
        self.query_id = query_id
        self.task_id = task_id
        self.fragment = fragment
        self.task_index = task_index
        self.worker = worker
        self.state = "RUNNING"
        self.create_time = time.time()
        self.wall_ms = 0.0
        self.error: Optional[str] = None


_LOCK = threading.Lock()
_QUERIES: deque = deque(maxlen=512)
_TASKS: deque = deque(maxlen=2048)
_CURRENT = threading.local()


def query_started(query_id: str, sql: str, user: str) -> QueryRecord:
    rec = QueryRecord(query_id, sql, user)
    with _LOCK:
        _QUERIES.append(rec)
    _CURRENT.record = rec
    return rec


def query_finished(rec: QueryRecord, state: str, wall_ms: float,
                   cpu_ms: float, output_rows: int,
                   error: Optional[str] = None,
                   peak_memory_bytes: int = 0) -> None:
    rec.state = state
    rec.end_time = time.time()
    rec.wall_ms = wall_ms
    rec.cpu_ms = cpu_ms
    rec.output_rows = output_rows
    rec.error = error
    rec.peak_memory_bytes = peak_memory_bytes
    if getattr(_CURRENT, "record", None) is rec:
        _CURRENT.record = None


def current_record() -> Optional[QueryRecord]:
    """The query record of the query running on THIS thread (set between
    query_started and query_finished by run_with_query_events)."""
    return getattr(_CURRENT, "record", None)


def adopt_record(rec: Optional[QueryRecord]) -> None:
    """Make ``rec`` (captured with :func:`current_record` on the query's
    thread) the current record of a thread that works for the query."""
    _CURRENT.record = rec


def add_input(rec: Optional[QueryRecord], rows: int, nbytes: int) -> None:
    """Credit scanned input to a query record; task threads call this with
    the record captured on the query thread, so it takes the record lock."""
    if rec is None or (not rows and not nbytes):
        return
    with rec._lock:
        rec.input_rows += int(rows)
        rec.input_bytes += int(nbytes)


def add_retries(rec: Optional[QueryRecord], n: int) -> None:
    if rec is None or not n:
        return
    with rec._lock:
        rec.retry_count += int(n)


def add_adaptive(rec: Optional[QueryRecord], decision: str) -> None:
    """Append one adaptive-execution decision tag to the query record."""
    if rec is None or not decision:
        return
    with rec._lock:
        rec.adaptive_decisions = (
            decision if not rec.adaptive_decisions
            else rec.adaptive_decisions + "," + decision)


def task_started(query_id: str, task_id: str, fragment: int,
                 task_index: int, worker: str) -> TaskRecord:
    rec = TaskRecord(query_id, task_id, fragment, task_index, worker)
    with _LOCK:
        _TASKS.append(rec)
    return rec


def task_finished(rec: TaskRecord, state: str,
                  error: Optional[str] = None) -> None:
    rec.state = state
    rec.error = error
    rec.wall_ms = (time.time() - rec.create_time) * 1e3


def queries() -> list:
    with _LOCK:
        return list(_QUERIES)


def tasks() -> list:
    with _LOCK:
        return list(_TASKS)
