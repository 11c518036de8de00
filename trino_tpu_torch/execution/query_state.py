"""Write-ahead query-state log: FTE queries survive the coordinator.

The port of the reference ``execution/query_state.py``.  Without it the
coordinator is the single point of failure: a crash loses every in-flight
query even though all committed stage outputs are already durable on disk
(execution/durable_spool.py).  With it (the spooled-execution story of
EventDrivenFaultTolerantQueryScheduler + FileSystemExchangeManager) the
*coordinator's* scheduling state becomes recoverable too.

One JSONL file per ``retry_policy="TASK"`` query, in the same torn-tail-
tolerant style as telemetry/journal.py:

- ``begin``             sql, plan fingerprint + the zlib-pickled fragment
                        tree (every tensor a plan node holds is pickled
                        from the host, so the snapshot does not depend on
                        the device that wrote it), the spool
                        root, and the JSON-able session fields that shape
                        FTE execution — everything a fresh coordinator
                        needs to re-materialize the query;
- ``attempt_start``     appended before every task attempt (the counters
                        that make "committed attempts are never
                        re-executed" *assertable*, not just claimed);
- ``attempt_committed`` appended + fsync'd inside ``commit()`` — after the
                        spool's atomic rename, so a record always points at
                        a directory that exists and is complete;
- ``end``               terminal state; a file with no ``end`` is an
                        in-flight query the next boot must resume.

Recovery (``pending_fte_recoveries`` → ``resume_fte_query`` in
distributed_runner.py) replays the committed-attempt map and re-runs only
what is missing.  At boot the statement server's dispatcher
(server/protocol.py) resumes every in-flight query under its original
id, and clients reattach by that id.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import io
import json
import os
import pickle
import re
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..spi import knobs

__all__ = ["QueryStateLog", "PendingQuery", "enabled", "state_dir",
           "encode_plan", "decode_plan", "load", "pending", "discard",
           "prune_ended", "restore_session"]

SCHEMA_VERSION = 1
_SAFE_QID = re.compile(r"[^A-Za-z0-9_.-]")

# Session fields recorded at begin() and replayed through
# dataclasses.replace on recovery: the JSON-able knobs that change what an
# FTE re-run would execute.  Process-local handles (failure_injector,
# transaction, ...) deliberately do NOT survive a coordinator death.
SESSION_FIELDS = (
    "default_catalog", "user", "splits_per_node", "node_count",
    "dynamic_filtering", "exchange_serde", "retry_policy",
    "task_retry_attempts", "fte_speculative", "fte_speculative_delay_s",
    "fte_memory_growth", "task_concurrency", "task_scheduler",
    "executor_workers", "scale_writers", "writer_task_limit",
)


def enabled() -> bool:
    return knobs.get_bool("TRINO_TPU_QUERY_STATE")


def default_dir() -> str:
    try:
        uid = os.getuid()
    except AttributeError:  # non-posix
        uid = 0
    return os.path.join(tempfile.gettempdir(),
                        f"trino-tpu-query-state-{uid}")


def state_dir() -> str:
    return knobs.get_str("TRINO_TPU_QUERY_STATE_DIR") or default_dir()


def _wal_path(query_id: str, dir: Optional[str] = None) -> str:
    safe = _SAFE_QID.sub("_", query_id) or "query"
    return os.path.join(dir or state_dir(), safe + ".wal")


class _HostPickler(pickle.Pickler):
    """Pickles a device tensor as its host copy."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return torch.as_tensor, (obj.detach().cpu(),)
        return NotImplemented


def encode_plan(subplan) -> tuple[str, str]:
    """-> (base64 of zlib-pickled SubPlan, sha256 fingerprint); tensors
    are pickled from the host."""
    buf = io.BytesIO()
    _HostPickler(buf).dump(subplan)
    raw = zlib.compress(buf.getvalue(), level=1)
    return (base64.b64encode(raw).decode("ascii"),
            hashlib.sha256(raw).hexdigest()[:16])


def decode_plan(plan_b64: str):
    return pickle.loads(zlib.decompress(base64.b64decode(plan_b64)))


class QueryStateLog:
    """Append-only per-query WAL.  ``attempt_committed`` and the begin/end
    bracket are fsync'd (they are the recovery contract); ``attempt_start``
    is flushed only — it exists for re-execution accounting, and a lost
    tail start record can only *under*-count work the dying coordinator
    did, never resurrect it."""

    def __init__(self, query_id: str, dir: Optional[str] = None):
        self.query_id = query_id
        self.path = _wal_path(query_id, dir)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def _append(self, record: dict, fsync: bool) -> None:
        record.setdefault("ts", time.time())
        line = json.dumps(record, separators=(",", ":"))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())

    def begin(self, sql: str, subplan, spool_root: str, session,
              task_counts: Optional[dict] = None,
              consumer_tasks: Optional[dict] = None) -> None:
        plan_b64, fingerprint = encode_plan(subplan)
        sess = {}
        get = getattr(session, "get", None)
        for name in SESSION_FIELDS:
            v = (get(name) if get is not None
                 else getattr(session, name, None))
            if isinstance(v, (str, int, float, bool)) or v is None:
                sess[name] = v
        self._append({
            "schema": SCHEMA_VERSION, "event": "begin",
            "query_id": self.query_id, "sql": sql,
            "fingerprint": fingerprint, "spool_root": spool_root,
            "session": sess, "plan": plan_b64,
            # the stage shape the committed dirs were produced under: a
            # resumed run whose worker topology changed these counts must
            # NOT reuse them (the per-partition files would be misshapen)
            "task_counts": {str(k): v for k, v in (task_counts or {})
                            .items()},
            "consumer_tasks": {str(k): v for k, v in (consumer_tasks or {})
                               .items()},
        }, fsync=True)

    def attempt_start(self, fragment_id: int, task_index: int,
                      attempt: int, kind: str) -> None:
        self._append({"event": "attempt_start", "fragment": fragment_id,
                      "task": task_index, "attempt": attempt,
                      "kind": kind}, fsync=False)

    def attempt_committed(self, fragment_id: int, task_index: int,
                          attempt: int, dir: str, kind: str) -> None:
        self._append({"event": "attempt_committed", "fragment": fragment_id,
                      "task": task_index, "attempt": attempt, "dir": dir,
                      "kind": kind}, fsync=True)

    def attempt_discarded(self, fragment_id: int, task_index: int,
                          reason: str) -> None:
        """A previously-committed attempt was invalidated (spool
        corruption); its producer will re-run."""
        self._append({"event": "attempt_discarded", "fragment": fragment_id,
                      "task": task_index, "reason": reason}, fsync=True)

    def end(self, state: str, error: Optional[str] = None) -> None:
        rec = {"event": "end", "state": state}
        if error:
            rec["error"] = error
        self._append(rec, fsync=True)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


@dataclass
class PendingQuery:
    """One parsed WAL file (in-flight unless ``ended``)."""

    query_id: str
    path: str
    sql: str = ""
    fingerprint: str = ""
    spool_root: str = ""
    session_fields: dict = field(default_factory=dict)
    plan_b64: str = ""
    task_counts: dict = field(default_factory=dict)      # str(fid) -> tc
    consumer_tasks: dict = field(default_factory=dict)   # str(fid) -> tc
    ended: Optional[str] = None        # terminal state string, if any
    # (fragment, task) -> {"attempt": n, "dir": path, "kind": ...} with
    # later records superseding earlier ones (a discard removes the entry)
    committed: dict = field(default_factory=dict)
    # (fragment, task) -> number of attempt_start records (re-execution
    # accounting across coordinator generations)
    attempt_counts: dict = field(default_factory=dict)

    @property
    def resumable(self) -> bool:
        return self.ended is None and bool(self.plan_b64)

    def committed_dirs(self) -> dict:
        return {k: v["dir"] for k, v in self.committed.items()}

    def shape_matches(self, task_counts: dict, consumer_tasks: dict) -> bool:
        """Committed dirs are reusable only when the resumed plan's stage
        shape equals the recorded one (worker replacement between boots can
        change task fan-out, which changes partition-file layout)."""
        if not self.task_counts:
            return True  # legacy record without shapes: trust the caller
        return (self.task_counts == {str(k): v
                                     for k, v in task_counts.items()}
                and self.consumer_tasks == {str(k): v for k, v
                                            in consumer_tasks.items()})


def load(path: str) -> Optional[PendingQuery]:
    """Parse one WAL file; unparseable lines (torn tail from a kill -9 mid
    write) are skipped, mirroring telemetry/journal.py reader semantics."""
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    pq = PendingQuery(query_id=os.path.basename(path)[:-len(".wal")],
                      path=path)
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        ev = rec.get("event")
        if ev == "begin":
            pq.query_id = rec.get("query_id", pq.query_id)
            pq.sql = rec.get("sql", "")
            pq.fingerprint = rec.get("fingerprint", "")
            pq.spool_root = rec.get("spool_root", "")
            pq.session_fields = rec.get("session", {}) or {}
            pq.plan_b64 = rec.get("plan", "")
            pq.task_counts = rec.get("task_counts", {}) or {}
            pq.consumer_tasks = rec.get("consumer_tasks", {}) or {}
            pq.ended = None
        elif ev == "attempt_start":
            key = (rec.get("fragment"), rec.get("task"))
            pq.attempt_counts[key] = pq.attempt_counts.get(key, 0) + 1
        elif ev == "attempt_committed":
            key = (rec.get("fragment"), rec.get("task"))
            pq.committed[key] = {"attempt": rec.get("attempt"),
                                 "dir": rec.get("dir"),
                                 "kind": rec.get("kind")}
        elif ev == "attempt_discarded":
            pq.committed.pop((rec.get("fragment"), rec.get("task")), None)
        elif ev == "end":
            pq.ended = rec.get("state", "FINISHED")
    return pq


def pending(dir: Optional[str] = None) -> list[PendingQuery]:
    """Every in-flight resumable query recorded under ``dir`` (the boot-
    time recovery work list), oldest WAL first."""
    d = dir or state_dir()
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        if not name.endswith(".wal"):
            continue
        pq = load(os.path.join(d, name))
        if pq is not None and pq.resumable:
            out.append(pq)
    out.sort(key=lambda p: _mtime(p.path))
    return out


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def prune_ended(dir: Optional[str] = None) -> int:
    """Delete WAL files whose query reached a terminal state (boot-time
    hygiene: only in-flight queries deserve durable state).  Returns the
    number removed."""
    d = dir or state_dir()
    if not os.path.isdir(d):
        return 0
    removed = 0
    for name in sorted(os.listdir(d)):
        if not name.endswith(".wal"):
            continue
        path = os.path.join(d, name)
        pq = load(path)
        if pq is not None and pq.ended is not None:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed


def discard(query_id: str, dir: Optional[str] = None) -> None:
    try:
        os.remove(_wal_path(query_id, dir))
    except OSError:
        pass


def restore_session(pq: PendingQuery, base=None):
    """Rebuild a Session for the resumed run: the recorded FTE-shaping
    fields over a fresh (or caller-provided) base (the port's stored
    properties go back into ``properties``)."""
    from ..runner import STORED_SESSION_PROPERTIES, Session

    base = base if base is not None else Session()
    known = {f.name for f in dataclasses.fields(Session)}
    fields = {k: v for k, v in pq.session_fields.items() if k in known}
    props = dict(base.properties)
    props.update({k: v for k, v in pq.session_fields.items()
                  if k in STORED_SESSION_PROPERTIES})
    return dataclasses.replace(base, properties=props, **fields)
