"""Query flight recorder: per-thread lock-free timeline profiler.

The port of the reference ``telemetry/profiler.py``: every thread that
works for a query owns a fixed-capacity ring of timestamped events —
operator enter/exit (exec/driver.py), batch staged (exec/operators.py,
the scan's DeviceStager), spill write and read-back (exec/spill.py), and
the cache tiers' hits (caching/).  Recording is one ``time.time()`` call
plus a tuple store into the ring — no contended locks, no device syncs —
so the default level adds no host sync to a query.

Levels (``TRINO_TPU_PROFILE``):

- ``off``/``0``  — recording disabled entirely.
- ``default``/``1`` (unset) — timestamped wall-time events.  Because the
  card runs the launched work asynchronously, an operator event at this
  level credits *launch* wall time (exactly like OperatorStats).
- ``full``/``2`` — additionally synchronizes the produced batch's CUDA
  stream after each operator step, so the event duration is true device
  time.  This deliberately syncs (counted by exec/syncguard.py under the
  ``profiler.full`` tag) and is opt-in for exactly that reason.

Rings are thread-local; a thread's current (query_id, task_id) context is
stamped onto every event it records, and threads that work for a query
adopt the spawning thread's context (:func:`capture_context` /
:func:`apply_context`).  Finished queries are *harvested* into a bounded
per-query store; ``chrome_trace()`` renders a query's timeline as Chrome
``trace_event`` JSON (viewable in Perfetto / chrome://tracing).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional

from ..spi import knobs

__all__ = [
    "OPERATOR", "FUSED", "RESIDENT", "EXCHANGE", "STAGE", "SPILL",
    "SPECULATION", "TASK", "ADAPTIVE", "RECOVERY",
    "level", "enabled", "is_full", "set_level", "event", "instant",
    "now", "set_context", "capture_context", "apply_context", "sync_batch",
    "collect", "harvest", "add_remote_events", "take_task_events",
    "events_for", "chrome_trace", "reset_for_test",
]

# event kinds (the ``cat`` field of the chrome trace)
OPERATOR = "operator"
FUSED = "fused-region"
RESIDENT = "resident-plan"  # trino.resident.* whole-plan program track
EXCHANGE = "exchange-wait"
STAGE = "batch-staged"
SPILL = "spill"
SPECULATION = "speculation"
TASK = "task"
ADAPTIVE = "adaptive"
RECOVERY = "recovery"

_OFF, _DEFAULT, _FULL = 0, 1, 2

# the process id stamped on events, read once (and again in a forked
# child), not once per harvest
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)


def _level_from_env() -> int:
    v = knobs.get_str("TRINO_TPU_PROFILE").strip().lower()
    if v in ("off", "0", "none", "false"):
        return _OFF
    if v in ("full", "2"):
        return _FULL
    return _DEFAULT


_LEVEL = _level_from_env()
_CAP = knobs.get_int("TRINO_TPU_PROFILE_RING") or 4096
_MAX_RINGS = 512       # dead-thread rings retained beyond this are pruned
_MAX_PROFILES = 64     # finished-query profiles retained


def level() -> int:
    return _LEVEL


def enabled() -> bool:
    return _LEVEL > _OFF


def is_full() -> bool:
    return _LEVEL >= _FULL


def set_level(lvl: Optional[int]) -> int:
    """Override the profiling level (None re-reads the env); returns the
    previous level so tests can restore it."""
    global _LEVEL
    prev = _LEVEL
    _LEVEL = _level_from_env() if lvl is None else int(lvl)
    return prev


class _Ring:
    """One thread's event ring.  Append is an index store under the GIL —
    no lock; the registry lock is taken once, at ring creation."""

    __slots__ = ("buf", "cap", "idx", "tid", "tname", "thread_ref",
                 "qid", "task", "overwrites")

    def __init__(self, cap: int):
        t = threading.current_thread()
        self.buf: list = []
        self.cap = cap
        self.idx = 0
        self.tid = t.ident or 0
        self.tname = t.name
        self.thread_ref = weakref.ref(t)
        self.qid = ""
        self.task = ""
        self.overwrites = 0

    def push(self, ev: tuple) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(ev)
        else:
            self.buf[self.idx % self.cap] = ev
            self.overwrites += 1
        self.idx += 1


_RINGS: list[_Ring] = []
_RINGS_LOCK = threading.Lock()
_TLS = threading.local()

_PROFILES: "OrderedDict[str, dict]" = OrderedDict()
_PROFILES_LOCK = threading.Lock()

# events of finished threads, by query id: a dead thread's ring is swept
# once, into here, and dropped (under _RINGS_LOCK), so a harvest reads the
# live rings and its own query's list, whatever the process's age
_RETIRED: "OrderedDict[str, list]" = OrderedDict()
_RETIRED_OVERWRITES = 0


def _alive(r: _Ring) -> bool:
    t = r.thread_ref()
    return t is not None and t.is_alive()


def _ring() -> _Ring:
    r = getattr(_TLS, "ring", None)
    if r is None:
        r = _Ring(_CAP)
        # a context applied before the thread's first event
        r.qid, r.task = getattr(_TLS, "ctx", ("", ""))
        with _RINGS_LOCK:
            _RINGS.append(r)
            if len(_RINGS) > _MAX_RINGS:
                # prune oldest dead-thread rings; live threads always stay
                live = [x for x in _RINGS if _alive(x)]
                dead = [x for x in _RINGS if not _alive(x)]
                _RINGS[:] = dead[-(_MAX_RINGS - len(live)):] + live \
                    if len(live) < _MAX_RINGS else live
        _TLS.ring = r
    return r


def now() -> float:
    """Event timebase: epoch seconds (``time.time``) — unlike perf_counter
    it is comparable across coordinator and worker processes on one host,
    which is what lets the merged timeline stitch without offset games."""
    return time.time()


def event(kind: str, name: str, t0: float, t1: Optional[float] = None,
          **args) -> None:
    """Record one complete (begin+duration) event on this thread's ring."""
    if not _LEVEL:
        return
    r = _ring()
    if t1 is None:
        t1 = time.time()
    r.push((t0, t1 - t0, kind, name, r.qid, r.task, args or None))


def instant(kind: str, name: str, **args) -> None:
    if not _LEVEL:
        return
    r = _ring()
    r.push((time.time(), 0.0, kind, name, r.qid, r.task, args or None))


def set_context(query_id: str, task_id: str = "") -> tuple:
    """Stamp the calling thread's (query, task) identity onto subsequent
    events; returns the previous context for restore."""
    r = _ring()
    prev = (r.qid, r.task)
    r.qid, r.task = query_id or "", task_id or ""
    return prev


def capture_context() -> tuple:
    r = getattr(_TLS, "ring", None)
    return (r.qid, r.task) if r is not None else \
        getattr(_TLS, "ctx", ("", ""))


def apply_context(ctx: tuple) -> None:
    """Adopt a context captured on another thread (driver group, prefetch
    and executor threads inherit the spawning thread's identity).  A
    thread that has recorded nothing yet gets its ring, stamped with the
    context, at its first event: a thread that never records (a prefetch
    thread) costs no ring."""
    r = getattr(_TLS, "ring", None)
    if r is None:
        _TLS.ctx = tuple(ctx)
    else:
        r.qid, r.task = ctx


def sync_batch(batch) -> None:
    """``TRINO_TPU_PROFILE=full`` only: wait for the CUDA stream of the
    batch's device, so the enclosing operator event charges true device
    time instead of launch time.  One blocking sync per batch on the card,
    counted by exec/syncguard.py under ``profiler.full``; a batch on the
    CPU has nothing to wait for."""
    if _LEVEL < _FULL or batch is None or not batch.columns:
        return
    try:
        import torch

        from ..exec import syncguard as SG

        device = batch.device
        if device.type != "cuda":
            return
        SG.count_sync("profiler.full", blocking=True)
        torch.cuda.current_stream(device).synchronize()
    except Exception:  # noqa: BLE001 — profiling never fails a query
        pass


# ------------------------------------------------------------------ export


def _ev_dict(ev: tuple, pid: int, tid: int, tname: str) -> dict:
    d = {"ts": ev[0], "dur": ev[1], "kind": ev[2], "name": ev[3],
         "task": ev[5], "pid": pid, "tid": tid, "thread": tname}
    if ev[6]:
        d["args"] = ev[6]
    return d


def _retire_dead_rings(pid: int) -> None:
    """Move the events of every dead thread's ring into ``_RETIRED`` and
    drop the ring (caller holds ``_RINGS_LOCK``).  The store keeps the
    newest ``_MAX_PROFILES`` query ids."""
    global _RETIRED_OVERWRITES
    live = []
    for r in _RINGS:
        if _alive(r):
            live.append(r)
            continue
        _RETIRED_OVERWRITES += r.overwrites
        for ev in r.buf:
            if not ev[4]:
                continue
            evs = _RETIRED.get(ev[4])
            if evs is None:
                evs = _RETIRED[ev[4]] = []
                while len(_RETIRED) > _MAX_PROFILES:
                    _RETIRED.popitem(last=False)
            evs.append(_ev_dict(ev, pid, r.tid, r.tname))
    _RINGS[:] = live


def collect(query_id: str, task_id: Optional[str] = None) -> list[dict]:
    """Non-destructive sweep for one query's events: the live threads'
    rings (wrap-around is their only eviction) and what dead threads
    left (swept once, then kept by query id)."""
    pid = _PID
    with _RINGS_LOCK:
        _retire_dead_rings(pid)
        rings = list(_RINGS)
        out = [e for e in _RETIRED.get(query_id, ())
               if task_id is None or e["task"] == task_id]
    for r in rings:
        for ev in list(r.buf):
            if ev[4] == query_id and (task_id is None or ev[5] == task_id):
                out.append(_ev_dict(ev, pid, r.tid, r.tname))
    return out


def _store(query_id: str) -> dict:
    p = _PROFILES.get(query_id)
    if p is None:
        p = {"events": [], "procs": {}}
        _PROFILES[query_id] = p
        while len(_PROFILES) > _MAX_PROFILES:
            _PROFILES.popitem(last=False)
    else:
        _PROFILES.move_to_end(query_id)
    return p


def harvest(query_id: str, process_name: str = "coordinator") -> int:
    """Copy this process's ring events for ``query_id`` into the bounded
    per-query store (run at query completion, before rings wrap)."""
    if not query_id:
        return 0
    global _RETIRED_OVERWRITES
    evs = collect(query_id)
    with _RINGS_LOCK:
        # stored below: the retired copy of this query's events goes
        _RETIRED.pop(query_id, None)
        overwrites, _RETIRED_OVERWRITES = _RETIRED_OVERWRITES, 0
        for r in _RINGS:
            overwrites += r.overwrites
            r.overwrites = 0
    from . import metrics as tm

    if evs:
        tm.PROFILE_EVENTS.inc(len(evs))
    if overwrites:
        tm.PROFILE_DROPPED.inc(overwrites)
    with _PROFILES_LOCK:
        p = _store(query_id)
        p["events"].extend(evs)
        p["procs"][str(_PID)] = process_name
    return len(evs)


def add_remote_events(query_id: str, events: list[dict],
                      process_name: str = "worker") -> None:
    """Fold a worker ring (shipped back in task status JSON) into the
    query's profile; events already carry the worker's pid/tid."""
    if not query_id or not events:
        return
    with _PROFILES_LOCK:
        p = _store(query_id)
        p["events"].extend(events)
        for ev in events:
            pid = str(ev.get("pid", ""))
            if pid and pid not in p["procs"]:
                p["procs"][pid] = process_name


def take_task_events(query_id: str, task_id: str,
                     limit: int = 2000) -> list[dict]:
    """A worker task's events, bounded for the status-JSON wire (newest
    kept — the tail of a truncated timeline is where failures live)."""
    evs = collect(query_id, task_id)
    evs.sort(key=lambda e: e["ts"])
    return evs[-limit:]


def events_for(query_id: str) -> list[dict]:
    with _PROFILES_LOCK:
        p = _PROFILES.get(query_id)
        stored = list(p["events"]) if p is not None else []
        procs = dict(p["procs"]) if p is not None else {}
    if not stored:
        # live query: render straight from the rings
        stored = collect(query_id)
        if stored:
            procs[str(_PID)] = "coordinator"
    return stored


def chrome_trace(query_id: str) -> Optional[dict]:
    """The merged timeline as Chrome ``trace_event`` JSON ("X" complete
    events, microsecond timestamps normalized to the query's first event),
    or None for an unknown/unprofiled query."""
    with _PROFILES_LOCK:
        p = _PROFILES.get(query_id)
        events = list(p["events"]) if p is not None else []
        procs = dict(p["procs"]) if p is not None else {}
    if not events:
        events = collect(query_id)
        if events:
            procs[str(_PID)] = "coordinator"
    if not events:
        return None
    t0 = min(e["ts"] for e in events)
    trace: list[dict] = []
    seen_procs: dict = {}
    seen_threads: set = set()
    for e in sorted(events, key=lambda e: e["ts"]):
        pid = int(e.get("pid", 0))
        tid = int(e.get("tid", 0))
        if pid not in seen_procs:
            name = procs.get(str(pid), "process")
            seen_procs[pid] = name
            trace.append({"ph": "M", "name": "process_name", "pid": pid,
                          "tid": 0, "args": {"name": name}})
        if (pid, tid) not in seen_threads:
            seen_threads.add((pid, tid))
            trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                          "tid": tid,
                          "args": {"name": e.get("thread", str(tid))}})
        out = {"name": e["name"], "cat": e["kind"], "ph": "X",
               "ts": (e["ts"] - t0) * 1e6, "dur": max(e["dur"], 0.0) * 1e6,
               "pid": pid, "tid": tid}
        args = dict(e.get("args") or {})
        if e.get("task"):
            args["task"] = e["task"]
        if args:
            out["args"] = args
        trace.append(out)
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"query_id": query_id,
                          "processes": {str(k): v
                                        for k, v in seen_procs.items()}}}


def reset_for_test() -> None:
    """Drop all rings, contexts and stored profiles (test isolation)."""
    global _RINGS, _RETIRED_OVERWRITES
    with _RINGS_LOCK:
        _RINGS = []
        _RETIRED.clear()
        _RETIRED_OVERWRITES = 0
    with _PROFILES_LOCK:
        _PROFILES.clear()
    _TLS.__dict__.clear()
