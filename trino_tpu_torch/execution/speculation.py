"""Streaming-path straggler speculation + the cross-query cluster blacklist.

The port of the reference ``execution/speculation.py``.  It extends the FTE
speculative-twin machinery (execution/fte.py run_stage —
reference: TaskExecutionClass.java:19 STANDARD/SPECULATIVE) to the streaming
pipelined scheduler: once half of a stage's tasks have committed, a task
whose wall time exceeds ``max(lag_multiplier x stage median, min_delay)``
without producing a single page gets a SPECULATIVE twin.  The twin races the
primary under first-commit-wins: both attempts write through a
:class:`TaskGate` guarding the task's shared OutputBuffer — the first
attempt to enqueue a page (or finish empty) owns the stream, the loser's
first write raises :class:`SpeculationLost` and its attempt unwinds quietly
(no query error, no double-commit: every page of exactly one attempt flows
downstream).

Scope: tasks whose fragment has no remote sources (leaf stages) and whose
sink is a plain OutputBuffer re-execute for free — a leaf twin re-reads its
splits from the connector.  A non-leaf streaming twin has to re-read its
producers' page streams, but the streaming exchange frees pages on ack
(execution/exchange.py) — there is nothing durable to re-read.  That
retention is exactly what FTE's spool buys, and since r15 the streaming
path can buy it too: with ``TRINO_TPU_SPECULATION_NONLEAF`` on, producers
feeding an eligible non-leaf stage tee their (winner-only) pages through
:class:`SpoolTeeBuffer` into a :class:`StreamingSpoolTee` — per-task
durable spool dirs committed by atomic rename, exactly the FTE sink
contract.  Once EVERY source task of a non-leaf stage has committed its
tee, the stage becomes twin-eligible; a straggler's SPECULATIVE attempt
re-reads the committed tee dirs through DurableSpoolClient instead of the
(already-drained) streaming exchange.  MapReduce draws the same line (maps
re-execute from durable input; reducers re-read retained map output —
Dean & Ghemawat, OSDI'04).

:class:`ClusterBlacklist` is the coordinator-held, cross-query companion:
the per-query retry blacklist (distributed_runner._run_query_retry) dies
with the query, so a flaky worker gets one task from EVERY new query.  Here
each recorded failure scores against the worker with a TTL; once the decayed
score crosses the threshold the worker stops receiving tasks across queries
(the process runner's task placement, execution/remote.py) until its
entries expire.  A twin runs on the runner's device with the same kernels
as its primary.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..spi import knobs
from ..telemetry import journal as tj
from ..telemetry import metrics as tm
from ..telemetry import profiler

__all__ = ["ClusterBlacklist", "SpeculationLost", "TaskGate", "GatedBuffer",
           "StreamingSpeculation", "StreamingSpoolTee", "SpoolTeeBuffer",
           "speculation_enabled", "nonleaf_speculation_enabled",
           "STANDARD", "SPECULATIVE"]

STANDARD = "STANDARD"
SPECULATIVE = "SPECULATIVE"


def speculation_enabled(session) -> bool:
    """Session tri-state first (SET SESSION speculation = true), then the
    TRINO_TPU_SPECULATION env knob; off by default."""
    v = getattr(session, "speculation", None)
    if v is None:
        return knobs.get_str("TRINO_TPU_SPECULATION").strip().lower() \
            in ("1", "true", "on")
    return bool(v)


def nonleaf_speculation_enabled(session) -> bool:
    """Non-leaf twin eligibility (requires the spool tee): session
    tri-state, then the TRINO_TPU_SPECULATION_NONLEAF knob; off by
    default.  Only meaningful when :func:`speculation_enabled` is on."""
    v = getattr(session, "speculation_nonleaf", None)
    if v is None:
        return knobs.get_bool("TRINO_TPU_SPECULATION_NONLEAF")
    return bool(v)


class SpeculationLost(Exception):
    """Raised inside a racing attempt whose twin already claimed the task's
    output gate; the attempt unwinds without reporting a query error."""


class TaskGate:
    """First-commit-wins ownership of one task's output stream.  ``claim``
    is called on every write: the first caller becomes the owner, later
    callers of the other kind are losers.  ``finish`` marks the owning
    attempt complete (feeds the stage-median straggler cutoff)."""

    def __init__(self, on_claim: Optional[Callable[[str], None]] = None,
                 on_finish: Optional[Callable[[str], None]] = None):
        self._lock = threading.Lock()
        self.owner: Optional[str] = None
        self.finished = False
        self._on_claim = on_claim
        self._on_finish = on_finish

    def claim(self, kind: str) -> bool:
        first = False
        with self._lock:
            if self.owner is None:
                self.owner = kind
                first = True
            ok = self.owner == kind
        if first and self._on_claim is not None:
            self._on_claim(kind)
        return ok

    def finish(self, kind: str) -> None:
        with self._lock:
            if self.owner != kind or self.finished:
                return
            self.finished = True
        if self._on_finish is not None:
            self._on_finish(kind)


class GatedBuffer:
    """OutputBuffer facade for one racing attempt: every write must hold the
    gate.  The loser's first write raises :class:`SpeculationLost`, so all
    pages downstream consumers ever see come from exactly one attempt (the
    sink-buffer byte accounting never sees the loser either)."""

    def __init__(self, inner, gate: TaskGate, kind: str):
        self._inner = inner
        self._gate = gate
        self.kind = kind

    @property
    def num_partitions(self) -> int:
        return self._inner.num_partitions

    @property
    def aborted(self) -> bool:
        return self._inner.aborted

    def enqueue(self, partition: int, batch, **kw) -> None:
        if not self._gate.claim(self.kind):
            raise SpeculationLost(self.kind)
        self._inner.enqueue(partition, batch, **kw)

    def has_capacity(self) -> bool:
        return self._inner.has_capacity()

    def set_finished(self) -> None:
        # an empty output commits here: first to FINISH an empty stream wins
        if not self._gate.claim(self.kind):
            raise SpeculationLost(self.kind)
        self._inner.set_finished()
        self._gate.finish(self.kind)

    def abort(self) -> None:
        self._inner.abort()


class StreamingSpoolTee:
    """Per-query durable tee of streaming producer outputs (the retention
    layer non-leaf speculation needs).  ``want()`` marks a producer
    fragment as teed; its tasks' sinks wrap in :class:`SpoolTeeBuffer`,
    which lands every winner page under
    ``<root>/f<fid>_t<t>/attempt-<n>`` via DurableSpoolWriter (atomic
    rename on commit — identical on-disk layout to the FTE spool, so
    DurableSpoolClient reads it unchanged).  ``ready(srcs)`` answers the
    twin-eligibility question: has every task of every source fragment
    committed its tee?  Callers lease ``root`` through
    :mod:`.spool_gc` (release at query end; boot sweep catches leaks)."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._want: dict[int, int] = {}            # fid -> task count
        self._committed: dict[int, dict[int, str]] = {}  # fid -> {t: dir}

    def want(self, fid: int, task_count: int) -> None:
        with self._lock:
            self._want[fid] = task_count
            self._committed.setdefault(fid, {})

    def wants(self, fid: int) -> bool:
        with self._lock:
            return fid in self._want

    def writer(self, fid: int, t: int, num_partitions: int,
               attempt: int = 0):
        from .durable_spool import DurableSpoolWriter
        from .fte import fte_task_dir

        task_dir = fte_task_dir(self.root, fid, t)
        os.makedirs(task_dir, exist_ok=True)
        return DurableSpoolWriter(task_dir, attempt, num_partitions)

    def mark_committed(self, fid: int, t: int, attempt_dir: str) -> None:
        with self._lock:
            self._committed.setdefault(fid, {})[t] = attempt_dir

    def ready(self, fids) -> bool:
        with self._lock:
            return all(
                len(self._committed.get(f, ())) >= self._want.get(f, 1 << 30)
                for f in fids)

    def committed_dirs(self, fid: int) -> Optional[list]:
        """Task-ordered committed attempt dirs, or None while incomplete."""
        with self._lock:
            got = self._committed.get(fid, {})
            if len(got) < self._want.get(fid, 1 << 30):
                return None
            return [got[t] for t in sorted(got)]


class SpoolTeeBuffer:
    """Sink facade teeing every page that clears ``inner`` (the gated or
    plain OutputBuffer) into a durable spool writer.  The tee sits OUTSIDE
    the gate: a losing attempt's enqueue raises SpeculationLost before the
    tee sees the page, so the committed tee holds exactly the winner's
    stream."""

    def __init__(self, inner, writer, on_commit: Callable[[str], None]):
        self._inner = inner
        self._writer = writer
        self._on_commit = on_commit

    @property
    def num_partitions(self) -> int:
        return self._inner.num_partitions

    @property
    def aborted(self) -> bool:
        return self._inner.aborted

    def enqueue(self, partition: int, batch, **kw) -> None:
        self._inner.enqueue(partition, batch, **kw)
        self._writer.enqueue(partition, batch)

    def has_capacity(self) -> bool:
        return self._inner.has_capacity()

    def set_finished(self) -> None:
        self._inner.set_finished()  # loser raises here; tee stays .tmp
        self._writer.set_finished()
        self._on_commit(self._writer.committed)

    def abort(self) -> None:
        try:
            self._inner.abort()
        finally:
            self._writer.abort()


class _TaskTrack:
    __slots__ = ("gate", "twin_started", "cancel", )

    def __init__(self):
        # cancel[kind] is set when the OTHER kind wins; racing attempts poll
        # it from injected stalls (failure_injector.maybe_stall) and before
        # planning, so a losing straggler exits early instead of sleeping
        # out its injected stall
        self.gate: Optional[TaskGate] = None
        self.twin_started = False
        self.cancel = {STANDARD: threading.Event(),
                       SPECULATIVE: threading.Event()}


class _StageTrack:
    __slots__ = ("fid", "tc", "t0", "tasks", "durations", "eligible")

    def __init__(self, fid: int, tc: int, t0: float, eligible=None):
        self.fid = fid
        self.tc = tc
        self.t0 = t0
        self.tasks: dict[int, _TaskTrack] = {}
        self.durations: list[float] = []
        # optional gate on twin launches: non-leaf stages pass a predicate
        # ("are all my sources' tee spools committed?") that must hold
        # before any twin spawns — a twin with an incomplete upstream tee
        # would re-read a truncated stream
        self.eligible = eligible


class StreamingSpeculation:
    """Per-query controller: tracks eligible stages, detects stragglers on
    the coordinator's join-poll cadence, and launches twins.  All bookkeeping
    is query-local; cumulative counters land in telemetry + the runner's
    resilience event log."""

    def __init__(self, lag_multiplier: float = 2.0,
                 min_delay_s: float = 0.25,
                 events: Optional[list] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.lag_multiplier = max(1.0, float(lag_multiplier))
        self.min_delay_s = float(min_delay_s)
        self.events = events if events is not None else []
        self._clock = clock
        self._lock = threading.Lock()
        self._stages: dict[int, _StageTrack] = {}
        self.starts = 0
        self.wins = 0

    # --------------------------------------------------------- registration
    def register_stage(self, fid: int, tc: int, eligible=None) -> None:
        with self._lock:
            self._stages[fid] = _StageTrack(fid, tc, self._clock(),
                                            eligible=eligible)

    def register_task(self, fid: int, t: int) -> TaskGate:
        """Create the task's gate; returns it for sink wrapping."""
        with self._lock:
            st = self._stages[fid]
            tr = _TaskTrack()
            st.tasks[t] = tr
        tr.gate = TaskGate(
            on_claim=lambda kind, _f=fid, _t=t: self._claimed(_f, _t, kind),
            on_finish=lambda kind, _f=fid, _t=t: self._finished(_f, _t))
        return tr.gate

    def cancel_event(self, fid: int, t: int, kind: str) -> threading.Event:
        with self._lock:
            return self._stages[fid].tasks[t].cancel[kind]

    # ------------------------------------------------------------ callbacks
    def _claimed(self, fid: int, t: int, kind: str) -> None:
        with self._lock:
            tr = self._stages[fid].tasks[t]
            had_twin = tr.twin_started
        loser = STANDARD if kind == SPECULATIVE else SPECULATIVE
        tr.cancel[loser].set()
        if kind == SPECULATIVE:
            with self._lock:
                self.wins += 1
            tm.SPECULATIVE_WINS.inc()
            self.events.append(("speculative_win", fid, t))
            profiler.instant(profiler.SPECULATION,
                             f"speculative-win[f{fid}.t{t}]")
        if had_twin:
            self.events.append(("speculative_cancelled", fid, t, loser))

    def _finished(self, fid: int, t: int) -> None:
        now = self._clock()
        with self._lock:
            st = self._stages[fid]
            st.durations.append(now - st.t0)

    # ------------------------------------------------------------ detection
    def tick(self, spawn: Callable[[int, int], object]) -> list:
        """One straggler sweep: for every stage with >= half its tasks
        committed, twin each unclaimed task past the lag cutoff.  ``spawn``
        launches the SPECULATIVE attempt and returns its thread; the list of
        new threads is handed back so the join loop tracks them."""
        now = self._clock()
        out = []
        with self._lock:
            stages = list(self._stages.values())
        for st in stages:
            if st.eligible is not None and not st.eligible():
                continue
            with self._lock:
                committed = len(st.durations)
                if st.tc < 2 or committed * 2 < st.tc:
                    continue
                med = sorted(st.durations)[committed // 2]
                cutoff = max(self.lag_multiplier * med, self.min_delay_s)
                lagging = [
                    (t, tr) for t, tr in st.tasks.items()
                    if tr.gate is not None and tr.gate.owner is None
                    and not tr.twin_started and now - st.t0 > cutoff
                ]
                for _t, tr in lagging:
                    tr.twin_started = True
                    self.starts += 1
            for t, _tr in lagging:
                tm.SPECULATIVE_STARTS.inc()
                self.events.append(("speculative_start", st.fid, t))
                profiler.instant(profiler.SPECULATION,
                                 f"speculative-start[f{st.fid}.t{t}]")
                th = spawn(st.fid, t)
                if th is not None:
                    out.append(th)
        return out


class ClusterBlacklist:
    """Coordinator-held cross-query worker blacklist with TTL decay.

    Each failure records ``(timestamp, weight)`` against the worker; the
    score is the weight sum of unexpired entries, and a worker is
    blacklisted while ``score >= threshold``.  Entries expire after
    ``ttl_s`` — a worker that stops failing regains placement without any
    operator action.  Thread-safe; the ``trino_blacklisted_workers`` gauge
    tracks the current blacklisted set size."""

    def __init__(self, ttl_s: Optional[float] = None,
                 threshold: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 persist: bool = False,
                 path: Optional[str] = None):
        if ttl_s is None:
            ttl_s = knobs.get_float("TRINO_TPU_BLACKLIST_TTL_S")
        if threshold is None:
            threshold = knobs.get_float("TRINO_TPU_BLACKLIST_THRESHOLD")
        self.ttl_s = float(ttl_s)
        self.threshold = max(1.0, float(threshold))
        self._clock = clock
        # persist=False keeps unit tests with fake clocks from polluting
        # (or being polluted by) the process journal
        self._persist = persist
        self._lock = threading.Lock()
        # worker -> list of (monotonic ts, weight, reason)
        self._entries: dict[str, list[tuple[float, float, str]]] = {}
        # fleet-shared durable store (execution/resilience.py): when the
        # whole coordinator fleet points TRINO_TPU_BLACKLIST_PATH at one
        # file, strikes are appended there and merged on every read — a
        # worker that fails under coordinator A is blacklisted under B too,
        # and concurrent writers interleave instead of clobbering
        self._store = None
        if persist:
            from .resilience import SharedBlacklistStore, blacklist_path

            shared = path if path is not None else blacklist_path()
            if shared:
                self._store = SharedBlacklistStore(shared)
                self._merge_store()
            else:
                self.seed_from_journal()

    def _merge_store(self) -> None:
        """Fold every strike appended to the shared store since the last
        merge (ours and our peers') into the in-memory table, back-dated on
        this process's monotonic clock so TTL decay expires each entry at
        the same wall moment fleet-wide."""
        if self._store is None:
            return
        recs = self._store.poll()
        if not recs:
            return
        now_wall = time.time()
        now = self._clock()
        with self._lock:
            for rec in recs:
                try:
                    age = now_wall - float(rec["ts"])
                    worker = rec["worker"]
                    weight = float(rec.get("weight", 1.0))
                except (KeyError, TypeError, ValueError):
                    continue
                if not 0 <= age < self.ttl_s:
                    continue
                self._entries.setdefault(worker, []).append(
                    (now - age, weight, str(rec.get("reason", ""))))
            self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.ttl_s
        for w in list(self._entries):
            kept = [e for e in self._entries[w] if e[0] > horizon]
            if kept:
                self._entries[w] = kept
            else:
                del self._entries[w]

    def record_failure(self, worker: str, reason: str = "",
                       weight: float = 1.0, query_id: str = "") -> float:
        if self._store is not None:
            # the shared file is the single source of truth: append the
            # strike there and read it back through the ordinary merge (no
            # separate local insert — that would double-count our own rows)
            self._store.append(worker, weight, reason, query_id)
            self._merge_store()
            with self._lock:
                score = sum(e[1] for e in self._entries.get(worker, ()))
            self._refresh_gauge()
            return score
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            self._entries.setdefault(worker, []).append(
                (now, float(weight), reason))
            score = sum(e[1] for e in self._entries[worker])
        self._refresh_gauge()
        if self._persist:
            self._journal_entry(worker, weight, reason, query_id)
        return score

    # ----------------------------------------------------------- durability
    def _journal_entry(self, worker: str, weight: float, reason: str,
                       query_id: str) -> None:
        """Append the failure to the durable query journal so a restarted
        coordinator re-seeds the blacklist instead of handing the flaky
        worker one task from every post-restart query."""
        j = tj.get_journal()
        if j is None:
            return
        j._write({
            "schema": tj.SCHEMA_VERSION,
            "event": "blacklist_entry",
            "ts": time.time(),  # wall clock: must survive process restarts
            "query_id": query_id,
            "worker": worker,
            "weight": float(weight),
            "reason": reason,
        })

    def seed_from_journal(self) -> int:
        """Boot-time re-seed with TTL decay: journal entries younger than
        ``ttl_s`` (by wall clock) re-enter the in-memory table back-dated on
        this blacklist's monotonic clock, so they expire at the same wall
        moment they would have without the restart.  Returns entries kept."""
        j = tj.get_journal()
        if j is None:
            return 0
        now_wall = time.time()
        now = self._clock()
        kept = 0
        with self._lock:
            for rec in j.read(events=("blacklist_entry",)):
                try:
                    age = now_wall - float(rec["ts"])
                    worker = rec["worker"]
                    weight = float(rec.get("weight", 1.0))
                except (KeyError, TypeError, ValueError):
                    continue
                if not 0 <= age < self.ttl_s:
                    continue
                self._entries.setdefault(worker, []).append(
                    (now - age, weight, str(rec.get("reason", ""))))
                kept += 1
            self._prune_locked(now)
        if kept:
            self._refresh_gauge()
        return kept

    def score(self, worker: str) -> float:
        self._merge_store()
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            return sum(e[1] for e in self._entries.get(worker, ()))

    def is_blacklisted(self, worker: str) -> bool:
        return self.score(worker) >= self.threshold

    def blacklisted(self) -> frozenset:
        self._merge_store()
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            out = frozenset(
                w for w, es in self._entries.items()
                if sum(e[1] for e in es) >= self.threshold)
        self._refresh_gauge()
        return out

    def snapshot(self) -> dict[str, float]:
        """worker -> current score (system.runtime.workers feed)."""
        self._merge_store()
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            return {w: sum(e[1] for e in es)
                    for w, es in self._entries.items()}

    def _refresh_gauge(self) -> None:
        with self._lock:
            n = sum(1 for es in self._entries.values()
                    if sum(e[1] for e in es) >= self.threshold)
        tm.BLACKLISTED_WORKERS.set(n)
