"""Engine-level failure injection (the port of the reference
``execution/failure_injector.py``; Trino: execution/FailureInjector.java:35).

Rules target (fragment_id, task_index, attempt) at named injection points
and fire a bounded number of times.  Kinds mirror the reference's enum
(FailureInjector.java:51):

- ``TASK_FAILURE``               raise inside the task body
- ``GET_RESULTS_FAILURE``        raise while reading an upstream spool/page
- ``PROCESS_EXIT``               hard-kill the hosting process (worker mode
                                 only — the real "node died" case)

Rules travel inside task descriptors to worker processes (the wire form,
:meth:`FailureInjector.consume_for` / :func:`match_wire_rule`); a worker
that matches ``PROCESS_EXIT`` calls ``os._exit(17)`` before the task runs
(execution/worker.py).  The in-process runner's tasks never reach that
point, as in the reference.  An injected failure never changes the device
or the kernels a retried task runs on.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["FailureInjector", "InjectedFailure",
           "TASK_FAILURE", "GET_RESULTS_FAILURE", "PROCESS_EXIT",
           "TASK_STALL", "TASK_OOM", "SPOOL_CORRUPTION",
           "match_wire_rule", "check_wire_rules", "sleep_with_cancel"]

TASK_FAILURE = "TASK_FAILURE"
GET_RESULTS_FAILURE = "GET_RESULTS_FAILURE"
PROCESS_EXIT = "PROCESS_EXIT"
# r5 additions for FTE tier 2 (reference: TaskExecutionClass.java:19
# speculation is exercised with stalled tasks; memory-aware retry with
# injected OOM — ExponentialGrowthPartitionMemoryEstimator.java:55):
TASK_STALL = "TASK_STALL"  # sleep stall_s inside the task body
TASK_OOM = "TASK_OOM"  # raise ExceededMemoryLimitError inside the task body
# r15: flip a byte inside a committed spool part file right before a
# consumer reads it — the on-disk bit-rot / torn-sector case the CRC frame
# checksums exist to catch (the read then raises SpoolCorruptionError and
# the FTE loop re-executes the corrupted producer attempt)
SPOOL_CORRUPTION = "SPOOL_CORRUPTION"


class InjectedFailure(RuntimeError):
    pass


@dataclass
class _Rule:
    kind: str
    fragment_id: Optional[int] = None  # None = any
    task_index: Optional[int] = None
    attempt: Optional[int] = None
    times: int = 1
    fired: int = 0
    stall_s: float = 0.0  # TASK_STALL only

    def matches(self, kind: str, fragment_id: int, task_index: int,
                attempt: int) -> bool:
        return (self.fired < self.times and self.kind == kind
                and (self.fragment_id is None
                     or self.fragment_id == fragment_id)
                and (self.task_index is None
                     or self.task_index == task_index)
                and (self.attempt is None or self.attempt == attempt))


@dataclass
class FailureInjector:
    rules: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inject(self, kind: str, fragment_id: Optional[int] = None,
               task_index: Optional[int] = None,
               attempt: Optional[int] = None, times: int = 1,
               stall_s: float = 0.0) -> None:
        self.rules.append(_Rule(kind, fragment_id, task_index, attempt,
                                times, stall_s=stall_s))

    def consume_for(self, fragment_id: int, task_index: int,
                    attempt: int, unreachable: frozenset = frozenset()
                    ) -> list[dict]:
        """Wire form for ONE task-attempt descriptor.  A rule whose scope
        matches this attempt is counted as fired at export time (the worker
        cannot report back — it may be dead), so ``times`` bounds hold
        identically in-process and across processes.  ``unreachable`` names
        injection points this attempt can never reach (e.g. a leaf task
        never reads upstream results); those rules are NOT consumed, so
        they stay armed for an attempt that can hit them (advisor r4: an
        exported-but-unreachable rule silently burned its ``times``
        budget).  Unlisted/new kinds export by default."""
        out = []
        with self._lock:
            for r in self.rules:
                if r.fired >= r.times:
                    continue
                if r.kind in unreachable:
                    continue
                if ((r.fragment_id is None or r.fragment_id == fragment_id)
                        and (r.task_index is None
                             or r.task_index == task_index)
                        and (r.attempt is None or r.attempt == attempt)):
                    r.fired += 1
                    out.append({"kind": r.kind, "fragment_id": fragment_id,
                                "task_index": task_index,
                                "attempt": attempt,
                                "stall_s": r.stall_s})
        return out

    def maybe_fail(self, kind: str, fragment_id: int, task_index: int,
                   attempt: int = 0) -> None:
        # TASK_OOM fires at the task-body injection point (same site as
        # TASK_FAILURE, different exception class)
        kinds = (kind, TASK_OOM) if kind == TASK_FAILURE else (kind,)
        with self._lock:
            for r in self.rules:
                if any(r.matches(k, fragment_id, task_index, attempt)
                       for k in kinds):
                    r.fired += 1
                    if r.kind == TASK_OOM:
                        from ..spi.memory import ExceededMemoryLimitError

                        raise ExceededMemoryLimitError(
                            f"injected-oom f{fragment_id}.t{task_index}",
                            1 << 40, 0)
                    raise InjectedFailure(
                        f"injected {kind} at f{fragment_id}.t{task_index} "
                        f"attempt {attempt}")

    def maybe_corrupt_spool(self, attempt_dir: str, fragment_id: int,
                            task_index: int, attempt: int = 0) -> None:
        """When a SPOOL_CORRUPTION rule matches the READING task's
        coordinates, flip one payload byte of the part file that task is
        about to consume from ``attempt_dir`` (deterministic offset: the
        first byte after the stream header + frame header).  The torn/
        flipped frame then fails its CRC at read time."""
        matched = False
        with self._lock:
            for r in self.rules:
                if r.matches(SPOOL_CORRUPTION, fragment_id, task_index,
                             attempt):
                    r.fired += 1
                    matched = True
                    break
        if not matched:
            return
        corrupt_spool_file(attempt_dir, task_index)

    def maybe_stall(self, fragment_id: int, task_index: int,
                    attempt: int = 0, should_cancel=None) -> None:
        """Sleep (outside the lock) when a TASK_STALL rule matches — the
        deterministic straggler for speculative-execution tests.  The sleep
        polls ``should_cancel`` every 50ms so a stall cannot outlive its
        query: a cancelled/aborted/speculatively-lost task exits the stall
        immediately instead of wedging a drain or OOM-kill."""
        delay = 0.0
        with self._lock:
            for r in self.rules:
                if r.kind == TASK_STALL and r.matches(
                        TASK_STALL, fragment_id, task_index, attempt):
                    r.fired += 1
                    delay = max(delay, r.stall_s)
        if delay:
            sleep_with_cancel(delay, should_cancel)


def corrupt_spool_file(attempt_dir: str, partition: int) -> bool:
    """XOR one payload byte of ``part-<partition>.bin`` under
    ``attempt_dir`` (falling back to any part file large enough).  Returns
    True if a byte was flipped.  Shared by the injector and the chaos
    harness's standalone torn-write drills."""
    candidates = [os.path.join(attempt_dir, f"part-{partition}.bin")]
    try:
        candidates += sorted(
            os.path.join(attempt_dir, n) for n in os.listdir(attempt_dir)
            if n.startswith("part-") and n.endswith(".bin"))
    except OSError:
        return False
    # byte 12 = stream magic (4) + frame length (4) + frame crc (4): the
    # first payload byte, so the flip damages data, not framing
    offset = 12
    for path in candidates:
        try:
            if os.path.getsize(path) <= offset:
                continue
            with open(path, "r+b") as f:
                f.seek(offset)
                b = f.read(1)
                f.seek(offset)
                f.write(bytes([b[0] ^ 0xFF]))
            return True
        except OSError:
            continue
    return False


def sleep_with_cancel(delay: float, should_cancel=None,
                      slice_s: float = 0.05) -> bool:
    """Sleep up to ``delay`` seconds in small slices, bailing out as soon
    as ``should_cancel()`` turns true.  Returns True if cancelled early."""
    import time

    if should_cancel is None:
        time.sleep(delay)
        return False
    deadline = time.monotonic() + delay
    while time.monotonic() < deadline:
        if should_cancel():
            return True
        time.sleep(min(slice_s, max(0.0, deadline - time.monotonic())))
    return bool(should_cancel())


def match_wire_rule(rules: list[dict], kind: str, fragment_id: int,
                    task_index: int, attempt: int) -> Optional[dict]:
    """Worker-side rule match over descriptor-carried rules.  Returns the
    full matched rule dict (so callers can read ``stall_s`` etc.) or None.
    Attempt-scoped rules make one-shot semantics deterministic without
    shared state: the retry carries attempt+1 which no longer matches."""
    for r in rules:
        if (r["kind"] == kind
                and (r["fragment_id"] is None
                     or r["fragment_id"] == fragment_id)
                and (r["task_index"] is None
                     or r["task_index"] == task_index)
                and (r["attempt"] is None or r["attempt"] == attempt)):
            return r
    return None


def check_wire_rules(rules: list[dict], kind: str, fragment_id: int,
                     task_index: int, attempt: int) -> Optional[str]:
    r = match_wire_rule(rules, kind, fragment_id, task_index, attempt)
    return r["kind"] if r is not None else None
