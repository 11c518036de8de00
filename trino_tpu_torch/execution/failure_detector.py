"""Coordinator heartbeat sweep over worker /v1/status with a node state
machine: the port of the reference ``execution/failure_detector.py``
(Trino: failuredetector/HeartbeatFailureDetector.java:76 — the
coordinator probes every node on an interval and gates placement on the
result; server/GracefulShutdownHandler.java:42 for the drain state).

Node states:

- ``ACTIVE``         responding; eligible for new task placement
- ``SHUTTING_DOWN``  responding but draining; keeps running tasks, gets none
- ``UNRESPONSIVE``   probes failing, below the failure threshold; placement
                     skips it, but its tasks are not yet declared lost
- ``GONE``           threshold consecutive probe failures, or authoritative
                     process death (:class:`NodeGoneError`); terminal for
                     this worker incarnation — the runner replaces it

Unlike the in-process pinger in execution/control.py (boolean callbacks over
announced names), this detector drives real HTTP ``/v1/status`` probes,
caches each worker's full status payload (node state + per-task states), and
exposes it so the coordinator's query sweep costs ONE poll per worker instead
of one per task.  Probes are injectable callables so every transition is
deterministically testable without sockets.  The port's runner has no
worker processes yet (ROADMAP queue 1 item 5), so nothing in-process
probes through it; its state machine is the reference's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["ACTIVE", "SHUTTING_DOWN", "UNRESPONSIVE", "GONE",
           "NodeGoneError", "WorkerFailureDetector"]

ACTIVE = "ACTIVE"
SHUTTING_DOWN = "SHUTTING_DOWN"
UNRESPONSIVE = "UNRESPONSIVE"
GONE = "GONE"


class NodeGoneError(RuntimeError):
    """Raised by a probe that KNOWS the node is dead (e.g. the worker
    process handle reports an exit code) — skips the miss-counting path and
    transitions the node straight to GONE."""


@dataclass
class _Node:
    node_id: str
    probe: Callable[[], dict]
    state: str = ACTIVE
    consecutive_failures: int = 0
    last_status: Optional[dict] = None
    last_error: Optional[str] = None
    last_seen: float = field(default_factory=time.monotonic)


class WorkerFailureDetector:
    """Heartbeat sweep + state machine over monitored workers.

    ``sweep_once()`` probes every node (deterministic, used by tests and by
    the coordinator's status loop); ``maybe_sweep()`` rate-limits to the
    heartbeat interval; ``start()``/``stop()`` run the sweep on a background
    thread for long-lived deployments.  State transitions append
    ``("heartbeat", node_id, old, new)`` to ``events``."""

    def __init__(self, heartbeat_interval_s: float = 0.5,
                 failure_threshold: int = 3,
                 events: Optional[list] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.failure_threshold = max(1, int(failure_threshold))
        self.events = events if events is not None else []
        self.transitions = 0
        self._clock = clock
        self._nodes: dict[str, _Node] = {}
        self._lock = threading.Lock()
        self._last_sweep = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ membership
    def monitor(self, node_id: str, probe: Callable[[], dict]) -> None:
        with self._lock:
            self._nodes[node_id] = _Node(node_id, probe)

    def unmonitor(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    # --------------------------------------------------------------- probing
    def sweep_once(self) -> None:
        """One heartbeat round: probe every monitored node and apply the
        state machine.  Probes run outside the lock (they do network I/O)."""
        with self._lock:
            self._last_sweep = self._clock()
            nodes = list(self._nodes.values())
        for node in nodes:
            if node.state == GONE:
                continue  # terminal for this incarnation
            try:
                status = node.probe()
                self._observe(node, ok=True, status=status)
            except NodeGoneError as e:
                self._observe(node, ok=False, error=str(e), authoritative=True)
            except BaseException as e:  # noqa: BLE001 — any probe trouble
                self._observe(node, ok=False, error=f"{type(e).__name__}: {e}")

    def maybe_sweep(self) -> None:
        """sweep_once, rate-limited to the heartbeat interval (callers can
        invoke it opportunistically from hot loops)."""
        if self._clock() - self._last_sweep >= self.heartbeat_interval_s:
            self.sweep_once()

    def _observe(self, node: _Node, ok: bool, status: Optional[dict] = None,
                 error: Optional[str] = None,
                 authoritative: bool = False) -> None:
        with self._lock:
            old = node.state
            if old == GONE:
                return
            if ok:
                node.consecutive_failures = 0
                node.last_status = status
                node.last_error = None
                node.last_seen = self._clock()
                new = (SHUTTING_DOWN
                       if (status or {}).get("state") == "SHUTTING_DOWN"
                       else ACTIVE)
            else:
                node.consecutive_failures += 1
                node.last_error = error
                new = (GONE if authoritative
                       or node.consecutive_failures >= self.failure_threshold
                       else UNRESPONSIVE)
            node.state = new
            if new == old:
                return
            self.transitions += 1
            self.events.append(("heartbeat", node.node_id, old, new))

    # ------------------------------------------------------------- accessors
    def state_of(self, node_id: str) -> Optional[str]:
        with self._lock:
            node = self._nodes.get(node_id)
            return node.state if node is not None else None

    def last_status(self, node_id: str) -> Optional[dict]:
        """The most recent successful /v1/status payload (node state plus
        per-task states) — the coordinator's task sweep reads THIS instead
        of re-polling each task."""
        with self._lock:
            node = self._nodes.get(node_id)
            return node.last_status if node is not None else None

    def last_error(self, node_id: str) -> Optional[str]:
        with self._lock:
            node = self._nodes.get(node_id)
            return node.last_error if node is not None else None

    def active(self) -> list[str]:
        with self._lock:
            return sorted(n.node_id for n in self._nodes.values()
                          if n.state == ACTIVE)

    def gone(self) -> list[str]:
        with self._lock:
            return sorted(n.node_id for n in self._nodes.values()
                          if n.state == GONE)

    def states(self) -> dict[str, str]:
        with self._lock:
            return {n.node_id: n.state for n in self._nodes.values()}

    def worker_rows(self) -> list[dict]:
        """Per-worker operational snapshot for ``system.runtime.workers``:
        detector state, task counts from the cached /v1/status payload, and
        heartbeat age.  Blacklist scores are joined in by the caller (they
        live on the coordinator's ClusterBlacklist, not here)."""
        now = self._clock()
        with self._lock:
            out = []
            for n in self._nodes.values():
                tasks = ((n.last_status or {}).get("tasks") or {})
                running = sum(1 for s in tasks.values()
                              if s.get("state") == "RUNNING"
                              and s.get("ready", True))
                queued = sum(1 for s in tasks.values()
                             if s.get("state") == "RUNNING"
                             and not s.get("ready", True))
                out.append({
                    "worker": n.node_id,
                    "state": n.state,
                    "running_tasks": running,
                    "queued_tasks": queued,
                    "last_heartbeat_age_ms": (now - n.last_seen) * 1000.0,
                })
            return out

    # ------------------------------------------------- background monitoring
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="worker-failure-detector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            self.sweep_once()
