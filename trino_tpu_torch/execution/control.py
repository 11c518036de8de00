"""Query control plane: state machines, dispatcher, resource groups,
discovery + heartbeat failure detection.

Mirrors the coordinator-side orchestration stack:

- :class:`StateMachine` — listener-based FSM
  (reference: execution/StateMachine.java:43)
- :class:`QueryStateMachine` — QUEUED → WAITING_FOR_RESOURCES → DISPATCHING
  → PLANNING → STARTING → RUNNING → FINISHING → FINISHED | FAILED
  (reference: execution/QueryState.java:26-58, QueryStateMachine.java)
- :class:`ResourceGroup` — hierarchical admission control with concurrency +
  queue quotas, weighted-fair scheduling, memory/CPU quotas; defined in
  execution/resource_manager.py and re-exported here so the historical
  import path keeps working
  (reference: execution/resourcegroups/InternalResourceGroup.java:75)
- :class:`DispatchManager` — accepts queries, runs them through group
  admission, tracks them (reference: dispatcher/DispatchManager.java:72,
  execution/QueryTracker.java:51)
- :class:`NodeManager` + :class:`HeartbeatFailureDetector` — worker
  announcements and liveness gating task placement (reference:
  metadata/DiscoveryNodeManager.java:68,
  failuredetector/HeartbeatFailureDetector.java:76)

The data plane stays exactly as before — this layer decides WHEN a query
runs and WHERE tasks may be placed, not how batches move.

The port of the reference ``execution/control.py``: host-only and the
reference's, so state sequences, admission orders and live-node sets
are equal in both packages (tests/test_torch_control.py)."""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "StateMachine", "QueryStateMachine", "QUERY_STATES",
    "ResourceGroup", "QueryInfo", "DispatchManager",
    "NodeManager", "HeartbeatFailureDetector",
]


class StateMachine:
    """Thread-safe listener FSM.  Terminal states absorb; when ``order`` is
    given, backward transitions are rejected (monotonic lifecycle)."""

    def __init__(self, name: str, initial: str, terminal: set[str],
                 order: Optional[list[str]] = None):
        self.name = name
        self._state = initial
        self._terminal = set(terminal)
        self._rank = {s: i for i, s in enumerate(order or [])}
        self._listeners: list[Callable[[str], None]] = []
        self._cond = threading.Condition()

    @property
    def state(self) -> str:
        with self._cond:
            return self._state

    def is_terminal(self) -> bool:
        return self.state in self._terminal

    def add_listener(self, cb: Callable[[str], None]) -> None:
        with self._cond:
            self._listeners.append(cb)
            state = self._state
        cb(state)  # fire with current state (reference: addStateChangeListener)

    def set(self, new_state: str) -> bool:
        """Transition; returns False if already terminal (absorbed) or the
        move would go backward along ``order``."""
        with self._cond:
            if self._state in self._terminal:
                return False
            if self._state == new_state:
                return True
            if (self._rank and new_state in self._rank
                    and self._state in self._rank
                    and self._rank[new_state] < self._rank[self._state]):
                return False
            self._state = new_state
            listeners = list(self._listeners)
            self._cond.notify_all()
        for cb in listeners:
            cb(new_state)
        return True

    def wait_for(self, predicate: Callable[[str], bool],
                 timeout: float = 30.0) -> str:
        deadline = time.monotonic() + timeout
        with self._cond:
            while not predicate(self._state):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self.name}: still {self._state} after {timeout}s")
                self._cond.wait(remaining)
            return self._state


QUERY_STATES = [
    "QUEUED", "WAITING_FOR_RESOURCES", "DISPATCHING", "PLANNING",
    "STARTING", "RUNNING", "FINISHING", "FINISHED", "FAILED",
]


class QueryStateMachine(StateMachine):
    def __init__(self, query_id: str):
        super().__init__(f"query {query_id}", "QUEUED",
                         {"FINISHED", "FAILED"}, QUERY_STATES)
        self.query_id = query_id
        self.error: Optional[BaseException] = None
        self.create_time = time.time()
        self.end_time: Optional[float] = None

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.end_time = time.time()
        self.set("FAILED")

    def finish(self) -> None:
        self.end_time = time.time()
        self.set("FINISHED")


@dataclass
class QueryInfo:
    query_id: str
    sql: str
    resource_group: str
    state_machine: QueryStateMachine

    @property
    def state(self) -> str:
        return self.state_machine.state


# the full weighted-fair/memory/CPU-quota group lives with the serving
# plane; this module keeps the name so `from .control import ResourceGroup`
# (tests, runners) stays the import path
from .resource_manager import ResourceGroup  # noqa: E402


class DispatchManager:
    """Accepts queries, applies resource-group admission, tracks lifecycle
    (reference: dispatcher/DispatchManager.java:173 createQuery →
    createQueryInternal:205; QueryTracker keeps recent history)."""

    def __init__(self, root_group: Optional[ResourceGroup] = None,
                 selector: Optional[Callable[[str, object], str]] = None,
                 max_history: int = 100):
        self.root = root_group or ResourceGroup("global")
        # selector(sql, session) -> subgroup name ('' = root)
        self._selector = selector
        self._tracker: dict[str, QueryInfo] = {}
        # deque: history eviction is O(1) popleft under the lock (list.pop(0)
        # shifted the whole buffer on every submit past max_history)
        self._history: deque[str] = deque()
        self._max_history = max_history
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _group_for(self, sql: str, session) -> ResourceGroup:
        """Selector output is a dotted path under the root (``etl.heavy``);
        path segments resolve against configured subgroups, creating
        default-knob groups for unconfigured names."""
        if self._selector is None:
            return self.root
        path = self._selector(sql, session)
        g = self.root
        for part in (path or "").split("."):
            if part:
                g = g.subgroup(part)
        return g

    def submit(self, sql: str, session, run: Callable[[QueryStateMachine], object]):
        """Admission + lifecycle around ``run`` (the planning/execution
        callback drives PLANNING..FINISHING itself via the FSM).  Queue
        wait is recorded into the admission distribution + the query record
        (system.runtime.queries queued_time_ms); the query's process-CPU
        window is charged to the group at release so CPU quotas regenerate
        against real usage."""
        from ..telemetry import metrics as tm
        from ..telemetry import runtime as rt

        with self._lock:
            qid = f"q_{next(self._ids)}"
        fsm = QueryStateMachine(qid)
        group = self._group_for(sql, session)
        info = QueryInfo(qid, sql, group.name, fsm)
        with self._lock:
            self._tracker[qid] = info
            self._history.append(qid)
            while len(self._history) > self._max_history:
                self._tracker.pop(self._history.popleft(), None)
        fsm.set("WAITING_FOR_RESOURCES")
        t0 = time.monotonic()
        try:
            group.acquire(
                timeout=getattr(session, "query_queued_timeout_s", 300.0),
                priority=getattr(session, "query_priority", 0))
        except BaseException as e:
            fsm.fail(e)
            raise
        queued_s = time.monotonic() - t0
        tm.ADMISSION_QUEUED_SECONDS.record(queued_s)
        rec = rt.current_record()
        if rec is not None:
            rec.queued_ms = queued_s * 1e3
            rec.resource_group = group.name
        fsm.set("DISPATCHING")
        cpu0 = time.process_time()
        try:
            result = run(fsm)
            fsm.finish()
            return result
        except BaseException as e:
            fsm.fail(e)
            raise
        finally:
            group.release(cpu_s=time.process_time() - cpu0)

    def groups(self) -> list[ResourceGroup]:
        """The full group tree, preorder (system.runtime.resource_groups)."""
        return self.root.walk()

    def query_info(self, query_id: str) -> Optional[QueryInfo]:
        with self._lock:
            return self._tracker.get(query_id)

    def queries(self) -> list[QueryInfo]:
        with self._lock:
            return [self._tracker[q] for q in self._history
                    if q in self._tracker]


# ---------------------------------------------------------------------------
# discovery + failure detection


@dataclass
class NodeInfo:
    node_id: str
    last_heartbeat: float = field(default_factory=time.monotonic)
    coordinator: bool = False
    draining: bool = False


class NodeManager:
    """Worker membership via announcements (reference:
    metadata/DiscoveryNodeManager.java:68 — workers announce; the
    coordinator's view is heartbeat-gated by the failure detector)."""

    def __init__(self, heartbeat_timeout: float = 10.0):
        self.heartbeat_timeout = heartbeat_timeout
        self._nodes: dict[str, NodeInfo] = {}
        self._lock = threading.Lock()

    def announce(self, node_id: str, coordinator: bool = False) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None:
                self._nodes[node_id] = NodeInfo(
                    node_id, time.monotonic(), coordinator)
            else:
                info.last_heartbeat = time.monotonic()

    def heartbeat(self, node_id: str) -> None:
        """Refresh liveness of an EXISTING node only — a heartbeat must not
        resurrect a node removed by the operator (remove() is deliberate)."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is not None:
                info.last_heartbeat = time.monotonic()

    def drain(self, node_id: str) -> None:
        """Graceful shutdown: stop placing new tasks on the node
        (reference: server/GracefulShutdownHandler.java:42)."""
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id].draining = True

    def restore(self, node_id: str) -> None:
        """Undo drain: the node takes new task placements again (the
        in-process rolling-restart drill drains and restores each worker
        in turn — there is no process to replace)."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is not None:
                info.draining = False
                info.last_heartbeat = time.monotonic()

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def active_workers(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return sorted(
                n.node_id for n in self._nodes.values()
                if not n.coordinator and not n.draining
                and now - n.last_heartbeat <= self.heartbeat_timeout)

    def all_nodes(self) -> list[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())


class HeartbeatFailureDetector:
    """Background pinger marking nodes failed after missed heartbeats
    (reference: failuredetector/HeartbeatFailureDetector.java:76 ping:344).
    ``ping`` callbacks stand in for HTTP /v1/status probes: they return True
    while the node is alive — in-process workers are functions; over DCN
    they would be HTTP checks."""

    def __init__(self, nodes: NodeManager, interval: float = 0.5):
        self.nodes = nodes
        self.interval = interval
        self._pingers: dict[str, Callable[[], bool]] = {}
        self._failed: set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def monitor(self, node_id: str, ping: Callable[[], bool]) -> None:
        with self._lock:
            self._pingers[node_id] = ping

    def unmonitor(self, node_id: str) -> None:
        with self._lock:
            self._pingers.pop(node_id, None)
            self._failed.discard(node_id)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="failure-detector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.ping_once()

    def ping_once(self) -> None:
        with self._lock:
            pingers = dict(self._pingers)
        for node_id, ping in pingers.items():
            ok = False
            try:
                ok = bool(ping())
            except BaseException:
                ok = False
            if ok:
                # heartbeat (not announce): a ping must never resurrect a
                # node the operator removed from membership
                self.nodes.heartbeat(node_id)
                with self._lock:
                    self._failed.discard(node_id)
            else:
                with self._lock:
                    self._failed.add(node_id)

    def failed_nodes(self) -> set[str]:
        with self._lock:
            return set(self._failed)
