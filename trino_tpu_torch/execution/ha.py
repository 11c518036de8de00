"""Horizontally-scaled HA control plane: the coordinator fleet.

The port of the reference ``execution/ha.py``.  The per-query
write-ahead state log (execution/query_state.py) lets a rebooted
coordinator resume its in-flight ``retry_policy="TASK"`` queries under
their original ids.  This module makes the control plane horizontal:

- **Cluster directory** (``TRINO_TPU_HA_DIR``): every coordinator
  registers a lease file ``coordinators/<node>.json`` renewed by a
  heartbeat thread.  A lease not renewed within
  ``TRINO_TPU_HA_LEASE_TTL_S`` is dead, and any peer may claim it.
- **Consistent-hash ownership**: query ids map to coordinators by
  rendezvous (highest-random-weight) hashing.  Removing a member remaps
  only that member's queries, so a failover never reshuffles the healthy
  fleet.  The stateless front tier (server/front_tier.py) routes by the
  same function.
- **Lease-based failover**: each coordinator watches for expired leases.
  The claim is one atomic ``os.rename`` of the dead lease file into
  ``claims/`` (exactly one racing peer wins), after which the winner
  renames the dead coordinator's WAL directory into its own custody and
  adopts every in-flight query in it through the recovery path
  (``query_state.pending`` -> ``QueryDispatcher.adopt`` ->
  ``DistributedQueryRunner.resume_fte_query``, which resumes on the
  runner's device).  Committed attempts are never re-executed, and a
  client polling the original query id through the front tier sees a
  slow query, not an error.
- **Elastic worker autoscaling**: :class:`WorkerAutoscaler` watches the
  ``trino_admission_queued_seconds`` distribution and the cluster memory
  gauges and grows the worker fleet, or drains one worker at a time
  through the zero-loss shutdown protocol, between a floor and a
  ceiling.

The lease JSON (``node_id``, ``url``, ``pid``, ``epoch``, ``ts``,
``state``, plus ``in_flight`` from the coordinator), the claim files and
the ``<ha>/wal/<node>`` layout are the reference's byte for byte, so a
fleet may mix members of both packages.  Everything is behind
``TRINO_TPU_HA`` (default 0: one coordinator, no lease file, no thread,
no directory I/O).  No tensor or device is touched here.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from typing import Callable, Optional

from ..spi import knobs
from ..telemetry import metrics as tm

__all__ = [
    "ha_enabled", "ha_dir", "node_id", "lease_ttl_s", "heartbeat_s",
    "coordinators_dir", "claims_dir", "wal_root", "node_wal_dir",
    "CoordinatorInfo", "read_members", "live_members", "owner_of",
    "CoordinatorLease", "claim_dead", "claimed_wal_dirs", "HACoordinator",
    "WorkerAutoscaler",
]


# --------------------------------------------------------------- knobs

def ha_enabled() -> bool:
    return knobs.get_bool("TRINO_TPU_HA")


def ha_dir() -> str:
    return knobs.get_str("TRINO_TPU_HA_DIR")


def node_id() -> str:
    nid = knobs.get_str("TRINO_TPU_HA_NODE_ID").strip()
    if nid:
        return nid
    return f"coord-{socket.gethostname()}-{os.getpid()}"


def lease_ttl_s() -> float:
    return knobs.get_float("TRINO_TPU_HA_LEASE_TTL_S") or 10.0


def heartbeat_s() -> float:
    return knobs.get_float("TRINO_TPU_HA_HEARTBEAT_S") or 2.0


# -------------------------------------------------------------- layout

def coordinators_dir(root: Optional[str] = None) -> str:
    return os.path.join(root or ha_dir(), "coordinators")


def claims_dir(root: Optional[str] = None) -> str:
    return os.path.join(root or ha_dir(), "claims")


def wal_root(root: Optional[str] = None) -> str:
    return os.path.join(root or ha_dir(), "wal")


def node_wal_dir(nid: str, root: Optional[str] = None) -> str:
    return os.path.join(wal_root(root), nid)


def _lease_path(nid: str, root: Optional[str] = None) -> str:
    return os.path.join(coordinators_dir(root), nid + ".json")


# ----------------------------------------------------------- directory

class CoordinatorInfo:
    """One parsed lease file."""

    __slots__ = ("node_id", "url", "pid", "epoch", "ts", "state",
                 "in_flight", "age_s")

    def __init__(self, node_id: str, url: str = "", pid: int = 0,
                 epoch: float = 0.0, ts: float = 0.0, state: str = "ACTIVE",
                 in_flight: int = 0, age_s: float = 0.0):
        self.node_id = node_id
        self.url = url
        self.pid = pid
        self.epoch = epoch
        self.ts = ts
        self.state = state
        self.in_flight = in_flight
        self.age_s = age_s


def read_members(root: Optional[str] = None,
                 ttl: Optional[float] = None) -> list[CoordinatorInfo]:
    """Every registered coordinator, lease-age annotated; ``state`` becomes
    ``EXPIRED`` past the TTL.  Sorted by node id."""
    d = coordinators_dir(root)
    ttl = lease_ttl_s() if ttl is None else ttl
    now = time.time()
    out = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name), encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # torn write or concurrent claim: skip this round
        info = CoordinatorInfo(
            node_id=rec.get("node_id", name[:-len(".json")]),
            url=rec.get("url", ""), pid=int(rec.get("pid", 0) or 0),
            epoch=float(rec.get("epoch", 0.0) or 0.0),
            ts=float(rec.get("ts", 0.0) or 0.0),
            state=rec.get("state", "ACTIVE"),
            in_flight=int(rec.get("in_flight", 0) or 0))
        info.age_s = max(0.0, now - info.ts)
        if info.state == "ACTIVE" and info.age_s > ttl:
            info.state = "EXPIRED"
        out.append(info)
    return out


def live_members(root: Optional[str] = None,
                 ttl: Optional[float] = None) -> list[CoordinatorInfo]:
    return [m for m in read_members(root, ttl) if m.state == "ACTIVE"]


def owner_of(key: str, member_ids: list[str]) -> Optional[str]:
    """Rendezvous-hash owner of ``key`` among ``member_ids``: every party
    (front tier, every coordinator, of either package) computes the same
    owner from the same membership, with no ring state to repair."""
    if not member_ids:
        return None
    return max(member_ids, key=lambda m: hashlib.sha256(
        f"{m}|{key}".encode("utf-8")).digest())


# --------------------------------------------------------------- lease

class CoordinatorLease:
    """This coordinator's heartbeated lease file.

    ``register()`` writes the lease (atomic tmp+rename) and starts the
    renewal thread.  A renewal that finds the file missing, or carrying
    another epoch, means a peer claimed the lease while this process was
    wedged: the lease flips ``deposed`` and stops renewing, so a zombie
    coordinator never resurrects its lease.  ``max_gap_s`` is the longest
    time between two writes of the lease (a renewal that came late on a
    busy host shows there before a peer reads the lease as expired)."""

    def __init__(self, nid: Optional[str] = None, url: str = "",
                 root: Optional[str] = None,
                 ttl: Optional[float] = None,
                 interval: Optional[float] = None,
                 info_fn: Optional[Callable[[], dict]] = None):
        self.node_id = nid or node_id()
        self.url = url
        self.root = root or ha_dir()
        self.ttl = lease_ttl_s() if ttl is None else ttl
        self.interval = heartbeat_s() if interval is None else interval
        self.epoch = time.time()
        self.path = _lease_path(self.node_id, self.root)
        self.deposed = False
        self.max_gap_s = 0.0
        self._last_write: Optional[float] = None
        self._info_fn = info_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _payload(self) -> dict:
        rec = {
            "node_id": self.node_id, "url": self.url, "pid": os.getpid(),
            "epoch": self.epoch, "ts": time.time(), "state": "ACTIVE",
        }
        if self._info_fn is not None:
            try:
                rec.update(self._info_fn())
            # optional enrichment must never stop the heartbeat
            except Exception:
                pass
        return rec

    def _write(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + f".tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._payload(), f)
        os.replace(tmp, self.path)
        now = time.monotonic()
        if self._last_write is not None:
            self.max_gap_s = max(self.max_gap_s, now - self._last_write)
        self._last_write = now

    def register(self) -> "CoordinatorLease":
        self._write()
        self._thread = threading.Thread(
            target=self._run, name=f"ha-lease-{self.node_id}", daemon=True)
        self._thread.start()
        return self

    def renew(self) -> bool:
        """One renewal; False (and ``deposed``) when the lease was claimed
        out from under this process."""
        if self.deposed:
            return False
        try:
            with open(self.path, encoding="utf-8") as f:
                rec = json.load(f)
            if float(rec.get("epoch", 0.0) or 0.0) != self.epoch:
                self.deposed = True
                return False
        except OSError:
            # the lease file is gone: a peer claimed it (rename)
            self.deposed = True
            return False
        except ValueError:
            pass  # torn read of our own write: rewrite below
        self._write()
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if not self.renew():
                break

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if not self.deposed:
            try:
                os.remove(self.path)
            except OSError:
                pass


# ------------------------------------------------------------ failover

def claim_dead(claimant: str, root: Optional[str] = None,
               ttl: Optional[float] = None) -> list[tuple[str, str]]:
    """Claim every expired peer lease.  Returns ``(dead_node_id,
    claimed_wal_dir)`` per win (``claimed_wal_dir`` is "" when the dead
    coordinator never ran an FTE query).

    The atomic primitive is ``os.rename`` of the lease file into
    ``claims/``: of N racing peers exactly one rename succeeds, the rest
    get ENOENT and walk away.  Only the winner then renames the dead WAL
    directory into its custody (``<wal>/<dead>.claimed-<claimant>-<epoch>``,
    on the same filesystem), so a restarted dead coordinator boots with
    an empty WAL directory and cannot resume queries its successor
    already owns."""
    root = root or ha_dir()
    ttl = lease_ttl_s() if ttl is None else ttl
    wins = []
    for m in read_members(root, ttl):
        if m.node_id == claimant or m.state != "EXPIRED":
            continue
        cdir = claims_dir(root)
        os.makedirs(cdir, exist_ok=True)
        claim = os.path.join(cdir, f"{m.node_id}-{m.epoch:.6f}.lease")
        try:
            os.rename(_lease_path(m.node_id, root), claim)
        except OSError:
            continue  # a peer won the race (or the lease re-appeared)
        src = node_wal_dir(m.node_id, root)
        dst = src + f".claimed-{claimant}-{m.epoch:.6f}"
        try:
            os.rename(src, dst)
        except OSError:
            dst = ""  # no WAL directory: nothing in flight to adopt
        wins.append((m.node_id, dst))
    return wins


def claimed_wal_dirs(claimant: str,
                     root: Optional[str] = None) -> list[str]:
    """WAL directories this claimant has custody of (a claimant that
    crashed mid-adoption re-adopts from them at its next boot)."""
    marker = f".claimed-{claimant}-"
    try:
        names = sorted(os.listdir(wal_root(root)))
    except OSError:
        return []
    return [os.path.join(wal_root(root), n) for n in names if marker in n]


class HACoordinator:
    """One fleet member: lease + failover watcher around a running
    :class:`~trino_tpu_torch.server.protocol.TrinoTpuServer`.

    Boot order: the server's dispatcher first recovers this node's own
    WAL directory (the restart path; a fleet member points
    ``TRINO_TPU_QUERY_STATE_DIR`` at ``<ha>/wal/<node>``), then
    :meth:`start` re-adopts what this node had claimed before, registers
    the lease and starts the watcher that claims dead peers."""

    def __init__(self, server, nid: Optional[str] = None,
                 root: Optional[str] = None,
                 ttl: Optional[float] = None,
                 interval: Optional[float] = None):
        self.server = server
        self.node_id = nid or node_id()
        self.root = root or ha_dir()
        self.ttl = lease_ttl_s() if ttl is None else ttl
        self.interval = heartbeat_s() if interval is None else interval
        host, port = server.address
        self.lease = CoordinatorLease(
            self.node_id, url=f"http://{host}:{port}", root=self.root,
            ttl=self.ttl, interval=self.interval, info_fn=self._lease_info)
        self.takeovers: list[str] = []
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None

    def _lease_info(self) -> dict:
        return {"in_flight": self.server.dispatcher.in_flight()}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "HACoordinator":
        for d in claimed_wal_dirs(self.node_id, self.root):
            self._adopt_dir(d)
        self.lease.register()
        tm.HA_LEASES_HELD.set(1)
        self._watcher = threading.Thread(
            target=self._watch, name=f"ha-watch-{self.node_id}",
            daemon=True)
        self._watcher.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5)
        self.lease.release()

    # ------------------------------------------------------------- failover
    def _watch(self) -> None:
        while not self._stop.wait(self.interval):
            if self.lease.deposed:
                break
            try:
                tm.HA_FLEET_COORDINATORS.set(
                    len(live_members(self.root, self.ttl)))
                self.step()
            # the watcher must survive any one bad round
            except Exception:
                pass

    def step(self) -> list[str]:
        """One failover round (exposed for deterministic tests): claim
        expired peers, adopt their in-flight queries.  Returns the node
        ids claimed this round."""
        claimed = []
        for dead, wal_dir in claim_dead(self.node_id, self.root, self.ttl):
            tm.HA_TAKEOVERS.inc()
            self.takeovers.append(dead)
            claimed.append(dead)
            if wal_dir:
                self._adopt_dir(wal_dir)
        if claimed:
            tm.HA_LEASES_HELD.set(1 + len(self.takeovers))
        return claimed

    def _adopt_dir(self, wal_dir: str) -> None:
        from . import query_state

        try:
            query_state.prune_ended(wal_dir)
        except OSError:
            pass
        for pq in query_state.pending(wal_dir):
            if self.server.dispatcher.adopt(pq):
                tm.HA_ADOPTED_QUERIES.inc()


# ----------------------------------------------------------- autoscaler

class WorkerAutoscaler:
    """Elastic worker fleet controller.

    Each round reads the pressure signals (the admission queued-seconds
    accumulated since the previous round, from the
    ``trino_admission_queued_seconds`` distribution, and the cluster
    memory manager's free bytes) and applies at most one action:

    - **pressure** and below the ceiling: grow the fleet by one worker
      (``runner.add_worker()`` on the process runner, or restore a slot
      this controller drained on the in-process runner);
    - **no pressure** for ``idle_rounds`` consecutive rounds and above the
      floor: drain one worker through the zero-loss shutdown protocol
      (``runner.remove_worker()``, or ``drain_worker`` in-process).

    One action per round keeps the loop from flapping between two
    observations of the same backlog."""

    def __init__(self, runner, min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 queue_s: Optional[float] = None,
                 idle_rounds: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 low_memory_frac: float = 0.1,
                 on_scale: Optional[Callable[[str, int], None]] = None):
        self.runner = runner
        self.min_workers = (knobs.get_int("TRINO_TPU_AUTOSCALE_MIN_WORKERS")
                            or 1) if min_workers is None else min_workers
        self.max_workers = (knobs.get_int("TRINO_TPU_AUTOSCALE_MAX_WORKERS")
                            or 4) if max_workers is None else max_workers
        self.queue_s = (knobs.get_float("TRINO_TPU_AUTOSCALE_QUEUE_S")
                        or 0.5) if queue_s is None else queue_s
        self.idle_rounds = (knobs.get_int("TRINO_TPU_AUTOSCALE_IDLE_ROUNDS")
                            or 3) if idle_rounds is None else idle_rounds
        self.interval_s = (knobs.get_float("TRINO_TPU_AUTOSCALE_INTERVAL_S")
                           or 5.0) if interval_s is None else interval_s
        self.low_memory_frac = low_memory_frac
        self.on_scale = on_scale
        self.events: list[tuple] = []
        self._idle = 0
        self._drained: list[str] = []  # in-process drains to undo
        self._last_queued_sum = self._queued_sum()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -------------------------------------------------------------- signals
    @staticmethod
    def _queued_sum() -> float:
        return float(tm.ADMISSION_QUEUED_SECONDS.snapshot()["sum"])

    def queued_delta(self) -> float:
        now = self._queued_sum()
        delta = max(0.0, now - self._last_queued_sum)
        self._last_queued_sum = now
        return delta

    def memory_low(self) -> bool:
        mm = getattr(self.runner, "memory_manager", None)
        cap = getattr(mm, "capacity_bytes", None)
        if not cap:
            return False
        return mm.cluster_free_bytes() <= cap * self.low_memory_frac

    def worker_count(self) -> int:
        workers = getattr(self.runner, "workers", None)
        if workers is not None:  # process runner: live processes
            return sum(1 for w in workers if w.alive())
        return int(self.runner.active_worker_count)

    # -------------------------------------------------------------- actions
    def _scale_up(self) -> bool:
        if self._drained and hasattr(self.runner, "restore_worker"):
            self.runner.restore_worker(self._drained.pop())
            return True
        add = getattr(self.runner, "add_worker", None)
        if add is None:
            return False
        add()
        return True

    def _scale_down(self) -> bool:
        remove = getattr(self.runner, "remove_worker", None)
        if remove is not None:
            return remove() is not None
        # in-process runner: drain the highest live slot
        nodes = getattr(self.runner, "nodes", None)
        if nodes is None:
            return False
        active = [n for n in nodes.active_workers()
                  if n not in self._drained]
        if not active:
            return False
        victim = sorted(active)[-1]
        self.runner.drain_worker(victim)
        self._drained.append(victim)
        return True

    # --------------------------------------------------------------- policy
    def step(self, queued_delta_s: Optional[float] = None) -> Optional[str]:
        """One controller round; returns "up", "down" or None."""
        with self._lock:
            delta = (self.queued_delta() if queued_delta_s is None
                     else queued_delta_s)
            pressure = delta >= self.queue_s or self.memory_low()
            count = self.worker_count()
            if pressure:
                self._idle = 0
                if count < self.max_workers and self._scale_up():
                    return self._applied("up", count + 1, delta)
                return None
            self._idle += 1
            if self._idle >= self.idle_rounds and count > self.min_workers \
                    and self._scale_down():
                self._idle = 0
                return self._applied("down", count - 1, delta)
            return None

    def _applied(self, action: str, count: int, delta: float) -> str:
        tm.HA_AUTOSCALE_EVENTS.inc()
        self.events.append((action, count, round(delta, 4)))
        if self.on_scale is not None:
            self.on_scale(action, count)
        return action

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "WorkerAutoscaler":
        self._thread = threading.Thread(
            target=self._run, name="ha-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            # the controller must survive any one bad round
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
