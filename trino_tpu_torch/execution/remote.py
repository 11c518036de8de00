"""Coordinator-side remote execution: worker processes over HTTP.

The process/network boundary: the coordinator spawns N worker processes
(execution/worker.py), mirrors each task with an
:class:`HttpRemoteTask` (reference: server/remotetask/HttpRemoteTask.java:132
— create POST, status polling, cancel), and pages move worker->worker and
worker->coordinator through :class:`HttpExchangeClient` speaking the
pull-token results protocol (operator/HttpPageBufferClient.java:355,
operator/DirectExchangeClient.java:56).

``ProcessDistributedQueryRunner`` keeps the in-process
``DistributedQueryRunner`` planning/DDL surface and swaps the execution
backend: every fragment task runs in a real worker process; killing a
worker kills its tasks for real (the FTE recovery story becomes testable).

The port of the reference ``execution/remote.py``.  The coordinator's
``device`` is passed to every worker it spawns (``--device``); on the card
the workers share it, each with its own CUDA context and caching
allocator, and the coordinator builds the kernel library before it spawns
them, so no worker runs nvcc.  Pages a client pulls are decoded onto the
receiving task's device (:class:`HttpExchangeClient` ``device``).  Every
wait has a bound: the worker's boot (``boot_timeout_s``), the exchange
backoff's ``max_failure_duration_s`` and the drain budget.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from ..runner import QueryResult, Session
from ..spi import knobs
from ..spi.batch import ColumnBatch
from ..spi.errors import (
    GENERIC_INTERNAL_ERROR,
    GENERIC_USER_ERROR,
    NO_NODES_AVAILABLE,
    PAGE_TRANSPORT_TIMEOUT,
    REMOTE_HOST_GONE,
    Backoff,
    TrinoError,
    classify,
    lookup_code,
)
from .distributed_runner import DistributedQueryRunner
from .failure_detector import (GONE, UNRESPONSIVE, NodeGoneError,
                               WorkerFailureDetector)
from .failure_injector import GET_RESULTS_FAILURE
from .fragmenter import SubPlan
from .serde import deserialize_batch
from .worker import encode_descriptor

# the seconds a worker has to print LISTENING (a process that imports torch
# and, on the card, makes its CUDA context and binds the kernel library)
BOOT_TIMEOUT_S = 120.0
# the seconds a replacement waits for an UNRESPONSIVE worker's process to
# exit: a process killed on the card closes its sockets before the CUDA
# driver has torn its context down, so the sweep that follows a kill -9
# can read UNRESPONSIVE for a process that is already dying
REAP_WAIT_S = 10.0

__all__ = ["HttpExchangeClient", "HttpRemoteTask",
           "ProcessDistributedQueryRunner", "WorkerProcess"]


def _http(method: str, url: str, data: Optional[bytes] = None,
          timeout: float = 30.0, headers: Optional[dict] = None):
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    # per-spawn internal shared secret (reference: server/
    # InternalCommunicationConfig.java:33 sharedSecret) — every node in the
    # cluster process tree carries it via env; the worker rejects mutating
    # or descriptor-decoding requests without it
    secret = knobs.get_str("TRINO_TPU_INTERNAL_SECRET")
    if secret:
        req.add_header("X-Trino-Internal-Bearer", secret)
    return urllib.request.urlopen(req, timeout=timeout)


class HttpExchangeClient:
    """Pulls one partition from many upstream task result URIs; same
    poll/is_finished surface as the in-process ExchangeClient so operators
    are transport-agnostic.

    Each source carries a deterministic :class:`Backoff`
    (HttpPageBufferClient.java:355's role): transient fetch failures skip
    the source until its delay gate reopens, and once failures persist past
    ``max_failure_duration_s`` the source surfaces as a classified EXTERNAL
    :class:`TrinoError` instead of spinning silently until the query
    deadline.  ``backoff`` is a config dict
    (min_delay_s / max_delay_s / max_failure_duration_s) so it travels in
    task descriptors."""

    def __init__(self, task_uris: list[str], partition: int,
                 backoff: Optional[dict] = None,
                 traceparent: Optional[str] = None, device=None):
        # the receiving task's device: pages are decoded on the host, then
        # moved there (None keeps host batches)
        self.device = device
        # trace context rides every results fetch (the reference propagates
        # OTel context on all task calls); servers are free to ignore it
        self._traceparent = traceparent
        cfg = backoff or {}
        # [uri, token, done, Backoff]
        self._sources = [[u, 0, False, Backoff(
            min_delay_s=cfg.get("min_delay_s", 0.05),
            max_delay_s=cfg.get("max_delay_s", 2.0),
            max_failure_duration_s=cfg.get("max_failure_duration_s", 120.0),
        )] for u in task_uris]
        self.partition = partition
        self._ready: list[ColumnBatch] = []
        # per-client counters, folded into ResilienceStats by the runner
        self.stats = {"fetch_failures": 0, "backoff_skips": 0,
                      "backoff_trips": 0,
                      "failures_by_source": {u: 0 for u in task_uris}}

    @staticmethod
    def _host_of(uri: str) -> str:
        # ".../v1/task/<id>" -> worker base URL, the blacklist key
        return uri.split("/v1/", 1)[0]

    def _fetch(self, s, timeout: float) -> int:
        uri, token, _done, backoff = s
        # the server bounds its long-poll to maxwait (worker.py honors it),
        # so a short poll really IS short; the socket timeout only needs a
        # small grace on top for page serialization + transfer
        maxwait = min(max(timeout, 0.0), 5.0)
        url = f"{uri}/results/{self.partition}/{token}?maxwait={maxwait:g}"
        t0 = time.perf_counter()
        hdrs = ({"traceparent": self._traceparent}
                if self._traceparent else None)
        try:
            with _http("GET", url, timeout=maxwait + 5.0,
                       headers=hdrs) as resp:
                body = resp.read()
                next_token = int(resp.headers.get("X-Next-Token", token))
                done = bool(int(resp.headers.get("X-Done", 0)))
        except urllib.error.HTTPError as e:
            if e.code == 404:  # task not created yet: transient
                return 0
            # a FAILED task's 500 body carries its own classification
            # (worker.py status JSON) — keep it, so a worker-side USER
            # error stays USER (fail-fast) instead of degrading to a
            # retryable transport error
            detail = e.read()[:500]
            code_name = error_type = None
            try:
                info = json.loads(detail)
                code_name = info.get("error_code")
                error_type = info.get("error_type")
                detail = info.get("error") or detail
            # best-effort payload parse; re-raised classified below
            except Exception:
                pass
            raise TrinoError(
                lookup_code(code_name or "REMOTE_TASK_ERROR", error_type),
                f"exchange fetch failed ({e.code}): {detail!r}",
                remote_host=self._host_of(uri)) from e
        except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
            # worker unreachable: back off; once failures persist past the
            # failure-duration budget this producer is DECLARED failed
            self.stats["fetch_failures"] += 1
            self.stats["failures_by_source"][uri] += 1
            if backoff.failure():
                self.stats["backoff_trips"] += 1
                raise TrinoError(
                    PAGE_TRANSPORT_TIMEOUT,
                    f"producer {uri} unreachable for "
                    f"{backoff.failure_duration_s:.1f}s "
                    f"({backoff.failure_count} attempts): "
                    f"{type(e).__name__}: {e}",
                    remote_host=self._host_of(uri)) from e
            return 0
        backoff.success()
        count = 0
        pos = 0
        while pos + 4 <= len(body):
            (n,) = struct.unpack("<I", body[pos:pos + 4])
            pos += 4
            batch = deserialize_batch(body[pos:pos + n])
            self._ready.append(batch if self.device is None
                               else batch.to(self.device))
            pos += n
            count += 1
        s[1] = next_token
        s[2] = done
        from ..telemetry.metrics import observe_exchange

        observe_exchange(len(body), count, time.perf_counter() - t0)
        from ..telemetry import profiler

        if count and profiler.enabled():
            # one event per non-empty fetch: the wall time covers the
            # long-poll wait plus page transfer for this source
            wall = time.perf_counter() - t0
            profiler.event(profiler.EXCHANGE, "http-exchange.fetch",
                           profiler.now() - wall, pages=count,
                           bytes=len(body))
        return count

    def poll(self, timeout: float = 0.05) -> Optional[ColumnBatch]:
        if self._ready:
            return self._ready.pop(0)
        for s in self._sources:
            if s[2]:
                continue
            if not s[3].ready():  # delay gate closed: skip this round
                self.stats["backoff_skips"] += 1
                continue
            if self._fetch(s, timeout):
                return self._ready.pop(0)
        return None

    def is_finished(self) -> bool:
        return not self._ready and all(s[2] for s in self._sources)


class HttpRemoteTask:
    """Coordinator-side mirror of one worker task."""

    def __init__(self, worker_url: str, task_id: str):
        self.worker_url = worker_url
        self.task_id = task_id
        self.uri = f"{worker_url}/v1/task/{task_id}"

    def create(self, descriptor: dict,
               traceparent: Optional[str] = None) -> None:
        headers = {"traceparent": traceparent} if traceparent else None
        with _http("POST", self.uri, encode_descriptor(descriptor),
                   timeout=60.0, headers=headers) as resp:
            assert resp.status == 200

    def status(self) -> dict:
        try:
            with _http("GET", f"{self.uri}/status", timeout=10.0) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, ConnectionError) as e:
            return {"state": "GONE", "error": str(e),
                    "error_type": "EXTERNAL",
                    "error_code": "REMOTE_HOST_GONE"}

    def cancel(self) -> None:
        try:
            _http("DELETE", self.uri, timeout=5.0).read()
        # best-effort cancel of a task that may already be gone
        except Exception:
            pass


_SECRET_LOCK = threading.Lock()


class WorkerProcess:
    """One spawned worker (python -m trino_tpu_torch.execution.worker
    --device <device>).

    Boot is bounded: a worker that dies (or wedges) before printing
    ``LISTENING`` raises within ``boot_timeout_s`` with its captured stderr
    in the message, instead of blocking the coordinator forever on
    ``stdout.readline()``.  A worker told ``--device cuda`` on a host
    without CUDA is such a worker: it exits with the reason on stderr.
    ``boot_s`` is the seconds from spawn to ``LISTENING``."""

    def __init__(self, env_overrides: Optional[dict] = None,
                 boot_timeout_s: float = BOOT_TIMEOUT_S, device="cuda"):
        import tempfile

        # one shared secret per cluster process tree: minted on first spawn,
        # inherited by every worker and by worker->worker exchange fetches
        with _SECRET_LOCK:
            if "TRINO_TPU_INTERNAL_SECRET" not in os.environ:
                import secrets

                os.environ["TRINO_TPU_INTERNAL_SECRET"] = secrets.token_hex(16)
        env = dict(os.environ)
        env.update(env_overrides or {})
        self._stderr = tempfile.TemporaryFile(mode="w+")
        self.device = str(device)
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "trino_tpu_torch.execution.worker",
             "--port", "0", "--device", self.device],
            stdout=subprocess.PIPE, stderr=self._stderr,
            text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
        box: list[str] = []
        reader = threading.Thread(
            target=lambda: box.append(self.proc.stdout.readline() or ""),
            daemon=True)
        reader.start()
        reader.join(timeout=boot_timeout_s)
        line = box[0] if box else None
        if line is None or not line.startswith("LISTENING"):
            try:
                self.proc.kill()
                self.proc.wait(timeout=10)
            # cleanup before the classified boot-failure raise below
            except Exception:
                pass
            reader.join(timeout=5)
            why = ("timed out after "
                   f"{boot_timeout_s}s" if line is None else f"got {line!r}")
            raise TrinoError(
                REMOTE_HOST_GONE,
                f"worker failed to boot ({why}); stderr: "
                f"{self.stderr_tail()!r}")
        self.boot_s = time.perf_counter() - t0
        self.port = int(line.split()[1])
        self.url = f"http://127.0.0.1:{self.port}"

    def stderr_tail(self, limit: int = 2000) -> str:
        try:
            self._stderr.flush()
            self._stderr.seek(0, os.SEEK_END)
            size = self._stderr.tell()
            self._stderr.seek(max(0, size - limit))
            return self._stderr.read()
        except Exception:
            return "<unavailable>"

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=10)

    def info(self) -> dict:
        """The worker's ``GET /v1/info`` (its device and kernel launch
        counts since boot, beside the reference's fields)."""
        with _http("GET", f"{self.url}/v1/info", timeout=10.0) as resp:
            return json.loads(resp.read())

    def shutdown(self) -> None:
        try:
            _http("PUT", f"{self.url}/v1/shutdown", timeout=5.0).read()
        # best-effort graceful stop; kill() below is the backstop
        except Exception:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.kill()


def _drain_budget(session, default: float = 30.0) -> float:
    """Bounded graceful-drain budget: the session's ``drain_timeout_s``,
    then TRINO_TPU_DRAIN_TIMEOUT_S when set, then ``default`` (the
    reference's speculation.drain_timeout_s)."""
    v = session.get("drain_timeout_s") if session is not None else None
    if v:
        return float(v)
    if knobs.is_set("TRINO_TPU_DRAIN_TIMEOUT_S"):
        return knobs.get_float("TRINO_TPU_DRAIN_TIMEOUT_S")
    return float(default)


class ProcessDistributedQueryRunner(DistributedQueryRunner):
    """DistributedQueryRunner whose tasks run in real worker processes.

    ``catalog_spec`` = {"factory": "module:callable", "kwargs": {...}}
    reconstructs the catalog inside each worker (split generation is
    worker-side; only plan fragments and pages cross the wire).
    ``device`` is the coordinator's and every worker's (``"cuda"`` by
    default; it raises without CUDA, as the in-process runner does)."""

    def __init__(self, catalog_spec: dict, worker_count: int = 2,
                 session: Optional[Session] = None,
                 env_overrides: Optional[dict] = None, device="cuda"):
        from .worker import build_catalog

        super().__init__(build_catalog(catalog_spec),
                         worker_count=worker_count, session=session,
                         device=device)
        self.catalog_spec = catalog_spec
        self._env_overrides = env_overrides
        if self.device.type == "cuda":
            # one build, here: the workers only bind the library
            from ..ops import gpu_kernels as GK

            GK.build_library()
        self.workers = self._spawn_all(worker_count)
        # a drain (an operator's thread) and a query retry's self-heal may
        # replace the same dead worker at once: one of them fills the slot
        self._fleet_lock = threading.RLock()
        self._query_seq = 0
        # replace the base in-process pinger with the real heartbeat sweep
        # over worker /v1/status (execution/failure_detector.py); shares the
        # resilience event log so transitions land in the same timeline as
        # retries and replacements
        sess = self.session
        self.failure_detector = WorkerFailureDetector(
            heartbeat_interval_s=sess.get("heartbeat_interval_s"),
            failure_threshold=sess.get("heartbeat_failure_threshold"),
            events=self.resilience_events)
        for w in self.workers:
            self._monitor_worker(w)
        self._replacements_used = 0

    def _spawn(self) -> WorkerProcess:
        return WorkerProcess(self._env_overrides, device=self.device)

    def _spawn_all(self, n: int) -> list:
        """``n`` workers booted at once (each boot is a process importing
        torch and, on the card, making its CUDA context); if any fails to
        boot, the others are killed and its error raised."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(1, n)) as pool:
            futs = [pool.submit(self._spawn) for _ in range(n)]
        workers, errors = [], []
        for f in futs:
            try:
                workers.append(f.result())
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
        if errors:
            for w in workers:
                w.kill()
            raise errors[0]
        return workers

    def _monitor_worker(self, w: WorkerProcess) -> None:
        def probe() -> dict:
            if not w.alive():
                raise NodeGoneError(
                    f"worker process exited rc={w.proc.poll()}")
            with _http("GET", f"{w.url}/v1/status", timeout=2.0) as resp:
                return json.loads(resp.read())

        self.failure_detector.monitor(w.url, probe)

    def _placement_workers(self, blacklist: frozenset = frozenset()
                           ) -> list[WorkerProcess]:
        """Task placement targets: live worker processes whose heartbeat
        state is ACTIVE (draining and unresponsive nodes get no new tasks),
        minus the query's blacklist, minus workers the cross-query
        ClusterBlacklist currently scores past its threshold.  Falls back to
        progressively ignoring the cluster then the query blacklist rather
        than returning nothing (a 1-worker cluster must still place after a
        blacklisting retry)."""
        self.failure_detector.maybe_sweep()
        states = self.failure_detector.states()
        live = [w for w in self.workers
                if w.alive() and states.get(w.url, "ACTIVE") == "ACTIVE"]
        placeable = [w for w in live if w.url not in blacklist]
        cluster_bl = self.cluster_blacklist.blacklisted()
        preferred = [w for w in placeable if w.url not in cluster_bl]
        return preferred or placeable or live

    @property
    def active_worker_count(self) -> int:
        """Heartbeat-gated worker count (overrides the base property, which
        consults the in-process control-plane pinger)."""
        return len(self._placement_workers()) or self.worker_count

    def _replace_gone_workers(self) -> None:
        """Self-heal cluster capacity: respawn a WorkerProcess for every
        GONE node, bounded by ``Session.max_worker_replacements`` over the
        runner's lifetime."""
        self.failure_detector.sweep_once()
        for i, w in enumerate(list(self.workers)):
            # a process that has exited is gone whatever the last sweep
            # saw; an unresponsive one gets a bounded wait to exit
            state = self.failure_detector.state_of(w.url)
            if state == UNRESPONSIVE:
                try:
                    w.proc.wait(timeout=REAP_WAIT_S)
                except subprocess.TimeoutExpired:
                    pass
            if state != GONE and w.alive():
                continue
            with self._fleet_lock:
                if i >= len(self.workers) or self.workers[i] is not w:
                    continue  # a drain replaced it meanwhile
                cap = self.session.get("max_worker_replacements")
                if self._replacements_used >= cap:
                    self.resilience_events.append(
                        ("replacement_cap", w.url, cap))
                    continue
                replacement = self._spawn()
                self._replacements_used += 1
                self.resilience.worker_replacements += 1
                self.resilience_events.append(
                    ("worker_replaced", w.url, replacement.url))
                self.failure_detector.unmonitor(w.url)
                self._monitor_worker(replacement)
                self.workers[i] = replacement
            try:
                if w.alive():
                    w.kill()
            # replaced worker teardown is best-effort
            except Exception:
                pass

    def _prepare_retry(self) -> None:
        """Between query-retry attempts: sweep heartbeats and respawn GONE
        workers so the re-run sees healed capacity."""
        self._replace_gone_workers()

    # --------------------------------------------------------------- drain
    def drain_worker(self, worker, timeout_s: Optional[float] = None,
                     replace: bool = True) -> dict:
        """Coordinator-driven graceful drain of one worker process.

        Protocol: PUT /v1/shutdown?timeout_s=N flips the worker to
        SHUTTING_DOWN (it refuses new tasks with 503; the next heartbeat
        sweep + placement stop scheduling to it — a 503 on task create
        surfaces as a retryable classified error, so retry_policy=QUERY
        migrates not-yet-started work automatically).  The worker exits on
        its own once every running task is terminal AND its output buffers
        are fully drained; past the budget it abandons the stragglers (exit
        code 9) and, if even the process lingers, the coordinator escalates
        with a hard kill.  The failure detector is swept synchronously
        before any replacement boots so in-flight queries observe
        REMOTE_HOST_GONE (and retry) instead of spinning on exchange
        backoff.  Operator-initiated: the replacement does NOT count
        against ``max_worker_replacements``."""
        import subprocess as _subprocess

        from ..telemetry import metrics as tm

        if isinstance(worker, str):
            matches = [w for w in self.workers if w.url == worker]
            if not matches:
                raise TrinoError(GENERIC_USER_ERROR,
                                 f"no such worker: {worker}")
            w = matches[0]
        else:
            w = worker
        budget = (float(timeout_s) if timeout_s is not None
                  else _drain_budget(self.session, 30.0))
        tm.DRAINS.inc()
        self.resilience_events.append(("drain", w.url, "started"))
        try:
            _http("PUT", f"{w.url}/v1/shutdown?timeout_s={budget:g}",
                  timeout=5.0).read()
        # already dead: the sweeps below classify it
        except Exception:
            pass
        # observe SHUTTING_DOWN promptly so placement excludes the worker
        # from this moment on, not from the next opportunistic sweep
        self.failure_detector.sweep_once()
        escalated = False
        try:
            w.proc.wait(timeout=budget + 5.0)
        except _subprocess.TimeoutExpired:
            escalated = True
            self.resilience_events.append(("drain", w.url, "escalated"))
            w.kill()
        # the process is gone: land GONE in the detector BEFORE a
        # replacement exists, so concurrent queries classify and retry
        self.failure_detector.sweep_once()
        summary = {"worker": w.url, "escalated": escalated,
                   "exit_code": w.proc.poll(), "replacement": None}
        with self._fleet_lock:
            # a query retry's self-heal may have replaced it meanwhile
            if replace and w in self.workers:
                slot = self.workers.index(w)
                replacement = self._spawn()
                self.failure_detector.unmonitor(w.url)
                self._monitor_worker(replacement)
                self.workers[slot] = replacement
                self.failure_detector.sweep_once()
                self.resilience_events.append(
                    ("drain", w.url, "replaced", replacement.url))
                summary["replacement"] = replacement.url
        self.resilience_events.append(("drain", w.url, "drained"))
        return summary

    # --------------------------------------------------------- elasticity
    def add_worker(self, worker: Optional[WorkerProcess] = None
                   ) -> WorkerProcess:
        """Grow the fleet by one worker process (autoscaler scale-up):
        ``worker``, a spare booted ahead of time on the runner's device,
        else a new one.  Placement picks it up on the next heartbeat sweep;
        running FTE stages keep their recorded task fan-out
        (shape_matches), new queries fan out wider."""
        w = worker if worker is not None else self._spawn()
        self._monitor_worker(w)
        self.workers.append(w)
        self.failure_detector.sweep_once()
        self.resilience_events.append(("scale", w.url, "added"))
        return w

    def remove_worker(self, timeout_s: Optional[float] = None
                      ) -> Optional[str]:
        """Shrink the fleet by one worker (autoscaler scale-down): drain
        the last slot through the zero-loss shutdown protocol WITHOUT a
        replacement, then drop it from the fleet.  Returns the removed
        worker's url, or None when only one worker remains."""
        live = [w for w in self.workers if w.alive()]
        if len(live) <= 1:
            return None
        w = live[-1]
        self.drain_worker(w, timeout_s=timeout_s, replace=False)
        self.failure_detector.unmonitor(w.url)
        self.workers.remove(w)
        self.resilience_events.append(("scale", w.url, "removed"))
        return w.url

    def rolling_restart(self, timeout_s: Optional[float] = None
                        ) -> list[dict]:
        """Drain + replace every worker slot, one at a time — the rolling
        restart drill.  Under retry_policy=QUERY this loses zero queries:
        capacity shrinks by one worker per step, never to zero."""
        return [self.drain_worker(self.workers[i], timeout_s=timeout_s,
                                  replace=True)
                for i in range(len(self.workers))]

    def close(self) -> None:
        self.failure_detector.stop()
        for w in self.workers:
            w.shutdown()

    def __del__(self):  # best effort
        try:
            for w in self.workers:
                if w.alive():
                    w.proc.kill()
        # interpreter-teardown kill; nothing to classify to
        except Exception:
            pass

    def fte_run_attempt(self, fragment, task_index: int, task_count: int,
                        nparts: int, upstream: dict, spool_root: str,
                        attempt: int, stats_sink: Optional[list],
                        memory_multiplier: float = 1.0) -> str:
        """Dispatch ONE FTE task attempt to a live worker PROCESS; the
        worker writes the durable spool (shared filesystem) and commits
        atomically.  A worker death mid-attempt surfaces here as GONE and
        the FTE retry loop re-dispatches to a surviving worker — recovery
        from real process loss, off the committed on-disk spools."""
        import os as _os

        from .fte import fte_task_dir

        alive = self._placement_workers()
        if not alive:
            raise TrinoError(NO_NODES_AVAILABLE, "no live workers")
        w = alive[(fragment.id * 31 + task_index + attempt) % len(alive)]
        self._query_seq += 1
        task_dir = fte_task_dir(spool_root, fragment.id, task_index)
        _os.makedirs(task_dir, exist_ok=True)
        injector = getattr(self.session, "failure_injector", None)
        desc = {
            "fragment": fragment,
            "task_index": task_index,
            "task_count": task_count,
            "num_partitions": nparts,
            "upstream": {},
            "catalog": self.catalog_spec,
            "splits_per_node": self.session.splits_per_node,
            "node_count": self.worker_count,
            "dynamic_filtering": self.session.dynamic_filtering,
            "hbm_limit_bytes": int(
                self.session.hbm_limit_bytes * memory_multiplier),
            "spill_to_disk_bytes": self.session.spill_to_disk_bytes,
            "spool": {"task_dir": task_dir, "attempt": attempt,
                      "num_partitions": nparts},
            "spool_upstream": upstream,
            "failure_rules": (
                injector.consume_for(
                    fragment.id, task_index, attempt,
                    # a leaf attempt (no upstream) never reaches the
                    # results-read injection point; new kinds export by
                    # default
                    unreachable=(set() if upstream
                                 else {GET_RESULTS_FAILURE}))
                if injector is not None else []),
        }
        rt = HttpRemoteTask(
            w.url, f"fte{self._query_seq}_f{fragment.id}_t{task_index}"
                   f"_a{attempt}")
        rt.create(desc)
        deadline = time.monotonic() + 600
        while True:
            st = rt.status()
            if st["state"] == "FINISHED":
                break
            if st["state"] in ("FAILED", "GONE", "CANCELED"):
                # classified so the FTE retry chain can fail fast on USER
                # errors and keep retrying EXTERNAL/INTERNAL ones
                raise TrinoError(
                    lookup_code(st.get("error_code"), st.get("error_type")),
                    f"attempt failed ({st['state']}): {st.get('error')}",
                    remote_host=w.url)
            if time.monotonic() > deadline:
                rt.cancel()
                raise TimeoutError("fte attempt stalled")
            time.sleep(0.05)
        expected = _os.path.join(task_dir, f"attempt-{attempt}")
        if not _os.path.isdir(expected):
            raise TrinoError(GENERIC_INTERNAL_ERROR,
                             "attempt reported FINISHED but no committed "
                             "spool found")
        if stats_sink is not None:
            from ..exec.stats import QueryStats

            stats_sink.append(QueryStats(
                label=f"fragment {fragment.id} task {task_index}: "
                      f"(remote worker {w.url})"))
        return expected

    # ------------------------------------------------------------- execution
    def _run_streaming(self, subplan: SubPlan, stats_sink: Optional[list],
                       attempt: int = 0,
                       blacklist: frozenset = frozenset(),
                       use_fused: bool = True) -> QueryResult:
        # cluster-state system tables (system.runtime.workers / queries /
        # metrics.counters) are coordinator-fed: the attached runner and
        # failure detector live in THIS process, not in any worker, so a
        # subplan whose scans all read catalog "system" executes in-process
        # — the analogue of Trino's coordinator-only system splits
        if self._scans_system_only(subplan):
            return super()._run_streaming(subplan, stats_sink,
                                          attempt=attempt,
                                          blacklist=blacklist)
        # the base class dispatches retry_policy (TASK -> fte, QUERY -> the
        # query-retry loop); both land here for the actual remote run
        return self._run_remote(subplan, attempt=attempt,
                                blacklist=blacklist)

    @staticmethod
    def _scans_system_only(subplan: SubPlan) -> bool:
        from ..planner.plan import TableScan

        scans: list = []

        def walk(n) -> None:
            if isinstance(n, TableScan):
                scans.append(n)
            for c in n.children:
                walk(c)

        for f in subplan.all_fragments():
            walk(f.root)
        return bool(scans) and all(s.catalog == "system" for s in scans)

    def _exchange_backoff_cfg(self) -> dict:
        sess = self.session
        return {"min_delay_s": sess.get("exchange_backoff_min_s"),
                "max_delay_s": sess.get("exchange_backoff_max_s"),
                "max_failure_duration_s":
                    sess.get("exchange_max_failure_duration_s")}

    def _check_workers(self, by_worker: dict) -> None:
        """One heartbeat-cadence sweep: a single cached /v1/status per
        WORKER (not per task) decides node death and task failure — the old
        per-task loop made the sweep itself the stall (10 s status timeout
        x N tasks against one hung worker)."""
        self.failure_detector.sweep_once()
        for wurl, owned in by_worker.items():
            # state None means the worker was unmonitored mid-query (a
            # drain replaced it) — without this an in-flight query would
            # spin on exchange backoff against a vanished process until the
            # query deadline instead of retrying promptly
            if self.failure_detector.state_of(wurl) in (GONE, None):
                raise TrinoError(
                    REMOTE_HOST_GONE,
                    f"worker {wurl} ({len(owned)} tasks): "
                    f"{self.failure_detector.last_error(wurl) or 'replaced'}",
                    remote_host=wurl)
            status = self.failure_detector.last_status(wurl) or {}
            # the same cached status JSON feeds the cluster memory view:
            # per-task query_id + memory_reserved_bytes aggregate on the
            # coordinator (ClusterMemoryManager.update_worker)
            self.memory_manager.update_worker(wurl, status)
            task_states = status.get("tasks", {})
            for fid, t, task_id in owned:
                st = task_states.get(task_id)
                if st is not None and st["state"] == "FAILED":
                    raise TrinoError(
                        lookup_code(st.get("error_code"),
                                    st.get("error_type")),
                        f"task f{fid}.t{t} FAILED: {st.get('error')}",
                        remote_host=wurl)

    def _collect_task_spans(self, tasks: dict, parent_span) -> None:
        """Re-attach every worker task's finished span subtree under the
        coordinator's query span — one distributed trace tree per query.
        Workers publish the span BEFORE the terminal state, but the client
        drain can observe the last page slightly before the producer flips
        state, hence the short bounded re-poll.  Scan totals travel as
        ``trino.scan.*`` span attributes and fold into the coordinator's
        query record (worker processes keep their own metric registries)."""
        if parent_span is None:
            return
        from ..telemetry import runtime as rt
        from .tracing import Span

        rec = rt.current_record()
        budget = time.monotonic() + 5.0
        for remote_task in tasks.values():
            d = None
            while True:
                st = remote_task.status()
                d = st.get("span")
                if d is not None or st.get("state") != "RUNNING" \
                        or time.monotonic() > budget:
                    break
                time.sleep(0.05)
            prof = st.get("profile") if st else None
            if prof and rec is not None:
                # worker rings are keyed by the worker-visible pq{N} id;
                # re-tag onto the engine query id so the coordinator's
                # chrome_trace merges both processes into one timeline
                from ..telemetry import profiler

                profiler.add_remote_events(
                    rec.query_id, prof,
                    process_name=f"worker:{remote_task.worker_url}")
            if not d:
                continue
            sub = Span.from_dict(d)
            parent_span.children.append(sub)
            if rec is not None:
                rt.add_input(rec,
                             int(sub.attributes.get("trino.scan.rows", 0)),
                             int(sub.attributes.get("trino.scan.bytes", 0)))

    def _run_remote(self, subplan: SubPlan, attempt: int = 0,
                    blacklist: frozenset = frozenset()) -> QueryResult:
        from ..telemetry import runtime as _rtl
        from .resource_manager import find_group
        from .tracing import traceparent as _traceparent

        self._query_seq += 1
        qid = f"pq{self._query_seq}"
        # cluster memory accounting is keyed by the WORKER-visible query id
        # (worker status payloads carry it per task), so register under qid
        qrec = _rtl.current_record()
        handle = self.memory_manager.register_query(
            qid, priority=self.session.query_priority,
            group=find_group(self.dispatcher.root,
                             qrec.resource_group if qrec is not None else ""),
            max_memory=self._query_max_memory())
        # the open trino.query span (run_with_query_events) becomes the
        # remote parent of every worker task span for this attempt
        parent_span = self.tracer.current()
        tp = _traceparent(parent_span) if parent_span is not None else None
        fragments = subplan.all_fragments()
        task_counts, consumer_tasks = self.stage_task_counts(fragments)
        alive = self._placement_workers(blacklist)
        if not alive:
            raise TrinoError(NO_NODES_AVAILABLE, "no live workers")
        injector = getattr(self.session, "failure_injector", None)

        # deterministic placement: task t of fragment f -> alive worker
        # (f*31 + t) % n  (UniformNodeSelector's role, minus locality)
        tasks: dict[tuple[int, int], HttpRemoteTask] = {}
        by_worker: dict[str, list] = {}
        for f in fragments:
            for t in range(task_counts[f.id]):
                w = alive[(f.id * 31 + t) % len(alive)]
                rt = HttpRemoteTask(w.url, f"{qid}_f{f.id}_t{t}")
                tasks[(f.id, t)] = rt
                by_worker.setdefault(w.url, []).append((f.id, t, rt.task_id))

        by_id = {f.id: f for f in fragments}
        client = None
        try:
            for f in fragments:
                tc = task_counts[f.id]
                for t in range(tc):
                    upstream = {}
                    for src in f.source_fragments:
                        src_tasks = [tasks[(src, i)].uri
                                     for i in range(task_counts[src])]
                        upstream[src] = {
                            "uris": src_tasks,
                            "merge": by_id[src].output_kind == "MERGE",
                        }
                    desc = {
                        "fragment": f,
                        "task_index": t,
                        "task_count": tc,
                        "num_partitions": consumer_tasks.get(f.id, 1),
                        "attempt": attempt,
                        "query_id": qid,
                        "upstream": upstream,
                        "catalog": self.catalog_spec,
                        "splits_per_node": self.session.splits_per_node,
                        "node_count": self.worker_count,
                        "dynamic_filtering": self.session.dynamic_filtering,
                        "hbm_limit_bytes": self.session.hbm_limit_bytes,
                        "spill_to_disk_bytes":
                            self.session.spill_to_disk_bytes,
                        "exchange_backoff": self._exchange_backoff_cfg(),
                        "failure_rules": (
                            injector.consume_for(
                                f.id, t, attempt,
                                # leaves never reach the results-read
                                # injection point
                                unreachable=(set() if upstream
                                             else {GET_RESULTS_FAILURE}))
                            if injector is not None else []),
                    }
                    rt = tasks[(f.id, t)]
                    try:
                        rt.create(desc, traceparent=tp)
                    except BaseException as e:  # noqa: BLE001
                        te = classify(e)
                        te.remote_host = te.remote_host or \
                            HttpExchangeClient._host_of(rt.uri)
                        raise te from e

            # drain the root fragment's partition 0 as the client; ONE
            # status poll per worker at heartbeat cadence decides failure
            root = subplan.fragment
            root_uris = [tasks[(root.id, t)].uri
                         for t in range(task_counts[root.id])]
            client = HttpExchangeClient(root_uris, 0,
                                        backoff=self._exchange_backoff_cfg(),
                                        traceparent=tp, device=self.device)
            batches: list[ColumnBatch] = []
            deadline = time.monotonic() + 600
            last_status = 0.0
            while not client.is_finished():
                b = client.poll(timeout=0.2)
                if b is not None:
                    batches.append(b)
                    continue
                now = time.monotonic()
                if now - last_status > self.session.get(
                        "heartbeat_interval_s"):
                    last_status = now
                    self._check_workers(by_worker)
                    # worker snapshots just refreshed: give the low-memory
                    # killer a chance, then surface a verdict against US
                    handle.poll()
                handle.check()
                if now > deadline:
                    raise TimeoutError("remote query stalled")
            self._collect_task_spans(tasks, parent_span)
            return self._to_result(subplan, batches)
        except BaseException:
            for rt in tasks.values():
                rt.cancel()
            raise
        finally:
            self.memory_manager.unregister_query(qid)
            if client is not None:
                self.resilience.exchange_fetch_failures += \
                    client.stats["fetch_failures"]
                self.resilience.exchange_backoff_trips += \
                    client.stats["backoff_trips"]
            self.resilience.heartbeat_transitions = \
                self.failure_detector.transitions
