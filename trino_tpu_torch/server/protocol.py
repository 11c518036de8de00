"""REST statement protocol: POST /v1/statement + nextUri paging.

The stdlib-only analogue of the reference's client protocol
(core/trino-main/.../dispatcher/QueuedStatementResource.java:104 +
protocol/ExecutingStatementResource + docs/src/main/sphinx/develop/
client-protocol.md): a client POSTs SQL, receives a query id and a
``nextUri``, and follows nextUri until ``state`` is FINISHED, collecting
``columns`` + ``data`` pages along the way.  DELETE cancels.

The dispatcher runs queries on a bounded worker pool (the miniature of
dispatcher/DispatchManager + resource-group admission) against either
runner; results are paged back JSON-encoded.

The port of the reference ``server/protocol.py``: the routes, the paging
and the JSON (``columns``, ``data``, ``state``, ``error``, and
:func:`_json_value`'s encoding of decimals, dates and NaN) are the
reference's, so one statement gives the same payloads from both servers.
The runner behind it runs on its own device (the card by default); the
server itself is host-only.
"""

from __future__ import annotations

import json
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["QueryDispatcher", "TrinoTpuServer"]

_PAGE_ROWS = 4096


def _json_value(v):
    import datetime
    import decimal

    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, datetime.date):
        return v.isoformat()
    if isinstance(v, float) and v != v:  # NaN
        return "NaN"
    return v


class _Query:
    def __init__(self, qid: str, sql: str):
        self.id = qid
        self.sql = sql
        self.state = "QUEUED"
        self.error: Optional[str] = None
        self.columns: Optional[list] = None
        self.rows: list = []
        self.done = threading.Event()
        self.cancelled = False
        self.recovered = False  # rehydrated from the query-state WAL


def _claimed_spool_roots() -> list:
    """With the HA fleet on, the spool roots of the in-flight queries in
    the WAL directories this node claimed from dead peers: their leases
    name a dead pid, and the boot sweep must not reclaim them before
    ``HACoordinator.start`` adopts the queries again.  Nothing with HA
    off."""
    from ..execution import ha, query_state

    if not (ha.ha_enabled() and ha.ha_dir()):
        return []
    return [pq.spool_root
            for d in ha.claimed_wal_dirs(ha.node_id())
            for pq in query_state.pending(d) if pq.spool_root]


class QueryDispatcher:
    """Admission + execution: a bounded pool of query slots (the stand-in
    for DispatchManager + resource groups).  At boot it also runs
    coordinator crash recovery: in-flight ``retry_policy="TASK"`` queries
    found in the query-state WAL are re-registered under their ORIGINAL
    query ids (so clients reattach through the unchanged
    ``GET /v1/statement/{id}/{token}`` surface) and resumed from their
    committed-attempt maps; afterwards the leaked-spool sweep reclaims
    every spool root no live query owns."""

    def __init__(self, runner, max_concurrent: int = 4,
                 recover: bool = True):
        self.runner = runner
        self.pool = ThreadPoolExecutor(max_workers=max_concurrent)
        self.queries: dict[str, _Query] = {}
        self._lock = threading.Lock()
        self.recovered_query_ids: list[str] = []
        if recover:
            self._recover_and_sweep()

    def _recover_and_sweep(self) -> None:
        from ..execution import query_state, spool_gc

        pending = []
        try:
            if hasattr(self.runner, "pending_fte_recoveries"):
                pending = self.runner.pending_fte_recoveries()
        except Exception:
            pending = []
        keep = []
        for pq in pending:
            if self.adopt(pq) and pq.spool_root:
                keep.append(pq.spool_root)
        keep.extend(_claimed_spool_roots())
        try:
            query_state.prune_ended()
            # roots under recovery are pinned; everything else follows
            # lease/TTL/budget rules
            spool_gc.sweep(keep=keep)
        except Exception:
            pass

    def adopt(self, pq) -> bool:
        """Register one WAL-recovered query under its ORIGINAL id and
        resume it.  Shared by boot-time self-recovery and HA lease
        takeover (execution/ha.py), where the WAL dir being adopted
        belonged to a dead fleet peer.  False if the id is already live
        here (double-adoption guard)."""
        with self._lock:
            if pq.query_id in self.queries:
                return False
            q = _Query(pq.query_id, pq.sql)
            q.recovered = True
            self.queries[q.id] = q
        self.recovered_query_ids.append(pq.query_id)
        self.pool.submit(self._resume, q, pq)
        return True

    def in_flight(self) -> int:
        """Queries registered and not yet done (lease-file enrichment and
        the runtime.coordinators table)."""
        with self._lock:
            return sum(1 for q in self.queries.values()
                       if not q.done.is_set())

    MAX_RETAINED = 256

    def submit(self, sql: str, qid: Optional[str] = None) -> _Query:
        """``qid`` lets the HA front tier pre-assign the query id it hashed
        the owning coordinator from, so routing and identity agree."""
        from ..telemetry.metrics import DISPATCHER_QUERIES

        DISPATCHER_QUERIES.inc()
        q = _Query(qid or uuid.uuid4().hex[:16], sql)
        with self._lock:
            self.queries[q.id] = q
            # bound the registry: evict oldest finished queries (the
            # reference expires results once the client stops polling)
            finished = [k for k, v in self.queries.items() if v.done.is_set()]
            for k in finished[:max(0, len(self.queries) - self.MAX_RETAINED)]:
                del self.queries[k]
        self.pool.submit(self._run, q)
        return q

    def _run(self, q: _Query) -> None:
        if q.cancelled:
            q.state = "CANCELED"
            q.done.set()
            return
        try:
            self._await_memory(q)
        except Exception as e:
            q.error = f"{type(e).__name__}: {e}"
            q.state = "FAILED"
            q.done.set()
            return
        if q.cancelled:
            q.state = "CANCELED"
            q.done.set()
            return
        q.state = "RUNNING"
        try:
            # the protocol query id IS the engine query id, so the flight
            # recorder's /v1/query/{id}/profile resolves without a mapping
            result = self.runner.execute(q.sql, query_id=q.id)
            self._deliver(q, result)
        except Exception as e:  # surfaced through the protocol, not the log
            q.error = f"{type(e).__name__}: {e}"
            q.state = "FAILED"
        q.done.set()

    def _resume(self, q: _Query, pq) -> None:
        """Run one crash-recovered query to completion under its original
        id; a client that survived the coordinator restart keeps polling
        the same nextUri and sees the query finish."""
        if q.cancelled:
            q.state = "CANCELED"
            q.done.set()
            return
        q.state = "RUNNING"
        try:
            self._deliver(q, self.runner.resume_fte_query(pq))
        except Exception as e:
            q.error = f"{type(e).__name__}: {e}"
            q.state = "FAILED"
        q.done.set()

    def _deliver(self, q: _Query, result) -> None:
        if q.cancelled:
            # the engine ran to completion (no mid-kernel interruption
            # yet), but a cancelled query must not deliver results
            q.state = "CANCELED"
            return
        q.columns = [
            {"name": n, "type": str(t)}
            for n, t in zip(result.names, result.batch.types)
        ]
        q.rows = [[_json_value(v) for v in row] for row in result.rows()]
        q.state = "FINISHED"

    def _await_memory(self, q: _Query) -> None:
        """Memory-aware admission: estimate the query's peak from the
        query-record history of the same plan fingerprint (telemetry
        runtime.fingerprint) and hold it QUEUED while the cluster lacks
        headroom — admitting into certain OOM just feeds the killer.
        Raises QUERY_QUEUED_TIMEOUT (USER, never retried) when the wait
        budget runs out.  No-op when the runner has no memory manager or
        the cluster is uncapped."""
        mm = getattr(self.runner, "memory_manager", None)
        if mm is None or mm.capacity_bytes is None:
            return
        import time

        from ..execution.resource_manager import estimate_peak_memory
        from ..spi import knobs
        from ..spi.errors import QUERY_QUEUED_TIMEOUT, TrinoError
        from ..telemetry import metrics as tm
        from ..telemetry.runtime import fingerprint

        default = knobs.get_int("TRINO_TPU_QUERY_DEFAULT_MEMORY")
        est = estimate_peak_memory(fingerprint(q.sql), default)
        budget = getattr(getattr(self.runner, "session", None),
                         "query_queued_timeout_s", 300.0)
        t0 = time.monotonic()
        while not mm.can_admit(est):
            if q.cancelled:
                return
            if time.monotonic() - t0 > budget:
                raise TrinoError(
                    QUERY_QUEUED_TIMEOUT,
                    f"queued {budget:.0f}s waiting for {est} bytes of "
                    f"cluster memory (free: {mm.cluster_free_bytes()})")
            mm.maybe_enforce()
            time.sleep(0.05)
        waited = time.monotonic() - t0
        if waited > 0.05:
            tm.ADMISSION_QUEUED_SECONDS.record(waited)

    def get(self, qid: str) -> Optional[_Query]:
        with self._lock:
            return self.queries.get(qid)

    def cancel(self, qid: str) -> bool:
        q = self.get(qid)
        if q is None:
            return False
        q.cancelled = True
        return True


class _Handler(BaseHTTPRequestHandler):
    dispatcher: QueryDispatcher = None  # set by TrinoTpuServer

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _query_payload(self, q: _Query, token: int) -> dict:
        out = {
            "id": q.id,
            "stats": {"state": q.state},
        }
        if q.state in ("QUEUED", "RUNNING"):
            out["nextUri"] = f"/v1/statement/{q.id}/{token}"
            return out
        if q.state == "FAILED":
            out["error"] = {"message": q.error}
            return out
        # FINISHED: page the rows out
        if q.columns is not None:
            out["columns"] = q.columns
        start = token * _PAGE_ROWS
        page = q.rows[start:start + _PAGE_ROWS]
        if page:
            out["data"] = page
        if start + _PAGE_ROWS < len(q.rows):
            out["nextUri"] = f"/v1/statement/{q.id}/{token + 1}"
        return out

    def do_POST(self):
        if self.path.rstrip("/") != "/v1/statement":
            self._send(404, {"error": {"message": "not found"}})
            return
        length = int(self.headers.get("Content-Length", "0"))
        sql = self.rfile.read(length).decode("utf-8")
        qid = (self.headers.get("X-Trino-Tpu-Query-Id") or "").strip() or None
        q = self.dispatcher.submit(sql, qid=qid)
        self._send(200, self._query_payload(q, 0))

    def _cluster_metrics(self) -> str:
        """One Prometheus exposition for the whole cluster: the coordinator
        registry folded with every live worker's snapshot (counters summed,
        distributions merged bucket-wise).  A dead worker is skipped — a
        scrape must never fail because one node is down."""
        from ..telemetry import metrics as tm

        snaps = []
        for w in getattr(self.dispatcher.runner, "workers", None) or []:
            url = getattr(w, "url", None)
            if not url:
                continue
            try:
                from ..execution.remote import _http

                with _http("GET", f"{url}/v1/metrics?format=json",
                           timeout=5.0) as resp:
                    snaps.append(json.loads(resp.read()))
            except Exception:  # noqa: BLE001 — a dead worker is skipped
                continue
        return tm.render_cluster(snaps)

    def do_GET(self):
        from urllib.parse import parse_qs, urlsplit

        url = urlsplit(self.path)
        qs = parse_qs(url.query)
        parts = [p for p in url.path.split("/") if p]
        if parts == ["v1", "metrics"]:
            # Prometheus text exposition — coordinator-process registry, or
            # the merged cluster fold with ?scope=cluster (_send is
            # JSON-only, so write the text inline)
            from ..telemetry.metrics import REGISTRY

            if qs.get("scope", [""])[0] == "cluster":
                body = self._cluster_metrics().encode("utf-8")
            else:
                body = REGISTRY.render_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if parts == ["v1", "caches"]:
            # per-tier cache-plane stats (same rows as system.runtime.caches)
            from .. import caching

            self._send(200, {"caches": caching.cache_rows(
                per_exec_cache=qs.get("detail", [""])[0] == "1")})
            return
        if len(parts) == 4 and parts[:2] == ["v1", "query"] and \
                parts[3] == "profile":
            # flight-recorder timeline as Chrome trace_event JSON
            from ..telemetry import profiler

            trace = profiler.chrome_trace(parts[2])
            if trace is None:
                self._send(404, {"error": {
                    "message": f"no profile for query {parts[2]}"}})
            else:
                self._send(200, trace)
            return
        # /v1/statement/{id}/{token}
        if len(parts) != 4 or parts[:2] != ["v1", "statement"]:
            self._send(404, {"error": {"message": "not found"}})
            return
        q = self.dispatcher.get(parts[2])
        if q is None:
            self._send(404, {"error": {"message": "unknown query"}})
            return
        # brief server-side wait cuts client poll round trips
        q.done.wait(timeout=0.5)
        self._send(200, self._query_payload(q, int(parts[3])))

    def do_DELETE(self):
        parts = self.path.strip("/").split("/")
        if len(parts) >= 3 and parts[:2] == ["v1", "statement"]:
            ok = self.dispatcher.cancel(parts[2])
            self._send(200 if ok else 404, {"cancelled": ok})
            return
        self._send(404, {"error": {"message": "not found"}})


class TrinoTpuServer:
    """In-process HTTP server hosting the statement protocol."""

    def __init__(self, runner, host: str = "127.0.0.1", port: int = 0,
                 max_concurrent: int = 4):
        self.dispatcher = QueryDispatcher(runner, max_concurrent)
        handler = type("_BoundHandler", (_Handler,),
                       {"dispatcher": self.dispatcher})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        # TRINO_TPU_AUTOSCALE=1: the elastic worker fleet's controller
        # (execution/ha.WorkerAutoscaler), running while the server does
        self.autoscaler = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> "TrinoTpuServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="trino-tpu-http",
            daemon=True)
        self._thread.start()
        self._start_autoscaler()
        return self

    def _start_autoscaler(self) -> None:
        """With ``TRINO_TPU_AUTOSCALE=1``, a controller grows and drains
        the runner's workers by the ``TRINO_TPU_AUTOSCALE_*`` knobs: worker
        processes on the process runner, logical drains on the in-process
        one.  A runner with no workers to scale gets none."""
        from ..spi import knobs

        runner = self.dispatcher.runner
        if not knobs.get_bool("TRINO_TPU_AUTOSCALE") or not (
                hasattr(runner, "remove_worker")
                or hasattr(runner, "drain_worker")):
            return
        from ..execution.ha import WorkerAutoscaler

        self.autoscaler = WorkerAutoscaler(runner).start()

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
