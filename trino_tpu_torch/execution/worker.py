"""Worker process: the engine's task control + data plane over HTTP.

The engine's process boundary.  Mirrors Trino's worker surface
(core/trino-main/src/main/java/io/trino/server/TaskResource.java):

- ``POST /v1/task/{task_id}``   create + start a task (TaskResource.java:140)
- ``GET  /v1/task/{task_id}/results/{buffer_id}/{token}``   pull-token page
  stream; a read at token T implicitly acks every earlier page
  (TaskResource.java:333, execution/buffer/ClientBuffer.java:318)
- ``GET  /v1/task/{task_id}/status``   long-pollable task state
- ``DELETE /v1/task/{task_id}``   cancel/abort (TaskResource.java:294)
- ``GET  /v1/info``   node liveness (the heartbeat target)
- ``PUT  /v1/shutdown``   graceful drain-and-exit
  (server/GracefulShutdownHandler.java:42)

The task descriptor travels as a zlib-compressed pickle (the trust domain is
the cluster's own coordinator, matching the reference's JSON-over-HTTP
between mutually-trusted nodes); pages travel as the serde wire format
(execution/serde.py — PageSerializer.java:58's role).

Run as ``python -m trino_tpu_torch.execution.worker --port 0 --device
cuda``; prints ``LISTENING <port>`` on stdout when ready.

The port of the reference ``execution/worker.py``.  What differs:

- The device.  Every task plans and runs on the worker's ``--device``
  (default ``cuda``), which the coordinator passes down as its own; pages
  from upstream tasks are decoded onto it.  Nothing falls back to another
  device: a worker told ``cuda`` on a host without CUDA exits before
  ``LISTENING`` with the reason on stderr, and the coordinator's
  ``WorkerProcess`` raises REMOTE_HOST_GONE with that stderr tail.
- The kernel library.  On a CUDA device the worker binds
  ``build/kernels/libtrino_kernels.so`` at boot (``gpu_kernels._lib(
  build=False)``) and never runs nvcc: the coordinator builds the library
  before it spawns workers, so workers sharing one card do not each
  rebuild a stale library.  It then imports the task path's modules and
  replays the warm-key journal (caching/executable_cache.py
  ``warm_at_boot``, under ``TRINO_TPU_EXEC_WARM``): each journaled key of
  a memo this process registers re-instantiates its program; the others
  are counted as skipped.  ``GET /v1/info`` reports the replay as
  ``warm`` (keys read, warmed, skipped, and its ms).
- Launch counts are per process.  ``GET /v1/info`` keeps the reference's
  ``state`` and ``tasks`` and adds the worker's ``device``, the card's
  name (``device_name``) and ``launches``, the kernel launch counts of
  this process since boot (ops/gpu_kernels.py ``LAUNCHES``): the
  coordinator cannot count launches in another process.
- Descriptors hold no tensor.  :func:`encode_descriptor` refuses one: a
  descriptor is a pickle of the port's plan fragments and control fields,
  and pages cross only as the wire format (execution/serde.py).
"""

from __future__ import annotations

import argparse
import importlib
import io
import json
import pickle
import sys
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

__all__ = ["TaskServer", "build_catalog", "encode_descriptor",
           "decode_descriptor", "main"]


class _NoTensorPickler(pickle.Pickler):
    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError(
                "a task descriptor must hold no tensor (pages cross the "
                f"process boundary as wire bytes): {tuple(obj.shape)} "
                f"{obj.dtype} on {obj.device}")
        return None


def encode_descriptor(desc: dict) -> bytes:
    buf = io.BytesIO()
    _NoTensorPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(desc)
    return zlib.compress(buf.getvalue(), level=1)


def decode_descriptor(data: bytes) -> dict:
    return pickle.loads(zlib.decompress(data))


class _TaskCanceled(Exception):
    """Internal unwind signal: the task was cancelled (DELETE or drain
    escalation) while sitting in an injected stall — terminal state is
    CANCELED, not FAILED, and no error classification applies."""


def build_catalog(spec: dict):
    """spec: {"factory": "module:callable", "kwargs": {...}} — the worker
    reconstructs its catalog locally (split generation happens worker-side;
    only control metadata crosses the wire)."""
    mod, fn = spec["factory"].split(":")
    factory = getattr(importlib.import_module(mod), fn)
    return factory(**spec.get("kwargs", {}))


class _Task:
    def __init__(self, task_id: str):
        self.task_id = task_id
        self.state = "RUNNING"
        self.error: Optional[str] = None
        # spi/errors.py classification of the failure, reported in status
        # JSON so the coordinator can decide fail-fast vs retry without
        # parsing message strings
        self.error_type: Optional[str] = None
        self.error_code: Optional[str] = None
        self.buffer = None  # OutputBuffer, set when planning completes
        # finished task span subtree (tracing.Span.to_dict) — published
        # BEFORE the terminal state so a status read that observes
        # FINISHED/FAILED always sees the span too
        self.span: Optional[dict] = None
        self.ready = threading.Event()
        self.thread: Optional[threading.Thread] = None
        # cluster memory feed: the owning query + the task's device pool
        # (exec/revoking.TaskMemoryContext), reported per status sweep so
        # the coordinator's ClusterMemoryManager can aggregate reservations
        self.query_id: Optional[str] = None
        self.memory = None
        # flight-recorder ring slice for this task (telemetry/profiler.py),
        # harvested just before the terminal state and shipped alongside
        # the span so the coordinator can merge the device timeline
        self.profile: Optional[list] = None

    def status_json(self, include_span: bool = False) -> dict:
        mem = self.memory
        reserved = 0
        if mem is not None:
            reserved = int(mem.pool.reserved + mem.pool.reserved_revocable)
        out = {"state": self.state, "error": self.error,
               "error_type": self.error_type, "error_code": self.error_code,
               "query_id": self.query_id,
               "memory_reserved_bytes": reserved,
               # progress feed for the coordinator's drain/straggler logic:
               # planning done + pages produced so far
               "ready": self.ready.is_set(),
               "pages_out": getattr(self.buffer, "pages_enqueued", 0)}
        if include_span and self.span is not None:
            out["span"] = self.span
        if include_span and self.profile:
            out["profile"] = self.profile
        return out


class TaskServer:
    """The worker's HTTP surface; every task runs on ``device``."""

    def __init__(self, port: int = 0, device="cuda",
                 warm: Optional[dict] = None):
        from ..spi import knobs
        from .tracing import Tracer

        self.device = torch.device(device)
        # the boot's warm-key replay (executable_cache.warm_at_boot), or
        # None where no replay ran (a TaskServer on a thread)
        self.warm = warm
        self.tasks: dict[str, _Task] = {}
        self._lock = threading.Lock()
        self._draining = False
        # set when a drain had to abandon running tasks at the deadline —
        # the process then exits with code 9 (vs 0 for a clean drain) so
        # the coordinator/operator can tell the two apart
        self.drain_timed_out = False
        # worker-local span collector: task spans are remote-parented from
        # the coordinator's traceparent header and shipped back (serialized)
        # with task completion
        self.tracer = Tracer(keep=200)
        # per-spawn shared secret (reference: InternalCommunicationConfig
        # sharedSecret): descriptors are pickles, so only the process tree
        # holding the secret may reach any endpoint that decodes or mutates
        self.secret = knobs.get_str("TRINO_TPU_INTERNAL_SECRET") or None
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes = b"",
                      content_type: str = "application/json",
                      headers: Optional[dict] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    server._get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    try:
                        self._send(500, json.dumps(
                            {"error": repr(e)}).encode())
                    # a double fault: the peer hung up during the 500
                    except Exception:
                        pass

            def do_POST(self):
                try:
                    server._post(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, json.dumps({"error": repr(e)}).encode())

            def do_DELETE(self):
                try:
                    server._delete(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, json.dumps({"error": repr(e)}).encode())

            def do_PUT(self):
                try:
                    server._put(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, json.dumps({"error": repr(e)}).encode())

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]

    def info(self) -> dict:
        """``/v1/info``: the reference's ``state`` and ``tasks``, then the
        port's ``device``, ``device_name``, ``launches`` (this process's
        kernel launches since boot) and ``warm`` (the boot's warm-key
        replay)."""
        from ..ops import gpu_kernels as GK

        name = str(self.device)
        if self.device.type == "cuda":
            name = torch.cuda.get_device_name(self.device)
        return {"state": "SHUTTING_DOWN" if self._draining else "ACTIVE",
                "tasks": len(self.tasks), "device": str(self.device),
                "device_name": name, "launches": dict(GK.LAUNCHES),
                "warm": self.warm}

    # ------------------------------------------------------------ handlers
    def _authorized(self, h) -> bool:
        import hmac

        if self.secret is None:
            return True
        if hmac.compare_digest(
                h.headers.get("X-Trino-Internal-Bearer") or "", self.secret):
            return True
        h._send(401, b'{"error": "missing or bad internal secret"}')
        return False

    def _get(self, h) -> None:
        from urllib.parse import parse_qs, urlsplit

        url = urlsplit(h.path)
        query = parse_qs(url.query)
        parts = [p for p in url.path.split("/") if p]
        if parts == ["v1", "info"]:
            h._send(200, json.dumps(self.info()).encode())
            return
        if parts == ["v1", "metrics"]:
            from ..telemetry.metrics import REGISTRY

            # ?format=json ships the raw registry snapshot — the structured
            # form the coordinator's scope=cluster fold merges (Prometheus
            # text can't be merged without re-parsing)
            if query.get("format", [""])[0] == "json":
                h._send(200, json.dumps(REGISTRY.snapshot()).encode())
                return
            # Prometheus text exposition of the worker-process registry
            h._send(200, REGISTRY.render_prometheus().encode(),
                    "text/plain; version=0.0.4")
            return
        if parts == ["v1", "status"]:
            # the heartbeat target: node state + EVERY task's state in one
            # payload, so the coordinator sweeps one poll per worker
            # (failure_detector.py caches this).  Spans stay out of the
            # sweep — they're fetched per task on completion.
            h._send(200, json.dumps({
                "state": "SHUTTING_DOWN" if self._draining else "ACTIVE",
                "tasks": {tid: t.status_json()
                          for tid, t in list(self.tasks.items())},
            }).encode())
            return
        if len(parts) == 4 and parts[:2] == ["v1", "task"] and \
                parts[3] == "status":
            t = self.tasks.get(parts[2])
            if t is None:
                h._send(404, b'{"error": "no such task"}')
                return
            h._send(200, json.dumps(t.status_json(
                include_span=True)).encode())
            return
        if len(parts) == 6 and parts[:2] == ["v1", "task"] and \
                parts[3] == "results":
            if not self._authorized(h):
                return
            # ?maxwait= bounds the server-side long-poll so short
            # non-blocking client polls return promptly (default keeps the
            # historical 5 s long-poll)
            try:
                maxwait = float(query.get("maxwait", ["5.0"])[0])
            except ValueError:
                maxwait = 5.0
            maxwait = min(max(maxwait, 0.0), 5.0)
            self._get_results(h, parts[2], int(parts[4]), int(parts[5]),
                              maxwait)
            return
        h._send(404, b'{"error": "not found"}')

    def _get_results(self, h, task_id: str, buffer_id: int,
                     token: int, maxwait: float = 5.0) -> None:
        """Pull-token page read (TaskResource.getResults equivalent): body
        is length-prefixed serde frames; X-Next-Token / X-Done carry the
        protocol state.  ``maxwait`` bounds both blocking waits so the
        handler never outlives the client's own poll budget."""
        import struct

        t = self.tasks.get(task_id)
        if t is None:
            h._send(404, b'{"error": "no such task"}')
            return
        if t.state == "FAILED":
            h._send(500, json.dumps({
                "error": t.error, "error_type": t.error_type,
                "error_code": t.error_code}).encode())
            return
        if t.state == "CANCELED":
            # e.g. abandoned by a timed-out drain: report a retryable
            # EXTERNAL failure so retry_policy=QUERY re-runs the query
            # instead of waiting on a stream that will never finish
            h._send(500, json.dumps({
                "error": t.error or f"task {task_id} canceled on worker",
                "error_type": "EXTERNAL",
                "error_code": "REMOTE_TASK_ERROR"}).encode())
            return
        if not t.ready.wait(timeout=maxwait) or t.buffer is None:
            h._send(200, b"", "application/x-trino-pages",
                    {"X-Next-Token": token, "X-Done": 0})
            return
        pages, next_token, done = t.buffer.get(
            buffer_id, token, timeout=min(maxwait, 1.0))
        if done and t.buffer.aborted:
            # an aborted stream NEVER reads as a clean end-of-stream: the
            # producer is failing or was cancelled, but its thread may not
            # have recorded the verdict yet (buffer.abort() precedes the
            # state flip).  Wait briefly for the real error, else report a
            # retryable transport error — otherwise the consumer completes
            # the query with a truncated/empty "successful" result.
            deadline = time.monotonic() + min(maxwait, 2.0)
            while t.state == "RUNNING" and time.monotonic() < deadline:
                time.sleep(0.01)
            h._send(500, json.dumps({
                "error": t.error or f"task {task_id} output aborted",
                "error_type": t.error_type or "EXTERNAL",
                "error_code": t.error_code or "REMOTE_TASK_ERROR",
            }).encode())
            return
        body = bytearray()
        for p in pages:
            raw = p.data if hasattr(p, "data") else None
            if raw is None:  # unserialized batch (non-serde sink): encode
                from .serde import serialize_batch

                raw = serialize_batch(p)
            body += struct.pack("<I", len(raw))
            body += raw
        h._send(200, bytes(body), "application/x-trino-pages",
                {"X-Next-Token": next_token, "X-Done": int(done)})

    def _post(self, h) -> None:
        if not self._authorized(h):
            return
        parts = [p for p in h.path.split("/") if p]
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            if self._draining:
                h._send(503, b'{"error": "shutting down"}')
                return
            n = int(h.headers.get("Content-Length", 0))
            desc = decode_descriptor(h.rfile.read(n))
            task_id = parts[2]
            with self._lock:
                if task_id in self.tasks:
                    h._send(200, b'{"state": "RUNNING"}')
                    return
                t = _Task(task_id)
                self.tasks[task_id] = t
            t.thread = threading.Thread(
                target=self._run_task,
                args=(t, desc, h.headers.get("traceparent")), daemon=True,
                name=f"task-{task_id}")
            t.thread.start()
            h._send(200, b'{"state": "RUNNING"}')
            return
        h._send(404, b'{"error": "not found"}')

    def _delete(self, h) -> None:
        if not self._authorized(h):
            return
        parts = [p for p in h.path.split("/") if p]
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            t = self.tasks.get(parts[2])
            if t is not None:
                if t.buffer is not None:
                    t.buffer.abort()
                t.state = "CANCELED" if t.state == "RUNNING" else t.state
                h._send(200, b'{"state": "CANCELED"}')
                return
        h._send(404, b'{"error": "not found"}')

    def _put(self, h) -> None:
        from urllib.parse import parse_qs, urlsplit

        if not self._authorized(h):
            return
        url = urlsplit(h.path)
        parts = [p for p in url.path.split("/") if p]
        if parts == ["v1", "shutdown"]:
            # graceful drain: refuse new tasks, exit once current ones end
            # (bounded — ?timeout_s= overrides TRINO_TPU_DRAIN_TIMEOUT_S)
            from ..spi import knobs

            try:
                timeout_s = float(parse_qs(url.query).get(
                    "timeout_s",
                    [knobs.get_str("TRINO_TPU_DRAIN_TIMEOUT_S")])[0])
            except ValueError:
                timeout_s = 300.0
            self._draining = True
            h._send(200, b'{"state": "SHUTTING_DOWN"}')
            threading.Thread(target=self._drain_and_exit,
                             args=(timeout_s,), daemon=True).start()
            return
        h._send(404, b'{"error": "not found"}')

    def _task_drained(self, t: _Task) -> bool:
        # a task may leave the drain only when it stopped running AND its
        # unfetched output is gone (fully acked or aborted) — exiting on
        # state alone would drop pages a consumer has not pulled yet
        if t.state == "RUNNING":
            return False
        b = t.buffer
        return b is None or b.drained

    def _drain_and_exit(self, timeout_s: float = 300.0) -> None:
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            if all(self._task_drained(t) for t in list(self.tasks.values())):
                break
            time.sleep(0.05)
        else:
            abandoned = [tid for tid, t in list(self.tasks.items())
                         if not self._task_drained(t)]
            if abandoned:
                self.drain_timed_out = True
                print(f"DRAIN TIMEOUT after {timeout_s:.1f}s "
                      f"abandoning tasks: {sorted(abandoned)}",
                      file=sys.stderr, flush=True)
                for tid in abandoned:
                    t = self.tasks.get(tid)
                    if t is None:
                        continue
                    if t.state == "RUNNING":
                        t.state = "CANCELED"
                    if t.buffer is not None:
                        t.buffer.abort()
        self.httpd.shutdown()

    # ------------------------------------------------------------ execution
    def _run_task(self, t: _Task, desc: dict,
                  traceparent_header: Optional[str] = None) -> None:
        import time as _time

        from ..telemetry import metrics as tm
        from ..telemetry import runtime as rt
        from .tracing import annotate_scan_span, parse_traceparent

        tm.TASKS_CREATED.inc()
        worker_addr = f"127.0.0.1:{self.port}"
        trec = rt.task_started(
            str(desc.get("query_id", "")), t.task_id,
            getattr(desc.get("fragment"), "id", -1),
            desc.get("task_index", -1), worker_addr)
        t0 = _time.perf_counter()
        # flight recorder: this thread's ring events attribute to the
        # coordinator-assigned (worker-visible) query id + this task
        from ..telemetry import profiler

        profiler.set_context(str(desc.get("query_id", "")), t.task_id)
        pt0 = profiler.now()
        # remote-parented span: the coordinator's traceparent header makes
        # this a local root carrying the query's trace identity; the ctx is
        # entered/exited explicitly so the span can close (and publish to
        # t.span) BEFORE the terminal state becomes visible
        ctx = self.tracer.span(
            "trino.task", remote=parse_traceparent(traceparent_header),
            **{"trino.task.id": t.task_id,
               "trino.task.worker": worker_addr})
        sp = ctx.__enter__()
        writer = None
        local = None
        state = "FINISHED"
        try:
            from ..exec.driver import run_pipelines
            from ..exec.local_planner import LocalPlanner
            from .durable_spool import DurableSpoolClient, DurableSpoolWriter
            from .exchange import OutputBuffer
            from .failure_injector import (
                GET_RESULTS_FAILURE,
                PROCESS_EXIT,
                TASK_FAILURE,
                TASK_OOM,
                TASK_STALL,
                InjectedFailure,
                check_wire_rules,
                match_wire_rule,
                sleep_with_cancel,
            )
            from .remote import HttpExchangeClient
            from .task import PartitionedOutputSink

            catalog = build_catalog(desc["catalog"])
            fragment = desc["fragment"]
            task_index = desc["task_index"]
            t.query_id = desc.get("query_id")
            # streaming descriptors carry the query-retry attempt at the top
            # level; FTE descriptors keep it inside the spool block
            attempt = desc.get(
                "attempt", desc.get("spool", {}).get("attempt", 0))
            rules = desc.get("failure_rules", [])
            if check_wire_rules(rules, PROCESS_EXIT, fragment.id,
                                task_index, attempt):
                # the real "node died" case: kill the whole worker process
                import os as _os

                _os._exit(17)
            if check_wire_rules(rules, TASK_FAILURE, fragment.id,
                                task_index, attempt):
                raise InjectedFailure(
                    f"injected TASK_FAILURE f{fragment.id}.t{task_index} "
                    f"attempt {attempt}")
            if check_wire_rules(rules, TASK_OOM, fragment.id, task_index,
                                attempt):
                from ..spi.memory import ExceededMemoryLimitError

                raise ExceededMemoryLimitError(
                    f"injected-oom f{fragment.id}.t{task_index}", 1 << 40, 0)
            stall = match_wire_rule(rules, TASK_STALL, fragment.id,
                                    task_index, attempt)
            if stall is not None and stall.get("stall_s"):
                # the stall polls the task's cancel flag (DELETE handler /
                # drain escalation both flip state off RUNNING) so an
                # injected straggler cannot outlive its query
                sleep_with_cancel(float(stall["stall_s"]),
                                  lambda: t.state != "RUNNING")
                if t.state != "RUNNING":
                    raise _TaskCanceled()
            if desc.get("upstream") and check_wire_rules(
                    rules, GET_RESULTS_FAILURE, fragment.id, task_index,
                    attempt):
                # streaming analogue of the FTE spool-read fault: the task's
                # exchange fetch from its producers fails
                raise InjectedFailure(
                    f"injected GET_RESULTS_FAILURE f{fragment.id}."
                    f"t{task_index} attempt {attempt}")

            clients = {}
            if "spool_upstream" in desc and desc["spool_upstream"]:
                def on_read(_d, _f=fragment.id, _t=task_index, _a=attempt):
                    if check_wire_rules(rules, GET_RESULTS_FAILURE, _f, _t,
                                        _a):
                        raise InjectedFailure("injected GET_RESULTS_FAILURE")

                for src_id, info in desc["spool_upstream"].items():
                    if info.get("merge"):
                        clients[src_id] = [
                            DurableSpoolClient([d], task_index, on_read,
                                               self.device)
                            for d in info["dirs"]
                        ]
                    else:
                        clients[src_id] = DurableSpoolClient(
                            info["dirs"], task_index, on_read, self.device)
            backoff_cfg = desc.get("exchange_backoff")
            # this task's exchange fetches carry ITS span as the trace
            # context (trace_id stays the query's)
            from .tracing import traceparent as _tp

            task_tp = _tp(sp)
            for src_id, info in desc.get("upstream", {}).items():
                uris = info["uris"]
                if info.get("merge"):
                    clients[src_id] = [
                        HttpExchangeClient([u], task_index,
                                           backoff=backoff_cfg,
                                           traceparent=task_tp,
                                           device=self.device)
                        for u in uris
                    ]
                else:
                    clients[src_id] = HttpExchangeClient(
                        uris, task_index, backoff=backoff_cfg,
                        traceparent=task_tp, device=self.device)
            planner = LocalPlanner(
                catalog, self.device,
                splits_per_node=desc.get("splits_per_node", 4),
                node_count=desc.get("node_count", 1),
                task_index=task_index,
                task_count=desc["task_count"],
                remote_clients=clients,
                dynamic_filtering=desc.get("dynamic_filtering", True),
                hbm_limit_bytes=desc.get("hbm_limit_bytes", 16 << 30),
                spill_to_disk_bytes=desc.get("spill_to_disk_bytes", 0),
            )
            t.memory = planner.memory
            local = planner.plan(fragment.root)
            if "spool" in desc:  # FTE: durable on-disk attempt spool
                spool = desc["spool"]
                writer = DurableSpoolWriter(
                    spool["task_dir"], spool["attempt"],
                    spool["num_partitions"])
                out = writer
            else:
                out = OutputBuffer(desc["num_partitions"])
            sink = PartitionedOutputSink(
                out,
                fragment.output_kind if fragment.output_kind != "OUTPUT"
                else "GATHER",
                fragment.output_keys, serde=True)
            local.pipelines[-1][-1] = sink
            if writer is None:
                t.buffer = out
            t.ready.set()
            run_pipelines(local.pipelines)
        except _TaskCanceled:
            state = "CANCELED"
            sp.set("canceled", True)
            if t.buffer is not None:
                t.buffer.abort()
            if writer is not None:
                writer.abort()
            t.ready.set()
        except BaseException as e:  # noqa: BLE001 — reported to coordinator
            from ..spi.errors import classify

            te = classify(e)
            t.error = f"{type(e).__name__}: {e}"
            t.error_type = te.error_type
            t.error_code = te.code.name
            state = "FAILED"
            sp.set("error", type(e).__name__)
            if t.buffer is not None:
                t.buffer.abort()
            if writer is not None:
                writer.abort()
            t.ready.set()
        try:
            if local is not None:
                from ..exec.driver import (collect_encoding_stats,
                                           collect_scan_stats)

                ingest = collect_scan_stats(local.pipelines)
                annotate_scan_span(sp, ingest)
                tm.observe_scan(ingest)
                tm.observe_encoding(collect_encoding_stats(local.pipelines))
        except Exception:  # noqa: BLE001 — stats never fail a task
            pass
        try:
            ctx.__exit__(None, None, None)
            t.span = sp.to_dict()  # span visible before terminal state read
            profiler.event(profiler.TASK, t.task_id, pt0, state=state)
            # sweep the ring slice for this task (run_pipelines group
            # threads inherited the context, so their operator events are
            # included) BEFORE the terminal state so a status read that
            # observes FINISHED/FAILED always sees the profile too
            t.profile = profiler.take_task_events(
                str(desc.get("query_id", "")), t.task_id)
            tm.TASK_WALL_SECONDS.record(_time.perf_counter() - t0)
            if state == "FAILED":
                tm.TASKS_FAILED.inc()
            rt.task_finished(trec, state, error=t.error)
        finally:
            # the terminal state MUST always land: a coordinator polling
            # status would otherwise wait on a RUNNING task forever
            t.state = state

    def serve_forever(self) -> None:
        self.httpd.serve_forever()


def _boot_device(device: str):
    """The worker's device, refused (before ``LISTENING``) when it cannot
    be used: nothing falls back to another device.  On a CUDA device the
    kernel library is bound here, never built."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"worker --device {device}: CUDA is not available on this "
                "host (pass the coordinator's device; a CPU coordinator "
                "spawns --device cpu workers)")
        torch.cuda.init()
        from ..ops import gpu_kernels as GK

        GK._lib(build=False)
    return dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device every task runs on (default cuda)")
    args = ap.parse_args(argv)
    try:
        device = _boot_device(args.device)
    except Exception as e:  # noqa: BLE001 — reported, then exit
        print(f"worker boot failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.exit(4)
    # the task path's modules, imported before LISTENING so the first
    # task does not pay for them
    from ..caching import executable_cache
    from ..exec import driver, local_planner  # noqa: F401
    from . import durable_spool, exchange, remote, task  # noqa: F401
    warm = executable_cache.warm_at_boot()
    server = TaskServer(args.port, device, warm=warm)
    print(f"LISTENING {server.port}", flush=True)
    server.serve_forever()
    # serve_forever returns when a drain shut the server down; exit code 9
    # distinguishes "drain abandoned tasks at the deadline" from a clean 0
    sys.exit(9 if server.drain_timed_out else 0)


if __name__ == "__main__":
    main()
