"""Tracing: per-query span trees (the OpenTelemetry role).

The port of the reference ``execution/tracing.py``: spans, the tracer,
W3C traceparent propagation and the scan, host-sync, fused-stage,
resident-plan and resilience annotations.  It mirrors Trino's tracing layer
(tracing/TracingMetadata.java:121 decorators, tracing/TrinoAttributes.java
span vocabulary, spans per query/stage/task propagated into workers)
without the OTel SDK dependency:
spans are plain objects collected per query; an exporter hook receives
finished root spans (plug an OTLP exporter there in a deployment).  The
attribute names follow the reference's ``trino.*`` vocabulary."""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["Span", "Tracer", "traceparent", "parse_traceparent",
           "annotate_scan_span", "annotate_sync_span", "annotate_fused_span",
           "annotate_resident_span", "annotate_resilience_span"]


# ids from the process's seeded generator, not the system's entropy: one
# system call fewer a span (OpenTelemetry's default id generator does the
# same)
def _new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"  # the W3C trace-id width


def _new_span_id() -> str:
    return f"{random.getrandbits(64):016x}"  # the W3C span-id width


def traceparent(span: "Span") -> str:
    """W3C-traceparent-style header value for propagating ``span`` as the
    remote parent across the HTTP plane (reference:
    tracing/TracingMetadata.java:121 injecting context into task calls)."""
    if not span.trace_id:
        span.trace_id = _new_trace_id()
    if not span.span_id:
        span.span_id = _new_span_id()
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[tuple[str, str]]:
    """``"00-<trace>-<span>-01"`` -> (trace_id, parent_span_id), or None on
    anything malformed (propagation is best-effort, never a failure)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


def annotate_sync_span(span: "Span", sync) -> None:
    """Set the ``trino.exec.*`` host-transfer attributes from a SyncGuard
    SyncStats delta (exec/syncguard.py), so exporters see how many times the
    operator hot path crossed the device boundary next to the wall time."""
    if sync is None or not sync.host_syncs:
        return
    span.set("trino.exec.host-syncs", sync.host_syncs)
    span.set("trino.exec.blocking-syncs", sync.blocking_syncs)
    span.set("trino.exec.hot-loop-syncs", sync.hot_loop_syncs)
    span.set("trino.exec.async-polls", sync.async_polls)
    span.set("trino.exec.async-poll-hits", sync.poll_hits)
    span.set("trino.exec.expand-overflows", sync.expand_overflows)
    span.set("trino.exec.expand-retries", sync.expand_retries)


def annotate_fused_span(span: "Span", fs) -> None:
    """Set the ``trino.fused.*`` attributes from a FusedStageStats roll-up
    (exec/stats.py): whole-stage compile counts, shape-bucket cache hits and
    per-batch dispatch counts next to the query wall time."""
    if fs is None or not fs.any:
        return
    span.set("trino.fused.stages", fs.stages)
    span.set("trino.fused.batches", fs.batches)
    span.set("trino.fused.input-rows", fs.input_rows)
    span.set("trino.fused.jit-calls", fs.jit_calls)
    span.set("trino.fused.compiles", fs.compiles)
    span.set("trino.fused.cache-hits", fs.cache_hits)
    span.set("trino.fused.seam-merges", fs.merges)
    span.set("trino.fused.fallbacks", fs.fallbacks)


def annotate_resident_span(span: "Span", rs) -> None:
    """Set the ``trino.resident.*`` attributes from a ResidentPlanStats
    roll-up (exec/stats.py): whole-plan program counts, in-program seam
    fusion and the launches/batch figure next to the query wall time."""
    if rs is None or not rs.any:
        return
    span.set("trino.resident.plans", rs.plans)
    span.set("trino.resident.seams", rs.seams)
    span.set("trino.resident.batches", rs.batches)
    span.set("trino.resident.input-rows", rs.input_rows)
    span.set("trino.resident.jit-calls", rs.jit_calls)
    span.set("trino.resident.programs", rs.programs)
    span.set("trino.resident.cache-hits", rs.cache_hits)
    span.set("trino.resident.launches-per-batch",
             round(rs.launches_per_batch, 3))
    span.set("trino.resident.code-seam-columns", rs.code_seam_columns)
    span.set("trino.resident.merges", rs.merges)
    span.set("trino.resident.fallbacks", rs.fallbacks)


def annotate_resilience_span(span: "Span", res) -> None:
    """Set the ``trino.exec.*`` resilience attributes from a ResilienceStats
    delta (exec/stats.py) so exporters see retries, backoff waits, worker
    replacements and heartbeat churn next to the query wall time."""
    if res is None or not res.any:
        return
    span.set("trino.exec.query-retries", res.query_retries)
    span.set("trino.exec.backoff-waits", res.backoff_waits)
    span.set("trino.exec.backoff-wait-ms", round(res.backoff_wait_s * 1e3, 1))
    span.set("trino.exec.blacklisted-workers", res.blacklisted_workers)
    span.set("trino.exec.worker-replacements", res.worker_replacements)
    span.set("trino.exec.heartbeat-transitions", res.heartbeat_transitions)
    span.set("trino.exec.exchange-fetch-failures", res.exchange_fetch_failures)
    span.set("trino.exec.exchange-backoff-trips", res.exchange_backoff_trips)


def annotate_scan_span(span: "Span", ingest) -> None:
    """Set the ``trino.scan.*`` attributes from a ScanIngestStats roll-up
    (exec/stats.py) on an execution span, so exporters see scan throughput,
    queue depth and transfer/compute overlap next to the wall time."""
    if ingest is None or not ingest.scan_batches:
        return
    span.set("trino.scan.bytes", ingest.scan_bytes)
    span.set("trino.scan.rows", ingest.scan_rows)
    span.set("trino.scan.batches", ingest.scan_batches)
    span.set("trino.scan.coalesced-batches", ingest.coalesced_batches)
    span.set("trino.scan.gb-per-s", round(ingest.gbps, 3))
    span.set("trino.scan.queue-depth-avg", round(ingest.queue_depth_avg, 2))
    span.set("trino.scan.queue-depth-max", ingest.queue_depth_max)
    span.set("trino.scan.source-read-ms", round(ingest.source_read_s * 1e3, 1))
    span.set("trino.scan.consumer-wait-ms",
             round(ingest.consumer_wait_s * 1e3, 1))
    span.set("trino.scan.stage-ms", round(ingest.stage_s * 1e3, 1))
    span.set("trino.scan.prefetch", ingest.prefetch_enabled)


@dataclass
class Span:
    name: str
    attributes: dict = field(default_factory=dict)
    start: float = 0.0
    end: Optional[float] = None
    children: list["Span"] = field(default_factory=list)
    # distributed identity: trace_id is shared by the whole query tree,
    # parent_id links a child to its parent across process boundaries
    trace_id: str = ""
    span_id: str = ""
    parent_id: Optional[str] = None

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.perf_counter()) - self.start) * 1e3

    def set(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def text(self, indent: int = 0) -> str:
        attrs = " ".join(f"{k}={v}" for k, v in self.attributes.items())
        lines = ["  " * indent
                 + f"- {self.name} {self.duration_ms:.1f}ms"
                 + (f" [{attrs}]" if attrs else "")]
        for c in self.children:
            lines.append(c.text(indent + 1))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """JSON-safe subtree for shipping finished spans across processes
        (worker -> coordinator with task completion).  Durations travel as
        milliseconds: perf_counter timestamps are not comparable across
        processes, so absolute start/end stay process-local."""
        return {
            "name": self.name,
            "attributes": dict(self.attributes),
            "duration_ms": self.duration_ms,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "children": [c.to_dict() for c in self.children],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        s = cls(d["name"], dict(d.get("attributes", {})),
                start=0.0, end=d.get("duration_ms", 0.0) / 1e3,
                trace_id=d.get("trace_id", ""),
                span_id=d.get("span_id", ""),
                parent_id=d.get("parent_id"))
        s.children = [cls.from_dict(c) for c in d.get("children", [])]
        return s


class _SpanCtx:
    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.end = time.perf_counter()
        if exc is not None:
            self.span.set("error", type(exc).__name__)
        self.tracer._pop(self.span)


class Tracer:
    """Thread-aware span collector.  ``span(name)`` nests under the current
    thread's open span; finished ROOT spans go to ``exporter`` and the
    bounded ``finished`` ring (introspection / tests)."""

    def __init__(self, exporter: Optional[Callable[[Span], None]] = None,
                 keep: int = 50):
        self._local = threading.local()
        self._exporter = exporter
        # deque(maxlen=keep): O(1) ring eviction (list.pop(0) was O(n) per
        # finished root, under the lock)
        self.finished: deque = deque(maxlen=keep)
        self._lock = threading.Lock()

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def span(self, name: str, parent: Optional[Span] = None,
             remote: Optional[tuple[str, str]] = None,
             **attributes) -> _SpanCtx:
        """Open a span.  Default parenting is the current thread's open
        span; ``parent=`` attaches to an explicit span on another thread
        (the distributed runner's task threads nesting under the query
        span).  ``remote=`` is a (trace_id, parent_span_id) pair from
        ``parse_traceparent``: the span becomes a local root carrying the
        remote identity (a worker process's task span), so the coordinator
        can re-attach the subtree shipped back with the task's status."""
        s = Span(name, dict(attributes), time.perf_counter(),
                 span_id=_new_span_id())
        stack = self._stack()
        if parent is not None:
            if not parent.trace_id:
                parent.trace_id = _new_trace_id()
            if not parent.span_id:
                parent.span_id = _new_span_id()
            s.trace_id = parent.trace_id
            s.parent_id = parent.span_id
            parent.children.append(s)  # list.append: thread-safe
        elif remote is not None:
            s.trace_id, s.parent_id = remote
            s._remote_root = True
        elif stack:
            s.trace_id = stack[-1].trace_id
            s.parent_id = stack[-1].span_id
            stack[-1].children.append(s)
        else:
            s.trace_id = _new_trace_id()
        stack.append(s)
        return _SpanCtx(self, s)

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        if stack:
            return
        # the thread's outermost span closed.  One attached to an explicit
        # cross-thread parent already lives in its parent's subtree;
        # remote-parented spans ARE local roots
        if span.parent_id is not None and \
                not getattr(span, "_remote_root", False):
            return
        with self._lock:
            self.finished.append(span)
        if self._exporter is not None:
            self._exporter(span)
