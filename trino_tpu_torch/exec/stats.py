"""Per-operator execution statistics (the OperatorStats equivalent).

The Driver credits wall time, rows and batches to each operator as it moves
batches (reference: operator/OperatorStats.java, the port of
``exec/stats.py`` with its scan-ingest, encoding, host-sync, compiled-
stage, resilience and adaptive counters).  Rows
are live rows: on the card a masked batch's count is a device reduction,
so the driver adds the counts up as tensors and
:meth:`QueryStats.read_counts` reads them all once the run has ended.
Device work is asynchronous, so a :class:`QueryStats` created with
``per_op_sync`` set synchronizes the device after every operator call: the
times then charge each operator its own device work, at the cost of the
overlap.  ``sync`` is the run's exec/syncguard.py delta, and an operator
that revoked its buffer to host memory reports its ``spill_count``; one
that spilled to disk (exec/spill.py) its pages, bytes and the seconds of
writing and reading them back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Optional

import torch


@dataclass
class ScanIngestStats:
    """Counters of one ScanOperator's ingest (prefetch, coalescing, device
    staging); ``merge`` folds them into the query's roll-up.  Beyond the
    reference's counters: the rows dynamic filters pruned and the bytes
    the scan copied from host to device (staged batches and LAZY columns
    materialized later)."""

    scan_bytes: int = 0          # host bytes produced by connector sources
    scan_rows: int = 0
    scan_batches: int = 0        # raw connector batches
    coalesced_batches: int = 0   # merged batches emitted to the pipeline
    coalesced_rows: int = 0
    staged_batches: int = 0      # batches copied to the device
    splits_opened: int = 0
    source_read_s: float = 0.0   # time inside connector get_next_batch
    consumer_wait_s: float = 0.0  # consumer blocked waiting on prefetch
    stage_s: float = 0.0         # host time issuing the device copies
    queue_depth_max: int = 0
    queue_depth_sum: int = 0
    queue_samples: int = 0
    prefetch_enabled: bool = False
    first_batch_t: Optional[float] = None
    last_batch_t: Optional[float] = None
    rows_pruned: int = 0         # by dynamic filters
    h2d_bytes: int = 0           # copied host -> device

    def observe_batch(self, nbytes: int, rows: int) -> None:
        now = time.perf_counter()
        if self.first_batch_t is None:
            self.first_batch_t = now
        self.last_batch_t = now
        self.scan_bytes += nbytes
        self.scan_rows += rows
        self.scan_batches += 1

    @property
    def wall_s(self) -> float:
        if self.first_batch_t is None or self.last_batch_t is None:
            return 0.0
        return self.last_batch_t - self.first_batch_t

    @property
    def gbps(self) -> float:
        """Scan ingest GB/s over the first -> last batch window."""
        w = self.wall_s
        return (self.scan_bytes / w) / 1e9 if w > 0 else 0.0

    @property
    def queue_depth_avg(self) -> float:
        return (self.queue_depth_sum / self.queue_samples
                if self.queue_samples else 0.0)

    def merge(self, other: "ScanIngestStats") -> None:
        for f in fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name == "queue_depth_max":
                setattr(self, f.name, max(a, b))
            elif f.name == "prefetch_enabled":
                setattr(self, f.name, a or b)
            elif f.name in ("first_batch_t", "last_batch_t"):
                pick = min if f.name == "first_batch_t" else max
                if b is not None:
                    setattr(self, f.name, b if a is None else pick(a, b))
            else:
                setattr(self, f.name, a + b)

    def text(self) -> str:
        mode = "prefetch" if self.prefetch_enabled else "sync"
        return (
            f"scan[{mode}]: {self.scan_bytes / 1e9:.3f} GB "
            f"({self.scan_rows} rows, {self.scan_batches} batches -> "
            f"{self.coalesced_batches} coalesced) @ {self.gbps:.2f} GB/s, "
            f"queue depth avg {self.queue_depth_avg:.1f} max "
            f"{self.queue_depth_max}, read {self.source_read_s * 1e3:.1f} ms"
            f" / wait {self.consumer_wait_s * 1e3:.1f} ms / stage "
            f"{self.stage_s * 1e3:.1f} ms"
        )


@dataclass
class EncodingStats:
    """Counters of compressed execution: batches by encoding, bytes saved
    against a flat representation, LAZY columns made and materialized, RLE
    aggregation.  One instance per encoding-aware operator; ``merge``
    folds them into the query's roll-up.  The exchange counter of the
    reference stays 0 until exchanges are ported."""

    rle_batches: int = 0        # batches carrying >= 1 RLE column
    dict_batches: int = 0       # batches carrying >= 1 dictionary column
    lazy_columns: int = 0       # LAZY columns made by the scan
    lazy_materialized: int = 0  # thunks that ran
    bytes_saved: int = 0        # flat-equivalent minus encoded bytes
    lazy_skipped_bytes: int = 0  # payload bytes not staged with the batch
    rle_agg_rows: int = 0       # rows aggregated as value * run_count
    code_group_batches: int = 0  # group-bys that ran on int32 codes
    code_join_batches: int = 0   # joins probed in code space
    exchange_code_pages: int = 0  # pages whose codes crossed a shuffle

    def merge(self, other: "EncodingStats") -> None:
        for f in fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    @property
    def any(self) -> bool:
        return any(getattr(self, f.name) for f in fields(self)
                   if f.name != "lazy_materialized")

    def text(self) -> str:
        never = self.lazy_columns - self.lazy_materialized
        return (
            f"encoding: {self.rle_batches} RLE / {self.dict_batches} dict "
            f"batches, {self.lazy_columns} lazy columns "
            f"({never} never materialized, "
            f"{self.lazy_skipped_bytes / 1e6:.2f} MB skipped), "
            f"{self.bytes_saved / 1e6:.2f} MB saved vs flat, "
            f"{self.rle_agg_rows} RLE-agg rows, "
            f"{self.code_group_batches} code group-bys / "
            f"{self.code_join_batches} code joins, "
            f"{self.exchange_code_pages} code pages through exchange"
        )


@dataclass
class ResilienceStats:
    """Counters for the query-level resilience layer (retry_policy=QUERY,
    heartbeat detection, worker replacement, exchange backoff) — the
    QueryStats/tracing surface of execution/failure_detector.py and the
    remote runner's retry loop."""

    query_retries: int = 0
    backoff_waits: int = 0
    backoff_wait_s: float = 0.0
    blacklisted_workers: int = 0
    worker_replacements: int = 0
    heartbeat_transitions: int = 0
    exchange_fetch_failures: int = 0
    exchange_backoff_trips: int = 0

    def merge(self, other: "ResilienceStats") -> None:
        self.query_retries += other.query_retries
        self.backoff_waits += other.backoff_waits
        self.backoff_wait_s += other.backoff_wait_s
        self.blacklisted_workers += other.blacklisted_workers
        self.worker_replacements += other.worker_replacements
        self.heartbeat_transitions += other.heartbeat_transitions
        self.exchange_fetch_failures += other.exchange_fetch_failures
        self.exchange_backoff_trips += other.exchange_backoff_trips

    @classmethod
    def delta(cls, after: "ResilienceStats",
              before: "ResilienceStats") -> "ResilienceStats":
        """after - before, field-wise (runner counters are cumulative; a
        query's own numbers are the delta across its retry loop)."""
        return cls(
            query_retries=after.query_retries - before.query_retries,
            backoff_waits=after.backoff_waits - before.backoff_waits,
            backoff_wait_s=after.backoff_wait_s - before.backoff_wait_s,
            blacklisted_workers=(after.blacklisted_workers
                                 - before.blacklisted_workers),
            worker_replacements=(after.worker_replacements
                                 - before.worker_replacements),
            heartbeat_transitions=(after.heartbeat_transitions
                                   - before.heartbeat_transitions),
            exchange_fetch_failures=(after.exchange_fetch_failures
                                     - before.exchange_fetch_failures),
            exchange_backoff_trips=(after.exchange_backoff_trips
                                    - before.exchange_backoff_trips),
        )

    @property
    def any(self) -> bool:
        return any((self.query_retries, self.backoff_waits,
                    self.blacklisted_workers, self.worker_replacements,
                    self.heartbeat_transitions, self.exchange_fetch_failures,
                    self.exchange_backoff_trips))

    def text(self) -> str:
        return (
            f"resilience: {self.query_retries} query retries "
            f"({self.backoff_waits} backoff waits, "
            f"{self.backoff_wait_s * 1e3:.0f} ms), "
            f"{self.blacklisted_workers} blacklists, "
            f"{self.worker_replacements} worker replacements, "
            f"{self.heartbeat_transitions} heartbeat transitions, "
            f"{self.exchange_fetch_failures} exchange fetch failures "
            f"({self.exchange_backoff_trips} backoff trips)"
        )


@dataclass
class AdaptiveStats:
    """Counters + decision tags for the adaptive execution plane
    (execution/adaptive.py): phased stage activations and the join-
    distribution / skew decisions taken at activation barriers.  The
    ``decisions`` list carries compact human-readable tags
    (``flip_to_broadcast[f3]``, ``skew_split[f5:k2]``, ``keep[f3]``) that
    surface verbatim in EXPLAIN ANALYZE and system.runtime.queries."""

    activations: int = 0       # stages activated by the phased scheduler
    decision_points: int = 0   # barriers where a decision was evaluated
    broadcast_flips: int = 0   # PARTITIONED -> REPLICATED rewrites
    partition_flips: int = 0   # REPLICATED -> PARTITIONED rewrites
    skew_splits: int = 0       # heavy keys split across probe tasks
    memo_hits: int = 0         # decisions replayed from the runtime memo
    decisions: list[str] = field(default_factory=list)

    def merge(self, other: "AdaptiveStats") -> None:
        self.activations += other.activations
        self.decision_points += other.decision_points
        self.broadcast_flips += other.broadcast_flips
        self.partition_flips += other.partition_flips
        self.skew_splits += other.skew_splits
        self.memo_hits += other.memo_hits
        self.decisions.extend(other.decisions)

    @property
    def any(self) -> bool:
        return any((self.activations, self.decision_points,
                    self.broadcast_flips, self.partition_flips,
                    self.skew_splits))

    def text(self) -> str:
        tags = ", ".join(self.decisions) if self.decisions else "none"
        return (
            f"adaptive: {self.activations} phased activations, "
            f"{self.decision_points} decision points "
            f"({self.broadcast_flips} -> broadcast, "
            f"{self.partition_flips} -> partitioned, "
            f"{self.skew_splits} skew splits, "
            f"{self.memo_hits} memo hits); decisions: {tags}"
        )


@dataclass
class FusedStageStats:
    """Counters of whole-stage compilation (execution/stage_compiler.py):
    the batches the accumulate program absorbed, how many calls were the
    first of their (program, bucket) signature, and how many seam merges
    and per-operator re-runs ran.  One instance per FusedStageExec;
    ``merge`` folds the sinks' instances into the query's roll-up."""

    stages: int = 0            # fused stage seams that executed
    compiles: int = 0          # first calls of a (program, bucket) signature
    cache_hits: int = 0        # calls of a signature seen before
    jit_calls: int = 0         # accumulate-program calls (one per batch)
    batches: int = 0           # input batches absorbed
    input_rows: int = 0        # physical rows (padded slots included)
    merges: int = 0            # seam merges executed (one per stage)
    fallbacks: int = 0         # overflow -> per-operator re-runs

    def merge(self, other: "FusedStageStats") -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))

    @property
    def any(self) -> bool:
        return any((self.stages, self.jit_calls, self.batches,
                    self.merges, self.fallbacks))

    def text(self) -> str:
        return (
            f"fused: {self.stages} stages, {self.batches} batches "
            f"({self.input_rows} rows) in {self.jit_calls} jit calls, "
            f"{self.compiles} compiles / {self.cache_hits} cache hits, "
            f"{self.merges} seam merges, {self.fallbacks} fallbacks")


@dataclass
class ResidentPlanStats:
    """Counters of whole-query compilation (execution/plan_compiler.py):
    resident plans run as one program call per probe batch, the interior
    seams (broadcast builds and the aggregation's repartition) they fold
    in, and the per-operator re-runs taken when a plan cannot hold
    (duplicate build keys, state overflow).  One instance per
    ResidentPlanExec; ``merge`` folds them into the query's roll-up."""

    plans: int = 0             # resident plans that executed
    programs: int = 0          # first calls of a (program, bucket) signature
    seams: int = 0             # interior exchange edges folded in
    batches: int = 0           # probe batches absorbed
    jit_calls: int = 0         # whole-plan program calls (one per batch)
    cache_hits: int = 0        # calls of a signature seen before
    input_rows: int = 0        # physical probe rows (padded slots included)
    merges: int = 0            # terminal seam merges (one per plan)
    code_seam_columns: int = 0  # dictionary-code lanes crossing a seam
    fallbacks: int = 0         # overflow / duplicate key -> re-runs
    fallback_reasons: list = field(default_factory=list)

    def merge(self, other: "ResidentPlanStats") -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))

    @property
    def launches_per_batch(self) -> float:
        return self.jit_calls / self.batches if self.batches else 0.0

    @property
    def any(self) -> bool:
        return any((self.plans, self.batches, self.jit_calls,
                    self.merges, self.fallbacks))

    def text(self) -> str:
        why = (f" ({', '.join(self.fallback_reasons)})"
               if self.fallback_reasons else "")
        return (
            f"resident: {self.plans} plans ({self.seams} seams fused), "
            f"{self.batches} batches ({self.input_rows} rows) in "
            f"{self.jit_calls} jit calls "
            f"({self.launches_per_batch:.2f} launches/batch), "
            f"{self.programs} programs / {self.cache_hits} cache hits, "
            f"{self.code_seam_columns} code-seam columns, "
            f"{self.merges} merges, {self.fallbacks} fallbacks{why}")


@dataclass
class OperatorStats:
    name: str
    input_rows: int = 0
    output_rows: int = 0
    input_batches: int = 0
    output_batches: int = 0
    wall_s: float = 0.0
    spill_count: int = 0  # revocations of the operator's buffer
    revoked_bytes: int = 0  # bytes those revocations moved to the host
    disk_pages: int = 0  # pages written to its spill files
    disk_bytes: int = 0  # bytes of those pages
    disk_write_s: float = 0.0  # serializing and writing them
    disk_read_s: float = 0.0  # reading them back and deserializing


@dataclass
class PipelineStats:
    operators: list[OperatorStats] = field(default_factory=list)


@dataclass
class QueryStats:
    pipelines: list[PipelineStats] = field(default_factory=list)
    per_op_sync: bool = False  # synchronize the device after each op call
    scan: Optional[ScanIngestStats] = None  # the run's scans, rolled up
    encoding: Optional[EncodingStats] = None  # compressed execution
    sync: Optional[object] = None  # the run's syncguard.SyncStats delta
    label: str = ""  # a distributed task's "fragment F task T:" heading
    fused: Optional[FusedStageStats] = None  # whole-stage compilation
    resident: Optional[ResidentPlanStats] = None  # whole-query compilation
    resilience: Optional[ResilienceStats] = None  # retry delta
    adaptive: Optional[AdaptiveStats] = None  # adaptive-execution decisions

    def by_operator(self) -> dict[str, float]:
        """Wall seconds summed per operator class name."""
        out: dict[str, float] = {}
        for p in self.pipelines:
            for o in p.operators:
                out[o.name] = out.get(o.name, 0.0) + o.wall_s
        return out

    def read_counts(self) -> None:
        """Replace row counts held as device tensors by ints: one host
        read per device."""
        from . import syncguard as SG

        slots: dict = {}
        for p in self.pipelines:
            for o in p.operators:
                for attr in ("input_rows", "output_rows"):
                    v = getattr(o, attr)
                    if isinstance(v, torch.Tensor):
                        slots.setdefault(v.device, []).append((o, attr, v))
        for items in slots.values():
            values = SG.fetch(torch.stack([v for _, _, v in items]),
                              "stats.row-counts")
            for (o, attr, _), n in zip(items, values):
                setattr(o, attr, int(n))

    def collect_spills(self, pipelines) -> None:
        """Copy each operator's revocations and disk spills into its stats
        (pipelines in the order of ``self.pipelines``)."""
        for p, ps in zip(pipelines, self.pipelines):
            for op, o in zip(p, ps.operators):
                o.spill_count = getattr(op, "spill_count", 0)
                o.revoked_bytes = getattr(op, "revoked_bytes", 0)
                if hasattr(op, "disk_stats"):
                    (o.disk_pages, o.disk_bytes, o.disk_write_s,
                     o.disk_read_s) = op.disk_stats()

    def spills(self) -> tuple:
        """Both tiers over the run's operators: (revocations, bytes
        revoked, pages spilled to disk, bytes spilled to disk)."""
        ops = [o for p in self.pipelines for o in p.operators]
        return (sum(o.spill_count for o in ops),
                sum(o.revoked_bytes for o in ops),
                sum(o.disk_pages for o in ops),
                sum(o.disk_bytes for o in ops))

    def text(self) -> str:
        """The stats lines of EXPLAIN ANALYZE: the scan and encoding
        roll-ups, then per operator (under the label, when there is one)."""
        lines = [self.label] if self.label else []
        if self.scan is not None and self.scan.scan_batches:
            lines.append("  " + self.scan.text())
        if self.sync is not None and self.sync.host_syncs:
            lines.append("  " + self.sync.text())
        if self.resilience is not None and self.resilience.any:
            lines.append("  " + self.resilience.text())
        if self.fused is not None and self.fused.any:
            lines.append("  " + self.fused.text())
        if self.resident is not None and self.resident.any:
            lines.append("  " + self.resident.text())
        if self.adaptive is not None and self.adaptive.any:
            lines.append("  " + self.adaptive.text())
        if self.encoding is not None and self.encoding.any:
            lines.append("  " + self.encoding.text())
        for i, p in enumerate(self.pipelines):
            lines.append(f"  pipeline {i}:")
            for op in p.operators:
                lines.append(
                    f"    {op.name}: {op.wall_s * 1e3:.1f} ms, "
                    f"in {op.input_rows} rows/{op.input_batches} batches, "
                    f"out {op.output_rows} rows/{op.output_batches} batches"
                    + (f", spilled {op.spill_count}x "
                       f"({op.revoked_bytes} bytes)" if op.spill_count
                       else "")
                    + (f", to disk {op.disk_pages} pages "
                       f"({op.disk_bytes} bytes)" if op.disk_pages
                       else ""))
        return "\n".join(lines)
