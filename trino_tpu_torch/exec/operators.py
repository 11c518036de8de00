"""Operators: the batch-at-a-time data plane on tensors.

The port of the reference ``exec/operators.py`` (operator contract of
operator/Operator.java:21 — ``needs_input``/``add_input``/``get_output``/
``is_finished``) for the operators the ported queries use:

- sources: ScanOperator (the asynchronous ingest path of exec/prefetch.py
  with dynamic filters, a pushed-down LIMIT and RLE / LAZY columns, or
  the synchronous path), ValuesOperator, UnionSourceOperator,
  TableFunctionOperator;
- streaming: FilterProjectOperator,
  LookupJoinOperator (INNER, CROSS, LEFT, RIGHT, FULL, SINGLE; keyed or
  nested-loop), SemiJoinOperator (IN / EXISTS mark), GroupIdOperator,
  ReplicateOperator, UnnestOperator, LimitOperator, RenameOperator;
- blocking: HashAggregationOperator (SINGLE, PARTIAL and FINAL steps; the
  variance family, any_value and exact long-decimal sum / avg too),
  JoinBuildSink, WindowOperator, SortOperator / TopNOperator, each a
  :class:`BufferedInputMixin` whose buffered batches are reserved in the
  task's memory pool and revoked to host memory when it is full
  (exec/revoking.py);
  OutputCollector and UnionSinkOperator are sinks.

Filters mark rows dead in the batch's ``live`` mask instead of compacting;
blocking operators concatenate their input on the device.  Encoded columns
pass FilterProject still encoded when it only hands them on
(:func:`plan_lazy_scan` plans the LAZY ones); every other reader of
``data`` gets a dense tensor on the device.  Deliberate host reads go
through exec/syncguard.py; the join probes make none in their steady state
(exec/join_exec.py's padded expand).
"""

from __future__ import annotations

import decimal
import itertools
import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..telemetry import profiler
from ..ops.expr import SUBQUERY_MULTIPLE_ROWS as ERR_MULTIPLE_ROWS
from ..ops.expr import (compile_expression, expr_condition_mask,
                        expr_error_scope, reduce_error_lanes)
from ..planner.add_exchanges import partial_agg_layout
from ..planner.plan import AggCall, SortKey, WindowFunc
from ..spi.batch import (Column, ColumnBatch, _object_array, _same_dictionary,
                         as_tensor, encode_sorted_objects, rescale_scaled_int,
                         torch_dtype, unify_dictionaries)
from ..spi.connector import Connector, ConnectorPageSink, Split
from ..spi.errors import SUBQUERY_MULTIPLE_ROWS, TrinoError
from ..spi.types import BIGINT, BOOLEAN, DOUBLE, DecimalType, Type
from ..sql.analyzer import STAT_AGGS
from ..sql.ir import InputRef, RowExpression, referenced_inputs
from . import join_exec as JX
from . import kernels as K
from . import syncguard as SG
from . import window_kernels as WK
from .prefetch import (BatchCoalescer, DeviceStager, IngestConfig,
                       PrefetchingPageSource, encode_scan_batch)
from .revoking import (batch_device_nbytes, batch_device_residual,
                       restore_to_device, to_device, to_host)
from .spill import Spiller
from .stats import EncodingStats, ScanIngestStats

__all__ = [
    "Operator", "ScanOperator", "FilterProjectOperator", "plan_lazy_scan",
    "HashAggregationOperator", "JoinBridge", "JoinBuildSink",
    "LookupJoinOperator", "SemiJoinOperator", "SortOperator",
    "TopNOperator", "LimitOperator", "RenameOperator", "TableWriterOperator",
    "OutputCollector", "ValuesOperator", "LocalUnionBridge",
    "UnionSinkOperator", "UnionSourceOperator", "GroupIdOperator",
    "ReplicateOperator", "WindowOperator", "UnnestOperator",
    "TableFunctionOperator", "BufferedInputMixin", "partial_agg_layout",
    "DistinctLimitOperator",
    "split_aggregation",
]


class Operator:
    """Synchronous single-driver operator protocol."""

    input_done: bool = False
    _closed: bool = False

    def needs_input(self) -> bool:
        return not self.input_done and not self._closed

    def add_input(self, batch: ColumnBatch) -> None:
        raise NotImplementedError

    def finish_input(self) -> None:
        self.input_done = True

    def get_output(self) -> Optional[ColumnBatch]:
        return None

    def is_finished(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        """Downstream no longer needs output (e.g. LIMIT satisfied)."""
        self._closed = True
        self.input_done = True


# ---------------------------------------------------------------------------
# source


class ScanOperator(Operator):
    """Reads splits through the connector page source (operator/
    TableScanOperator.java:46).  Each host batch is masked on the host by
    the advisory TupleDomain (exec/domain_filter.py) and by the
    ``dynamic_filters`` [(column index, holder)] of the joins it feeds
    (exec/dynamic_filter.py), then moved to ``device``.  A batch already in
    device memory, or of a device-resident table, skips the masks, the
    coalescing and the encodings and is handed on without a copy (the
    filter above the scan still applies the predicate).

    With ``ingest.active`` (the default), unless the table is device-
    resident, the scan runs the asynchronous path of exec/prefetch.py:
    splits decode on background threads, small batches merge into pinned
    buffers, and the next batch's copy to the card is issued on a side
    stream while the previous one computes.
    ``IngestConfig(enabled=False)`` runs the synchronous path, one split at
    a time, each batch copied in the operator's thread.  ``limit``, a
    pushed-down LIMIT, stops opening splits once that many rows are out
    (the Limit above enforces the exact count).  With ``encoded`` the scan
    makes RLE columns of constant runs and LAZY columns of the channels in
    ``lazy_channels`` (set by :func:`plan_lazy_scan`)."""

    def __init__(self, connector: Connector, splits: Sequence[Split],
                 columns: Sequence[str], device, constraint=None,
                 dynamic_filters=None, limit: Optional[int] = None,
                 ingest: Optional[IngestConfig] = None,
                 encoded: bool = True):
        self.connector = connector
        self.splits = list(splits)
        self.columns = list(columns)
        self.device = torch.device(device)
        self.constraint = constraint if (
            constraint is not None and not constraint.is_all) else None
        self.dynamic_filters = list(dynamic_filters or [])
        self.limit = limit
        self._emitted_rows = 0
        self._name_to_idx = {n: i for i, n in enumerate(self.columns)}
        self._domain_dict_cache: dict = {}
        self._source = None
        self.input_done = True
        self.ingest_cfg = ingest if ingest is not None else IngestConfig()
        # a device-resident table has nothing to prefetch, mask or copy
        self._resident = bool(self.splits) and connector.is_resident(
            self.splits[0].table)
        self._async = self.ingest_cfg.active and not self._resident
        self.ingest_stats = ScanIngestStats()
        self.encoded = encoded
        self.lazy_channels: frozenset = frozenset()
        self.encoding_stats = EncodingStats()
        self._prefetcher: Optional[PrefetchingPageSource] = None
        self._coalescer: Optional[BatchCoalescer] = None
        self._stager: Optional[DeviceStager] = None
        self._staged: Optional[tuple] = None  # (batch, copy event)
        self._hold_back: Optional[ColumnBatch] = None
        self._ingest_done = False

    def needs_input(self) -> bool:
        return False

    def _on_host(self, batch: ColumnBatch) -> bool:
        """A host batch to mask, coalesce and copy (not one in device
        memory or of a device-resident table)."""
        return not self._resident and batch.device.type == "cpu"

    def _apply_constraint(self, batch: ColumnBatch) -> ColumnBatch:
        from .domain_filter import tuple_domain_mask

        mask = tuple_domain_mask(batch, self.constraint, self._name_to_idx,
                                 self._domain_dict_cache)
        if mask is None or mask.all():
            return batch
        return batch.filter(as_tensor(mask))

    def _apply_dynamic_filters(self, batch: ColumnBatch) -> ColumnBatch:
        mask = None
        for col_idx, holder in self.dynamic_filters:
            c = batch.columns[col_idx]
            m = holder.probe_mask(
                c.data.numpy(), None if c.valid is None else c.valid.numpy(),
                c.dictionary)
            if m is not None:
                mask = m if mask is None else (mask & m)
        if mask is None or mask.all():
            return batch
        pruned = batch.num_rows - int(np.count_nonzero(mask))
        self.dynamic_filters[0][1].add_pruned(pruned)  # once per batch
        self.ingest_stats.rows_pruned += pruned
        return batch.filter(torch.from_numpy(mask))

    def _masked(self, batch: ColumnBatch) -> ColumnBatch:
        if self.constraint is not None:
            batch = self._apply_constraint(batch)
        if self.dynamic_filters and batch.num_rows:
            batch = self._apply_dynamic_filters(batch)
        return batch

    def get_output(self) -> Optional[ColumnBatch]:
        if self._async:
            return self._get_output_async()
        return self._get_output_sync()

    def _limit_reached(self) -> bool:
        return self.limit is not None and self._emitted_rows >= self.limit

    def _count_limit(self, batch: ColumnBatch, raw_rows: int) -> None:
        """Count a batch's rows toward a pushed-down LIMIT (a masked batch's
        dead rows would need a device read: it counts none) and, on the
        asynchronous path, hand the prefetcher its gate count."""
        if self.limit is None:
            return
        kept = batch.num_rows if batch.live is None else 0
        self._emitted_rows += kept
        if self._prefetcher is not None:
            self._prefetcher.consumed(raw_rows, kept)

    def _get_output_sync(self) -> Optional[ColumnBatch]:
        while not self._closed:
            if self._source is None:
                if self._limit_reached():
                    self.splits = []  # pushed-down LIMIT satisfied
                if not self.splits:
                    return None
                self._source = self.connector.create_page_source(
                    self.splits.pop(0), self.columns)
                self.ingest_stats.splits_opened += 1
            if self._source.is_finished():
                self._source.close()
                self._source = None
                continue
            batch = self._source.get_next_batch()
            if batch is None:
                continue
            if not self._on_host(batch):
                self.ingest_stats.observe_batch(batch.nbytes, batch.num_rows)
                self._count_limit(batch, batch.num_rows)
                return batch.to(self.device)  # no copy when already there
            batch = self._masked(batch)
            if batch.num_rows == 0:
                continue
            self.ingest_stats.observe_batch(batch.nbytes, batch.num_rows)
            self._count_limit(batch, batch.num_rows)
            if self.encoded:
                batch = encode_scan_batch(
                    batch, self.lazy_channels, self.device,
                    self.encoding_stats, self.ingest_stats)
            if self.device.type != "cpu":
                self.ingest_stats.h2d_bytes += sum(
                    c.data.numel() * c.data.element_size()
                    + (0 if c.valid is None else c.valid.numel())
                    for c in batch.columns if c.encoding not in ("RLE",
                                                                 "LAZY"))
            return batch.to(self.device)
        return None

    # -- asynchronous ingest -------------------------------------------------

    def _ensure_ingest(self) -> None:
        if self._prefetcher is not None or self._ingest_done:
            return
        self._stager = DeviceStager(self.device, self.ingest_stats,
                                    self.lazy_channels, self.encoding_stats,
                                    self.encoded)
        self._coalescer = BatchCoalescer(self.ingest_cfg.coalesce_rows,
                                         self.ingest_stats,
                                         self._stager.alloc)
        self._prefetcher = PrefetchingPageSource(
            self.connector, self.splits, self.columns, self.ingest_cfg,
            self.ingest_stats, limit_rows=self.limit)
        self.splits = []  # the prefetcher's now

    def _flush(self) -> Optional[tuple]:
        flushed = self._coalescer.flush()
        if flushed is None:
            return None
        if not profiler.enabled():
            return self._stager.stage(*flushed)
        t0 = profiler.now()
        staged = self._stager.stage(*flushed)
        profiler.event(profiler.STAGE, "scan.stage", t0,
                       rows=flushed[0].num_rows, bytes=flushed[0].nbytes)
        return staged

    def _produce_next(self) -> Optional[tuple]:
        """One coalesced, staged (batch, event), or None at the end.  The
        masks run here, on the consumer's thread (the holders' counters
        are not thread-safe); a batch in device memory flushes the
        coalescer first, so row order holds, then passes through."""
        if self._ingest_done:
            return None
        self._ensure_ingest()
        while True:
            if self._limit_reached():
                self._prefetcher.close()
                self._ingest_done = True
                return self._flush()
            batch = self._prefetcher.get_next_batch()
            if batch is None:
                self._ingest_done = True
                return self._flush()
            if not self._on_host(batch):
                batch = batch.to(self.device)
                self._count_limit(batch, batch.num_rows)
                flushed = self._flush()
                if flushed is not None:
                    self._hold_back = batch
                    return flushed
                return batch, None
            rows = batch.num_rows
            batch = self._masked(batch)
            self._count_limit(batch, rows)
            if batch.num_rows == 0:
                continue
            self._coalescer.add(batch)
            if self._coalescer.ready():
                return self._flush()

    def _get_output_async(self) -> Optional[ColumnBatch]:
        if self._closed:
            return None
        if self._hold_back is not None:
            out, self._hold_back = (self._hold_back, None), None
        elif self._staged is not None:
            out, self._staged = self._staged, None
        else:
            out = self._produce_next()
        if out is None:
            return None
        # issue the next batch's copy now, so it crosses while this one
        # computes downstream
        if self._staged is None and self._hold_back is None:
            self._staged = self._produce_next()
        batch, event = out
        self._stager.ready(event)
        return batch

    def is_finished(self) -> bool:
        if self._closed:
            return True
        if not self._async:
            return self._source is None and not self.splits
        if self._staged is not None or self._hold_back is not None:
            return False
        if self._prefetcher is None:
            return self._ingest_done or not self.splits
        return self._ingest_done and self._coalescer.buffered_rows == 0

    def close(self) -> None:
        super().close()
        if self._prefetcher is not None:
            self._prefetcher.close()  # drop in-flight and unclaimed splits
        if self._source is not None:
            self._source.close()
            self._source = None

    def shutdown(self) -> None:
        """Close and wait for the prefetch threads to end (the run is
        over, or failed)."""
        self.close()
        if self._prefetcher is not None:
            self._prefetcher.join()


class ValuesOperator(Operator):
    """Emits one batch of literal rows (a Values node: SELECT without FROM,
    and the empty relation the iterative optimizer folds a FALSE filter or
    an empty input into), already on the runner's device."""

    def __init__(self, batch: ColumnBatch):
        self._batch = batch
        self.input_done = True

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        b, self._batch = self._batch, None
        return b

    def is_finished(self) -> bool:
        return self._closed or self._batch is None


class TableFunctionOperator(Operator):
    """Leaf table-function source (operator/LeafTableFunctionOperator.
    java:41): drains the bound function's batch generator, each batch
    moved to the runner's device."""

    def __init__(self, bound, output_names: Sequence[str], device):
        self.output_names = list(output_names)
        self.device = torch.device(device)
        self._iter = bound.batches()
        self._done = False
        self.input_done = True

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        if self._done or self._closed:
            return None
        batch = next(self._iter, None)
        if batch is None:
            self._done = True
            return None
        return batch.rename(self.output_names).to(self.device)

    def is_finished(self) -> bool:
        return self._done or self._closed


# ---------------------------------------------------------------------------
# union (a local gather between pipelines)


class LocalUnionBridge:
    """Handoff for a Union's inputs: each input pipeline ends in a
    UnionSinkOperator appending here; the consumer pipeline starts from a
    UnionSourceOperator (the single-driver analogue of a gathering
    LocalExchange, operator/exchange/LocalExchange.java:67).  Branches keep
    their own dictionaries: a consumer that concatenates unifies them
    (``ColumnBatch.concat``), and one that does not reads each batch with
    its own."""

    def __init__(self, num_inputs: int):
        self.num_inputs = num_inputs
        self.batches: "deque[ColumnBatch]" = deque()
        self.finished_inputs = 0

    @property
    def all_finished(self) -> bool:
        return self.finished_inputs >= self.num_inputs


class UnionSinkOperator(Operator):
    def __init__(self, bridge: LocalUnionBridge, names: Sequence[str]):
        self.bridge = bridge
        self.names = list(names)

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self.bridge.batches.append(batch.rename(self.names))

    def finish_input(self) -> None:
        super().finish_input()
        self.bridge.finished_inputs += 1

    def is_finished(self) -> bool:
        return self.input_done


class UnionSourceOperator(Operator):
    def __init__(self, bridge: LocalUnionBridge):
        self.bridge = bridge
        self.input_done = True

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        if self._closed or not self.bridge.all_finished:
            return None
        return self.bridge.batches.popleft() if self.bridge.batches else None

    def is_finished(self) -> bool:
        return self._closed or (self.bridge.all_finished
                                and not self.bridge.batches)


# ---------------------------------------------------------------------------
# filter / project


def _to_cols(batch: ColumnBatch):
    return [(c.data, c.valid) for c in batch.columns]


class FilterProjectOperator(Operator):
    """Fused filter+project: the predicate ANDs into the batch's ``live``
    mask, projections evaluate on every lane.  Error-capable expressions
    leave one int32 scalar per batch in ``pending_errors``."""

    def __init__(self, predicate: Optional[RowExpression],
                 projections: Optional[Sequence[RowExpression]],
                 output_names: Sequence[str], output_types: Sequence[Type]):
        self.predicate = predicate
        self.projections = (list(projections) if projections is not None
                            else None)
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._pending: Optional[ColumnBatch] = None
        self._compiled = None
        self._compiled_dicts = None
        self.pending_errors: list = []
        self.encoding_stats = EncodingStats()

    def _compile(self, batch: ColumnBatch):
        dicts = [c.dictionary for c in batch.columns]
        if self._compiled is not None and all(
                a is b for a, b in zip(self._compiled_dicts, dicts)):
            return self._compiled
        types = [c.type for c in batch.columns]
        dev = batch.device
        pred = (compile_expression(self.predicate, types, dicts, device=dev)
                if self.predicate is not None else None)
        projs = ([compile_expression(e, types, dicts, device=dev)
                  for e in self.projections]
                 if self.projections is not None else None)
        self._compiled = (pred, projs)
        self._compiled_dicts = dicts
        return self._compiled

    def needs_input(self) -> bool:
        return self._pending is None and super().needs_input()

    def _encoded_plan(self, batch: ColumnBatch) -> tuple:
        """(needed, passthrough) of the encoded path: ``needed`` are the
        input channels the expressions read (the predicate's and every
        projection's that is not a bare column); ``passthrough`` maps an
        output position to the input channel it hands on unchanged.  Those
        columns skip the expressions and keep their encoding: a selective
        predicate reads only its own channels, and payload columns ride
        through still RLE or LAZY (the late-materialization seam)."""
        needed: set = set()
        if self.predicate is not None:
            needed |= referenced_inputs(self.predicate)
        if self.projections is None:
            return needed, {i: i for i in range(batch.num_columns)}
        passthrough = {}
        for j, e in enumerate(self.projections):
            if (isinstance(e, InputRef) and str(batch.columns[e.index].type)
                    == str(self.output_types[j])):
                passthrough[j] = e.index
            else:
                needed |= referenced_inputs(e)
        return needed, passthrough

    def _observe_encoded(self, batch: ColumnBatch, needed: set) -> None:
        es = self.encoding_stats
        saved = n_rle = n_dict = 0
        for i, c in enumerate(batch.columns):
            enc = c.encoding
            n_rle += enc == "RLE"
            n_dict += enc == "DICT"
            if enc in ("RLE", "LAZY") and i not in needed:
                saved += c.flat_nbytes - c.nbytes
        es.rle_batches += n_rle > 0
        es.dict_batches += n_dict > 0
        es.bytes_saved += max(saved, 0)

    def add_input(self, batch: ColumnBatch) -> None:
        if any(c.encoding in ("RLE", "LAZY") for c in batch.columns):
            needed, passthrough = self._encoded_plan(batch)
            # an RLE input expands on the device; reading a LAZY one runs
            # its thunk; channels nothing reads are never touched
            cols = [((K.rle_fill(c.rle_value, len(c), c.device), c.valid)
                     if c.encoding == "RLE" else (c.data, c.valid))
                    if i in needed else (None, None)
                    for i, c in enumerate(batch.columns)]
            self._observe_encoded(batch, needed)
        else:
            cols, passthrough = _to_cols(batch), {}
        pred, projs = self._compile(batch)
        live = batch.live
        n = batch.num_rows
        dev = batch.device
        with expr_error_scope() as errs:
            if pred is not None:
                with expr_condition_mask(live):
                    data, valid = pred(cols)
                mask = data if valid is None else data & valid
                mask = mask.expand(n) if mask.dim() == 0 else mask
                live = mask if live is None else live & mask
            if projs is None:
                out_cols = list(batch.columns)
            else:
                out_cols = []
                with expr_condition_mask(live):
                    for j, (ce, t) in enumerate(zip(projs,
                                                    self.output_types)):
                        if j in passthrough:
                            out_cols.append(batch.columns[passthrough[j]])
                            continue
                        d, v = ce(cols)
                        d = d.to(torch_dtype(t.storage_dtype))
                        if d.dim() == 0:
                            d = d.expand(n).contiguous()
                        if v is not None and v.dim() == 0:
                            v = v.expand(n).contiguous()
                        out_cols.append(Column(t, d, v, ce.dictionary))
            err = reduce_error_lanes(errs, n, dev)
        if err is not None:
            self.pending_errors.append(err)
        self._pending = ColumnBatch(self.output_names, out_cols, live)

    def get_output(self) -> Optional[ColumnBatch]:
        b, self._pending = self._pending, None
        return b

    def is_finished(self) -> bool:
        return self.input_done and self._pending is None


def plan_lazy_scan(pipeline: Sequence[Operator]) -> None:
    """Late-materialization planning: when a scan feeds straight into a
    filtering FilterProject, every channel the filter only passes through
    becomes LAZY; the mask is computed from the predicate's columns alone,
    and a selective filter's payload bytes never cross to the device (the
    LazyBlock contract of ScanFilterAndProjectOperator).  Called once per
    pipeline by the local planner; a no-op for a scan without encodings."""
    if len(pipeline) < 2:
        return
    scan, fp = pipeline[0], pipeline[1]
    if not (isinstance(scan, ScanOperator) and scan.encoded
            and isinstance(fp, FilterProjectOperator)
            and fp.predicate is not None):
        return
    needed = set(referenced_inputs(fp.predicate))
    if fp.projections is not None:
        for e in fp.projections:
            if not isinstance(e, InputRef):
                needed |= referenced_inputs(e)
    scan.lazy_channels = frozenset(
        i for i in range(len(scan.columns)) if i not in needed)


class RenameOperator(Operator):
    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self._pending = None

    def needs_input(self) -> bool:
        return self._pending is None and super().needs_input()

    def add_input(self, batch: ColumnBatch) -> None:
        self._pending = batch.rename(self.names)

    def get_output(self):
        b, self._pending = self._pending, None
        return b

    def is_finished(self) -> bool:
        return self.input_done and self._pending is None


# ---------------------------------------------------------------------------
# aggregation


_COMPACT_FACTOR = 4  # compact when live rows < lanes / 4
_COMPACT_MIN_LANES = 1 << 16  # below this the count sync costs more


def _maybe_compact(batch: ColumnBatch) -> ColumnBatch:
    """Shrink a sparsely-live batch (a selective join keeps its probe
    batch's shape) before hashing or sorting it: one counted sync for the
    live count."""
    if batch.live is None or batch.num_rows < _COMPACT_MIN_LANES:
        return batch
    count = int(SG.fetch(batch.live.sum(), "exec.compact-count"))
    if count * _COMPACT_FACTOR <= batch.num_rows:
        return batch.compact()
    return batch


class BufferedInputMixin:
    """Blocking operators accumulate ``self._batches``; with a
    TaskMemoryContext attached (exec/revoking.py) their bytes are reserved
    as revocable memory, and a revocation moves them to ``_revoked`` in host
    memory (pinned on the card) until :meth:`buffered_batches` brings them
    back at finish.  ``spill_count`` counts the revocations that moved
    bytes, ``revoked_bytes`` the bytes they moved.

    Below that tier is the disk (exec/spill.py): when the bytes buffered in
    both lists exceed the context's ``spill_to_disk_bytes``, all of them
    move, in arrival order, to the operator's spill file as v1 pages, and
    come back first at finish.  :meth:`disk_stats` sums the pages, bytes
    and seconds of every spill file the operator used.

    Batches are appended and taken under ``_buf_lock``, never held while
    the memory context is called, because a concurrent driver's
    reservation may revoke this operator's buffer."""

    _mem = None  # TaskMemoryContext, set by attach_memory
    spill_count = 0
    revoked_bytes = 0
    _spiller = None  # the raw-page spill file, while it holds pages
    _spillers = ()  # every spill file the operator used (for the stats)

    def _buffer_state(self):
        if "_buf_lock" not in self.__dict__:
            self._buf_lock = threading.RLock()
            self._revoked = []  # [(host batch, its device)]
            self._spilled_devices = []  # the device of each spilled page
        return self._buf_lock

    def attach_memory(self, mem) -> None:
        self._mem = mem
        if mem is not None:
            mem.register(self)

    def buffer(self, batch: ColumnBatch) -> None:
        """Append an input batch and reserve its bytes."""
        with self._buffer_state():
            self._batches.append(batch)
        self.account_memory()

    def account_memory(self) -> None:
        if self._mem is not None:
            self._mem.update(self, batch_device_residual(self))
            if self._mem.spill_to_disk_bytes:
                self._maybe_spill_to_disk()

    def revoke_memory(self) -> int:
        freed = 0
        with self._buffer_state():
            for b in self._batches:
                freed += batch_device_nbytes(b)
                self._revoked.append((to_host(b), b.device))
            self._batches = []
        if freed:
            self.spill_count += 1
            self.revoked_bytes += freed
        return freed

    def release_memory(self) -> None:
        """Drop the input buffer and its reservation once finish consumed
        it (a lingering reservation would revoke other operators' live
        buffers for nothing)."""
        with self._buffer_state():
            self._batches = []
            self._revoked = []
            if self._spiller is not None:
                self._spiller.close()
                self._spiller = None
                self._spilled_devices = []
        if self._mem is not None:
            self._mem.update(self, 0)

    def _new_spiller(self):
        sp = Spiller()
        self._spillers = (*self._spillers, sp)
        return sp

    def _maybe_spill_to_disk(self) -> None:
        """The disk tier: past the context's ``spill_to_disk_bytes``,
        everything buffered (revoked batches first, then the ones on the
        device, which is arrival order) goes to the spill file."""
        limit = self._mem.spill_to_disk_bytes
        with self._buffer_state():
            held = [b for b, _ in self._revoked] + self._batches
            if (not held or any(not b.columns for b in held)
                    or sum(b.nbytes for b in held) <= limit):
                return
            devices = [d for _, d in self._revoked] + [
                b.device for b in self._batches]
            if self._spiller is None:
                self._spiller = self._new_spiller()
            for b in held:
                self._spiller.spill(b)
            self._spilled_devices += devices
            self._revoked, self._batches = [], []
        self._mem.update(self, batch_device_residual(self))

    def buffered_batches(self) -> list:
        """The operator's whole input in arrival order, each batch back on
        its device: the spilled pages first (every disk spill takes all
        that was buffered), then the revoked batches (every revocation
        takes all that was on the device), then the ones still there."""
        with self._buffer_state():
            restored = []
            if self._spiller is not None:
                restored = [restore_to_device(b, dev) for b, dev in zip(
                    self._spiller.read_back(), self._spilled_devices)]
                self._spiller.close()
                self._spiller = None
                self._spilled_devices = []
            if self._revoked:
                restored += [to_device(b, dev) for b, dev in self._revoked]
                self._revoked = []
            if restored:
                self._batches = restored + self._batches
            return self._batches

    def disk_stats(self) -> tuple:
        """(pages, bytes, write seconds, read-back seconds) over every
        spill file of the operator."""
        sps = self._spillers
        return (sum(s.pages_spilled for s in sps),
                sum(s.bytes_spilled for s in sps),
                sum(s.write_s for s in sps), sum(s.read_s for s in sps))


def _host_copy(batch: ColumnBatch, tag: str) -> ColumnBatch:
    """A compact batch's columns in host memory: one counted read of all
    of them (the batch itself on the CPU)."""
    if batch.device.type == "cpu":
        return batch
    flat = [c.data for c in batch.columns] + [
        c.valid for c in batch.columns if c.valid is not None]
    got = iter(SG.fetch(flat, tag))
    data = [next(got) for _ in batch.columns]
    return ColumnBatch(batch.names, [
        Column(c.type, d, None if c.valid is None else next(got),
               c.dictionary) for c, d in zip(batch.columns, data)])


def split_aggregation(op: "HashAggregationOperator") -> Optional[tuple]:
    """A SINGLE aggregation as a (PARTIAL, FINAL) pair of operators that
    together compute its output from the same input (the single-node form
    of the reference's PARTIAL / exchange / FINAL split in
    ``planner/add_exchanges``), or None when it cannot split: a DISTINCT
    aggregate or a long-decimal average."""
    if op.step != "SINGLE" or any(
            a.distinct or (a.fn == "avg" and isinstance(a.type, DecimalType))
            for a in op.aggs):
        return None
    nk = len(op.group_keys)
    names, types = list(op.output_names[:nk]), list(op.output_types[:nk])
    calls, ch = [], nk
    for i, (a, states) in enumerate(zip(op.aggs,
                                        partial_agg_layout(op.aggs))):
        calls.append(AggCall(a.fn, ch, a.type, False))
        ch += len(states)
        for j, (_, t) in enumerate(states):
            names.append(f"_s{i}_{j}")
            types.append(t)
    partial = HashAggregationOperator(op.group_keys, op.aggs, names, types,
                                      "PARTIAL", op.device)
    final = HashAggregationOperator(list(range(nk)), calls, op.output_names,
                                    op.output_types, "FINAL", op.device)
    return partial, final


class HashAggregationOperator(BufferedInputMixin, Operator):
    """Grouped aggregation (operator/HashAggregationOperator.java:53):
    accumulate batches, then at finish either the small-code path (all keys
    small dictionary codes: no hashing, a scatter into the static group
    space) or the hash path (``hash_insert`` group ids + grouped_reduce).

    ``step`` is SINGLE, PARTIAL or FINAL.  PARTIAL emits the mergeable
    states of :func:`partial_agg_layout` after the group keys; FINAL reads
    such rows (group keys first, each call's ``arg`` its first state
    channel) and merges them: sums of sums and of counts, min / max /
    any_value of the states.  A grouped PARTIAL step flushes early: once
    ``FLUSH_ROWS`` input rows are buffered it emits their states at once,
    so its buffer stays bounded by the flush window (the
    InMemoryHashAggregationBuilder partial flush).  DISTINCT aggregates and
    long-decimal averages run SINGLE only.

    Under a disk budget a SINGLE or FINAL step without DISTINCT or a
    long-decimal average spills STATES, not raw pages (the reference's
    SpillableHashAggregationBuilder): past the budget it pre-aggregates
    its buffer into PARTIAL states, splits them into ``SPILL_PARTITIONS``
    hash partitions of the group keys on the device
    (``local_exchange.hash_partitions``; a group's rows share a partition)
    and appends each to a spill file of its own.  At finish it merges one
    partition at a time through a FINAL step back on the device, so the
    memory held is one partition's states.  The others take the raw-page
    tier of :class:`BufferedInputMixin`."""

    FLUSH_ROWS = 1 << 20
    SPILL_PARTITIONS = 16

    def __init__(self, group_keys: Sequence[int], aggs: Sequence[AggCall],
                 output_names: Sequence[str], output_types: Sequence[Type],
                 step: str = "SINGLE", device=None):
        if step not in ("SINGLE", "PARTIAL", "FINAL"):
            raise ValueError(f"aggregation step {step}")
        self.group_keys = list(group_keys)
        self.aggs = list(aggs)
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self.step = step
        # the task's device: where a result built without input lies
        self.device = None if device is None else torch.device(device)
        self._batches: list[ColumnBatch] = []
        self._buffered_rows = 0
        self._flushed: list[ColumnBatch] = []
        self._result: Optional[ColumnBatch] = None
        self._emitted = False
        self.encoding_stats = EncodingStats()
        # the partitioned state spill: one spill file per hash partition
        self._state_spillers: Optional[list] = None
        self._state_device = None  # where the merges run

    # -- partitioned state spill ----------------------------------------------

    def _state_spill_eligible(self) -> bool:
        return self.step in ("SINGLE", "FINAL") and not any(
            a.distinct or (a.fn == "avg" and isinstance(a.type, DecimalType))
            for a in self.aggs)

    def _maybe_spill_to_disk(self) -> None:
        """Spill states when the revoked bytes exceed the budget or the
        device rows would (8 bytes a row); raw pages when not eligible."""
        if not self._state_spill_eligible():
            super()._maybe_spill_to_disk()
            return
        limit = self._mem.spill_to_disk_bytes
        with self._buffer_state():
            host_bytes = sum(b.nbytes for b, _ in self._revoked)
            device_rows = sum(b.num_rows for b in self._batches)
        if host_bytes > limit or device_rows * 8 > limit:
            self._spill_states()
            self._mem.update(self, batch_device_residual(self))

    def _final_calls(self) -> list:
        """The FINAL step's calls over the spilled state rows."""
        if self.step == "FINAL":
            return list(self.aggs)
        calls, ch = [], len(self.group_keys)
        for a, states in zip(self.aggs, partial_agg_layout(self.aggs)):
            calls.append(AggCall(a.fn, ch, a.type, False))
            ch += len(states)
        return calls

    def _partial_states(self, batches: list) -> ColumnBatch:
        """The buffer as mergeable state rows (a FINAL step's input is
        state rows already), on its device, compacted."""
        if self.step == "FINAL":
            state = ColumnBatch.concat(batches, keep_live=True)
        else:
            nk = len(self.group_keys)
            names, types = [f"k{i}" for i in range(nk)], [
                batches[0].columns[c].type for c in self.group_keys]
            for i, states in enumerate(partial_agg_layout(self.aggs)):
                for j, (_, t) in enumerate(states):
                    names.append(f"s{i}_{j}")
                    types.append(t)
            tmp = HashAggregationOperator(self.group_keys, self.aggs, names,
                                          types, "PARTIAL", self.device)
            tmp._batches = batches
            state = tmp._compute()
        if state.live is not None:
            if state.live.device.type != "cpu":
                SG.count_sync("agg.spill-compact")
            state = state.compact()
        return state

    def _spill_states(self) -> None:
        """Pre-aggregate everything buffered, partition the states on the
        device and append each partition to its spill file: one counted
        read of the partition sizes, one of the sorted states."""
        from .local_exchange import hash_partitions

        with self._buffer_state():
            batches = self.buffered_batches()
            if not batches:
                return
            state = self._partial_states(batches)
            self._batches = []
            m = self.SPILL_PARTITIONS
            if self._state_spillers is None:
                self._state_spillers = [self._new_spiller()
                                        for _ in range(m)]
                self._state_device = state.device
            if not state.num_rows:
                return
            nk = len(self.group_keys)
            if nk:
                parts = hash_partitions(state, range(nk), m)
                order = torch.argsort(parts, stable=True)
                counts = SG.fetch(torch.bincount(parts, minlength=m),
                                  "agg.spill-partitions")
                state = ColumnBatch(state.names,
                                    [c.take(order) for c in state.columns])
            else:  # a global aggregation: one partition
                counts = np.zeros(m, np.int64)
                counts[0] = state.num_rows
            host = _host_copy(state, "agg.spill-states")
            start = 0
            for p in range(m):
                n = int(counts[p])
                if n:
                    self._state_spillers[p].spill(host.slice(start,
                                                             start + n))
                start += n
        self._buffered_rows = 0

    def _merge_spilled(self) -> list:
        """Merge-on-unspill: one FINAL step per partition, on the device
        the states came from."""
        nk, calls = len(self.group_keys), self._final_calls()
        outs = []
        for sp in self._state_spillers:
            batches = [restore_to_device(b, self._state_device)
                       for b in sp.read_back()]
            sp.close()
            if not batches:
                continue
            merger = HashAggregationOperator(list(range(nk)), calls,
                                             self.output_names,
                                             self.output_types, "FINAL",
                                             self.device)
            merger._batches = batches
            out = merger._compute()
            if out.num_rows:
                outs.append(out)
        self._state_spillers = None
        return outs

    def _can_flush(self) -> bool:
        # PARTIAL states merge downstream; SINGLE / FINAL see all input
        return self.step == "PARTIAL" and bool(self.group_keys)

    def add_input(self, batch: ColumnBatch) -> None:
        if not batch.num_rows:
            return
        self.buffer(batch)
        self._buffered_rows += batch.num_rows
        if self._can_flush() and self._buffered_rows >= self.FLUSH_ROWS:
            out = self._compute()
            if out.num_rows:
                self._flushed.append(out)
            self._buffered_rows = 0
            self.release_memory()

    def finish_input(self) -> None:
        super().finish_input()
        if self._state_spillers is not None:
            # spill the tail, then merge partition by partition
            self._spill_states()
            self._flushed.extend(self._merge_spilled())
            self._emitted = True
            self.release_memory()
            return
        if self._flushed and not self.buffered_batches():
            self._emitted = True  # everything left with the flushes
        else:
            self._result = self._compute()
        self.release_memory()

    def _empty_result(self, nk: int) -> ColumnBatch:
        """The result over no live input, on the task's device (a FINAL
        task concatenates it with its other producers' batches)."""
        out = self._empty_columns(nk)
        return out if self.device is None else out.to(self.device)

    def _empty_columns(self, nk: int) -> ColumnBatch:
        if nk:  # grouped agg over empty input -> empty result
            cols = [Column(t, np.empty(0, t.storage_dtype))
                    for t in self.output_types]
            return ColumnBatch(self.output_names, cols)
        # global agg over empty input -> one row of defaults: counts 0,
        # other values NULL (a PARTIAL sum of squares 0)
        layouts = (partial_agg_layout(self.aggs) if self.step == "PARTIAL"
                   else [[(a.fn, None)] for a in self.aggs])
        cols = []
        types = iter(self.output_types)
        for states in layouts:
            for j, (name, _) in enumerate(states):
                t = next(types)
                if name in ("count", "avg_count", "stat_count",
                            "stat_sumsq"):
                    cols.append(Column(t, np.zeros(1, t.storage_dtype)))
                else:
                    cols.append(Column(t, np.zeros(1, t.storage_dtype),
                                       np.zeros(1, bool)))
        return ColumnBatch(self.output_names, cols)

    def _final_specs(self, a: AggCall, inp: ColumnBatch, specs: list,
                     plan: list) -> bool:
        """FINAL's merge of avg, variance and count states (True when
        handled): sums of the state columns.  Other calls merge like
        SINGLE ones over their state column."""
        col = inp.columns[a.arg]
        if a.fn == "avg":
            cnt = inp.columns[a.arg + 1]
            plan.append(("avg", len(specs)))
            specs.append(("sum", col.data, col.valid, np.float64, False))
            specs.append(("sum", cnt.data, cnt.valid, np.int64, False))
        elif a.fn in STAT_AGGS:
            sq, cnt = inp.columns[a.arg + 1], inp.columns[a.arg + 2]
            plan.append(("stat", len(specs)))
            specs.append(("sum", col.data, col.valid, np.float64, False))
            specs.append(("sum", sq.data, sq.valid, np.float64, False))
            specs.append(("sum", cnt.data, cnt.valid, np.int64, False))
        elif a.fn == "count":
            plan.append(("count", len(specs)))
            specs.append(("sum", col.data, col.valid, np.int64, False))
        else:
            return False
        return True

    def _specs(self, inp: ColumnBatch):
        """Kernel specs (fn, data, valid, dtype, distinct[, pre]) and the
        finalize plan; avg expands to a (scale-free f64 sum, count) pair."""
        specs, plan = [], []
        limbs: dict = {}  # argument channel -> its gathered limb planes
        for a in self.aggs:
            if self.step == "FINAL" and self._final_specs(a, inp, specs,
                                                          plan):
                continue
            if a.fn == "count" and a.arg < 0:
                plan.append(("count", len(specs)))
                specs.append(("count_star", None, None, np.int64, False))
                continue
            col = inp.columns[a.arg]
            dist = bool(a.distinct)
            if a.fn in ("sum", "avg") and isinstance(
                    col.type, DecimalType) and col.type.is_long:
                # exact wide sum / avg: six int64 limb-plane sums and a
                # count, recombined as python ints per group
                if dist:
                    raise NotImplementedError(
                        "DISTINCT long-decimal aggregate")
                plan.append(("long_" + a.fn, len(specs)))
                if a.arg not in limbs:
                    codes = col.data.long()
                    limbs[a.arg] = [
                        as_tensor(tab, col.data.device)[codes]
                        for tab in K.decimal_limb_tables(col.dictionary)]
                for plane in limbs[a.arg]:
                    specs.append(("sum", plane, col.valid, np.int64, False))
                specs.append(("count", col.data, col.valid, np.int64,
                              False))
                continue
            if a.fn == "avg":
                scale = (col.type.scale if isinstance(col.type, DecimalType)
                         else 0)
                plan.append(("avg", len(specs)))
                specs.append(("sum", col.data, col.valid, np.float64, dist,
                              ("scale", scale)))
                specs.append(("count", col.data, col.valid, np.int64, dist))
            elif a.fn == "sum":
                dtype = (np.float64 if a.type == DOUBLE
                         else np.float32 if a.type.name == "real"
                         else np.int64)
                plan.append(("sum", len(specs)))
                specs.append(("sum", col.data, col.valid, dtype, dist))
            elif a.fn == "count":
                plan.append(("count", len(specs)))
                specs.append(("count", col.data, col.valid, np.int64, dist))
            elif a.fn in ("min", "max", "any_value"):
                # DISTINCT does not change a min, a max or any value
                plan.append((a.fn, len(specs)))
                specs.append((a.fn, col.data, col.valid, None, False))
            elif a.fn in STAT_AGGS:
                # (sum, sum of squares, count) states; the analyzer casts
                # the argument to DOUBLE and rejects DISTINCT
                plan.append(("stat", len(specs)))
                specs.append(("sum", col.data, col.valid, np.float64, False))
                specs.append(("sum", col.data, col.valid, np.float64, False,
                              ("square",)))
                specs.append(("count", col.data, col.valid, np.int64, False))
            else:
                raise NotImplementedError(f"aggregate {a.fn}")
        return specs, plan

    # aggregates computable from one stored value and a live / valid count
    _RLE_AGG_FNS = frozenset(("sum", "count", "count_star", "min", "max"))

    def _rle_fast_path(self) -> Optional[ColumnBatch]:
        """A global aggregation over RLE inputs: SUM(x) over a constant run
        is ``value * run_count`` (the RunLengthEncodedBlock shortcut): host
        arithmetic over per-batch scalars, no concatenation and no
        expansion.  Taken only when every live mask and run mask is on the
        host (counting a device mask would cost a sync)."""
        if (self.group_keys or not self.aggs or self.step == "FINAL"
                or any(a.distinct for a in self.aggs)
                or not all(a.fn in self._RLE_AGG_FNS for a in self.aggs)):
            return None
        for b in self._batches:
            if b.live is not None and b.live.device.type != "cpu":
                return None
            for a in self.aggs:
                if a.arg < 0:
                    continue
                c = b.columns[a.arg]
                if c.encoding != "RLE" or (c.valid is not None and
                                           c.valid.device.type != "cpu"):
                    return None
                if c.dictionary is not None and a.fn == "sum":
                    return None  # codes do not sum; min / max do (sorted)
        first = self._batches[0]
        for a in self.aggs:  # min / max on codes need ONE dictionary
            if a.arg < 0 or first.columns[a.arg].dictionary is None:
                continue
            d0 = first.columns[a.arg].dictionary
            if not all(_same_dictionary(b.columns[a.arg].dictionary, d0)
                       for b in self._batches[1:]):
                return None

        def counted(b: ColumnBatch, c: Column) -> int:
            """Rows of this run that are live and valid."""
            if c.valid is None and b.live is None:
                return len(c)
            m = torch.ones(len(c), dtype=torch.bool)
            if c.valid is not None:
                m &= c.valid
            if b.live is not None:
                m &= b.live
            return int(torch.count_nonzero(m))

        out_cols: list[Column] = []
        rows_folded = 0
        for a, t in zip(self.aggs, self.output_types):
            if a.arg < 0:  # count(*)
                total = sum(b.live_count for b in self._batches)
                out_cols.append(Column(t, np.array([total], np.int64)))
                continue
            pairs = [(b.columns[a.arg], counted(b, b.columns[a.arg]))
                     for b in self._batches]
            rows_folded += sum(cnt for _, cnt in pairs)
            if a.fn == "count":
                out_cols.append(Column(t, np.array(
                    [sum(cnt for _, cnt in pairs)], np.int64)))
                continue
            alive = [(c, cnt) for c, cnt in pairs if cnt > 0]
            if not alive:  # sum / min / max of no value is NULL
                out_cols.append(Column(t, np.zeros(1, t.storage_dtype),
                                       np.zeros(1, np.bool_),
                                       pairs[0][0].dictionary))
                continue
            if a.fn == "sum":
                dtype = np.dtype(t.storage_dtype)
                if dtype.kind == "f":
                    v = float(sum(float(c.rle_value) * cnt
                                  for c, cnt in alive))
                else:  # exact: python ints until the final cast
                    v = sum(int(c.rle_value) * cnt for c, cnt in alive)
                out_cols.append(Column(t, np.array([v], dtype)))
            else:
                pick = min if a.fn == "min" else max
                v = pick(c.rle_value for c, _ in alive)
                out_cols.append(Column(t, np.array([v], v.dtype), None,
                                       alive[0][0].dictionary))
        self.encoding_stats.rle_agg_rows += rows_folded
        self.encoding_stats.rle_batches += len(self._batches)
        return ColumnBatch(self.output_names, out_cols).to(first.device)

    def _compute(self) -> ColumnBatch:
        nk = len(self.group_keys)
        if not self.buffered_batches():
            return self._empty_result(nk)
        fast = self._rle_fast_path()
        if fast is not None:
            return fast
        inp = _maybe_compact(ColumnBatch.concat(self._batches,
                                                keep_live=True))
        live = inp.live
        key_cols = [inp.columns[i] for i in self.group_keys]
        specs, plan = self._specs(inp)
        presence = None
        space = K.small_codes_group_space(key_cols) if nk else 1
        if nk and space is not None:
            # every key is a small dictionary code: the group-by runs in
            # code space
            self.encoding_stats.code_group_batches += 1
        if space is not None:
            reduced, presence, keys_out, num_groups = (
                K.small_grouped_aggregate(key_cols, live, specs,
                                          inp.num_rows, inp.device))
        else:
            keys = [(c.data, c.valid) for c in key_cols]
            perm, gid, num_groups = K.hash_group_ids(keys, live)
            if num_groups == 0:  # every row dead
                return self._empty_result(nk)
            keys_out = K.group_keys_out(perm, gid, num_groups, keys)
            reduced = K.grouped_reduce(perm, gid, num_groups, specs)
        # finalize: one plan entry per output column after the keys
        # (PARTIAL emits avg / variance states instead of their values)
        partial = self.step == "PARTIAL"
        fplan, arrays, meta = [], [], []  # meta: (type, dictionary) | idx
        types = iter(self.output_types[nk:])
        for idx, (a, (kind, i)) in enumerate(zip(self.aggs, plan)):
            t = next(types)
            if kind.startswith("long_"):
                meta.append(idx)
                continue
            d, v = reduced[i]
            dv = [d] + ([v] if v is not None else [])
            if kind == "avg" and partial:
                c, _ = reduced[i + 1]
                fplan += [("copy", np.float64, v is not None),
                          ("count", None, False)]
                arrays += dv + [c]
                meta += [(t, None), (next(types), None)]
            elif kind == "avg":
                c, _ = reduced[i + 1]
                fplan.append(("avg_final", t.storage_dtype, v is not None))
                arrays += dv + [c]
                meta.append((t, None))
            elif kind == "stat" and partial:
                (q, _), (c, _) = reduced[i + 1], reduced[i + 2]
                fplan += [("copy", np.float64, v is not None),
                          ("copy", np.float64, False),
                          ("count", None, False)]
                arrays += dv + [q, c]
                meta += [(t, None), (next(types), None), (next(types), None)]
            elif kind == "stat":
                (q, _), (c, _) = reduced[i + 1], reduced[i + 2]
                fplan.append(("stat_final", a.fn, t.storage_dtype,
                              v is not None))
                arrays += dv + [q, c]
                meta.append((t, None))
            elif kind == "count":
                fplan.append(("count", None, False))
                arrays.append(d)
                meta.append((t, None))
            else:
                fplan.append(("copy", t.storage_dtype, v is not None))
                arrays += dv
                meta.append((t, inp.columns[a.arg].dictionary
                             if kind in ("min", "max", "any_value")
                             else None))
        outs = iter(K.finalize_groups(fplan, arrays))
        wide = self._long_decimal_columns(inp, plan, reduced)
        out_cols = [Column(c.type, d, v, c.dictionary)
                    for (d, v), c in zip(keys_out, key_cols)]
        for m in meta:
            if isinstance(m, int):
                out_cols.append(wide[m])
                continue
            d, v = next(outs)
            out_cols.append(Column(m[0], d, v, m[1]))
        return ColumnBatch(self.output_names, out_cols, presence)

    def _long_decimal_columns(self, inp: ColumnBatch, plan,
                              reduced) -> dict:
        """Finalize the long-decimal sums and averages: one host fetch of
        every per-group limb sum and count (groups x 7 int64 each), then
        python-int recombination, HALF_UP at the output scale for AVG.
        Returns agg index -> a column on the input's device."""
        picks = [(idx, kind, i) for idx, (kind, i) in enumerate(plan)
                 if kind.startswith("long_")]
        if not picks:
            return {}
        fetched = SG.fetch(torch.stack([reduced[i + k][0]
                                        for _, _, i in picks
                                        for k in range(7)]),
                           "agg.decimal-limbs")
        nk = len(self.group_keys)
        out = {}
        for j, (idx, kind, _) in enumerate(picks):
            planes = fetched[7 * j: 7 * j + 7]
            counts = planes[6]
            totals = K.combine_limb_sums(planes[:6])
            src_scale = inp.columns[self.aggs[idx].arg].type.scale
            t = self._output_type(idx)
            values: list = []
            with decimal.localcontext() as ctx:
                ctx.prec = 80
                for total, cnt in zip(totals, counts):
                    if cnt == 0:
                        values.append(None)
                    elif kind == "long_avg":
                        q = (decimal.Decimal(int(total)).scaleb(-src_scale)
                             / int(cnt))
                        values.append(int(q.scaleb(t.scale).quantize(
                            0, rounding=decimal.ROUND_HALF_UP)))
                    else:
                        values.append(rescale_scaled_int(
                            int(total), src_scale, t.scale))
            codes, valid, dict_ = encode_sorted_objects(values, 0)
            out[idx] = Column(t, codes, valid, dict_).to(inp.device)
        return out

    def _output_type(self, idx: int) -> Type:
        """The output type of aggregate ``idx`` (its first state column's
        under PARTIAL)."""
        widths = ([len(st) for st in partial_agg_layout(self.aggs)]
                  if self.step == "PARTIAL" else [1] * len(self.aggs))
        return self.output_types[len(self.group_keys) + sum(widths[:idx])]

    def get_output(self) -> Optional[ColumnBatch]:
        if self._flushed:
            return self._flushed.pop(0)
        if self.input_done and self._result is not None and not self._emitted:
            self._emitted = True
            return self._result
        return None

    def is_finished(self) -> bool:
        return (self.input_done and self._emitted
                and not self._flushed) or self._closed


# ---------------------------------------------------------------------------
# joins


class JoinBridge:
    """Build-side handoff between pipelines (the LookupSourceFactory)."""

    def __init__(self):
        self.table: Optional[JX.DeviceJoinTable] = None
        self.batch: Optional[ColumnBatch] = None
        self.key_dicts: list = []

    @property
    def ready(self) -> bool:
        return self.batch is not None


class JoinBuildSink(BufferedInputMixin, Operator):
    """Accumulates the build side, then builds the join table
    (operator/join/HashBuilderOperator.java:57)."""

    def __init__(self, bridge: JoinBridge, key_channels: Sequence[int],
                 types: Sequence[Type], names: Sequence[str], device,
                 dynamic_filter_holders=None):
        self.bridge = bridge
        self.key_channels = list(key_channels)
        self.types = list(types)
        self.names = list(names)
        self.device = torch.device(device)
        # one holder per key channel (or None), filled at finish so the
        # probe-side scan can prune (exec/dynamic_filter.py)
        self.dynamic_filter_holders = list(dynamic_filter_holders or [])
        self._batches: list[ColumnBatch] = []

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self.buffer(batch)

    def finish_input(self) -> None:
        super().finish_input()
        if self.buffered_batches():
            # dead rows are dropped before the build: on the card the
            # compaction costs less than hashing and indexing them
            batch = ColumnBatch.concat(self._batches)
        else:
            batch = ColumnBatch(self.names, [
                Column(t, np.empty(0, t.storage_dtype)) for t in self.types])
            batch = batch.to(self.device)
        self.release_memory()
        keys = [(JX.key_input(batch.columns[ch]), batch.columns[ch].valid)
                for ch in self.key_channels]
        for (data, valid), ch, holder in zip(keys, self.key_channels,
                                             self.dynamic_filter_holders):
            if holder is not None:
                holder.fill_device(data, valid, batch.live,
                                   batch.columns[ch].dictionary)
        self.bridge.key_dicts = [batch.columns[ch].dictionary
                                 for ch in self.key_channels]
        # a keyless (nested-loop) join reads the batch alone
        self.bridge.table = (JX.build_table(keys, live=batch.live) if keys
                             else None)
        self.bridge.batch = batch

    def is_finished(self) -> bool:
        return self.input_done


class _Residual:
    """A join's residual predicate over the pair layout (probe columns ++
    build columns), compiled once per set of probe/build dictionaries.
    Calling the bound program returns the bool mask (NULL = no match)."""

    def __init__(self, expr: RowExpression):
        self.expr = expr
        self.refs = referenced_inputs(expr)
        self._dicts = None
        self._prog = None

    def bind(self, probe: ColumnBatch, build: ColumnBatch):
        cols = list(probe.columns) + list(build.columns)
        dicts = [c.dictionary for c in cols]
        if self._dicts is None or not all(
                a is b for a, b in zip(self._dicts, dicts)):
            ce = compile_expression(self.expr, [c.type for c in cols],
                                    dicts, device=probe.device)

            def prog(pair_cols):
                d, v = ce(pair_cols)
                return d if v is None else (d & v)

            prog.refs = self.refs
            self._dicts, self._prog = dicts, prog
        return self._prog


def _null_columns(build: ColumnBatch, n: int, device) -> list[Column]:
    """All-NULL stand-ins for the build columns over ``n`` rows."""
    return [Column(c.type, torch.zeros(n, dtype=c.data.dtype, device=device),
                   torch.zeros(n, dtype=torch.bool, device=device),
                   c.dictionary)
            for c in build.columns]


def _nested_loop_pairs(probe: ColumnBatch, build: ColumnBatch, residual):
    """Nested-loop pair expansion of two compacted batches (operator/join/
    NestedLoopJoinOperator.java:45): the full probe x build product, kept
    where the residual holds.  Returns (probe idx, build idx)."""
    dev = probe.device
    nb, npr = build.num_rows, probe.num_rows
    pi = torch.arange(npr, device=dev).repeat_interleave(nb)
    bi = torch.arange(nb, device=dev).repeat(npr)
    if residual is None or not len(pi):
        return pi, bi
    prog = residual.bind(probe, build)
    cols = ([(c.data[pi], None if c.valid is None else c.valid[pi])
             for c in probe.columns]
            + [(c.data[bi], None if c.valid is None else c.valid[bi])
               for c in build.columns])
    mask = prog(cols)
    if mask.dim() == 0:
        mask = mask.expand(pi.shape)
    return pi[mask], bi[mask]


class _ProbeKeys:
    """Probe key (data, valid) pairs and the dictionary remaps into the
    build's code space, one remap table per key kept while the probe's
    dictionary object stays the same (batches of one table share it), so a
    steady-state probe copies no table to the device."""

    def __init__(self, channels: Sequence[int]):
        self.channels = list(channels)
        self._remaps: dict = {}  # key index -> (probe dictionary, remap)

    def __call__(self, batch: ColumnBatch, bridge: "JoinBridge"):
        keys = [(JX.key_input(batch.columns[ch]), batch.columns[ch].valid)
                for ch in self.channels]
        remaps = []
        for k, ch in enumerate(self.channels):
            pdict = batch.columns[ch].dictionary
            hit = self._remaps.get(k)
            if hit is None or hit[0] is not pdict:
                hit = (pdict, JX.probe_key_remap(pdict, bridge.key_dicts[k],
                                                 batch.device))
                self._remaps[k] = hit
            remaps.append(hit[1])
        return keys, remaps


def _cols(batch: ColumnBatch) -> list:
    return [(c.data, c.valid) for c in batch.columns]


def _take_rows(c: Column, idx) -> Column:
    """``c.take(idx)``, except that a LAZY column stays LAZY: the gather
    runs when something reads the result (late materialization survives
    a compacting join)."""
    if c.encoding != "LAZY":
        return c.take(idx)
    n = int(idx.shape[0])
    return Column.lazy(
        c.type, n,
        lambda: (c.data[idx], None if c.valid is None else c.valid[idx]),
        c.dictionary, device=c.device,
        nbytes_hint=c.nbytes * n // max(len(c), 1))


class LookupJoinOperator(Operator):
    """Probe side of the equi-join (operator/join/LookupJoinOperator.java:37)
    for INNER, CROSS, LEFT, RIGHT, FULL and SINGLE joins, with an optional
    residual.  The keyed probe makes no host sync in its steady state: a
    unique build (every FK->PK edge) keeps the probe batch's shape (dense or
    sorted-hash lookup), or, for a selective INNER / RIGHT probe, compacts
    its matches to a bucket estimated from earlier batches' match counts;
    a build with duplicate keys expands the candidate runs the
    ``hash_probe`` kernel finds into a padded bucket (exec/join_exec.py:
    :class:`ExpandPlanner` picks it, an estimated one waits in an
    :class:`OverflowQueue` for its overflow flag).  LEFT / SINGLE / FULL
    keep every probe row: an unmatched one is NULL-extended.  RIGHT / FULL
    count, in one device tensor per build row, the pairs that survived the
    residual, and after the last probe batch emit one more batch: the build
    rows no pair matched (NULL keys included), with NULL probe-side columns.
    A SINGLE join (a scalar subquery) whose build gives a probe row more
    than one match raises SUBQUERY_MULTIPLE_ROWS through the deferred error
    channel (``pending_errors``, read once at the pipeline's end).  Keyless
    joins run as a nested loop, with the same marking, and raise at once."""

    def __init__(self, bridge: JoinBridge, left_keys: Sequence[int],
                 join_type: str, residual: Optional[RowExpression],
                 output_names: Sequence[str], output_types: Sequence[Type]):
        if join_type not in ("INNER", "CROSS", "LEFT", "RIGHT", "FULL",
                             "SINGLE"):
            raise NotImplementedError(f"{join_type} join")
        self.bridge = bridge
        self.left_keys = list(left_keys)
        self.join_type = join_type
        self.residual_expr = residual
        self.residual = _Residual(residual) if residual is not None else None
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._pending: "deque[ColumnBatch]" = deque()
        # RIGHT / FULL: matched pairs per build row, and the dictionaries
        # of the last probe batch for the epilogue's NULL probe columns
        self._build_hits: Optional[torch.Tensor] = None
        self._probe_dicts: Optional[list] = None
        self._epilogue_done = not self._build_outer
        self.encoding_stats = EncodingStats()
        self._keys = _ProbeKeys(self.left_keys)
        # sync-free probe state: bucket planners keyed by the join's shape
        # (a later run of the same plan starts from this run's totals) and
        # the deferred commits of estimated buckets
        ident = (join_type, tuple(self.left_keys), tuple(self.output_names),
                 residual is not None)
        self._planner = JX.ExpandPlanner(key=("pairs",) + ident)
        self._uplanner = JX.ExpandPlanner(key=("unique",) + ident)
        self._inflight = JX.OverflowQueue()
        self.pending_errors: list = []  # deferred cardinality violations
        self.expand_batches = 0  # probe batches through the padded expand

    @property
    def _outer(self) -> bool:
        """Unmatched probe rows are kept (NULL-extended)."""
        return self.join_type in ("LEFT", "SINGLE", "FULL")

    @property
    def _build_outer(self) -> bool:
        """Unmatched build rows are kept (the epilogue)."""
        return self.join_type in ("RIGHT", "FULL")

    def needs_input(self) -> bool:
        return (self.bridge.ready and not self._pending
                and super().needs_input())

    def _emit(self, cols, live=None) -> None:
        self._pending.append(ColumnBatch(self.output_names, cols, live))

    def _null_extended(self, probe: ColumnBatch, live) -> None:
        """Unmatched probe rows keep the probe batch's shape under ``live``;
        the build columns read NULL."""
        self._emit(list(probe.columns) + _null_columns(
            self.bridge.batch, probe.num_rows, probe.device), live)

    def _too_many_rows(self) -> TrinoError:
        return TrinoError(SUBQUERY_MULTIPLE_ROWS,
                          "scalar subquery returned multiple rows")

    def _mark_build(self, build_id, ok) -> None:
        """Count the surviving pairs per build row (no host sync)."""
        if self._build_hits is None:
            self._build_hits = torch.zeros(self.bridge.batch.num_rows,
                                           dtype=torch.int64,
                                           device=build_id.device)
        self._build_hits.index_add_(0, build_id, ok.to(torch.int64))

    def _add_cross_input(self, probe: ColumnBatch) -> None:
        probe = probe.compact()
        build = self.bridge.batch
        if (self.join_type == "SINGLE" and build.num_rows > 1
                and probe.num_rows):
            raise self._too_many_rows()
        pi, bi = _nested_loop_pairs(probe, build, self.residual)
        if self._build_outer:
            self._mark_build(bi, torch.ones_like(bi, dtype=torch.bool))
        if self._outer:
            matched = torch.zeros(probe.num_rows, dtype=torch.bool,
                                  device=probe.device)
            matched[pi] = True
            un = torch.nonzero(~matched).flatten()
            if len(un):
                self._emit([c.take(un) for c in probe.columns]
                           + _null_columns(build, len(un), probe.device))
        if len(pi):
            self._emit([c.take(pi) for c in probe.columns]
                       + [c.take(bi) for c in build.columns])

    def add_input(self, probe: ColumnBatch) -> None:
        if self._build_outer:
            self._probe_dicts = [c.dictionary for c in probe.columns]
        if probe.num_rows == 0:
            return
        if not self.left_keys:
            self._add_cross_input(probe)
            return
        build = self.bridge.batch
        table = self.bridge.table
        if table.num_rows == 0:  # empty build: every probe row unmatched
            if self._outer:
                self._null_extended(probe, probe.live)
            return
        keys, remaps = self._keys(probe, self.bridge)
        if any(r is not None for r in remaps):
            # dictionary keys probe as remapped int32 codes, never values
            self.encoding_stats.code_join_batches += 1
        residual = (self.residual.bind(probe, build)
                    if self.residual is not None else None)
        if table.unique:
            self._add_unique(probe, table, keys, remaps, residual)
        else:
            self._add_pairs(probe, table, keys, remaps, residual)

    def _add_unique(self, probe: ColumnBatch, table, keys, remaps,
                    residual) -> None:
        """One match at most per probe row.  INNER / RIGHT compact the
        matches when earlier batches' landed match counts say they fill at
        most a quarter of the lanes (the wide output is the overflow's
        retry); every other case keeps the probe batch's shape."""
        build = self.bridge.batch
        build_cols = _cols(build)
        # only what the residual reads: a LAZY payload column stays LAZY
        probe_cols = ([(c.data, c.valid) if i in residual.refs else None
                       for i, c in enumerate(probe.columns)]
                      if residual is not None else ())

        def wide():
            return ("wide",) + JX.unique_output(
                ok, bid, keys, build_cols, live=probe.live,
                residual=residual, probe_cols=probe_cols)

        def commit(res) -> None:
            if res[0] == "wide":
                _, b_out, ok_live, _ = res
                if self._build_outer:
                    self._mark_build(bid, ok_live)
                left, right_bid = list(probe.columns), None
                live = probe.live if self._outer else ok_live
            else:
                _, lanes, b_out, live, right_bid, _ = res
                if self._build_outer:
                    self._mark_build(right_bid, live)
                left = [_take_rows(c, lanes) for c in probe.columns]
            right = [Column(c.type, d, v, c.dictionary)
                     for c, (d, v) in zip(build.columns, b_out)]
            # LEFT/SINGLE/FULL: unmatched rows stay live, build side NULL
            self._emit(left + right, live)

        with SG.hot_region():
            ok, bid = JX.unique_lookup(table, keys, remaps)
            if self.join_type not in ("INNER", "RIGHT"):
                self._inflight.submit(None, wide(), None, commit)
                return
            ok_live = ok if probe.live is None else ok & probe.live
            est = self._uplanner.recent_max()
            cap = JX.plan_unique_cap(
                probe.num_rows, None if est is None
                else est * JX.EST_HEADROOM)
            self._uplanner.observe_async(
                SG.async_scalar(ok_live.sum(), "join.unique-count"))
            if cap is None:
                self._inflight.submit(None, wide(), None, commit)
                return
            res = ("compact",) + JX.unique_compact(
                ok_live, bid, cap, build_cols, residual, probe_cols)
            self._inflight.submit(
                SG.async_scalar(res[5], "join.unique-overflow"), res, wide,
                commit)

    def _add_pairs(self, probe: ColumnBatch, table, keys, remaps,
                   residual) -> None:
        """A build with duplicate keys: candidate runs, then the padded
        expand at the planner's bucket.  A provable bucket commits at
        once; an estimated one commits once its overflow flag has landed
        False, or re-runs at the exact total."""
        build = self.bridge.batch
        probe_cols, build_cols = _cols(probe), _cols(build)
        self.expand_batches += 1

        def commit(res) -> None:
            pairs, ok, matches, _, build_id, _ = res
            if self.join_type == "SINGLE":
                self.pending_errors.append(torch.where(
                    matches.max() > 1, ERR_MULTIPLE_ROWS, 0).to(torch.int32))
            if self._build_outer:
                self._mark_build(build_id, ok)
            cols = list(probe.columns) + list(build.columns)
            self._emit([Column(c.type, d, v, c.dictionary)
                        for c, (d, v) in zip(cols, pairs)], ok)
            if self._outer:
                unmatched = matches == 0
                self._null_extended(probe, unmatched if probe.live is None
                                    else probe.live & unmatched)

        with SG.hot_region():
            lo, counts, total = JX.probe_ranges_device(table, keys, remaps,
                                                       probe.live)
            cap, provable = self._planner.plan(probe.num_rows, table.max_run)
            self._planner.observe_async(total)
            res = JX.run_pairs(table, lo, counts, total, keys, remaps,
                               probe_cols, build_cols, residual=residual,
                               need_matched=self._outer, cap=cap)
            if provable:  # cap >= any possible total: no overflow
                self._inflight.submit(None, res, None, commit)
                return

            def retry():
                # rare: the estimated bucket truncated candidates; re-run
                # at the exact total (landed before its flag did)
                exact = max(int(total.get()), 1)
                self._planner.observe(exact)
                return JX.run_pairs(table, lo, counts, exact, keys, remaps,
                                    probe_cols, build_cols,
                                    residual=residual,
                                    need_matched=self._outer)

            self._inflight.submit(
                SG.async_scalar(res[5], "join.expand-overflow"), res, retry,
                commit)

    def _unmatched_build(self) -> Optional[ColumnBatch]:
        """The RIGHT / FULL epilogue: every live build row no pair matched,
        with NULL probe-side columns.  A NULL string column carries the last
        probe batch's dictionary, or [""] when no probe batch arrived (a
        one-entry dictionary, as a NULL literal has, keeps a gather of code
        0 in bounds downstream)."""
        build = self.bridge.batch
        if build is None or build.num_rows == 0:
            return None
        dev = build.device
        keep = (torch.ones(build.num_rows, dtype=torch.bool, device=dev)
                if self._build_hits is None else self._build_hits == 0)
        if build.live is not None:
            keep = keep & build.live
        un = torch.nonzero(keep).flatten()
        n = len(un)
        if not n:
            return None
        probe_types = self.output_types[:len(self.output_types)
                                        - build.num_columns]
        cols = []
        for i, t in enumerate(probe_types):
            d = (self._probe_dicts[i] if self._probe_dicts is not None
                 else None)
            if t.is_dictionary_encoded and (d is None or not len(d)):
                d = np.array([""], dtype=object)
            cols.append(Column(
                t, torch.zeros(n, dtype=torch_dtype(t.storage_dtype),
                               device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev), d))
        return ColumnBatch(self.output_names,
                           cols + [c.take(un) for c in build.columns])

    def get_output(self) -> Optional[ColumnBatch]:
        if len(self._inflight):
            # commit landed estimated buckets; at input end the tail is
            # waited for (the probe's only blocking poll)
            self._inflight.drain(block=self.input_done)
        if self.input_done:
            self._planner.settle()
            self._uplanner.settle()
        if self._pending:
            return self._pending.popleft()
        if self.input_done and not self._closed and not self._epilogue_done:
            self._epilogue_done = True
            return self._unmatched_build()
        return None

    def is_finished(self) -> bool:
        return self._closed or (self.input_done and not self._pending
                                and not len(self._inflight)
                                and self._epilogue_done)


class SemiJoinOperator(Operator):
    """Mark join for IN / EXISTS (operator/HashSemiJoinOperator.java:47):
    output = source channels + a BOOLEAN match column.  Null-aware IN is
    three-valued: a non-match is NULL when the probe key is NULL or the
    build holds a NULL key, so a downstream ``$not`` yields NULL and the
    row is filtered (NOT IN); IN over an empty build is FALSE.  The keyed
    mark is sync-free as the lookup join's probe is.  A keyless semi-join
    (EXISTS with only non-equi conjuncts) runs as a nested loop where the
    residual alone decides the mark."""

    def __init__(self, bridge: JoinBridge, source_keys: Sequence[int],
                 null_aware: bool, residual: Optional[RowExpression],
                 output_names: Sequence[str], output_types: Sequence[Type]):
        self.bridge = bridge
        self.source_keys = list(source_keys)
        self.null_aware = null_aware
        self.residual_expr = residual
        self.residual = _Residual(residual) if residual is not None else None
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._pending: "deque[ColumnBatch]" = deque()
        self._keys = _ProbeKeys(self.source_keys)
        self._planner = JX.ExpandPlanner(key=(
            "semi", tuple(self.source_keys), null_aware,
            tuple(self.output_names), residual is not None))
        self._inflight = JX.OverflowQueue()
        self.expand_batches = 0  # probe batches through the padded expand

    def needs_input(self) -> bool:
        return (self.bridge.ready and not self._pending
                and super().needs_input())

    def _emit(self, batch: ColumnBatch, data, valid=None) -> None:
        self._pending.append(ColumnBatch(
            self.output_names,
            list(batch.columns) + [Column(BOOLEAN, data, valid)], batch.live))

    def _add_keyless_input(self, batch: ColumnBatch) -> None:
        batch = batch.compact()
        pi, _ = _nested_loop_pairs(batch, self.bridge.batch, self.residual)
        matched = torch.zeros(batch.num_rows, dtype=torch.bool,
                              device=batch.device)
        matched[pi] = True
        self._emit(batch, matched)

    def add_input(self, batch: ColumnBatch) -> None:
        if not self.source_keys:
            self._add_keyless_input(batch)
            return
        table = self.bridge.table
        build = self.bridge.batch

        def commit(res) -> None:
            self._emit(batch, *res[3])

        if table.num_rows == 0 or batch.num_rows == 0:
            # IN over the empty set is FALSE
            self._inflight.submit(None, (None,) * 3 + ((torch.zeros(
                batch.num_rows, dtype=torch.bool, device=batch.device),
                None),), None, commit)
            return
        keys, remaps = self._keys(batch, self.bridge)
        semi = (self.null_aware, table.has_null_key, table.live_rows > 0)
        residual = (self.residual.bind(batch, build)
                    if self.residual is not None else None)
        probe_cols = _cols(batch) if residual is not None else []
        build_cols = _cols(build) if residual is not None else []
        with SG.hot_region():
            if table.unique:
                ok, bid = JX.unique_lookup(table, keys, remaps)
                mark = JX.unique_output(
                    ok, bid, keys, build_cols, live=batch.live,
                    residual=residual, probe_cols=probe_cols, semi=semi)[2]
                self._inflight.submit(None, (None,) * 3 + (mark,), None,
                                      commit)
                return
            self.expand_batches += 1
            lo, counts, total = JX.probe_ranges_device(table, keys, remaps,
                                                       batch.live)
            cap, provable = self._planner.plan(batch.num_rows, table.max_run)
            self._planner.observe_async(total)
            res = JX.run_pairs(table, lo, counts, total, keys, remaps,
                               probe_cols, build_cols, residual=residual,
                               semi=semi, cap=cap)
            if provable:
                self._inflight.submit(None, res, None, commit)
                return

            def retry():
                exact = max(int(total.get()), 1)
                self._planner.observe(exact)
                return JX.run_pairs(table, lo, counts, exact, keys, remaps,
                                    probe_cols, build_cols,
                                    residual=residual, semi=semi)

            self._inflight.submit(
                SG.async_scalar(res[5], "join.expand-overflow"), res, retry,
                commit)

    def get_output(self) -> Optional[ColumnBatch]:
        if len(self._inflight):
            self._inflight.drain(block=self.input_done)
        if self.input_done:
            self._planner.settle()
        return self._pending.popleft() if self._pending else None

    def is_finished(self) -> bool:
        return self._closed or (self.input_done and not self._pending
                                and not len(self._inflight))


# ---------------------------------------------------------------------------
# grouping sets and row replication


class GroupIdOperator(Operator):
    """Grouping-sets expansion (operator/GroupIdOperator.java:32): each
    input batch becomes one batch per grouping set.  A key column absent
    from the set becomes an all-NULL copy (valid all False, data and
    dictionary kept), pass-through channels (aggregation arguments) are
    unchanged, and the last column is the set's constant BIGINT
    ``$groupid``.  Every new column is made on the batch's device."""

    def __init__(self, key_channels: Sequence[int],
                 passthrough: Sequence[int], sets, output_names:
                 Sequence[str], output_types: Sequence[Type]):
        self.key_channels = list(key_channels)
        self.passthrough = list(passthrough)
        self.sets = [tuple(x) for x in sets]
        self.output_names = list(output_names)
        self.gid_type = output_types[-1]
        self._queue: "deque[ColumnBatch]" = deque()

    def needs_input(self) -> bool:
        return not self._queue and super().needs_input()

    def add_input(self, batch: ColumnBatch) -> None:
        n, dev = batch.num_rows, batch.device
        if not n:
            return
        null = torch.zeros(n, dtype=torch.bool, device=dev)
        for gid, live_keys in enumerate(self.sets):
            cols = []
            for idx, ch in enumerate(self.key_channels):
                c = batch.columns[ch]
                cols.append(c if idx in live_keys
                            else Column(c.type, c.data, null, c.dictionary))
            cols += [batch.columns[ch] for ch in self.passthrough]
            cols.append(Column(self.gid_type, torch.full(
                (n,), gid, dtype=torch.int64, device=dev)))
            self._queue.append(ColumnBatch(self.output_names, cols,
                                           batch.live))

    def get_output(self) -> Optional[ColumnBatch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.input_done and not self._queue


class UnnestOperator(Operator):
    """Array row expansion (operator/unnest/UnnestOperator.java:42), on the
    batch's device.  Several arrays zip-pad with NULL to the longest one;
    rows where every array is NULL or empty, and dead rows, emit nothing;
    the output keeps the input's row order, then the element position;
    ordinality is 1-based BIGINT.

    Per dictionary object (once per operator, not per batch) the host
    builds each entry's length and offset and one flat element column.
    Per batch the device gathers the lengths by code, takes the longest
    per row, expands the row indices with ``repeat_interleave`` (the one
    host sync: the output size), and gathers each element at
    ``offset[code] + position``, NULL where the position is past the
    entry's end."""

    def __init__(self, replicate: Sequence[int],
                 unnest_channels: Sequence[int], ordinality: bool,
                 output_names: Sequence[str], output_types: Sequence[Type]):
        self.replicate = list(replicate)
        self.unnest_channels = list(unnest_channels)
        self.ordinality = ordinality
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        k = len(self.replicate)
        self.element_types = self.output_types[k:k + len(unnest_channels)]
        self._tables: dict = {}
        self._pending: Optional[ColumnBatch] = None

    def _table(self, ch: int, col: Column, et: Type):
        """(lengths, offsets, elements) of ``col``'s dictionary, on the
        column's device."""
        d = col.dictionary if col.dictionary is not None else \
            _object_array([()])
        hit = self._tables.get((ch, id(d)))
        if hit is not None and hit[0] is d:  # the entry holds d: ids stay
            return hit[1]
        dev = col.data.device
        lens = np.fromiter(map(len, d), dtype=np.int64, count=len(d))
        offs = np.zeros(len(d), dtype=np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        # one invalid slot keeps the gathers in bounds when d has no element
        elems = Column.from_values(
            et, list(itertools.chain.from_iterable(d)) or [None])
        entry = (as_tensor(lens, dev), as_tensor(offs, dev), elems.to(dev))
        self._tables[(ch, id(d))] = (d, entry)
        return entry

    def needs_input(self) -> bool:
        return self._pending is None and super().needs_input()

    def add_input(self, batch: ColumnBatch) -> None:
        n, dev = batch.num_rows, batch.device
        if n == 0:
            return
        arrays = []
        length = None
        for ch, et in zip(self.unnest_channels, self.element_types):
            c = batch.columns[ch]
            lens, offs, elems = self._table(ch, c, et)
            code = c.data.long()
            ln = lens[code]
            if c.valid is not None:  # a NULL array is empty
                ln = torch.where(c.valid, ln, 0)
            arrays.append((code, ln, offs, elems))
            length = ln if length is None else torch.maximum(length, ln)
        if batch.live is not None:
            length = torch.where(batch.live, length, 0)
        # the one host sync: the output size
        total = int(SG.fetch(length.sum(), "unnest.output-size"))
        if total == 0:
            return
        rows = torch.repeat_interleave(
            torch.arange(n, device=dev), length, output_size=total)
        starts = torch.cumsum(length, 0) - length
        pos = torch.arange(total, dtype=torch.int64, device=dev) - starts[rows]
        cols = [batch.columns[ch].take(rows) for ch in self.replicate]
        for (code, ln, offs, elems), et in zip(arrays, self.element_types):
            ok = pos < ln[rows]
            at = torch.clamp(offs[code[rows]] + torch.where(ok, pos, 0),
                             max=len(elems) - 1)
            valid = ok if elems.valid is None else ok & elems.valid[at]
            cols.append(Column(et, elems.data[at], valid, elems.dictionary))
        if self.ordinality:
            cols.append(Column(self.output_types[-1], pos + 1))
        self._pending = ColumnBatch(self.output_names, cols)

    def get_output(self) -> Optional[ColumnBatch]:
        b, self._pending = self._pending, None
        return b

    def is_finished(self) -> bool:
        return self.input_done and self._pending is None


class ReplicateOperator(Operator):
    """Each live row repeated N times, N from a BIGINT count channel (0 or
    less drops it): the row expansion of INTERSECT ALL / EXCEPT ALL.  The
    indices come from ``torch.repeat_interleave`` on the batch's device."""

    def __init__(self, count_channel: int):
        self.count_channel = count_channel
        self._pending: Optional[ColumnBatch] = None

    def needs_input(self) -> bool:
        return self._pending is None and super().needs_input()

    def add_input(self, batch: ColumnBatch) -> None:
        batch = batch.compact()
        c = batch.columns[self.count_channel]
        counts = torch.clamp(c.data.to(torch.int64), min=0)
        if c.valid is not None:
            counts = torch.where(c.valid, counts, 0)
        idx = torch.repeat_interleave(counts)
        if len(idx):
            self._pending = ColumnBatch(batch.names,
                                        [x.take(idx) for x in batch.columns])

    def get_output(self) -> Optional[ColumnBatch]:
        b, self._pending = self._pending, None
        return b

    def is_finished(self) -> bool:
        return self.input_done and self._pending is None


# ---------------------------------------------------------------------------
# window


_NEVER_NULL = WK.WINDOW_RANK_FNS | {"count", "count_star"}


class WindowOperator(BufferedInputMixin, Operator):
    """Window-function evaluation (operator/WindowOperator.java:69):
    blocking -- accumulate, then exec/window_kernels.py sorts once per spec,
    computes every function and gathers the results back to input order on
    the batch's device."""

    def __init__(self, partition_keys: Sequence[int],
                 order_keys: Sequence[SortKey],
                 functions: Sequence[WindowFunc],
                 output_names: Sequence[str], output_types: Sequence[Type]):
        self.partition_keys = list(partition_keys)
        self.order_keys = list(order_keys)
        self.functions = list(functions)
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._batches: list[ColumnBatch] = []
        self._result: Optional[ColumnBatch] = None
        self._emitted = False

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self.buffer(batch)

    def finish_input(self) -> None:
        super().finish_input()
        # a shard can arrive with rows that are all dead (a collective
        # edge's lanes): nothing is left once the concat compacts it
        inp = (ColumnBatch.concat(self._batches)  # compacts + unifies dicts
               if self.buffered_batches() else None)
        self.release_memory()
        if inp is None or inp.num_rows == 0:
            self._result = ColumnBatch(
                self.output_names,
                [Column(t, np.empty(0, t.storage_dtype))
                 for t in self.output_types])
            return
        pkeys = [(inp.columns[c].data, inp.columns[c].valid)
                 for c in self.partition_keys]
        okeys = [(inp.columns[k.channel].data, inp.columns[k.channel].valid,
                  k.ascending, k.nulls_first) for k in self.order_keys]
        specs, fn_dicts = [], []
        for f in self.functions:
            acols = [inp.columns[c] for c in f.args]
            if len(acols) > 1 and acols[0].type.is_dictionary_encoded:
                # lag/lead default drawn from a different dictionary column
                acols = unify_dictionaries(acols)
            fn_dicts.append(acols[0].dictionary if acols else None)
            specs.append({
                "fn": f.fn, "args": [(c.data, c.valid) for c in acols],
                "offset": f.offset, "frame": f.frame,
                "dtype": f.type.storage_dtype,
            })
        results = WK.compute_windows(pkeys, okeys, specs, inp.num_rows,
                                     inp.device)
        out_cols = list(inp.columns)
        for f, (data, valid), fdict in zip(self.functions, results, fn_dicts):
            dict_ = (fdict if f.args and f.fn not in ("count", "sum", "avg")
                     else None)
            if f.fn in _NEVER_NULL:
                valid = None
            out_cols.append(Column(f.type, data, valid, dict_))
        self._result = ColumnBatch(self.output_names, out_cols)

    def get_output(self) -> Optional[ColumnBatch]:
        if self._result is not None and not self._emitted:
            self._emitted = True
            return self._result
        return None

    def is_finished(self) -> bool:
        return (self.input_done and self._emitted) or self._closed


# ---------------------------------------------------------------------------
# sort / top-N / limit


class SortOperator(BufferedInputMixin, Operator):
    """Full sort (operator/OrderByOperator.java:44): lexsort + payload
    gather on the device, dead rows last."""

    limit: Optional[int] = None  # TopN sets this

    def __init__(self, keys: Sequence[SortKey]):
        self.keys = list(keys)
        self._batches: list[ColumnBatch] = []
        self._result = None
        self._emitted = False

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self.buffer(batch)

    def _sorted_batch(self, batches: Sequence[ColumnBatch],
                      out_n: Optional[int]) -> ColumnBatch:
        inp = _maybe_compact(ColumnBatch.concat(batches, keep_live=True))
        keys = [(inp.columns[k.channel].data, inp.columns[k.channel].valid,
                 k.ascending, k.nulls_first) for k in self.keys]
        cols = [(c.data, c.valid) for c in inp.columns]
        cap = None if out_n is None else min(out_n, inp.num_rows)
        outs, live = K.device_sort(keys, cols, inp.live, cap)
        out_cols = [Column(c.type, d, v, c.dictionary)
                    for (d, v), c in zip(outs, inp.columns)]
        return ColumnBatch(inp.names, out_cols, live)

    def finish_input(self) -> None:
        super().finish_input()
        if not self.buffered_batches():
            self._emitted = True
            return
        self._result = self._sorted_batch(self._batches, self.limit)
        self.release_memory()

    def get_output(self):
        if self._result is not None and not self._emitted:
            self._emitted = True
            return self._result
        return None

    def is_finished(self) -> bool:
        return self.input_done and self._emitted


class TopNOperator(SortOperator):
    """Top-N (operator/TopNOperator.java:34): when the buffer outgrows a
    multiple of N it shrinks to the current best N rows."""

    def __init__(self, count: int, keys: Sequence[SortKey]):
        super().__init__(keys)
        self.count = count
        self.limit = count
        self._buffered_rows = 0
        self._shrink_at = max(4 * count, 1 << 16)

    def add_input(self, batch: ColumnBatch) -> None:
        if not batch.num_rows:
            return
        with self._buffer_state():
            self._batches.append(batch)
        self._buffered_rows += batch.num_rows
        if self._buffered_rows > self._shrink_at:
            best = self._sorted_batch(self.buffered_batches(), self.count)
            with self._buffer_state():
                self._batches = [best]
            self._buffered_rows = best.num_rows
        self.account_memory()


class LimitOperator(Operator):
    def __init__(self, count: int):
        self.count = count
        self._remaining = count
        self._pending = None

    def needs_input(self) -> bool:
        return (self._remaining > 0 and self._pending is None
                and super().needs_input())

    def add_input(self, batch: ColumnBatch) -> None:
        batch = batch.compact()
        if batch.num_rows > self._remaining:
            batch = batch.slice(0, self._remaining)
        self._remaining -= batch.num_rows
        self._pending = batch

    def get_output(self):
        b, self._pending = self._pending, None
        return b

    def is_finished(self) -> bool:
        return ((self.input_done or self._remaining == 0)
                and self._pending is None)


class DistinctLimitOperator(BufferedInputMixin, Operator):
    """DISTINCT, optionally limited (the reference's DistinctLimitOperator,
    which ``planner/add_exchanges`` places on both sides of a GATHER): the
    first row of every distinct row value, in input order.  Group ids come
    from ``hash_insert`` (``K.hash_row_gids``) over all the columns; they
    are dense in first-occurrence order, so each group's smallest row
    index, taken in id order, is already in input order."""

    def __init__(self, count: Optional[int]):
        self.count = count
        self._batches: list[ColumnBatch] = []
        self._result = None
        self._emitted = False

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self.buffer(batch)

    def finish_input(self) -> None:
        super().finish_input()
        if not self.buffered_batches():
            self._emitted = True
            return
        inp = ColumnBatch.concat(self._batches)
        n = inp.num_rows
        row_gid, groups = K.hash_row_gids(
            [(c.data, c.valid) for c in inp.columns])
        rows = torch.arange(n, device=inp.device)
        first = torch.full((groups,), n, dtype=torch.int64,
                           device=inp.device)
        first.scatter_reduce_(0, row_gid.long(), rows, "amin")
        if self.count is not None:
            first = first[:self.count]
        self._result = ColumnBatch(inp.names,
                                   [c.take(first) for c in inp.columns])
        self.release_memory()

    def get_output(self):
        if self._result is not None and not self._emitted:
            self._emitted = True
            return self._result
        return None

    def is_finished(self) -> bool:
        return self.input_done and self._emitted


class TableWriterOperator(Operator):
    """Writes batches into a connector sink, hands the sink's fragments to
    ``on_finish`` (the connector's commit) and emits the row count
    (operator/TableWriterOperator.java:68)."""

    def __init__(self, sink: ConnectorPageSink, on_finish):
        self.sink = sink
        self.on_finish = on_finish
        self._rows = 0
        self._emitted = False

    def add_input(self, batch: ColumnBatch) -> None:
        batch = batch.compact()
        self._rows += batch.num_rows
        self.sink.append(batch)

    def finish_input(self) -> None:
        super().finish_input()
        self.on_finish(self.sink.finish())

    def get_output(self) -> Optional[ColumnBatch]:
        if self.input_done and not self._emitted:
            self._emitted = True
            return ColumnBatch(["rows"], [
                Column(BIGINT, np.array([self._rows], np.int64))])
        return None

    def is_finished(self) -> bool:
        return self.input_done and self._emitted


class OutputCollector(Operator):
    """Terminal sink: buffers result batches for the client."""

    def __init__(self):
        self.batches: list[ColumnBatch] = []

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self.batches.append(batch)

    def is_finished(self) -> bool:
        return self.input_done
