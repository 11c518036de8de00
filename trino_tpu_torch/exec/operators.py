"""Operators: the batch-at-a-time data plane on tensors.

The port of the reference ``exec/operators.py`` (operator contract of
operator/Operator.java:21 — ``needs_input``/``add_input``/``get_output``/
``is_finished``) for the operators the ported queries use:

- streaming: ScanOperator (synchronous path), FilterProjectOperator,
  LookupJoinOperator (INNER, LEFT, SINGLE; keyed or nested-loop),
  SemiJoinOperator (IN / EXISTS mark), LimitOperator, RenameOperator;
- blocking: HashAggregationOperator (SINGLE step), JoinBuildSink,
  SortOperator / TopNOperator; OutputCollector is the sink.

Filters mark rows dead in the batch's ``live`` mask instead of compacting;
blocking operators concatenate their input on the device.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.expr import (compile_expression, expr_condition_mask,
                        expr_error_scope, reduce_error_lanes)
from ..planner.plan import AggCall, SortKey
from ..spi.batch import Column, ColumnBatch, as_tensor, torch_dtype
from ..spi.connector import Connector, ConnectorPageSink, Split
from ..spi.errors import SUBQUERY_MULTIPLE_ROWS, TrinoError
from ..spi.types import BIGINT, BOOLEAN, DOUBLE, DecimalType, Type
from ..sql.ir import RowExpression, referenced_inputs
from . import join_exec as JX
from . import kernels as K

__all__ = [
    "Operator", "ScanOperator", "FilterProjectOperator",
    "HashAggregationOperator", "JoinBridge", "JoinBuildSink",
    "LookupJoinOperator", "SemiJoinOperator", "SortOperator",
    "TopNOperator", "LimitOperator", "RenameOperator", "TableWriterOperator",
    "OutputCollector",
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
    """Reads splits through the connector page source, applies the advisory
    TupleDomain on the host batch (exec/domain_filter.py), then moves the
    surviving rows to ``device``.  A batch already in device memory (a
    pinned memory table) skips the host mask, as the reference's pinned
    batches do (the filter above the scan still applies the predicate), and
    is handed on without a copy."""

    def __init__(self, connector: Connector, splits: Sequence[Split],
                 columns: Sequence[str], device, constraint=None):
        self.connector = connector
        self.splits = list(splits)
        self.columns = list(columns)
        self.device = torch.device(device)
        self.constraint = constraint if (
            constraint is not None and not constraint.is_all) else None
        self._name_to_idx = {n: i for i, n in enumerate(self.columns)}
        self._domain_dict_cache: dict = {}
        self._source = None
        self.input_done = True
        self.scan_rows = 0

    def needs_input(self) -> bool:
        return False

    def _apply_constraint(self, batch: ColumnBatch) -> ColumnBatch:
        from .domain_filter import tuple_domain_mask

        mask = tuple_domain_mask(batch, self.constraint, self._name_to_idx,
                                 self._domain_dict_cache)
        if mask is None or mask.all():
            return batch
        return batch.filter(as_tensor(mask))

    def get_output(self) -> Optional[ColumnBatch]:
        while not self._closed:
            if self._source is None:
                if not self.splits:
                    return None
                self._source = self.connector.create_page_source(
                    self.splits.pop(0), self.columns)
            if self._source.is_finished():
                self._source.close()
                self._source = None
                continue
            batch = self._source.get_next_batch()
            if batch is None:
                continue
            self.scan_rows += batch.num_rows
            if self.constraint is not None and batch.device.type == "cpu":
                batch = self._apply_constraint(batch)
                if batch.num_rows == 0:
                    continue
            return batch.to(self.device)  # no copy when already there
        return None

    def is_finished(self) -> bool:
        return self._closed or (self._source is None and not self.splits)


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

    def _compile(self, batch: ColumnBatch):
        dicts = [c.dictionary for c in batch.columns]
        if self._compiled is not None and all(
                a is b for a, b in zip(self._compiled_dicts, dicts)):
            return self._compiled
        types = [c.type for c in batch.columns]
        dev = batch.device
        pred = (compile_expression(self.predicate, types, dicts, dev)
                if self.predicate is not None else None)
        projs = ([compile_expression(e, types, dicts, dev)
                  for e in self.projections]
                 if self.projections is not None else None)
        self._compiled = (pred, projs)
        self._compiled_dicts = dicts
        return self._compiled

    def needs_input(self) -> bool:
        return self._pending is None and super().needs_input()

    def add_input(self, batch: ColumnBatch) -> None:
        pred, projs = self._compile(batch)
        cols = _to_cols(batch)
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
                    for ce, t in zip(projs, self.output_types):
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
    batch's shape) before hashing or sorting it."""
    if batch.live is None or batch.num_rows < _COMPACT_MIN_LANES:
        return batch
    if batch.live_count * _COMPACT_FACTOR <= batch.num_rows:
        return batch.compact()
    return batch


class HashAggregationOperator(Operator):
    """Grouped aggregation (operator/HashAggregationOperator.java:53):
    accumulate batches, then at finish either the small-code path (all keys
    small dictionary codes: no hashing, a scatter into the static group
    space) or the hash path (``hash_insert`` group ids + grouped_reduce).
    Only the SINGLE step (the standalone runner's) is ported."""

    def __init__(self, group_keys: Sequence[int], aggs: Sequence[AggCall],
                 output_names: Sequence[str], output_types: Sequence[Type],
                 step: str = "SINGLE"):
        if step != "SINGLE":
            raise NotImplementedError(f"aggregation step {step}")
        self.group_keys = list(group_keys)
        self.aggs = list(aggs)
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._batches: list[ColumnBatch] = []
        self._result: Optional[ColumnBatch] = None
        self._emitted = False

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self._batches.append(batch)

    def finish_input(self) -> None:
        super().finish_input()
        self._result = self._compute()
        self._batches = []

    def _empty_result(self, nk: int) -> ColumnBatch:
        if nk:  # grouped agg over empty input -> empty result
            cols = [Column(t, np.empty(0, t.storage_dtype))
                    for t in self.output_types]
            return ColumnBatch(self.output_names, cols)
        cols = []  # global agg over empty input -> one row of defaults
        for a, t in zip(self.aggs, self.output_types):
            if a.fn == "count":
                cols.append(Column(t, np.zeros(1, np.int64)))
            else:
                cols.append(Column(t, np.zeros(1, t.storage_dtype),
                                   np.zeros(1, bool)))
        return ColumnBatch(self.output_names, cols)

    def _specs(self, inp: ColumnBatch):
        """Kernel specs (fn, data, valid, dtype, distinct[, pre]) and the
        finalize plan; avg expands to a (scale-free f64 sum, count) pair."""
        specs, plan = [], []
        for a in self.aggs:
            if a.fn == "count" and a.arg < 0:
                plan.append(("count", len(specs)))
                specs.append(("count_star", None, None, np.int64, False))
                continue
            col = inp.columns[a.arg]
            dist = bool(a.distinct)
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
            elif a.fn in ("min", "max"):
                # DISTINCT does not change a min or a max
                plan.append((a.fn, len(specs)))
                specs.append((a.fn, col.data, col.valid, None, False))
            else:
                raise NotImplementedError(f"aggregate {a.fn}")
        return specs, plan

    def _compute(self) -> ColumnBatch:
        nk = len(self.group_keys)
        if not self._batches:
            return self._empty_result(nk)
        inp = _maybe_compact(ColumnBatch.concat(self._batches,
                                                keep_live=True))
        live = inp.live
        key_cols = [inp.columns[i] for i in self.group_keys]
        specs, plan = self._specs(inp)
        presence = None
        space = K.small_codes_group_space(key_cols) if nk else 1
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
        fplan, arrays = [], []
        for kind, i in plan:
            t_idx = len(fplan) + nk
            t = self.output_types[t_idx]
            d, v = reduced[i]
            if kind == "avg":
                c, _ = reduced[i + 1]
                fplan.append(("avg_final", t.storage_dtype, v is not None))
                arrays += [d] + ([v] if v is not None else []) + [c]
            elif kind == "count":
                fplan.append(("count", None, False))
                arrays.append(d)
            else:
                fplan.append(("copy", t.storage_dtype, v is not None))
                arrays += [d] + ([v] if v is not None else [])
        outs = K.finalize_groups(fplan, arrays)
        out_cols = [Column(c.type, d, v, c.dictionary)
                    for (d, v), c in zip(keys_out, key_cols)]
        for a, (kind, _), (d, v), t in zip(self.aggs, plan, outs,
                                           self.output_types[nk:]):
            dict_ = (inp.columns[a.arg].dictionary
                     if kind in ("min", "max") else None)
            out_cols.append(Column(t, d, v, dict_))
        return ColumnBatch(self.output_names, out_cols, presence)

    def get_output(self) -> Optional[ColumnBatch]:
        if self.input_done and self._result is not None and not self._emitted:
            self._emitted = True
            return self._result
        return None

    def is_finished(self) -> bool:
        return (self.input_done and self._emitted) or self._closed


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


class JoinBuildSink(Operator):
    """Accumulates the build side, then builds the join table
    (operator/join/HashBuilderOperator.java:57)."""

    def __init__(self, bridge: JoinBridge, key_channels: Sequence[int],
                 types: Sequence[Type], names: Sequence[str], device):
        self.bridge = bridge
        self.key_channels = list(key_channels)
        self.types = list(types)
        self.names = list(names)
        self.device = torch.device(device)
        self._batches: list[ColumnBatch] = []

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self._batches.append(batch)

    def finish_input(self) -> None:
        super().finish_input()
        if self._batches:
            # dead rows are dropped before the build: on the card the
            # compaction costs less than hashing and indexing them
            batch = ColumnBatch.concat(self._batches)
        else:
            batch = ColumnBatch(self.names, [
                Column(t, np.empty(0, t.storage_dtype)) for t in self.types])
            batch = batch.to(self.device)
        self._batches = []
        keys = [(batch.columns[ch].data, batch.columns[ch].valid)
                for ch in self.key_channels]
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
                                    dicts, probe.device)

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


def _probe_keys(batch: ColumnBatch, channels, bridge: "JoinBridge"):
    """Probe key (data, valid) pairs and the dictionary remaps into the
    build's code space."""
    keys = [(batch.columns[ch].data, batch.columns[ch].valid)
            for ch in channels]
    remaps = [JX.probe_key_remap(batch.columns[ch].dictionary,
                                 bridge.key_dicts[k], batch.device)
              for k, ch in enumerate(channels)]
    return keys, remaps


def _cols(batch: ColumnBatch) -> list:
    return [(c.data, c.valid) for c in batch.columns]


class LookupJoinOperator(Operator):
    """Probe side of the equi-join (operator/join/LookupJoinOperator.java:37)
    for INNER, LEFT and SINGLE joins, with an optional residual.  A unique
    build (every FK->PK edge) keeps the probe batch's shape (dense or
    sorted-hash lookup); a build with duplicate keys expands candidate runs
    found by the ``hash_probe`` kernel.  LEFT/SINGLE keep every probe row:
    an unmatched one is NULL-extended.  A SINGLE join (a scalar subquery)
    whose build gives a probe row more than one match raises
    SUBQUERY_MULTIPLE_ROWS.  Keyless joins run as a nested loop."""

    def __init__(self, bridge: JoinBridge, left_keys: Sequence[int],
                 join_type: str, residual: Optional[RowExpression],
                 output_names: Sequence[str], output_types: Sequence[Type]):
        if join_type not in ("INNER", "LEFT", "SINGLE"):
            raise NotImplementedError(f"{join_type} join")
        self.bridge = bridge
        self.left_keys = list(left_keys)
        self.join_type = join_type
        self.residual = _Residual(residual) if residual is not None else None
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._pending: "deque[ColumnBatch]" = deque()

    @property
    def _outer(self) -> bool:
        return self.join_type in ("LEFT", "SINGLE")

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

    def _add_cross_input(self, probe: ColumnBatch) -> None:
        probe = probe.compact()
        build = self.bridge.batch
        if (self.join_type == "SINGLE" and build.num_rows > 1
                and probe.num_rows):
            raise self._too_many_rows()
        pi, bi = _nested_loop_pairs(probe, build, self.residual)
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
        keys, remaps = _probe_keys(probe, self.left_keys, self.bridge)
        residual = (self.residual.bind(probe, build)
                    if self.residual is not None else None)
        build_cols = _cols(build)
        if table.unique:
            b_out, ok_live, _ = JX.run_unique(
                table, keys, remaps, build_cols, live=probe.live,
                residual=residual,
                probe_cols=_cols(probe) if residual is not None else ())
            right = [Column(c.type, d, v, c.dictionary)
                     for c, (d, v) in zip(build.columns, b_out)]
            # LEFT/SINGLE: unmatched rows stay live, their build side NULL
            self._emit(list(probe.columns) + right,
                       probe.live if self._outer else ok_live)
            return
        lo, counts, total = JX.probe_ranges_device(table, keys, remaps,
                                                   probe.live)
        if total == 0:
            if self._outer:
                self._null_extended(probe, probe.live)
            return
        pairs, ok, matches, _ = JX.run_pairs(
            table, lo, counts, total, keys, remaps, _cols(probe),
            build_cols, residual=residual, need_matched=self._outer)
        if self.join_type == "SINGLE" and int(matches.max()) > 1:
            raise self._too_many_rows()
        cols = list(probe.columns) + list(build.columns)
        self._emit([Column(c.type, d, v, c.dictionary)
                    for c, (d, v) in zip(cols, pairs)], ok)
        if self._outer:
            unmatched = matches == 0
            self._null_extended(probe, unmatched if probe.live is None
                                else probe.live & unmatched)

    def get_output(self) -> Optional[ColumnBatch]:
        return self._pending.popleft() if self._pending else None

    def is_finished(self) -> bool:
        return self._closed or (self.input_done and not self._pending)


class SemiJoinOperator(Operator):
    """Mark join for IN / EXISTS (operator/HashSemiJoinOperator.java:47):
    output = source channels + a BOOLEAN match column.  Null-aware IN is
    three-valued: a non-match is NULL when the probe key is NULL or the
    build holds a NULL key, so a downstream ``$not`` yields NULL and the
    row is filtered (NOT IN); IN over an empty build is FALSE.  A keyless
    semi-join (EXISTS with only non-equi conjuncts) runs as a nested loop
    where the residual alone decides the mark."""

    def __init__(self, bridge: JoinBridge, source_keys: Sequence[int],
                 null_aware: bool, residual: Optional[RowExpression],
                 output_names: Sequence[str], output_types: Sequence[Type]):
        self.bridge = bridge
        self.source_keys = list(source_keys)
        self.null_aware = null_aware
        self.residual = _Residual(residual) if residual is not None else None
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self._pending: "deque[ColumnBatch]" = deque()

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
        no_match = torch.zeros(batch.num_rows, dtype=torch.bool,
                               device=batch.device)
        if table.num_rows == 0 or batch.num_rows == 0:
            self._emit(batch, no_match)  # IN over the empty set is FALSE
            return
        keys, remaps = _probe_keys(batch, self.source_keys, self.bridge)
        semi = (self.null_aware, table.has_null_key, table.live_rows > 0)
        residual = (self.residual.bind(batch, build)
                    if self.residual is not None else None)
        probe_cols = _cols(batch) if residual is not None else []
        build_cols = _cols(build) if residual is not None else []
        if table.unique:
            _, _, mark = JX.run_unique(
                table, keys, remaps, build_cols, live=batch.live,
                residual=residual, probe_cols=probe_cols, semi=semi)
        else:
            lo, counts, total = JX.probe_ranges_device(table, keys, remaps,
                                                       batch.live)
            if total == 0:
                mark = JX.semi_mark(no_match, keys, semi)
            else:
                mark = JX.run_pairs(
                    table, lo, counts, total, keys, remaps, probe_cols,
                    build_cols, residual=residual, semi=semi)[3]
        self._emit(batch, *mark)

    def get_output(self) -> Optional[ColumnBatch]:
        return self._pending.popleft() if self._pending else None

    def is_finished(self) -> bool:
        return self._closed or (self.input_done and not self._pending)


# ---------------------------------------------------------------------------
# sort / top-N / limit


class SortOperator(Operator):
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
            self._batches.append(batch)

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
        if not self._batches:
            self._emitted = True
            return
        self._result = self._sorted_batch(self._batches, self.limit)
        self._batches = []

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
        self._batches.append(batch)
        self._buffered_rows += batch.num_rows
        if self._buffered_rows > self._shrink_at:
            best = self._sorted_batch(self._batches, self.count)
            self._batches = [best]
            self._buffered_rows = best.num_rows


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
