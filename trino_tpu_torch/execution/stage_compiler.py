"""Whole-stage compilation: one program call per batch of a fused stage.

The port of the reference ``execution/stage_compiler.py``.  The fragmenter
marks REPARTITION seams whose producer is an ``Aggregate(PARTIAL)`` over a
Filter/Project chain and whose consumer FINAL-aggregates that edge
(execution/fragmenter.py ``FusedSeam``).  Such a seam runs as two
programs instead of a per-batch operator chain plus the collective
exchange:

1. **Accumulate** (one call per input batch, per task): the Filter/Project
   chain (the port's compiled expressions), the static grouped partial
   aggregation of the batch and its merge into a ``cap``-slot carried
   state, as one Python call of torch operations on the batch's device.
   Both groupings run through the ``hash_insert`` kernel
   (``parallel/static_agg.py``) with their group counts kept on the
   device, so the call reads nothing back.  The reference's jitted
   program donates the state; here the call returns the new state and
   the old one is dropped, so no second copy is kept.  Batches are padded
   to power-of-two buckets first (the ingest pad), as in the reference,
   and here a batch that carries a live mask too (the reference's come
   bucket-shaped from its jitted operators; a coalescing scan's sizes
   vary from run to run): ``compiles`` counts the first call of each
   (program, bucket, pad pattern) signature, so a warm run has
   ``cache_hits == jit_calls``.

2. **Seam merge** (one per stage, run by the last depositing task): a
   host loop over the tasks' states on the stage's mesh (one shard per
   task, all on the runner's device): dictionary key codes remap into the
   merged dictionary, every slot routes by the value hash of its keys
   (``kernels.partition_assignments`` over
   ``local_exchange.partition_key_tuple``: a dictionary key by the crc32
   of its value, NULL keys to task 0, as every other edge routes), the
   lanes cross through ``parallel/distributed.all_to_all``, and each task's
   share is combined at ``n_tasks * cap`` slots (which cannot overflow)
   and finalized with the reference's output layout.

Overflow contract: the carried state holds ``cap`` group slots per task
(``TRINO_TPU_FUSED_CAP``).  A task that sees more groups trips the device
overflow scalar, read once per task at finish (``fused.overflow``), and
raises :class:`FusedStageOverflow`; the runner re-runs the query on the
per-operator path, counted.  No other error is recovered from.

``TRINO_TPU_FUSED_STAGE={auto,1,0}``: 0 is the per-operator and
collective-exchange path.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..caching.executable_cache import memo, register_external
from ..exec import kernels as K
from ..exec import local_exchange as LX
from ..exec import syncguard as SG
from ..exec.operators import Operator
from ..exec.stats import FusedStageStats
from ..ops.expr import (compile_expression, expr_condition_mask,
                        expr_error_scope, reduce_error_lanes)
from ..parallel.distributed import Mesh, all_to_all
from ..parallel.static_agg import AggSpec, combine_partials, static_grouped_agg
from ..planner import plan as PL
from ..spi import knobs
from ..spi.batch import (Column, ColumnBatch, host_table, torch_dtype,
                         unify_dictionaries)
from ..spi.errors import (DEVICE_FAULT, GENERIC_INTERNAL_ERROR,
                          PAGE_TRANSPORT_TIMEOUT, TrinoError, is_device_fault)
from ..spi.types import DOUBLE, DecimalType
from ..telemetry import metrics as tm
from ..telemetry import profiler
from . import task as T

__all__ = ["FusedStageExec", "FusedStageOverflow", "FusedStageSinkOperator",
           "FusedStageSourceOperator", "FusedStageSpec", "build_fused_spec",
           "plan_fused_stages", "fused_stage_mode", "fused_cap"]


def fused_stage_mode() -> str:
    """TRINO_TPU_FUSED_STAGE: auto (default, fuse eligible seams), 1 (same),
    0 (the per-operator and collective-exchange path)."""
    v = knobs.get_str("TRINO_TPU_FUSED_STAGE").strip().lower()
    return v if v in ("auto", "1", "0") else "auto"


def fused_cap() -> int:
    """Carried-state group-slot capacity per task (TRINO_TPU_FUSED_CAP)."""
    return knobs.get_int("TRINO_TPU_FUSED_CAP") or 8192


class FusedStageOverflow(RuntimeError):
    """A task saw more distinct groups than the fused state cap; the runner
    re-runs the query on the per-operator path."""


# ---------------------------------------------------------------------------
# stage spec: what the fragmenter's FusedSeam lowers to


@dataclass(frozen=True)
class _StateSpec:
    """One mergeable state column of the carried aggregation state
    (HashAggregationOperator's aggregate plus the PARTIAL avg expansion of
    add_exchanges.partial_agg_layout)."""

    fn: str           # sum | count | count_star | min | max
    arg: int          # chain-output channel (-1 for count_star)
    dtype: str        # numpy dtype str of the state lane
    scale: int = 0    # decimal scale folded into the avg sum state
    has_valid: bool = True  # state carries a validity lane


@dataclass
class FusedStageSpec:
    producer_fid: int
    consumer_fid: int
    n_tasks: int
    feed: PL.PlanNode              # runs as the operator pipeline
    chain: tuple                   # Filter|Project nodes, application order
    partial: PL.Aggregate
    final: PL.Aggregate
    nk: int
    cap: int
    state_specs: tuple = ()        # tuple[tuple[_StateSpec, ...], ...]

    @property
    def key_types(self):
        src = self.partial.source.output_types
        return tuple(src[c] for c in self.partial.group_keys)

    @property
    def flat_states(self) -> tuple:
        return tuple(s for group in self.state_specs for s in group)

    def cache_key(self) -> tuple:
        return (self.partial, tuple(self.chain),
                tuple(self.feed.output_types), self.cap)


def _derive_state_specs(partial: PL.Aggregate) -> tuple:
    src_types = partial.source.output_types
    out = []
    for a in partial.aggregates:
        if a.fn == "count" and a.arg < 0:
            out.append((_StateSpec("count_star", -1, "<i8", 0, False),))
        elif a.fn == "avg":
            t = src_types[a.arg]
            scale = t.scale if isinstance(t, DecimalType) else 0
            out.append((_StateSpec("sum", a.arg, "<f8", scale, True),
                        _StateSpec("count", a.arg, "<i8", 0, False)))
        elif a.fn == "sum":
            if a.type == DOUBLE:
                dt = "<f8"
            elif a.type.name == "real":
                dt = "<f4"
            else:
                dt = "<i8"
            out.append((_StateSpec("sum", a.arg, dt, 0, True),))
        elif a.fn == "count":
            out.append((_StateSpec("count", a.arg, "<i8", 0, False),))
        else:  # min | max
            dt = np.dtype(src_types[a.arg].storage_dtype).str
            out.append((_StateSpec(a.fn, a.arg, dt, 0, True),))
    return tuple(out)


def build_fused_spec(producer, consumer, n_tasks: int,
                     cap: int) -> FusedStageSpec:
    """Lower a fragmenter-marked FusedSeam into the executable spec."""
    from .fragmenter import _walk

    root = producer.root  # Aggregate(PARTIAL), checked by the fragmenter
    chain = []
    node = root.source
    while isinstance(node, (PL.Filter, PL.Project)):
        chain.append(node)
        node = node.source
    chain.reverse()
    final = next(n for n in _walk(consumer.root)
                 if isinstance(n, PL.Aggregate) and n.step == "FINAL"
                 and isinstance(n.source, PL.RemoteSource)
                 and n.source.fragment_id == producer.id)
    spec = FusedStageSpec(
        producer_fid=producer.id, consumer_fid=consumer.id, n_tasks=n_tasks,
        feed=node, chain=tuple(chain), partial=root, final=final,
        nk=len(root.group_keys), cap=cap,
        state_specs=_derive_state_specs(root))
    if len(spec.flat_states) != len(root.output_types) - spec.nk:
        raise AssertionError(
            "fused state layout disagrees with partial_agg_layout")
    return spec


def plan_fused_stages(fragments, session, task_counts: dict,
                      consumer_tasks: dict, device) -> dict:
    """Runtime gate over fragmenter-marked seams: {producer_fid:
    FusedStageExec} for the seams whose producer and consumer task counts
    line up (the collective edge's conditions).  Every shard of a stage's
    mesh lies on the runner's ``device``, where its tasks run."""
    if fused_stage_mode() == "0" or not session.use_collectives:
        return {}
    from .collective_exchange import collectives_available

    by_id = {f.id: f for f in fragments}
    out: dict = {}
    for f in fragments:
        seam = f.fused_seam
        if seam is None or not f.device_resident:
            continue
        tc = task_counts.get(f.id)
        if (tc is None or consumer_tasks.get(f.id) != tc
                or task_counts.get(seam.consumer_fid) != tc
                or not collectives_available(tc)):
            continue
        spec = build_fused_spec(f, by_id[seam.consumer_fid], tc, fused_cap())
        out[f.id] = FusedStageExec(spec, Mesh([device] * tc))
    return out


# ---------------------------------------------------------------------------
# the accumulate program: chain -> partial agg -> state merge, one call


_ACCUM_CACHE: dict = {}
_ACCUM_LOCK = threading.Lock()
_ACCUM_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_TRACE_SIGS: set = set()  # (program id, bucket signature): first calls


def _accum_cache_stats() -> dict:
    """system.runtime.caches row of the identity-keyed accumulate memo (its
    keys are object identities, so it lives outside the registry)."""
    with _ACCUM_LOCK:
        return {"tier": "exec", "name": "stage._accumulate_program",
                "entries": len(_ACCUM_CACHE), "bytes": 0,
                "hits": _ACCUM_STATS["hits"],
                "misses": _ACCUM_STATS["misses"],
                "evictions": _ACCUM_STATS["evictions"], "invalidations": 0}


register_external("stage._accumulate_program", _accum_cache_stats)


def _state_dtype(ss: _StateSpec) -> torch.dtype:
    return torch_dtype(np.dtype(ss.dtype))


def _acc_dtype(ss: _StateSpec) -> torch.dtype:
    """The dtype a state's reduction accumulates in: a REAL sum adds in
    float64 and is rounded to its float32 state once per call, so the sum
    of a batch does not drift with the order of float32 atomic adds."""
    dt = _state_dtype(ss)
    return torch.float64 if dt == torch.float32 and ss.fn == "sum" else dt


def initial_state(spec: FusedStageSpec, device) -> dict:
    """The zero carried state: key lanes and valids, state lanes and
    valids, the slot-used lane, the error and overflow scalars."""
    cap = spec.cap

    def zeros(dt):
        return torch.zeros(cap, dtype=dt, device=device)

    return {
        "kd": tuple(zeros(torch_dtype(t.storage_dtype))
                    for t in spec.key_types),
        "kv": tuple(zeros(torch.bool) for _ in spec.key_types),
        "sd": tuple(zeros(_state_dtype(s)) for s in spec.flat_states),
        "sv": tuple(zeros(torch.bool) if s.has_valid else None
                    for s in spec.flat_states),
        "used": zeros(torch.bool),
        "err": torch.zeros((), dtype=torch.int32, device=device),
        "ovf": torch.zeros((), dtype=torch.int32, device=device)}


class _AccumulateProgram:
    """One fused accumulate program: the compiled expressions, the static
    aggregation and the carried-state combine, called once per batch.
    Cached per (stage spec, feed dictionary identities, device)."""

    def __init__(self, spec: FusedStageSpec, in_types, in_dicts, device):
        self.spec = spec
        self.device = torch.device(device)
        self._compile_chain(in_types, in_dicts)

    def _compile_chain(self, in_types, in_dicts):
        spec = self.spec
        types = list(in_types)
        dicts = list(in_dicts)
        steps = []
        for node in spec.chain:
            if isinstance(node, PL.Filter):
                steps.append(("filter", compile_expression(
                    node.predicate, types, dicts, device=self.device), None))
            else:
                ces = [compile_expression(e, types, dicts, device=self.device)
                       for e in node.expressions]
                steps.append(("project", ces,
                              [torch_dtype(t.storage_dtype)
                               for t in node.output_types]))
                types = list(node.output_types)
                dicts = [ce.dictionary for ce in ces]
        self.steps = steps
        # chain-output dictionaries: what the carried state's key codes mean
        self.key_dicts = [dicts[c] for c in spec.partial.group_keys]

    def initial_state(self) -> dict:
        return initial_state(self.spec, self.device)

    def __call__(self, state, cols, live, batch_remaps, state_remaps):
        n = int(live.shape[0])
        cols, live, batch_err = self._apply_chain(cols, live, n)
        return self._agg_merge(state, cols, live, batch_remaps,
                               state_remaps, n, batch_err)

    def _apply_chain(self, cols, live, n):
        """The Filter/Project chain, as FilterProjectOperator evaluates it."""
        with expr_error_scope() as errs:
            for kind, compiled, out_dtypes in self.steps:
                if kind == "filter":
                    with expr_condition_mask(live):
                        data, valid = compiled(cols)
                    mask = data if valid is None else data & valid
                    if mask.dim() == 0:
                        mask = mask.expand(n)
                    live = live & mask
                else:
                    outs = []
                    with expr_condition_mask(live):
                        for ce, dt in zip(compiled, out_dtypes):
                            d, v = ce(cols)
                            if d.dim() == 0:
                                d = d.expand(n).contiguous()
                            d = d.to(dt)
                            if v is not None and v.dim() == 0:
                                v = v.expand(n).contiguous()
                            outs.append((d, v))
                    cols = outs
            err = reduce_error_lanes(errs, n, live.device)
        if err is None:
            err = torch.zeros((), dtype=torch.int32, device=live.device)
        return cols, live, err

    def _agg_merge(self, state, cols, live, batch_remaps, state_remaps,
                   n, batch_err):
        spec = self.spec
        cap = spec.cap
        # ---- partial aggregation of this batch ----------------------------
        keys, kvalids = [], []
        for j, ch in enumerate(spec.partial.group_keys):
            d, v = cols[ch]
            if batch_remaps[j] is not None:  # codes -> merged dict space
                d = batch_remaps[j][d.long()]
            keys.append(d)
            kvalids.append(v)
        agg_inputs = []
        for ss in spec.flat_states:
            if ss.fn == "count_star":
                agg_inputs.append((AggSpec("count_star", torch.int64),
                                   None, None))
                continue
            d, v = cols[ss.arg]
            if ss.fn == "sum" and ss.scale:
                d = d.to(torch.float64) / (10.0 ** ss.scale)
            agg_inputs.append((AggSpec(ss.fn, _acc_dtype(ss)), d, v))
        part = static_grouped_agg(keys, kvalids, agg_inputs, cap,
                                  row_mask=live)

        # ---- merge with the carried state ---------------------------------
        skd = list(state["kd"])
        for j in range(spec.nk):
            if state_remaps[j] is not None:
                skd[j] = state_remaps[j][skd[j].long()]
        ckd = [torch.cat([skd[j], part.keys[j].to(skd[j].dtype)])
               for j in range(spec.nk)]
        ckv = [torch.cat([state["kv"][j],
                          part.key_valids[j] if part.key_valids[j] is not None
                          else part.slot_used])
               for j in range(spec.nk)]
        cused = torch.cat([state["used"], part.slot_used])
        partial_inputs = []
        for si, ss in enumerate(spec.flat_states):
            vals = torch.cat([state["sd"][si].to(_acc_dtype(ss)),
                              part.values[si]])
            if ss.has_valid:
                pv = part.value_valids[si]
                valid = torch.cat([state["sv"][si],
                                   pv if pv is not None else part.slot_used])
            else:
                valid = None
            partial_inputs.append(
                (AggSpec(ss.fn if ss.fn != "count_star" else "count",
                         _acc_dtype(ss)), vals, valid))
        merged = combine_partials(ckd, ckv, partial_inputs, cused, cap)

        new_sd, new_sv = [], []
        for si, ss in enumerate(spec.flat_states):
            new_sd.append(merged.values[si].to(_state_dtype(ss)))
            if ss.has_valid:
                mv = merged.value_valids[si]
                new_sv.append(mv if mv is not None else merged.slot_used)
            else:
                new_sv.append(None)
        ovf = torch.maximum(state["ovf"], torch.maximum(
            part.num_groups, merged.num_groups).to(torch.int32))
        return {
            "kd": tuple(merged.keys),
            "kv": tuple(v if v is not None else merged.slot_used
                        for v in merged.key_valids),
            "sd": tuple(new_sd),
            "sv": tuple(new_sv),
            "used": merged.slot_used,
            "err": torch.maximum(state["err"], batch_err),
            "ovf": ovf,
        }


@memo("stage._ingest_program", maxsize=256)
def _ingest_program(n_out: int, has_valid: tuple, has_live: bool):
    """The pad-to-bucket program of one pad pattern: pads every column and
    its valid mask to ``n_out`` rows and extends ``live`` (all-live when
    the batch has none) as dead over the pad rows.  A missing valid mask
    stays missing: the compiled expressions take None for all-valid."""

    def run(cols, live, n_in: int):
        pad = n_out - n_in
        if pad:
            outs = []
            for (d, v), hv in zip(cols, has_valid):
                d = torch.cat([d, d.new_zeros(pad)])
                if hv:
                    v = torch.cat([v, v.new_zeros(pad)])
                outs.append((d, v))
            cols = outs
        if not has_live:
            live = torch.arange(n_out, device=cols[0][0].device) < n_in
        elif pad:
            live = torch.cat([live, live.new_zeros(pad)])
        return tuple(cols), live

    return run


def _accumulate_program(spec: FusedStageSpec, in_types, in_dicts,
                        device) -> _AccumulateProgram:
    key = (spec.cache_key(), tuple(in_types), str(device),
           tuple(id(d) if d is not None else None for d in in_dicts))
    with _ACCUM_LOCK:
        hit = _ACCUM_CACHE.get(key)
        if hit is not None:
            _ACCUM_STATS["hits"] += 1
            return hit[0]
        _ACCUM_STATS["misses"] += 1
        if len(_ACCUM_CACHE) >= 256:
            _ACCUM_CACHE.pop(next(iter(_ACCUM_CACHE)))
            _ACCUM_STATS["evictions"] += 1
    prog = _AccumulateProgram(spec, in_types, in_dicts, device)
    with _ACCUM_LOCK:
        # dict refs held in the value keep the id()-keyed entries stable
        _ACCUM_CACHE.setdefault(key, (prog, list(in_dicts)))
    return prog


# ---------------------------------------------------------------------------
# the seam merge: route -> all_to_all -> FINAL combine -> finalize


@memo("stage._merge_program")
def _merge_program(n_dev: int, cap: int, key_types: tuple,
                   state_sig: tuple, final_sig: tuple):
    """The seam merge of one stage shape, as a host loop over the mesh:
    hash-route every live slot of every task's state to its owner task,
    all_to_all each lane, FINAL-combine at ``n_dev * cap`` slots (never
    overflows) and finalize the aggregate outputs.  ``route`` is each key's
    per-task routing lanes (the value hashes of dictionary keys)."""
    nk = len(key_types)
    fcap = n_dev * cap

    def run(mesh, kds, kvs, sds, svs, used, route):
        dests = [K.partition_assignments(
            [(route[j][t], kvs[j][t]) for j in range(nk)], n_dev)
            for t in range(n_dev)]
        lane_live = [[used[t] & (dests[t] == d) for d in range(n_dev)]
                     for t in range(n_dev)]

        def shuffle(per_task):
            return all_to_all([[x] * n_dev for x in per_task], mesh)

        rkd = [shuffle(kds[j]) for j in range(nk)]
        rkv = [shuffle(kvs[j]) for j in range(nk)]
        rsd = [shuffle(sds[si]) for si in range(len(state_sig))]
        rsv = [shuffle(svs[si]) if hv else None
               for si, (_, _, hv) in enumerate(state_sig)]
        rlive = all_to_all(lane_live, mesh)
        outs = []
        for d in range(n_dev):
            fin = combine_partials(
                [k[d] for k in rkd], [v[d] for v in rkv],
                [(AggSpec(fn, torch_dtype(np.dtype(dt))), rsd[si][d],
                  None if rsv[si] is None else rsv[si][d])
                 for si, (fn, dt, _) in enumerate(state_sig)],
                rlive[d], fcap)
            # FINAL finalize (HashAggregationOperator FINAL semantics)
            aggs = []
            si = 0
            for fn, out_dt, width in final_sig:
                odt = torch_dtype(np.dtype(out_dt))
                if fn == "avg":
                    s, sv = fin.values[si], fin.value_valids[si]
                    c = fin.values[si + 1]
                    vals = (s / torch.clamp(c, min=1)).to(odt)
                    valid = c > 0
                    if sv is not None:
                        valid = valid & sv
                    aggs.append((vals, valid))
                elif fn == "count":
                    aggs.append((fin.values[si].to(torch.int64), None))
                else:  # sum | min | max
                    aggs.append((fin.values[si].to(odt),
                                 fin.value_valids[si]))
                si += width
            keys = [(fin.keys[j],
                     fin.key_valids[j] if fin.key_valids[j] is not None
                     else fin.slot_used) for j in range(nk)]
            outs.append((keys, aggs, fin.slot_used))
        return outs

    return run


# ---------------------------------------------------------------------------
# rendezvous + operators


class FusedStageExec:
    """Rendezvous for one fused seam: ``n_tasks`` producer sinks deposit
    their carried states; the last depositor runs the seam merge (its
    device part in a SyncGuard hot region: no host read between deposit
    and take); consumer sources take their shard."""

    def __init__(self, spec: FusedStageSpec, mesh: Mesh):
        if len(mesh) != spec.n_tasks:
            raise ValueError(f"mesh of {len(mesh)} shards for "
                             f"{spec.n_tasks} tasks")
        self.spec = spec
        self.mesh = mesh
        n = spec.n_tasks
        self._deposits: list = [None] * n
        self._dicts: list = [None] * n
        self._count = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._results: list = [None] * n
        self._error: Optional[BaseException] = None
        self.stats = FusedStageStats(stages=1)

    # ------------------------------------------------------------ producers
    def deposit(self, task_index: int, state, key_dicts,
                sink_stats: FusedStageStats) -> None:
        with self._lock:
            self._deposits[task_index] = state
            self._dicts[task_index] = key_dicts
            self.stats.merge(sink_stats)
            self._count += 1
            run_it = self._count == self.spec.n_tasks
        if run_it:
            t0 = profiler.now() if profiler.enabled() else 0.0
            try:
                self._run_merge()
                self.stats.merges += 1
            except BaseException as e:  # surfaced to every waiting consumer
                self._error = e
            if t0:
                profiler.event(
                    profiler.FUSED,
                    f"fused-merge[f{self.spec.producer_fid}->"
                    f"f{self.spec.consumer_fid}]", t0,
                    tasks=self.spec.n_tasks)
            self._done.set()

    def abort(self) -> None:
        self._error = RuntimeError("fused stage aborted")
        self._done.set()

    # ------------------------------------------------------------- the merge
    def _run_merge(self) -> None:
        spec = self.spec
        n, nk, mesh = spec.n_tasks, spec.nk, self.mesh
        key_types = spec.key_types
        # a task that saw no input deposits the zero state
        states = [st if st is not None else initial_state(spec, mesh[t])
                  for t, st in enumerate(self._deposits)]
        kds = [[states[t]["kd"][j] for t in range(n)] for j in range(nk)]
        kvs = [[states[t]["kv"][j] for t in range(n)] for j in range(nk)]
        # unify each dictionary key across the tasks (host work over the
        # dictionaries; the codes remap with one device gather per task)
        # and route it by its values' hashes
        merged_dicts: list = [None] * nk
        route = [list(kd) for kd in kds]
        empty = np.array([], dtype=object)
        for j, t_ in enumerate(key_types):
            if not t_.is_dictionary_encoded:
                continue
            cols = unify_dictionaries([
                Column(t_, kds[j][t], kvs[j][t],
                       self._dicts[t][j] if self._dicts[t] is not None
                       and self._dicts[t][j] is not None else empty)
                for t in range(n)])
            kds[j] = [c.data for c in cols]
            merged_dicts[j] = cols[0].dictionary
            route[j] = [LX.partition_key_tuple(c)[0] for c in cols]
        state_sig = tuple((s.fn if s.fn != "count_star" else "count",
                           s.dtype, s.has_valid) for s in spec.flat_states)
        final_sig = tuple(
            (a.fn if not (a.fn == "count" and a.arg < 0) else "count",
             np.dtype(t.storage_dtype).str, len(group))
            for a, t, group in zip(spec.final.aggregates,
                                   spec.final.output_types[nk:],
                                   spec.state_specs))
        prog = _merge_program(n, spec.cap, tuple(str(t) for t in key_types),
                              state_sig, final_sig)
        with SG.hot_region():
            outs = prog(
                mesh, kds, kvs,
                [[states[t]["sd"][si] for t in range(n)]
                 for si in range(len(state_sig))],
                [[states[t]["sv"][si] for t in range(n)]
                 for si in range(len(state_sig))],
                [states[t]["used"] for t in range(n)], route)
        fin = spec.final
        for t, (keys, aggs, live) in enumerate(outs):
            cols = [Column(fin.output_types[j], d, v, merged_dicts[j])
                    for j, (d, v) in enumerate(keys)]
            cols += [Column(fin.output_types[nk + a], d, v)
                     for a, (d, v) in enumerate(aggs)]
            self._results[t] = ColumnBatch(list(fin.output_names), cols,
                                           live)

    # ------------------------------------------------------------- consumers
    def take(self, task_index: int,
             timeout: Optional[float] = None) -> ColumnBatch:
        """Blocking take: the default timeout is ``task.STALL_TIMEOUT_S``
        (TRINO_TPU_EXCHANGE_STALL_S), and a stall raises a retryable
        PAGE_TRANSPORT_TIMEOUT, the contract of every exchange."""
        if timeout is None:
            timeout = T.STALL_TIMEOUT_S
        t0 = profiler.now() if profiler.enabled() else 0.0
        ok = self._done.wait(timeout)
        if t0:
            profiler.event(
                profiler.EXCHANGE,
                f"fused-take[f{self.spec.producer_fid}->"
                f"f{self.spec.consumer_fid}]", t0, stalled=not ok)
        if not ok:
            raise TrinoError(
                PAGE_TRANSPORT_TIMEOUT,
                f"fused stage seam f{self.spec.producer_fid}->"
                f"f{self.spec.consumer_fid} stalled after {timeout:.0f}s")
        if self._error is not None:
            if isinstance(self._error, (FusedStageOverflow, TrinoError)):
                raise self._error
            # a fault of the card keeps its code: it must not be retried
            code = (DEVICE_FAULT if is_device_fault(self._error)
                    else GENERIC_INTERNAL_ERROR)
            raise TrinoError(code, f"fused stage failed: {self._error}") \
                from self._error
        return self._results[task_index]


class _CarriedStateSink(Operator):
    """What the fused and resident sinks share: the carried state, the
    feed dictionaries' drift into it, the signature count and the overflow
    check at finish."""

    blocking = True  # see task.RemoteExchangeSourceOperator
    _track = profiler.FUSED
    _event = "fused-accumulate"
    _ovf_tag = "fused.overflow"

    def __init__(self, exchange, task_index: int):
        self.exchange = exchange
        self.task_index = task_index
        self.spec = exchange.spec
        self._state: Optional[dict] = None
        self._key_dicts: Optional[list] = None
        self._remap_cache: dict = {}
        self.stats = FusedStageStats()
        self.pending_errors: list = []

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        self._before_batch()
        # LAZY columns materialize here, outside the hot region: theirs is
        # the scan's copy to the device, which from pageable memory (a
        # synchronous scan) waits for the stream
        for c in batch.columns:
            c.valid
        t0 = profiler.now() if profiler.enabled() else 0.0
        with SG.hot_region():
            self._accumulate(batch)
        if t0:
            profiler.event(self._track,
                           f"{self._event}[f{self.spec.producer_fid}]", t0,
                           rows=batch.num_rows)

    def _before_batch(self) -> None:
        pass

    def _drift(self, j: int, bd, device) -> tuple:
        """(batch remap, state remap) lifting batch codes under dictionary
        ``bd`` and the carried codes of key ``j`` into a merged
        dictionary, which becomes the carried one; (None, None) when they
        agree."""
        cur = self._key_dicts[j]
        if bd is None or cur is None or bd is cur:
            if cur is None:
                self._key_dicts[j] = bd
            return None, None
        ck = (id(bd), id(cur))
        hit = self._remap_cache.get(ck)
        if hit is None:
            if bd.shape == cur.shape and (bd == cur).all():
                hit = (None, None, cur)
            else:
                merged = np.unique(np.concatenate([cur, bd]))
                hit = (_pad_table(np.searchsorted(merged, bd), device),
                       _pad_table(np.searchsorted(merged, cur), device),
                       merged)
            # the dictionaries ride in the entry, so their ids stay unique
            self._remap_cache[ck] = hit + (bd, cur)
        self._key_dicts[j] = hit[2]
        return hit[0], hit[1]

    def _call(self, prog, sig: tuple, lock, sigs: set, compiles_metric,
              *args) -> None:
        """One program call, counted as the first of its signature (a
        compile) or a repeat (a cache hit)."""
        with lock:
            fresh = sig not in sigs
            sigs.add(sig)
        if fresh:
            self.stats.compiles += 1
        else:
            self.stats.cache_hits += 1
        t0 = time.perf_counter() if fresh else 0.0
        self._state = prog(self._state, *args)
        if fresh:
            compiles_metric.inc()
            tm.FUSED_COMPILE_SECONDS.record(time.perf_counter() - t0)
        self.stats.jit_calls += 1
        self.stats.batches += 1

    def finish_input(self) -> None:
        super().finish_input()
        if self._state is not None:
            # the one data-dependent scalar of the stage, read outside the
            # hot region, once per task (not per batch)
            ovf = int(SG.fetch(self._state["ovf"], self._ovf_tag))
            if ovf > self.spec.cap:
                raise self._overflow(ovf)
            self.pending_errors.append(self._state["err"])
        self.exchange.deposit(self.task_index, self._state, self._key_dicts,
                              self.stats)

    def _overflow(self, ovf: int) -> BaseException:
        return FusedStageOverflow(
            f"fused stage f{self.spec.producer_fid}: {ovf} groups exceed "
            f"the {self.spec.cap}-slot state (TRINO_TPU_FUSED_CAP); "
            "re-running on the per-operator path")

    def is_finished(self) -> bool:
        return self.input_done


class FusedStageSinkOperator(_CarriedStateSink):
    """Producer-side terminal of a fused stage: absorbs the feed's device
    batches with one accumulate call each (SyncGuard hot region: no host
    read), checks the overflow scalar once at finish, then deposits the
    carried state into the seam rendezvous."""

    def _accumulate(self, batch: ColumnBatch) -> None:
        spec = self.spec
        raw_n = batch.num_rows
        dev = batch.device
        n = K.bucket(raw_n)
        prog = _accumulate_program(
            spec, [c.type for c in batch.columns],
            [c.dictionary for c in batch.columns], dev)
        if self._state is None:
            self._state = prog.initial_state()
            self._key_dicts = list(prog.key_dicts)
        batch_remaps: list = [None] * spec.nk
        state_remaps: list = [None] * spec.nk
        for j in range(spec.nk):
            batch_remaps[j], state_remaps[j] = self._drift(
                j, prog.key_dicts[j], dev)
        has_valid = tuple(c.valid is not None for c in batch.columns)
        ingest = _ingest_program(n, has_valid, batch.live is not None)
        cols, live = ingest(tuple((c.data, c.valid) for c in batch.columns),
                            batch.live, raw_n)
        sig = (id(prog), n, has_valid, batch.live is not None,
               tuple(None if r is None else len(r) for r in batch_remaps),
               tuple(None if r is None else len(r) for r in state_remaps))
        self._call(prog, sig, _ACCUM_LOCK, _TRACE_SIGS, tm.FUSED_COMPILES,
                   cols, live, tuple(batch_remaps), tuple(state_remaps))
        self.stats.input_rows += n


def _pad_table(t: np.ndarray, device) -> torch.Tensor:
    t = t.astype(np.int32)
    R = K.bucket(max(len(t), 1))
    return host_table(np.concatenate([t, np.zeros(R - len(t), np.int32)]),
                      device)


class FusedStageSourceOperator(Operator):
    """Consumer-side source: emits this task's shard of the fused FINAL
    aggregation once (in place of RemoteSource + HashAggregation(FINAL)
    in the consumer pipeline)."""

    blocking = True  # see task.RemoteExchangeSourceOperator

    def __init__(self, exchange: FusedStageExec, task_index: int):
        self.exchange = exchange
        self.task_index = task_index
        self.input_done = True
        self._emitted = False

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        if self._emitted or self._closed:
            return None
        if not self.blocking and not self.exchange._done.is_set():
            return None  # park; the executor reschedules us
        self._emitted = True
        batch = self.exchange.take(self.task_index)
        return batch if batch.num_rows else None

    def is_finished(self) -> bool:
        return self._emitted or self._closed
