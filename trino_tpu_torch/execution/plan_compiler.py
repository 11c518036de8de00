"""Whole-query compilation: one program call per batch of a resident plan.

The port of the reference ``execution/plan_compiler.py``.  Its
``init_distributed`` brings up ``torch.distributed`` over gloo where the
reference brings up ``jax.distributed`` with gloo CPU collectives.
The fragmenter coalesces a maximal connected subtree of device-resident
fragments, a broadcast multi-join tree under a fusable PARTIAL->FINAL
seam, into a ``ResidentPlan`` record (execution/fragmenter.py).  This
module runs each record as:

1. **Build prep** (once per build fragment, per query, by its last
   depositing task): the tasks' build batches concatenate on the runner's
   device (the BROADCAST interior edge; dictionary columns unify over
   their small dictionaries and cross as codes, counted in
   ``code_seam_columns``), and the live, non-NULL keys index into a
   ``hash_insert`` table with the group count kept on the device.  A count
   below the live-key count means duplicate build keys: the one host read
   of the prep (``resident.build-dup``) raises
   :class:`ResidentPlanOverflow`, since the probe below is 1-match.  The
   reference all_gathers and sorts the build and probes with
   ``searchsorted``; the port's join indexes are ``hash_insert`` tables.

2. **Whole-plan accumulate** (one call per probe batch, per task): the
   feed batch looks its keys up in every build with ``hash_probe`` (group
   id -> build row, -1 = no match) and gathers the build payload, then
   the Filter/Project chain, the partial aggregation and the carried-state
   merge of the fused stage run in the same call, with no host read.  The
   program is memoized under a value key (base64 of the zlib-pickled plan
   payload, as the reference builds it), which survives a JSON round trip
   and so reaches the warm-key journal (caching/executable_cache.py).  A
   payload is unpickled only when it names no module of the reference (a
   journal written by the reference's package holds such payloads).

3. **Seam merge**: the fused stage's (execution/stage_compiler.py).

Only :class:`ResidentPlanOverflow` (state overflow, duplicate build keys)
re-runs the query on the per-operator path; every other failure of a
build, probe or merge fails the query.

``TRINO_TPU_RESIDENT_PLAN={auto,1,0}``: 0 keeps the fused or per-operator
path.
"""

from __future__ import annotations

import base64
import io
import pickle
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..caching.executable_cache import memo
from ..exec import kernels as K
from ..exec import syncguard as SG
from ..exec.operators import Operator
from ..exec.stats import FusedStageStats, ResidentPlanStats
from ..ops import gpu_kernels as GK
from ..parallel.distributed import Mesh
from ..planner import plan as PL
from ..spi import knobs
from ..spi.batch import Column, ColumnBatch, torch_dtype
from ..spi.errors import PAGE_TRANSPORT_TIMEOUT, TrinoError
from ..sql.ir import InputRef
from ..telemetry import metrics as tm
from ..telemetry import profiler
from . import task as T
from .stage_compiler import (FusedStageExec, FusedStageOverflow,
                             FusedStageSpec, _AccumulateProgram,
                             _CarriedStateSink, _ingest_program,
                             build_fused_spec, fused_cap, fused_stage_mode)

__all__ = ["ResidentPlanExec", "ResidentPlanOverflow", "ResidentPlanSpec",
           "init_distributed",
           "ResidentBuildHandle", "ResidentBuildSinkOperator",
           "ResidentPlanSinkOperator", "build_resident_spec",
           "plan_resident_plans", "resident_plan_mode",
           "resident_max_fragments"]


def resident_plan_mode() -> str:
    """TRINO_TPU_RESIDENT_PLAN: auto (default, compile eligible resident
    plans), 1 (same), 0 (the fused or per-operator path)."""
    v = knobs.get_str("TRINO_TPU_RESIDENT_PLAN").strip().lower()
    return v if v in ("auto", "1", "0") else "auto"


def resident_max_fragments() -> int:
    """Largest fragment count one resident program may absorb
    (TRINO_TPU_RESIDENT_MAX_FRAGMENTS)."""
    return knobs.get_int("TRINO_TPU_RESIDENT_MAX_FRAGMENTS") or 8


def _mesh_device_cap() -> int:
    """TRINO_TPU_MESH_SHAPE override ("8" or "2x4"): the product caps the
    mesh width a resident plan may claim; 0 = no override."""
    v = knobs.get_str("TRINO_TPU_MESH_SHAPE").strip().lower()
    if not v:
        return 0
    try:
        dims = [int(p) for p in v.replace("x", " ").split()]
    except ValueError:
        return 0
    n = 1
    for d in dims:
        if d <= 0:
            return 0
        n *= d
    return n


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """``torch.distributed`` bring-up for resident plans that span
    processes, with the reference's signature: a gloo process group of
    ``num_processes`` ranks rendezvousing at ``coordinator_address``
    (``host:port``), this process being rank ``process_id``.  Gloo, not NCCL: the port's
    processes share one card, and NCCL refuses two ranks on one card
    ("Duplicate GPU detected"), while gloo's ``all_gather`` takes the
    card's tensors as they are (both measured on the H100 by
    tools/dist_probe.py), so a broadcast gather needs no copy to host
    tensors by the caller."""
    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


class ResidentPlanOverflow(FusedStageOverflow):
    """A resident plan cannot hold (state overflow, duplicate build keys);
    the runner re-runs the query with resident and fused compilation
    off."""


# ---------------------------------------------------------------------------
# spec: what the fragmenter's ResidentPlan lowers to


@dataclass
class ResidentPlanSpec(FusedStageSpec):
    """FusedStageSpec plus the inlined broadcast joins.  ``feed`` is the
    scan chain BELOW the join spine (what the operator pipeline runs per
    task); ``joins`` apply bottom-up, each widening the probe schema by its
    build fragment's output columns."""

    joins: tuple = ()              # tuple[fragmenter.ResidentJoin, ...]
    build_types: tuple = ()        # per-join tuple of build output types
    plan: object = None            # the fragmenter.ResidentPlan record


def build_resident_spec(frag, frags_by_id: dict, n_tasks: int,
                        cap: int) -> ResidentPlanSpec:
    """Lower a fragmenter-marked ResidentPlan into the executable spec."""
    rp = frag.resident_plan
    base = build_fused_spec(frag, frags_by_id[rp.consumer_fid], n_tasks, cap)
    feed = base.feed               # the topmost Join of the probe spine
    for _ in rp.joins:
        feed = feed.left
    build_types = tuple(
        tuple(frags_by_id[j.build_fid].root.output_types) for j in rp.joins)
    return ResidentPlanSpec(
        producer_fid=base.producer_fid, consumer_fid=base.consumer_fid,
        n_tasks=n_tasks, feed=feed, chain=base.chain, partial=base.partial,
        final=base.final, nk=base.nk, cap=cap, state_specs=base.state_specs,
        joins=tuple(rp.joins), build_types=build_types, plan=rp)


def _key_origins(spec: ResidentPlanSpec) -> list:
    """For each group key, its channel in the post-join (chain-input)
    schema, or None when the key is a computed expression.  Feed-origin
    dictionary keys drift per batch; build-origin ones are stable for the
    whole query."""
    if spec.chain:
        width = len(spec.chain[0].source.output_types)
    else:
        width = len(spec.partial.source.output_types)
    idx: list = list(range(width))
    for node in spec.chain:
        if isinstance(node, PL.Project):
            idx = [idx[e.index] if isinstance(e, InputRef) else None
                   for e in node.expressions]
    return [idx[c] for c in spec.partial.group_keys]


def _key_index_inputs(key: torch.Tensor) -> tuple:
    """([P, N] key planes, [N] slot hashes) of an integer join key, as
    ``kernels.hash_row_gids`` makes them: build and probe agree on both."""
    planes = K.key_planes([(key.to(torch.int64), None)])
    return torch.stack(planes), K.slot_hash32(K.hash_combine(planes))


# ---------------------------------------------------------------------------
# the whole-plan program: probe every build + chain + partial agg + state
# merge, one call per batch


class _ResidentProgram(_AccumulateProgram):
    """The per-batch resident-plan program.  Joins are ``hash_probe``
    lookups in the build tables (1-match: duplicate build keys fall back
    at prep); the chain and the aggregation tail are the fused
    accumulate's.  Expressions compile without dictionaries (eligibility
    keeps the chain dictionary-free; codes pass through as bare lanes), so
    the program depends on no dictionary and its memo key is a value."""

    def __init__(self, spec: ResidentPlanSpec, device):
        self.spec = spec
        self.device = torch.device(device)
        if spec.chain:
            in_types = list(spec.chain[0].source.output_types)
        else:
            in_types = list(spec.partial.source.output_types)
        self._compile_chain(in_types, [None] * len(in_types))

    def __call__(self, state, feed_cols, live, builds, batch_remaps,
                 state_remaps):
        n = int(live.shape[0])
        cols = list(feed_cols)
        for join, (planes, slot_gid, row_of, payload) in zip(
                self.spec.joins, builds):
            pk_d, pk_v = cols[join.probe_key]
            probe, h32 = _key_index_inputs(pk_d)
            look = live if pk_v is None else live & pk_v
            gid = GK.hash_probe(planes, slot_gid, probe, h32,
                                look.contiguous())
            hit = gid >= 0
            row = row_of[torch.clamp(gid, min=0).long()]
            for d, v in payload:
                cols.append((d[row], hit if v is None else v[row] & hit))
            if join.join_type == "INNER":
                live = live & hit
        cols, live, batch_err = self._apply_chain(cols, live, n)
        return self._agg_merge(state, cols, live, batch_remaps,
                               state_remaps, n, batch_err)


def encode_resident_payload(spec: ResidentPlanSpec) -> str:
    """Everything the program depends on, serialized by value (base64 of
    the zlib-compressed pickle, the reference's encoding): the memo key,
    which survives a JSON round trip."""
    raw = pickle.dumps((tuple(spec.chain), spec.partial, tuple(spec.joins),
                        tuple(spec.state_specs)), protocol=4)
    return base64.b64encode(zlib.compress(raw)).decode("ascii")


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a plan payload, refusing any class of the reference's
    package (the port never imports it)."""

    def find_class(self, module: str, name: str):
        if module.split(".", 1)[0] in ("trino_tpu", "jax"):
            raise pickle.UnpicklingError(
                f"plan payload names {module}.{name}, not a port class")
        return super().find_class(module, name)


@memo("resident._program", maxsize=64)
def _resident_program(spec_b64: str, cap: int,
                      device: str) -> _ResidentProgram:
    chain, partial, joins, state_specs = _PortUnpickler(io.BytesIO(
        zlib.decompress(base64.b64decode(spec_b64)))).load()
    feed = chain[0].source if chain else partial.source
    spec = ResidentPlanSpec(
        producer_fid=-1, consumer_fid=-1, n_tasks=0, feed=feed,
        chain=tuple(chain), partial=partial, final=partial,
        nk=len(partial.group_keys), cap=cap, state_specs=tuple(state_specs),
        joins=tuple(joins))
    return _ResidentProgram(spec, device)


# first calls of each (program, bucket) signature, as stage_compiler's
_RES_TRACE_SIGS: set = set()
_RES_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# rendezvous


class ResidentPlanExec(FusedStageExec):
    """Rendezvous for one resident plan: build sinks deposit their
    fragments' batches (the last depositor runs the build prep), probe
    sinks wait for every build and then absorb batches with one whole-plan
    call each, and the inherited seam merge and take serve the consumer."""

    def __init__(self, spec: ResidentPlanSpec, mesh: Mesh):
        super().__init__(spec, mesh)
        self.rstats = ResidentPlanStats(plans=1, seams=len(spec.joins) + 1)
        self.spec_b64 = encode_resident_payload(spec)
        self.key_origins = _key_origins(spec)
        self.n_feed = len(spec.feed.output_types)
        self._build_lock = threading.Lock()
        self._builds: dict = {}
        for j in spec.joins:
            self._builds[j.build_fid] = {
                "deposits": [None] * spec.n_tasks, "count": 0,
                "ready": threading.Event(), "table": None, "dicts": None}

    # ------------------------------------------------------------ build side
    def build_deposit(self, build_fid: int, task_index: int,
                      batches: list) -> None:
        slot = self._builds[build_fid]
        with self._build_lock:
            slot["deposits"][task_index] = batches
            slot["count"] += 1
            run_prep = slot["count"] == self.spec.n_tasks
        if run_prep:
            try:
                self._prep_build(build_fid)
            except BaseException as e:
                self._fail(e)
            slot["ready"].set()

    def _fail(self, e: BaseException) -> None:
        self._error = e
        for slot in self._builds.values():
            slot["ready"].set()
        self._done.set()

    def abort(self) -> None:
        self._fail(RuntimeError("resident plan aborted"))

    def builds_ready(self) -> bool:
        return all(s["ready"].is_set() for s in self._builds.values())

    def _prep_build(self, build_fid: int) -> None:
        spec = self.spec
        t0 = profiler.now() if profiler.enabled() else 0.0
        ji = next(i for i, j in enumerate(spec.joins)
                  if j.build_fid == build_fid)
        join = spec.joins[ji]
        col_types = spec.build_types[ji]
        slot = self._builds[build_fid]
        dev = self.mesh[0]
        batches = [b for bs in slot["deposits"] for b in (bs or [])]
        if batches:
            # dictionaries unify over the small dictionaries; the code
            # lanes stay codes through the concatenation
            batch = ColumnBatch.concat([b.to(dev) for b in batches],
                                       keep_live=True)
        else:
            batch = ColumnBatch(
                [f"c{i}" for i in range(len(col_types))],
                [Column(t, torch.empty(0, dtype=torch_dtype(t.storage_dtype),
                                       device=dev),
                        None, np.array([], dtype=object)
                        if t.is_dictionary_encoded else None)
                 for t in col_types])
        merged_dicts = [c.dictionary for c in batch.columns]
        n_code_cols = sum(1 for d in merged_dicts if d is not None)
        rows = batch.num_rows
        # the build pads to a power of two with dead rows, as the reference
        # pads its per-task lanes; a build of no rows still has one lane
        cap = K.bucket(max(rows, 1))
        pad = cap - rows

        def padded(x, fill=0):
            return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

        kc = batch.columns[join.build_key]
        live = batch.live if batch.live is not None else torch.ones(
            rows, dtype=torch.bool, device=dev)
        if kc.valid is not None:
            live = live & kc.valid
        live = padded(live, False).contiguous()
        planes, h32 = _key_index_inputs(padded(kc.data))
        S = K.bucket(2 * cap)
        row_gid, count, tplanes, slot_gid = GK.hash_insert(
            planes, h32, live, S, count_on_device=True)
        dup = count.to(torch.int64) != live.sum()
        if bool(SG.fetch(dup, "resident.build-dup")):
            raise ResidentPlanOverflow(
                f"resident plan f{spec.producer_fid}: build f{build_fid} "
                "has duplicate join keys (the resident probe is 1-match); "
                "re-running on the per-operator path")
        # build row of each group id: the keys are unique, so every id
        # has one row (dead rows write the spare last slot)
        row_of = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        row_of.scatter_(0, torch.where(live, row_gid.long(), cap),
                        torch.arange(cap, device=dev))
        payload = tuple(
            (padded(c.data), None if c.valid is None else padded(c.valid))
            for c in batch.columns)
        slot["table"] = (tplanes, slot_gid, row_of[:cap], payload)
        slot["dicts"] = merged_dicts
        with self._build_lock:
            self.rstats.code_seam_columns += n_code_cols
        if n_code_cols:
            tm.RESIDENT_CODE_SEAMS.inc(n_code_cols)
        if t0:
            profiler.event(
                profiler.RESIDENT,
                f"resident-build[f{build_fid}->f{spec.producer_fid}]", t0,
                rows=rows, code_columns=n_code_cols)

    # ------------------------------------------------------------ probe side
    def wait_builds(self) -> None:
        for fid, slot in self._builds.items():
            if not slot["ready"].wait(T.STALL_TIMEOUT_S):
                raise TrinoError(
                    PAGE_TRANSPORT_TIMEOUT,
                    f"resident build f{fid} stalled after "
                    f"{T.STALL_TIMEOUT_S:.0f}s")
        if self._error is not None:
            raise self._error

    def build_tables(self) -> tuple:
        return tuple(self._builds[j.build_fid]["table"]
                     for j in self.spec.joins)

    def _build_col_dict(self, post_join_channel: int):
        """Merged dictionary of a build-origin post-join channel."""
        off = post_join_channel - self.n_feed
        for ji, types in enumerate(self.spec.build_types):
            if off < len(types):
                dicts = self._builds[self.spec.joins[ji].build_fid]["dicts"]
                return dicts[off] if dicts is not None else None
            off -= len(types)
        return None

    def initial_key_dicts(self) -> list:
        """Starting key dictionaries of a probe sink's carried state:
        build-origin dictionary keys are the merged build dictionary
        (stable all query); feed-origin keys start None and track the
        batches' drift in the sink."""
        out: list = [None] * self.spec.nk
        for j, o in enumerate(self.key_origins):
            if o is not None and o >= self.n_feed:
                out[j] = self._build_col_dict(o)
        return out

    # ------------------------------------------------------------- producers
    def deposit(self, task_index: int, state, key_dicts,
                sink_stats: FusedStageStats) -> None:
        with self._build_lock:
            self.rstats.batches += sink_stats.batches
            self.rstats.jit_calls += sink_stats.jit_calls
            self.rstats.programs += sink_stats.compiles
            self.rstats.cache_hits += sink_stats.cache_hits
            self.rstats.input_rows += sink_stats.input_rows
        super().deposit(task_index, state, key_dicts, sink_stats)

    def _run_merge(self) -> None:
        super()._run_merge()
        self.rstats.merges += 1


class ResidentBuildHandle:
    """Edge value of a build fragment folded into a resident plan: its
    tasks end in a ResidentBuildSinkOperator that deposits into the owning
    ResidentPlanExec."""

    def __init__(self, exchange: ResidentPlanExec, build_fid: int):
        self.exchange = exchange
        self.build_fid = build_fid

    def abort(self) -> None:
        self.exchange.abort()


class ResidentBuildSinkOperator(Operator):
    """Build-side terminal: batches stay as produced (codes and all) and
    hand off to the build prep at finish."""

    def __init__(self, handle: ResidentBuildHandle, task_index: int):
        self.handle = handle
        self.task_index = task_index
        self._batches: list = []

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self._batches.append(batch)

    def finish_input(self) -> None:
        super().finish_input()
        self.handle.exchange.build_deposit(
            self.handle.build_fid, self.task_index, self._batches)

    def is_finished(self) -> bool:
        return self.input_done


class ResidentPlanSinkOperator(_CarriedStateSink):
    """Probe-side terminal of a resident plan: one whole-plan call per feed
    batch (SyncGuard hot region: the probes, chain, partial aggregation
    and state merge are all inside), the overflow checked once at finish,
    the state deposited into the inherited seam rendezvous.  Under the
    time-sharing executor (non-blocking) it takes no input until every
    build is ready, so its driver parks instead of holding a worker."""

    _track = profiler.RESIDENT
    _event = "resident-accumulate"
    _ovf_tag = "resident.overflow"

    def __init__(self, exchange: ResidentPlanExec, task_index: int):
        super().__init__(exchange, task_index)
        self._builds: Optional[tuple] = None

    def needs_input(self) -> bool:
        if (not self.blocking and self._builds is None
                and not self.exchange.builds_ready()):
            return False
        return super().needs_input()

    def _before_batch(self) -> None:
        if self._builds is None:
            self.exchange.wait_builds()  # blocks OUTSIDE the hot region
            self._builds = self.exchange.build_tables()

    def _accumulate(self, batch: ColumnBatch) -> None:
        spec = self.spec
        raw_n = batch.num_rows
        dev = batch.device
        n = K.bucket(raw_n)
        prog = _resident_program(self.exchange.spec_b64, spec.cap, str(dev))
        if self._state is None:
            self._state = prog.initial_state()
            self._key_dicts = self.exchange.initial_key_dicts()
        # feed-origin dictionary drift: lift the carried codes and the
        # batch's codes into a merged dictionary before the state combine
        batch_remaps: list = [None] * spec.nk
        state_remaps: list = [None] * spec.nk
        for j, origin in enumerate(self.exchange.key_origins):
            if origin is not None and origin < self.exchange.n_feed:
                batch_remaps[j], state_remaps[j] = self._drift(
                    j, batch.columns[origin].dictionary, dev)
        has_valid = tuple(c.valid is not None for c in batch.columns)
        has_live = batch.live is not None
        ingest = _ingest_program(n, has_valid, has_live)
        cols, live = ingest(tuple((c.data, c.valid) for c in batch.columns),
                            batch.live, raw_n)
        sig = (id(prog), n, has_valid, has_live,
               tuple(None if r is None else len(r) for r in batch_remaps),
               tuple(None if r is None else len(r) for r in state_remaps))
        self._call(prog, sig, _RES_LOCK, _RES_TRACE_SIGS,
                   tm.RESIDENT_PROGRAMS, cols, live, self._builds,
                   tuple(batch_remaps), tuple(state_remaps))
        self.stats.input_rows += n

    def _overflow(self, ovf: int) -> BaseException:
        return ResidentPlanOverflow(
            f"resident plan f{self.spec.producer_fid}: {ovf} groups exceed "
            f"the {self.spec.cap}-slot state (TRINO_TPU_FUSED_CAP); "
            "re-running on the per-operator path")


# ---------------------------------------------------------------------------
# runtime planning gate


def plan_resident_plans(fragments, session, task_counts: dict,
                        consumer_tasks: dict, device) -> dict:
    """Runtime gate over fragmenter-coalesced resident plans: {core_fid:
    ResidentPlanExec} plus {build_fid: ResidentBuildHandle} for the plans
    whose every fragment's task count equals the mesh width (the fused
    seam's conditions over the whole subtree), within
    TRINO_TPU_MESH_SHAPE and TRINO_TPU_RESIDENT_MAX_FRAGMENTS."""
    if (resident_plan_mode() == "0" or fused_stage_mode() == "0"
            or not session.use_collectives):
        return {}
    from .collective_exchange import collectives_available

    by_id = {f.id: f for f in fragments}
    max_frags = resident_max_fragments()
    cap_dev = _mesh_device_cap()
    out: dict = {}
    for f in fragments:
        rp = f.resident_plan
        if rp is None or not f.device_resident:
            continue
        if len(rp.fragment_ids) > max_frags:
            continue
        tc = task_counts.get(f.id)
        if (tc is None or consumer_tasks.get(f.id) != tc
                or task_counts.get(rp.consumer_fid) != tc
                or not collectives_available(tc)):
            continue
        if cap_dev and tc > cap_dev:
            continue
        if any(task_counts.get(j.build_fid) != tc for j in rp.joins):
            continue
        ex = ResidentPlanExec(build_resident_spec(f, by_id, tc, fused_cap()),
                              Mesh([device] * tc))
        out[f.id] = ex
        for j in rp.joins:
            out[j.build_fid] = ResidentBuildHandle(ex, j.build_fid)
    return out
