"""Adaptive query execution: the coordinator-side control plane.

The port of the reference ``execution/adaptive.py``.  Three capabilities,
all gated by ``TRINO_TPU_ADAPTIVE`` (session property ``adaptive``): ``0``
is the static plan (this module is never touched), ``auto`` (default)
engages only when the plan has decision edges, ``1`` forces the phased
scheduler even without any.

1. **Phased stage activation.**  Fragments are grouped (union-find over
   collective / fused edges, whose rendezvous requires co-activation) and
   activated bottom-up as their input groups activate.  Plain-edge groups
   cascade immediately, so streaming overlap is preserved, but a group
   containing an unresolved join decision site stays inactive: its
   fragments hold no task threads and its plan remains rewritable.

2. **Runtime join-distribution switching.**  The build (and, for
   partitioned joins, probe) edges of an eligible topmost join are
   *deferred*: their producers write into single-partition staging buffers
   whose cumulative ``bytes_enqueued`` counters and heavy-hitter sketches
   are the observed runtime statistics.  At the activation barrier the
   coordinator compares observed build bytes against the broadcast
   threshold and rewrites PARTITIONED<->BROADCAST before the consumer (and
   for B->P flips, a freshly split probe stage) is activated.  Rewrites
   mutate only per-execution fragments; decisions are memoized in a
   bounded, runtime-stat-keyed side cache (never published to the plan
   cache).

3. **Skew-aware repartitioning.**  The probe sink's per-task
   :class:`HeavyHitterSketch` (top-k over the join-key hashes) identifies
   keys above ``skew_factor`` x the mean partition weight; a kept
   partitioned join then splits each heavy key across several probe tasks
   (round-robin scatter) while the build router replicates that key's
   build rows to exactly those tasks.  Restricted to INNER/LEFT joins.

On the card the pages stay device batches: the sink hashes the key
columns on the batch's device and the sketch reads the batch's distinct
hashes and their counts back in one counted host read
(``adaptive.sketch``); the router computes every row's lane on the batch's
device (the static sink's lanes, ``task.partition_rows``, plus the heavy
keys' targets) and reads the lane counts back in one counted host read
(``adaptive.route``) per staging page.  Hashes are uint64 bits held in
int64: every modulus is unsigned (``exec/kernels.unsigned_mod``), and the
sketch keeps its keys as the reference's non-negative Python ints, in
ascending unsigned order, so its counts, its pruning and the skew splits
are the reference's.

Barrier rule: a site resolves when its build staging is complete OR any
deferred edge has buffered >= half its byte budget.  Routing is fixed at
the barrier and streams thereafter, so correctness needs only
consistency between the two routers, not complete statistics.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..exec import kernels as K
from ..exec import syncguard as SG
from ..exec.local_exchange import partition_key_tuple
from ..exec.stats import AdaptiveStats
from ..planner.plan import Join, RemoteSource, plan_text
from ..spi import knobs
from ..spi.batch import ColumnBatch
from ..telemetry import metrics as tm
from ..telemetry import profiler
from ..telemetry import runtime as rt
from .exchange import ExchangeClient, OutputBuffer
from .fragmenter import _walk, split_probe_fragment
from .task import maybe_deserialize

__all__ = ["AdaptiveExec", "HeavyHitterSketch", "adaptive_mode",
           "broadcast_threshold_bytes", "skew_factor"]

_U64 = 1 << 64


# --------------------------------------------------------------------- knobs
def adaptive_mode(session) -> str:
    """``0`` | ``1`` | ``auto``: the session property wins over the env."""
    v = getattr(session, "adaptive", None)
    if v is None:
        v = knobs.get_str("TRINO_TPU_ADAPTIVE")
    v = str(v).strip().lower()
    if v in ("0", "false", "off", "no"):
        return "0"
    if v in ("1", "true", "on", "yes"):
        return "1"
    return "auto"


def broadcast_threshold_bytes(session) -> int:
    """Observed build side at or under this flips to broadcast; over it,
    a static broadcast flips back to partitioned (32 MiB default)."""
    v = int(getattr(session, "broadcast_threshold_bytes", 0) or 0)
    if v > 0:
        return v
    return knobs.get_int("TRINO_TPU_BROADCAST_THRESHOLD_BYTES") or (32 << 20)


def skew_factor(session) -> float:
    """A probe key heavier than this multiple of the mean partition weight
    is split across multiple probe tasks."""
    v = float(getattr(session, "skew_factor", 0.0) or 0.0)
    if v > 0:
        return v
    return knobs.get_float("TRINO_TPU_SKEW_FACTOR") or 2.0


def _as_signed(hv: int) -> int:
    """A uint64 value (Python int) as the int64 bits the port holds."""
    return hv - _U64 if hv >= (1 << 63) else hv


# -------------------------------------------------------------------- sketch
class HeavyHitterSketch:
    """Bounded top-k frequency sketch over uint64 key hashes.

    ``update`` takes one batch's hash lanes: a tensor of uint64 bits held
    in int64 (``exec/kernels.partition_key_hashes``, on the batch's
    device), or a numpy array of uint64.  Keys are inserted in ascending
    unsigned order, as the reference's ``np.unique`` gives them, so the
    pruning's ties (``sorted`` is stable) keep the reference's keys.  The
    dict is pruned to the heaviest entries whenever it outgrows ``4 * k``;
    ``total`` is exact, per-key counts are lower bounds after pruning.  One
    sketch per producer task (single writer); the coordinator folds them
    with ``merge`` at the barrier."""

    __slots__ = ("k", "counts", "total")

    def __init__(self, k: int = 64):
        self.k = k
        self.counts: dict[int, int] = {}
        self.total = 0

    def update(self, h) -> None:
        if len(h) == 0:
            return
        if isinstance(h, torch.Tensor):
            vals, cnts = torch.unique(h, return_counts=True)
            host = SG.fetch(torch.stack([vals, cnts.to(vals.dtype)]),
                            "adaptive.sketch")
            uv = host[0].view(np.uint64)
            order = np.argsort(uv, kind="stable")
            vals_l, cnts_l = uv[order].tolist(), host[1][order].tolist()
        else:
            v, c = np.unique(np.asarray(h, dtype=np.uint64),
                             return_counts=True)
            vals_l, cnts_l = v.tolist(), c.tolist()
        self.total += int(len(h))
        c = self.counts
        for v, n in zip(vals_l, cnts_l):
            c[v] = c.get(v, 0) + n
        if len(c) > 4 * self.k:
            keep = sorted(c.items(), key=lambda kv: -kv[1])[:2 * self.k]
            self.counts = dict(keep)

    def merge(self, other: "HeavyHitterSketch") -> None:
        self.total += other.total
        c = self.counts
        for v, n in other.counts.items():
            c[v] = c.get(v, 0) + n
        if len(c) > 4 * self.k:
            keep = sorted(c.items(), key=lambda kv: -kv[1])[:2 * self.k]
            self.counts = dict(keep)

    def heavy(self, factor: float, num_partitions: int) -> dict[int, int]:
        """hash -> count for keys above ``factor`` x mean partition weight."""
        if self.total == 0 or num_partitions < 2:
            return {}
        mean = self.total / num_partitions
        return {v: n for v, n in self.counts.items() if n > factor * mean}


def _imbalance_ratio(sketch: "HeavyHitterSketch", split: dict,
                     n: int) -> float:
    """Sketch-estimated max partition weight under plain hash routing
    divided by the max under ``split``.  Total probe work is unchanged by
    a split, so this ratio, not the split itself, is what a parallel host
    converts into wall-clock."""
    rest = max(sketch.total - sum(sketch.counts.values()), 0) / n
    before = np.full(n, rest)
    after = np.full(n, rest)
    for hv, cnt in sketch.counts.items():
        p = hv % n
        before[p] += cnt
        if hv in split:
            after[split[hv]] += cnt / len(split[hv])
        else:
            after[p] += cnt
    return float(before.max() / max(after.max(), 1e-9))


# --------------------------------------------------------- decision plumbing
@dataclass
class DecisionEdge:
    """One deferred producer->consumer edge: producer tasks land pages in
    single-partition staging buffers; after the barrier a router thread
    re-routes them into ``routed`` under the decided distribution."""

    producer_fid: int
    consumer_fid: int
    role: str                  # "build" | "probe"
    keys: tuple                # hash keys, producer output coordinates
    staging: list = field(default_factory=list)
    sketches: list = field(default_factory=list)
    routed: Optional[OutputBuffer] = None
    router: Optional[threading.Thread] = None

    def bytes_observed(self) -> int:
        return sum(b.bytes_enqueued for b in self.staging)

    def complete(self) -> bool:
        return bool(self.staging) and all(b.finished for b in self.staging)

    def fold_sketch(self) -> Optional[HeavyHitterSketch]:
        if not self.sketches:
            return None
        out = HeavyHitterSketch(self.sketches[0].k)
        for s in self.sketches:
            out.merge(s)
        return out


@dataclass
class JoinSite:
    """One adaptive decision point: the topmost INNER/LEFT join of a
    multi-task consumer fragment whose build (and probe, when partitioned)
    inputs are plain remote edges."""

    consumer_fid: int
    join: Join
    static: str                # the planner's choice: PARTITIONED|BROADCAST
    n: int                     # consumer task count
    build: DecisionEdge
    probe: Optional[DecisionEdge]
    can_refragment: bool = False
    resolved: bool = False

    def edges(self):
        return (self.build,) if self.probe is None else (self.build,
                                                         self.probe)


_COALESCE_ROWS = 32768


class _Router(threading.Thread):
    """Drains one deferred edge's staging buffers into its routed buffer
    under the decided distribution.  Modes: broadcast, round_robin, hash
    (with an optional heavy-key split map: probe rows scatter round-robin
    across the key's target tasks, build rows replicate to all of them).

    Hash routing computes each row's lane on the page's device in one
    pass: the static sink's lane for ordinary rows (so a kept decision
    reproduces the static routing bit for bit), the scatter target for a
    heavy probe row, or a lane of its own per heavy key for replicated
    build rows.  One stable sort orders the rows by lane (and, inside a
    lane, ordinary rows before each heavy key's rows, the reference's
    emission order), and one counted host read of the lane counts cuts the
    sorted rows into slivers.  Slivers are coalesced per target and
    released in ~``_COALESCE_ROWS``-row pages."""

    def __init__(self, name: str, staging: list, out: OutputBuffer, n: int,
                 mode: str, keys=(), split=None, replicate=False,
                 errors=None, device=None):
        super().__init__(name=name, daemon=True)
        self.staging = staging
        self.out = out
        self.n = n
        self.mode = mode
        self.keys = list(keys)
        self.split = dict(split or {})       # hash -> np.ndarray of targets
        self.replicate = replicate
        self.errors = errors
        self.device = device
        self._rr = 0
        self._offsets: dict[int, int] = {}   # per-heavy-key scatter cursor
        self._heavy = list(self.split)       # split order = emission order
        self._pend: dict[int, list] = {}     # target -> [rows, [slivers]]
        self._dev: dict = {}                 # device -> (heavy bits, targets)

    def run(self):
        try:
            client = ExchangeClient(self.staging, 0)
            while not client.is_finished():
                page = client.poll(timeout=0.05)
                if page is None:
                    continue
                self._route(maybe_deserialize(page, self.device))
            for p in list(self._pend):
                self._flush(p)
            self.out.set_finished()
        except BaseException as e:  # noqa: BLE001 — surfaced to coordinator
            if self.errors is not None:
                self.errors.append(e)
            self.out.abort()
            for b in self.staging:
                b.abort()

    def _emit(self, p: int, batch) -> None:
        ent = self._pend.get(p)
        if ent is None:
            ent = self._pend[p] = [0, []]
        ent[0] += batch.num_rows
        ent[1].append(batch)
        if ent[0] >= _COALESCE_ROWS:
            self._flush(p)

    def _flush(self, p: int) -> None:
        ent = self._pend.pop(p, None)
        if ent is not None and ent[1]:
            self.out.enqueue(p, ColumnBatch.concat(ent[1]))

    def _heavy_on(self, device):
        got = self._dev.get(device)
        if got is None:
            bits = torch.tensor([_as_signed(hv) for hv in self._heavy],
                                dtype=torch.int64, device=device)
            targets = [torch.as_tensor(np.asarray(self.split[hv]),
                                       dtype=torch.int64, device=device)
                       for hv in self._heavy]
            got = self._dev[device] = (bits, targets)
        return got

    def _route(self, batch) -> None:
        n = self.n
        if batch.num_rows == 0:
            return
        if self.mode == "broadcast":
            for p in range(n):
                self.out.enqueue(p, batch)
            return
        if self.mode == "round_robin":
            self.out.enqueue(self._rr % n, batch)
            self._rr += 1
            return
        batch = batch.compact()
        h = K.partition_key_hashes(
            [partition_key_tuple(batch.columns[k]) for k in self.keys])
        lane = K.unsigned_mod(h, n)
        group = torch.zeros_like(lane)
        nk = len(self._heavy)
        hit_counts = []
        if nk:
            bits, targets = self._heavy_on(h.device)
            for k in range(nk):
                m = h == bits[k]
                hit_counts.append(m.sum())
                if self.replicate:
                    # lane n is unused; heavy key k owns lane n + 1 + k
                    lane = torch.where(m, n + 1 + k, lane)
                else:
                    d = len(targets[k])
                    rank = torch.cumsum(m.to(torch.int64), 0) - 1
                    slot = torch.remainder(
                        rank + self._offsets.get(self._heavy[k], 0), d)
                    lane = torch.where(m, targets[k][slot.clamp(min=0)],
                                       lane)
                    group = torch.where(m, k + 1, group)
        lanes = n + 1 + (nk if self.replicate else 0)
        order = torch.argsort(lane * (nk + 1) + group, stable=True)
        counts = torch.bincount(lane, minlength=lanes)
        host = SG.fetch(torch.cat([counts] + [c.reshape(1)
                                              for c in hit_counts]),
                        "adaptive.route")
        counts_h = [int(c) for c in host[:lanes]]
        for k, c in enumerate(host[lanes:]):
            if not self.replicate and int(c):
                hv = self._heavy[k]
                self._offsets[hv] = self._offsets.get(hv, 0) + int(c)
        start = 0
        for p, c in enumerate(counts_h):
            if not c:
                continue
            idx = order[start:start + c]
            start += c
            sub = ColumnBatch(batch.names,
                              [col.take(idx) for col in batch.columns])
            if p < n:
                self._emit(p, sub)
            elif p > n:
                for t in self.split[self._heavy[p - n - 1]]:
                    self._emit(int(t), sub)


# -------------------------------------------------- runtime-stat-keyed memo
# Decision memo: (plan shape, log2-bucketed runtime stats, knobs) -> kind.
# Deliberately separate from the plan cache: rewritten plans are
# per-execution and must never be published there.  Bounded LRU.
_MEMO: OrderedDict = OrderedDict()
_MEMO_CAP = 256
_MEMO_LOCK = threading.Lock()


def _memo_get(key):
    with _MEMO_LOCK:
        kind = _MEMO.get(key)
        if kind is not None:
            _MEMO.move_to_end(key)
        return kind


def _memo_put(key, kind) -> None:
    with _MEMO_LOCK:
        _MEMO[key] = kind
        _MEMO.move_to_end(key)
        while len(_MEMO) > _MEMO_CAP:
            _MEMO.popitem(last=False)


def reset_memo_for_test() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


# ----------------------------------------------------------------- the plane
class AdaptiveExec:
    """Per-query adaptive controller, driven by the coordinator's polled
    join loop: ``start`` activates every group not gated by a decision,
    ``advance`` resolves barriers and cascades newly unblocked groups.
    ``stage_factory(fragment, task_count, buffers)`` makes the stage of a
    split probe fragment (the runner's ``_Stage``); routed pages land on
    ``device``."""

    def __init__(self, stages: dict, fragments: list, edges: dict,
                 sink_cap: int, session, errors: list,
                 stage_factory: Callable, device=None):
        self.stages = stages
        self.sink_cap = sink_cap
        self.session = session
        self.errors = errors
        self.stage_factory = stage_factory
        self.device = device
        self.stats = AdaptiveStats()
        self.threshold = broadcast_threshold_bytes(session)
        self.skew = skew_factor(session)
        self.sites: list[JoinSite] = []
        # the last skew split (hash -> target tasks) and its imbalance
        # ratio, for observability
        self.last_split: dict = {}
        self.last_imbalance: Optional[float] = None
        self._aborted = False
        self._next_fid = max(stages) + 1 if stages else 0
        self._order = [f.id for f in fragments]
        self._plan_sites(fragments, edges)
        self._edge_by_producer = {
            e.producer_fid: e for s in self.sites for e in s.edges()}
        self._wire_staging()
        self._build_groups(fragments, edges)
        self._unspawned = set(self._order)

    # ------------------------------------------------------------- planning
    def _plan_sites(self, fragments, edges) -> None:
        def plain(fid: int, kind: str) -> bool:
            st = self.stages.get(fid)
            return (st is not None and fid not in edges
                    and st.fragment.output_kind == kind)

        for f in fragments:
            st = self.stages[f.id]
            if st.task_count < 2:
                continue
            join = next((x for x in _walk(f.root) if isinstance(x, Join)),
                        None)
            if join is None or join.join_type not in ("INNER", "LEFT"):
                continue
            br = join.right
            if not isinstance(br, RemoteSource):
                continue
            if join.distribution == "PARTITIONED":
                if br.kind != "REPARTITION" or not plain(br.fragment_id,
                                                         "REPARTITION"):
                    continue
                bl = join.left
                if (not isinstance(bl, RemoteSource)
                        or bl.kind != "REPARTITION"
                        or not plain(bl.fragment_id, "REPARTITION")):
                    continue
                build = DecisionEdge(
                    br.fragment_id, f.id, "build",
                    tuple(self.stages[br.fragment_id].fragment.output_keys))
                probe = DecisionEdge(
                    bl.fragment_id, f.id, "probe",
                    tuple(self.stages[bl.fragment_id].fragment.output_keys))
                self.sites.append(JoinSite(
                    f.id, join, "PARTITIONED", st.task_count, build, probe))
            elif join.distribution == "BROADCAST":
                if br.kind != "BROADCAST" or not plain(br.fragment_id,
                                                       "BROADCAST"):
                    continue
                if not join.left_keys:
                    continue
                # re-fragmenting cuts join.left into a new stage: every
                # remote edge inside it must be a plain buffer edge (no
                # collective / fused rendezvous, no order-sensitive MERGE),
                # and the consumer itself must not be a compiled or
                # collective producer (a fused seam plans a snapshot of its
                # feed, so a runtime root rewrite would be invisible to it)
                ok = f.id not in edges
                for rs in _walk(join.left):
                    if not isinstance(rs, RemoteSource):
                        continue
                    p = self.stages.get(rs.fragment_id)
                    if (p is None or rs.fragment_id in edges
                            or p.fragment.output_kind == "MERGE"):
                        ok = False
                        break
                if not ok:
                    continue
                build = DecisionEdge(br.fragment_id, f.id, "build",
                                     tuple(join.right_keys))
                self.sites.append(JoinSite(
                    f.id, join, "BROADCAST", st.task_count, build, None,
                    can_refragment=True))

    def _wire_staging(self) -> None:
        """Swap each deferred producer's stage buffers for single-partition
        staging buffers: its tasks, abort paths and backpressure all keep
        working through the normal ``stage.buffers`` plumbing."""
        for site in self.sites:
            for e in site.edges():
                pstage = self.stages[e.producer_fid]
                e.staging = [OutputBuffer(1, max_bytes=self.sink_cap)
                             for _ in range(pstage.task_count)]
                pstage.buffers = e.staging
                e.routed = OutputBuffer(site.n, max_bytes=self.sink_cap)
                if e.role == "probe":
                    e.sketches = [HeavyHitterSketch()
                                  for _ in range(pstage.task_count)]

    def _build_groups(self, fragments, edges) -> None:
        parent = {f.id: f.id for f in fragments}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        consumer_of = {}
        for f in fragments:
            for src in f.source_fragments:
                consumer_of[src] = f.id
        # collective / compiled edges rendezvous producer and consumer
        # tasks: both sides must activate together
        for src in edges:
            if src in consumer_of and src in parent:
                parent[find(src)] = find(consumer_of[src])
        self._group_of = {fid: find(fid) for fid in parent}
        members = defaultdict(list)
        for fid in self._order:
            members[self._group_of[fid]].append(fid)
        self._group_members = dict(members)
        self._group_deps = {
            g: {self._group_of[src]
                for fid in m
                for src in self.stages[fid].fragment.source_fragments
                if self._group_of.get(src, g) != g}
            for g, m in self._group_members.items()}
        self._sites_of_group = defaultdict(list)
        for s in self.sites:
            self._sites_of_group[self._group_of[s.consumer_fid]].append(s)
        self._activated: set = set()

    # ----------------------------------------------------------- accessors
    def routed_buffer(self, src: int) -> Optional[OutputBuffer]:
        """The consumer-facing buffer of a deferred edge (None otherwise)."""
        e = self._edge_by_producer.get(src)
        return e.routed if e is not None else None

    def sink_override(self, fid: int, task_index: int):
        """(sketch, sketch_keys) for a deferred producer's sink (its kind
        is forced to GATHER into staging); None for ordinary fragments."""
        e = self._edge_by_producer.get(fid)
        if e is None:
            return None
        if e.sketches:
            return e.sketches[task_index], tuple(e.keys)
        return None, ()

    def is_deferred_producer(self, fid: int) -> bool:
        return fid in self._edge_by_producer

    def observed_stats(self) -> dict:
        """Per deferred-producer fragment: exact rows / bytes observed at
        the activation barrier (staging is single-partition, so the
        counters are not inflated by broadcast fan-out) plus the folded
        sketch's heavy-hitter share: the feed of history-based
        optimization."""
        out: dict[int, dict] = {}
        for fid, e in self._edge_by_producer.items():
            entry = {
                "rows": sum(b.rows_enqueued for b in e.staging),
                "bytes": e.bytes_observed(),
            }
            sk = e.fold_sketch()
            if sk is not None and sk.total:
                entry["skew"] = max(sk.counts.values(), default=0) / sk.total
            out[fid] = entry
        return out

    def done(self) -> bool:
        return self._aborted or (
            all(s.resolved for s in self.sites)
            and len(self._activated) == len(self._group_members))

    def unactivated(self) -> list[str]:
        if self._aborted:
            return []
        return [f"stage-{fid}" for fid in sorted(self._unspawned)]

    def abort(self) -> None:
        self._aborted = True
        for site in self.sites:
            for e in site.edges():
                for b in e.staging:
                    b.abort()
                if e.routed is not None:
                    e.routed.abort()

    # ----------------------------------------------------------- scheduling
    def start(self, spawn: Callable[[int], list]) -> list:
        return self._cascade(spawn)

    def advance(self, spawn: Callable[[int], list]) -> list:
        if self._aborted:
            return []
        out = []
        for site in self.sites:
            if site.resolved:
                continue
            # every deferred edge drained to completion (full statistics)
            # OR any edge nearing its staging budget (partial statistics
            # beat a parked producer; routing is fixed here either way)
            if (all(e.complete() for e in site.edges())
                    or any(self._early(e) for e in site.edges())):
                out.extend(self._decide(site, spawn))
                site.resolved = True
        out.extend(self._cascade(spawn))
        return out

    def _early(self, e: DecisionEdge) -> bool:
        # resolve before any producer parks on a full staging buffer; the
        # routers started at the barrier keep draining from then on
        return any(b.bytes_enqueued >= self.sink_cap // 2
                   for b in e.staging)

    def _cascade(self, spawn) -> list:
        out = []
        progress = True
        while progress and not self._aborted:
            progress = False
            for g, members in self._group_members.items():
                if g in self._activated:
                    continue
                if any(d not in self._activated
                       for d in self._group_deps[g]):
                    continue
                if any(not s.resolved for s in self._sites_of_group.get(
                        g, ())):
                    continue
                self._activated.add(g)
                progress = True
                for fid in members:
                    out.extend(spawn(fid))
                    self._unspawned.discard(fid)
                    self.stats.activations += 1
        return out

    # ------------------------------------------------------------ decisions
    def _decide(self, site: JoinSite, spawn) -> list:
        from ..planner.add_exchanges import rewrite_join_distribution

        b_bytes = site.build.bytes_observed()
        b_complete = site.build.complete()
        sketch = site.probe.fold_sketch() if site.probe is not None else None
        p_rows = sketch.total if sketch is not None else 0
        key = (hashlib.sha1(plan_text(
                   self.stages[site.consumer_fid].fragment.root
               ).encode()).hexdigest()[:12],
               site.static, int(b_bytes).bit_length(),
               int(p_rows).bit_length(), self.threshold,
               round(self.skew, 3), site.n)
        kind = _memo_get(key)
        if kind is not None and self._valid(site, kind, b_complete):
            self.stats.memo_hits += 1
            tm.ADAPTIVE_MEMO_HITS.inc()
        else:
            if site.static == "PARTITIONED":
                kind = ("flip_to_broadcast"
                        if b_complete and b_bytes <= self.threshold
                        else "keep")
            else:
                kind = ("flip_to_partitioned"
                        if b_bytes > self.threshold and site.can_refragment
                        else "keep")
            _memo_put(key, kind)

        out: list = []
        consumer = self.stages[site.consumer_fid].fragment
        tag = f"{kind}[f{site.consumer_fid}]"
        if site.static == "PARTITIONED":
            if kind == "flip_to_broadcast":
                consumer.root = rewrite_join_distribution(
                    consumer.root, site.join, "BROADCAST")
                self._start_router(site.build, site, "broadcast")
                self._start_router(site.probe, site, "round_robin")
                self.stats.broadcast_flips += 1
                tm.ADAPTIVE_BROADCAST_FLIPS.inc()
            else:
                # split map computed fresh from this run's sketch (never
                # memoized: targets depend on live counts)
                split = self._split_map(sketch, site.n)
                self._start_router(site.build, site, "hash",
                                   keys=site.build.keys, split=split,
                                   replicate=True)
                self._start_router(site.probe, site, "hash",
                                   keys=site.probe.keys, split=split,
                                   replicate=False)
                if split:
                    kind = "skew_split"
                    tag = f"skew_split[f{site.consumer_fid}:{len(split)}k]"
                    self.stats.skew_splits += 1
                    tm.ADAPTIVE_SKEW_SPLITS.inc()
                    self.last_split = split
                    self.last_imbalance = _imbalance_ratio(sketch, split,
                                                           site.n)
                    tm.ADAPTIVE_SKEW_IMBALANCE.set(self.last_imbalance)
        else:
            if kind == "flip_to_partitioned":
                new_fid = self._next_fid
                self._next_fid += 1
                new_frag = split_probe_fragment(consumer, site.join, new_fid)
                new_frag.sink_coalesce_rows = _COALESCE_ROWS
                self.stages[new_fid] = self.stage_factory(new_frag, site.n, [
                    OutputBuffer(site.n, max_bytes=self.sink_cap)
                    for _ in range(site.n)])
                self._start_router(site.build, site, "hash",
                                   keys=site.build.keys)
                out.extend(spawn(new_fid))
                self.stats.partition_flips += 1
                tm.ADAPTIVE_PARTITION_FLIPS.inc()
            else:
                self._start_router(site.build, site, "broadcast")
        for e in site.edges():
            if e.router is not None:
                out.append(e.router)

        self.stats.decision_points += 1
        self.stats.decisions.append(tag)
        tm.ADAPTIVE_DECISIONS.inc()
        if profiler.enabled():
            profiler.instant(
                profiler.ADAPTIVE, f"adaptive.{kind}",
                fragment=site.consumer_fid, static=site.static,
                build_bytes=b_bytes, build_complete=b_complete,
                probe_rows=p_rows, threshold=self.threshold)
        rt.add_adaptive(rt.current_record(), tag)
        return out

    @staticmethod
    def _valid(site: JoinSite, kind: str, b_complete: bool) -> bool:
        """Memoized kinds apply only when their preconditions still hold."""
        if kind == "flip_to_broadcast":
            return b_complete and site.probe is not None
        if kind == "flip_to_partitioned":
            return site.can_refragment
        return True

    def _split_map(self, sketch: Optional[HeavyHitterSketch],
                   n: int) -> dict:
        if sketch is None or sketch.total == 0:
            return {}
        mean = sketch.total / n
        split = {}
        for hv, cnt in sketch.heavy(self.skew, n).items():
            d = min(n, max(2, int(np.ceil(cnt / mean))))
            base = hv % n
            split[hv] = np.array([(base + i) % n for i in range(d)],
                                 dtype=np.int32)
        return split

    def _start_router(self, e: Optional[DecisionEdge], site: JoinSite,
                      mode: str, keys=(), split=None,
                      replicate=False) -> None:
        if e is None:
            return
        e.router = _Router(
            f"adaptive-route-f{e.producer_fid}", e.staging, e.routed,
            site.n, mode, keys=keys, split=split, replicate=replicate,
            errors=self.errors, device=self.device)
        e.router.start()
