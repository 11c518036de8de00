"""PlanFragmenter: cut the distributed plan at REMOTE exchanges.

The port of the reference ``execution/fragmenter.py``, which mirrors
sql/planner/PlanFragmenter.java:94 (``createSubPlans:124``): every
``Exchange(scope=REMOTE)`` boundary becomes a fragment edge; the consumer
side sees a ``RemoteSource`` leaf naming the producer fragment.  Fragment
partitioning (how many tasks execute it) follows SystemPartitioningHandle:
SOURCE (split-driven leaf), HASH (repartition consumer), SINGLE (gather
consumer / coordinator stage).

:func:`mark_device_residency` records the reference's ``FusedSeam`` and
``ResidentPlan`` marks on the fragments, so the fragment text is the
reference's; the distributed runner compiles them
(execution/stage_compiler.py, execution/plan_compiler.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from ..planner.plan import (
    Aggregate,
    Exchange,
    Filter,
    Join,
    MatchRecognize,
    PlanNode,
    Project,
    RemoteSource,
    TableFunctionScan,
    TableScan,
    TableWriter,
    Union,
    plan_text,
)
from ..sql.ir import InputRef, referenced_inputs

__all__ = ["PlanFragment", "SubPlan", "FusedSeam", "ResidentEdge",
           "ResidentJoin", "ResidentPlan", "fragment_plan",
           "mark_device_residency", "split_probe_fragment"]

# Aggregate functions whose PARTIAL state merges with plain
# sum/min/max combines inside one jitted program (avg rides as its
# sum+count expansion from add_exchanges.partial_agg_layout).  distinct
# and STAT_AGGS never reach a PARTIAL/FINAL split with these fns.
_FUSABLE_AGGS = frozenset({"count", "sum", "min", "max", "avg"})

# Plan nodes whose operators keep batches host-side (Python row loops or
# connector writes); any fragment containing one is not device-resident.
_HOST_NODES = (MatchRecognize, TableFunctionScan, TableWriter)


@dataclass(frozen=True)
class FusedSeam:
    """A REPARTITION edge eligible for whole-stage compilation: the
    producer's PARTIAL aggregation, the all_to_all shuffle and the
    consumer's FINAL aggregation compile into ONE jitted program
    (execution/stage_compiler.py).  ``in_spec``/``out_spec`` record the
    seam PartitionSpec contract: both sides shard dim 0 over the mesh
    axis, so the fused program needs no resharding at the boundary."""

    producer_fid: int
    consumer_fid: int
    nk: int                    # number of group-key columns
    axis: str = "x"            # mesh axis name (matches collective_exchange)
    in_spec: tuple = ("x",)    # producer deposit sharding, dim 0
    out_spec: tuple = ("x",)   # consumer take sharding, dim 0


@dataclass(frozen=True)
class ResidentEdge:
    """One interior exchange edge of a ResidentPlan with its PartitionSpec
    contract.  BROADCAST edges gather build tables replicated (out_spec
    ``()``); the terminal REPARTITION seam keeps dim 0 sharded on both
    sides (``("x",) -> ("x",)``) so the compiled program inserts exactly
    one in-program ``all_to_all`` and no resharding."""

    producer_fid: int
    consumer_fid: int
    kind: str                  # BROADCAST | REPARTITION
    axis: str = "x"
    in_spec: tuple = ("x",)
    out_spec: tuple = ("x",)


@dataclass(frozen=True)
class ResidentJoin:
    """One broadcast hash join inlined into a resident-plan program.
    ``probe_key`` indexes the probe-side schema at this join's depth
    (feed columns ++ payloads of already-applied joins, bottom-up);
    ``build_key`` indexes the build fragment's output schema."""

    build_fid: int
    join_type: str             # INNER | LEFT
    probe_key: int
    build_key: int
    n_build_cols: int


@dataclass(frozen=True)
class ResidentPlan:
    """A maximal connected subtree of device-resident fragments — a
    multi-join broadcast tree feeding one PARTIAL->FINAL agg seam —
    compiled by execution/plan_compiler.py as ONE jitted program over a
    named mesh.  ``core_fid`` is the probe/agg fragment carrying the
    terminal FusedSeam; ``joins`` are bottom-up along the probe spine."""

    core_fid: int
    consumer_fid: int
    nk: int
    joins: tuple[ResidentJoin, ...]
    edges: tuple[ResidentEdge, ...]
    fragment_ids: tuple[int, ...]


@dataclass
class PlanFragment:
    id: int
    root: PlanNode
    partitioning: str          # SOURCE | HASH | SINGLE
    output_kind: str           # GATHER | REPARTITION | BROADCAST | OUTPUT
    output_keys: tuple[int, ...]
    source_fragments: list[int]
    device_resident: bool = False   # every operator keeps batches on device
    fused_seam: Optional[FusedSeam] = None  # set when this fragment's
    #                                 REPARTITION edge is whole-stage fusable
    resident_plan: Optional[ResidentPlan] = None  # set on the core fragment
    #                                 of a coalesced whole-plan program
    sink_coalesce_rows: int = 0     # >0: the output sink buffers each
    #                                 partition's slivers into pages of
    #                                 about this many rows (adaptive
    #                                 re-fragmented stages set this; one
    #                                 join-probe dispatch per sliver is
    #                                 what it avoids)


@dataclass
class SubPlan:
    fragment: PlanFragment
    children: list["SubPlan"]

    def all_fragments(self) -> list[PlanFragment]:
        out = []
        for c in self.children:
            out.extend(c.all_fragments())
        out.append(self.fragment)
        return out

    def text(self) -> str:
        lines = []
        for f in self.all_fragments():
            lines.append(
                f"Fragment {f.id} [{f.partitioning} -> {f.output_kind}"
                + (f" keys={list(f.output_keys)}" if f.output_keys else "")
                + f" sources={f.source_fragments}"
                + (" device-resident" if f.device_resident else "")
                + (f" fused-seam->f{f.fused_seam.consumer_fid}"
                   if f.fused_seam is not None else "")
                + (f" resident-plan[{len(rp.fragment_ids)}f/"
                   f"{len(rp.edges)}e]"
                   if (rp := getattr(f, "resident_plan", None)) is not None
                   else "")
                + "]")
            lines.append(plan_text(f.root, 1))
        return "\n".join(lines)


class _Fragmenter:
    def __init__(self):
        self.next_id = 0
        self.subplans: dict[int, SubPlan] = {}

    def fragment(self, node: PlanNode, output_kind: str,
                 output_keys: tuple[int, ...]) -> SubPlan:
        fid = self.next_id
        self.next_id += 1
        sources: list[int] = []
        children: list[SubPlan] = []
        root = self._rewrite(node, sources, children)
        partitioning = self._partitioning(root)
        frag = PlanFragment(fid, root, partitioning, output_kind,
                            output_keys, sources)
        sp = SubPlan(frag, children)
        self.subplans[fid] = sp
        return sp

    def _rewrite(self, node: PlanNode, sources: list[int],
                 children: list[SubPlan]) -> PlanNode:
        if isinstance(node, Exchange) and node.scope == "REMOTE":
            child = self.fragment(node.source, node.kind, node.partition_keys)
            sources.append(child.fragment.id)
            children.append(child)
            return RemoteSource(node.output_names, node.output_types,
                               child.fragment.id, node.kind, node.sort_keys)
        kids = node.children
        if not kids:
            return node
        new_kids = [self._rewrite(c, sources, children) for c in kids]
        if all(a is b for a, b in zip(kids, new_kids)):
            return node
        if isinstance(node, Union):
            return replace(node, sources=tuple(new_kids))
        if len(kids) == 1:
            return replace(node, source=new_kids[0])
        return replace(node, left=new_kids[0], right=new_kids[1]) \
            if hasattr(node, "left") else \
            replace(node, source=new_kids[0], filter_source=new_kids[1])

    @staticmethod
    def _partitioning(root: PlanNode) -> str:
        has_scan = False
        kinds = []

        def walk(n: PlanNode):
            nonlocal has_scan
            if isinstance(n, TableScan):
                has_scan = True
            if isinstance(n, RemoteSource):
                kinds.append(n.kind)
            for c in n.children:
                walk(c)

        walk(root)
        if has_scan:
            return "SOURCE"
        if "REPARTITION" in kinds:
            return "HASH"
        if "ROUND_ROBIN" in kinds:
            return "ARBITRARY"  # FIXED_ARBITRARY_DISTRIBUTION: multi-task
        return "SINGLE"


def _walk(node: PlanNode):
    yield node
    for c in node.children:
        yield from _walk(c)


def _dict_free(expr, in_types) -> bool:
    """True when ``expr`` reads no dictionary-encoded channel (the fused
    accumulate program evaluates expressions on raw lanes; dictionary
    columns may only pass through as bare InputRefs)."""
    return not any(in_types[i].is_dictionary_encoded
                   for i in referenced_inputs(expr))


def _match_fused_seam(producer: PlanFragment,
                      consumer: PlanFragment) -> Optional[FusedSeam]:
    """Structural eligibility of one REPARTITION edge for whole-stage
    compilation: producer root is ``Aggregate(PARTIAL)`` over a
    Filter/Project chain, consumer FINAL-aggregates exactly this edge,
    aggregate states merge with plain sum/min/max combines, and every
    fused expression reads only non-dictionary channels."""
    root = producer.root
    if producer.output_kind != "REPARTITION":
        return None
    if not isinstance(root, Aggregate) or root.step != "PARTIAL":
        return None
    nk = len(root.group_keys)
    if nk == 0 or producer.output_keys != tuple(range(nk)):
        return None
    if any(a.distinct or a.fn not in _FUSABLE_AGGS for a in root.aggregates):
        return None
    src_types = root.source.output_types
    for a in root.aggregates:
        # agg args must be plain numeric lanes (covers long decimals:
        # precision > 18 is dictionary/limb-encoded)
        if a.arg >= 0 and src_types[a.arg].is_dictionary_encoded:
            return None
    node = root.source
    while isinstance(node, (Filter, Project)):
        in_types = node.source.output_types
        if isinstance(node, Filter):
            if not _dict_free(node.predicate, in_types):
                return None
        else:
            for e in node.expressions:
                if not isinstance(e, InputRef) and not _dict_free(e, in_types):
                    return None
        node = node.source
    # the consumer must FINAL-aggregate this edge, and reference it only there
    finals = [n for n in _walk(consumer.root)
              if isinstance(n, Aggregate) and n.step == "FINAL"
              and isinstance(n.source, RemoteSource)
              and n.source.fragment_id == producer.id]
    remotes = [n for n in _walk(consumer.root)
               if isinstance(n, RemoteSource)
               and n.fragment_id == producer.id]
    if len(finals) != 1 or len(remotes) != 1:
        return None
    fin = finals[0]
    if (fin.group_keys != tuple(range(nk))
            or len(fin.aggregates) != len(root.aggregates)):
        return None
    if any(fa.fn != pa.fn for fa, pa in zip(fin.aggregates, root.aggregates)):
        return None
    return FusedSeam(producer.id, consumer.id, nk)


def _resident_key_ok(t) -> bool:
    """Join keys the in-program sorted-probe handles: plain integer lanes.
    Dictionary codes on the PROBE side drift per batch (remapped host-side
    before the launch); value-space decimals/doubles never reach broadcast
    join keys in TPC-H shapes we inline."""
    from ..spi.types import DecimalType
    if t.is_dictionary_encoded or isinstance(t, DecimalType):
        return False
    return np.dtype(t.storage_dtype).kind in "iu"


def _match_resident_plan(producer: PlanFragment,
                         frags: dict[int, PlanFragment],
                         rs_counts: dict[int, int],
                         ) -> Optional[ResidentPlan]:
    """Coalesce a maximal broadcast-join tree under an already-matched
    FusedSeam into one ResidentPlan: the producer's probe spine must be
    single-key BROADCAST INNER/LEFT joins whose build sides are
    device-resident single-consumer SOURCE fragments, bottoming out in a
    pure scan chain.  Every interior edge gets a PartitionSpec contract;
    plan_compiler.py lowers the whole record to a single jitted program."""
    seam = producer.fused_seam
    if seam is None or rs_counts.get(producer.id, 0) != 1:
        return None
    node = producer.root.source            # Aggregate(PARTIAL).source
    while isinstance(node, (Filter, Project)):
        node = node.source
    joins: list[ResidentJoin] = []
    build_fids: list[int] = []
    while isinstance(node, Join):
        if (node.distribution != "BROADCAST"
                or node.join_type not in ("INNER", "LEFT")
                or node.residual is not None
                or len(node.left_keys) != 1 or len(node.right_keys) != 1):
            return None
        rs = node.right
        if not isinstance(rs, RemoteSource) or rs.kind != "BROADCAST":
            return None
        b = frags.get(rs.fragment_id)
        if (b is None or not b.device_resident
                or b.output_kind != "BROADCAST"
                or b.partitioning != "SOURCE"
                or b.source_fragments
                or rs_counts.get(b.id, 0) != 1):
            return None
        pk_t = node.left.output_types[node.left_keys[0]]
        bk_t = rs.output_types[node.right_keys[0]]
        if not (_resident_key_ok(pk_t) and _resident_key_ok(bk_t)):
            return None
        joins.append(ResidentJoin(b.id, node.join_type, node.left_keys[0],
                                  node.right_keys[0], len(rs.output_types)))
        build_fids.append(b.id)
        node = node.left
    if not joins:
        return None
    if any(isinstance(n, RemoteSource) for n in _walk(node)):
        return None                        # feed must be a pure scan chain
    if set(producer.source_fragments) != set(build_fids):
        return None
    joins.reverse()                        # bottom-up along the probe spine
    edges = tuple(
        ResidentEdge(fid, producer.id, "BROADCAST", out_spec=())
        for fid in build_fids
    ) + (ResidentEdge(producer.id, seam.consumer_fid, "REPARTITION"),)
    return ResidentPlan(
        core_fid=producer.id, consumer_fid=seam.consumer_fid, nk=seam.nk,
        joins=tuple(joins), edges=edges,
        fragment_ids=tuple(sorted({producer.id, seam.consumer_fid,
                                   *build_fids})))


def mark_device_residency(subplan: SubPlan) -> SubPlan:
    """Bottom-up TPU-residency propagation + fused-seam recording.

    A fragment is device-resident when none of its own nodes run host-side
    loops and all of its source fragments are device-resident; on every
    device-resident REPARTITION producer whose consumer FINAL-aggregates
    it, record the FusedSeam that stage_compiler.py compiles into one
    jitted program."""
    frags = {f.id: f for f in subplan.all_fragments()}
    for f in subplan.all_fragments():  # children first
        own = not any(isinstance(n, _HOST_NODES) for n in _walk(f.root))
        f.device_resident = own and all(
            frags[s].device_resident for s in f.source_fragments)
    for consumer in frags.values():
        for src in consumer.source_fragments:
            producer = frags[src]
            if not producer.device_resident:
                continue
            seam = _match_fused_seam(producer, consumer)
            if seam is not None:
                producer.fused_seam = seam
    # RemoteSource reference counts gate whole-plan coalescing: a build
    # or core fragment consumed from more than one site can't fold into
    # one program without duplicating work.
    rs_counts: dict[int, int] = {}
    for f in frags.values():
        for n in _walk(f.root):
            if isinstance(n, RemoteSource):
                rs_counts[n.fragment_id] = rs_counts.get(n.fragment_id, 0) + 1
    for f in frags.values():
        if f.fused_seam is not None:
            f.resident_plan = _match_resident_plan(f, frags, rs_counts)
    return subplan


def split_probe_fragment(consumer: PlanFragment, join,
                         new_fid: int) -> PlanFragment:
    """Runtime broadcast->partitioned re-fragmentation (adaptive plane):
    cut ``join.left`` (the probe subtree) out of the not-yet-activated
    ``consumer`` fragment into a new REPARTITION fragment hashing on the
    join's probe keys, and re-enter it as a RemoteSource.  RemoteSources
    inside the subtree move with it: their producer fragments now feed the
    new fragment.  ``consumer`` is mutated in place (runtime fragments are
    per-execution copies, never plan-cache residents)."""
    from ..planner.add_exchanges import rewrite_join_distribution

    subtree = join.left
    moved = [n.fragment_id for n in _walk(subtree)
             if isinstance(n, RemoteSource)]
    new_frag = PlanFragment(
        new_fid, subtree, _Fragmenter._partitioning(subtree),
        "REPARTITION", tuple(join.left_keys), moved)
    rs = RemoteSource(subtree.output_names, subtree.output_types,
                      new_fid, "REPARTITION", ())
    consumer.root = rewrite_join_distribution(
        consumer.root, join, "PARTITIONED", new_left=rs)
    consumer.source_fragments = [
        s for s in consumer.source_fragments if s not in moved] + [new_fid]
    consumer.partitioning = _Fragmenter._partitioning(consumer.root)
    return new_frag


def fragment_plan(root: PlanNode) -> SubPlan:
    """Root fragment is the coordinator (OUTPUT) stage."""
    return mark_device_residency(_Fragmenter().fragment(root, "OUTPUT", ()))
