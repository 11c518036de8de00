"""AddExchanges: place REMOTE exchange boundaries + split aggregations.

The port of the reference ``planner/add_exchanges.py``, the
distribution-planning pass (reference: sql/planner/optimizations/
AddExchanges.java:138, chooses SystemPartitioningHandle.java:48-57
partitionings).  Transforms a single-node plan into a distributed one:

- ``Aggregate(SINGLE)`` → ``Aggregate(FINAL) ∘ Exchange(REPARTITION keys)
  ∘ Aggregate(PARTIAL)`` — the classic two-phase aggregation.  The PARTIAL
  step emits mergeable state columns (``avg`` expands to sum+count, scale
  folded in so states are scale-free); distinct aggregates cannot pre-
  aggregate, so they repartition raw rows and aggregate SINGLE after.
- global ``Aggregate`` (no keys) → FINAL after ``Exchange(GATHER)``.
- ``Join(BROADCAST)`` → build side wrapped in ``Exchange(BROADCAST)``
  (BroadcastOutputBuffer path); ``Join(PARTITIONED)`` → both sides hash-
  repartitioned on the join keys (FIXED_HASH_DISTRIBUTION).
- ``Sort`` → per-task sort + order-preserving ``MERGE`` gather (no
  coordinator re-sort; MergeOperator.java:46); ``TopN`` → partial TopN +
  ``MERGE`` + final ``Limit``; ``Limit/DistinctLimit`` → partial on
  workers, final above a ``GATHER``.
- ``Output``/``TableWriter`` root runs single (coordinator gather).

Leaf fragments stay SOURCE-partitioned (split-driven).
"""

from __future__ import annotations

from typing import Optional

from ..spi.types import BIGINT, DOUBLE, DecimalType, Type
from .plan import (
    Aggregate,
    AggCall,
    DistinctLimit,
    Exchange,
    Filter,
    GroupId,
    Join,
    Limit,
    MatchRecognize,
    Output,
    PlanNode,
    Project,
    Replicate,
    SemiJoin,
    Sort,
    TableFunctionScan,
    TableScan,
    TableWriter,
    TopN,
    Union,
    Unnest,
    Values,
    Window,
)

__all__ = ["add_exchanges", "partial_agg_layout",
           "rewrite_join_distribution"]


def partial_agg_layout(aggs, input_types=None) -> list[tuple[str, Type, int]]:
    """Per original AggCall: list of (state_fn, state_type, width) describing
    the PARTIAL output columns.  avg → [(sum,f64),(count,i64)] with the
    decimal scale folded into the sum state."""
    from ..sql.analyzer import STAT_AGGS

    out = []
    for a in aggs:
        if a.fn == "avg":
            out.append([("avg_sum", DOUBLE), ("avg_count", BIGINT)])
        elif a.fn in STAT_AGGS:
            out.append([("stat_sum", DOUBLE), ("stat_sumsq", DOUBLE),
                        ("stat_count", BIGINT)])
        elif a.fn == "count":
            out.append([("count", BIGINT)])
        else:
            t = a.type
            out.append([(a.fn, t)])
    return out


def add_exchanges(root: PlanNode, writer_tasks: int = 1) -> PlanNode:
    """``writer_tasks > 1`` plans INSERT/CTAS with parallel writers fed by a
    ROUND_ROBIN exchange (the SCALED_WRITER_* partitionings planned by
    estimate; SkewedPartitionRebalancer-style runtime growth is a later
    round — see SystemPartitioningHandle.java:48-57)."""
    return _visit(root, single=True, writer_tasks=writer_tasks)


def _exchange(node: PlanNode, kind: str, keys=()) -> Exchange:
    return Exchange(node.output_names, node.output_types, node, kind,
                    "REMOTE", tuple(keys))


def rewrite_join_distribution(root: PlanNode, join: Join,
                              new_distribution: str,
                              new_left: Optional[PlanNode] = None
                              ) -> PlanNode:
    """Runtime PARTITIONED<->REPLICATED rewrite used by the adaptive
    execution plane (execution/adaptive.py): return ``root`` with the
    exact node ``join`` (identity match) replaced by a copy carrying
    ``new_distribution`` (and, for a broadcast->partitioned flip,
    ``new_left`` — the probe subtree cut into its own fragment and
    re-entered as a RemoteSource).  Only legal on plan trees whose
    consuming stage has not been activated yet; the static planning path
    never calls this."""
    from dataclasses import replace as _replace

    def walk(node: PlanNode) -> PlanNode:
        if node is join:
            return _replace(node,
                            left=node.left if new_left is None else new_left,
                            distribution=new_distribution)
        kids = node.children
        if not kids:
            return node
        new_kids = [walk(c) for c in kids]
        if all(a is b for a, b in zip(kids, new_kids)):
            return node
        if isinstance(node, Union):
            return _replace(node, sources=tuple(new_kids))
        if len(kids) == 1:
            return _replace(node, source=new_kids[0])
        if hasattr(node, "left"):
            return _replace(node, left=new_kids[0], right=new_kids[1])
        return _replace(node, source=new_kids[0], filter_source=new_kids[1])

    return walk(root)


def _visit(node: PlanNode, single: bool, writer_tasks: int = 1) -> PlanNode:
    """Rewrite bottom-up.  ``single`` = the parent requires this subtree's
    output to arrive at one task (root stage)."""

    if isinstance(node, TableWriter) and writer_tasks > 1:
        from dataclasses import replace as _replace

        src = _visit(node.source, single=False)
        rr = Exchange(src.output_names, src.output_types, src,
                      "ROUND_ROBIN", "REMOTE", ())
        # writer tasks each emit one BIGINT row count ("rows"); note the
        # optimizer's generic remap leaves TableWriter.output_names pointing
        # at the SOURCE columns, so the writer contract is restated here
        writer = _replace(node, source=rr,
                          output_names=("rows",), output_types=(BIGINT,))
        gathered = _exchange(writer, "GATHER")
        # TableFinish: sum the per-writer row counts
        # (reference: operator/TableFinishOperator.java:51)
        return Aggregate(("rows",), (BIGINT,), gathered,
                         (), (AggCall("sum", 0, BIGINT),))

    if isinstance(node, Aggregate):
        return _split_aggregate(node, single)

    if isinstance(node, Join):
        left = _visit(node.left, single=False)
        right = _visit(node.right, single=False)
        if node.distribution == "PARTITIONED" and node.left_keys:
            left = _exchange(left, "REPARTITION", node.left_keys)
            right = _exchange(right, "REPARTITION", node.right_keys)
        elif node.join_type in ("RIGHT", "FULL"):
            # keyless outer joins collapse to one task: a broadcast build
            # would emit unmatched build rows once per task
            left = _exchange(left, "GATHER")
            right = _exchange(right, "GATHER")
        else:
            right = _exchange(right, "BROADCAST")
        out = Join(node.output_names, node.output_types, left, right,
                   node.join_type, node.left_keys, node.right_keys,
                   node.residual, node.distribution)
        return _gather_if(out, single)

    if isinstance(node, SemiJoin):
        src = _visit(node.source, single=False)
        filt = _visit(node.filter_source, single=False)
        filt = _exchange(filt, "BROADCAST")
        out = SemiJoin(node.output_names, node.output_types, src, filt,
                       node.source_keys, node.filter_keys, node.negated,
                       node.residual, node.null_aware)
        return _gather_if(out, single)

    if isinstance(node, MatchRecognize):
        src = _visit(node.source, single=False)
        if node.partition_channels:
            src = _exchange(src, "REPARTITION", node.partition_channels)
        else:
            src = _exchange(src, "GATHER")
        out = _replace_source(node, src)
        return _gather_if(out, single and bool(node.partition_channels))

    if isinstance(node, Window):
        src = _visit(node.source, single=False)
        if node.partition_keys:
            # rows of one partition must colocate: hash-repartition on the
            # partition keys (reference: AddExchanges window distribution)
            src = _exchange(src, "REPARTITION", node.partition_keys)
            out = _replace_source(node, src)
            return _gather_if(out, single)
        src = _exchange(src, "GATHER")
        return _replace_source(node, src)

    if isinstance(node, Sort):
        # order-preserving distributed sort: sort per task, MERGE-gather
        # the pre-sorted streams (reference: MergeOperator.java:46; the
        # previous shape — gather then re-sort everything — is the
        # degenerate fallback this replaces)
        src = _visit(node.source, single=False)
        partial = Sort(node.output_names, node.output_types, src, node.keys)
        return Exchange(node.output_names, node.output_types, partial,
                        "MERGE", "REMOTE", (), node.keys)

    if isinstance(node, TopN):
        src = _visit(node.source, single=False)
        partial = TopN(node.output_names, node.output_types, src,
                       node.count, node.keys)
        merged = Exchange(node.output_names, node.output_types, partial,
                          "MERGE", "REMOTE", (), node.keys)
        return Limit(node.output_names, node.output_types, merged, node.count)

    if isinstance(node, Limit):
        src = _visit(node.source, single=False)
        partial = Limit(node.output_names, node.output_types, src, node.count)
        gathered = _exchange(partial, "GATHER")
        return Limit(node.output_names, node.output_types, gathered, node.count)

    if isinstance(node, DistinctLimit):
        src = _visit(node.source, single=False)
        partial = DistinctLimit(node.output_names, node.output_types, src,
                                node.count)
        gathered = _exchange(partial, "GATHER")
        return DistinctLimit(node.output_names, node.output_types, gathered,
                             node.count)

    if isinstance(node, Output):
        src = _visit(node.source, single=True, writer_tasks=writer_tasks)
        return _replace_source(node, src)

    if isinstance(node, TableWriter):
        src = _visit(node.source, single=True)
        return _replace_source(node, src)

    if isinstance(node, (Filter, Project, Replicate, GroupId, Unnest)):
        src = _visit(node.source, single=single)
        return _replace_source(node, src)

    if isinstance(node, Union):
        # each input stays in the union fragment: tasks union their own
        # split shares; any required global dedup sits above as an Aggregate.
        # A static (Values-only) input would be replayed identically by every
        # task of a multi-task union fragment, so it gets its own SINGLE
        # fragment via a GATHER edge.
        from dataclasses import replace as _replace

        srcs = []
        for s in node.sources:
            v = _visit(s, single=False)
            if not _has_task_varying_source(v):
                v = _exchange(v, "GATHER")
            srcs.append(v)
        return _gather_if(_replace(node, sources=tuple(srcs)), single)

    if isinstance(node, (TableScan, Values, TableFunctionScan)):
        return _gather_if(node, single)

    if isinstance(node, Exchange):  # already placed (LOCAL exchanges later)
        return _replace_source(node, _visit(node.source, single=False))

    raise NotImplementedError(f"add_exchanges: {type(node).__name__}")


def _has_task_varying_source(node: PlanNode) -> bool:
    """True when the subtree's output differs per task (scans split by task;
    exchange edges deliver per-task partitions).  Values-only subtrees are
    task-invariant: every task would produce identical copies."""
    if isinstance(node, (TableScan, Exchange)):
        return True
    return any(_has_task_varying_source(c) for c in node.children)


def _replace_source(node, src):
    from dataclasses import replace

    return replace(node, source=src)


def _gather_if(node: PlanNode, single: bool) -> PlanNode:
    if single:
        return _exchange(node, "GATHER")
    return node


def _split_aggregate(node: Aggregate, single: bool) -> PlanNode:
    src = _visit(node.source, single=False)
    nk = len(node.group_keys)
    has_distinct = any(a.distinct for a in node.aggregates)

    def _long_dec_avg(a) -> bool:
        # AVG over decimal(>18): the partial avg state is a scale-free f64
        # sum, which would lose the wide decimal's exactness across the
        # exchange — run it SINGLE at the consumer (SUM keeps its exact
        # limb path through PARTIAL/FINAL: the state is itself a long
        # decimal)
        from ..spi.types import DecimalType

        if a.fn != "avg" or a.arg < 0:
            return False
        t = node.source.output_types[a.arg]
        return isinstance(t, DecimalType) and t.precision > 18

    if has_distinct or any(_long_dec_avg(a) for a in node.aggregates):
        # distinct can't pre-aggregate: repartition raw rows on the group
        # keys (or gather when global), aggregate SINGLE at the consumer
        if nk:
            src = _exchange(src, "REPARTITION", node.group_keys)
        else:
            src = _exchange(src, "GATHER")
        out = Aggregate(node.output_names, node.output_types, src,
                        node.group_keys, node.aggregates, "SINGLE")
        return _gather_if(out, single and nk > 0)

    # ---- PARTIAL ----------------------------------------------------------
    layouts = partial_agg_layout(node.aggregates, src.output_types)
    p_names = [src.output_names[c] for c in node.group_keys]
    p_types = [src.output_types[c] for c in node.group_keys]
    for i, states in enumerate(layouts):
        for j, (fn, t) in enumerate(states):
            p_names.append(f"_s{i}_{j}")
            p_types.append(t)
    partial = Aggregate(tuple(p_names), tuple(p_types), src,
                        node.group_keys, node.aggregates, "PARTIAL")

    # ---- exchange ---------------------------------------------------------
    if nk:
        ex = _exchange(partial, "REPARTITION", tuple(range(nk)))
    else:
        ex = _exchange(partial, "GATHER")

    # ---- FINAL: same call list; args point at the first state channel -----
    f_calls = []
    ch = nk
    for a, states in zip(node.aggregates, layouts):
        f_calls.append(AggCall(a.fn, ch, a.type, False))
        ch += len(states)
    final = Aggregate(node.output_names, node.output_types, ex,
                      tuple(range(nk)), tuple(f_calls), "FINAL")
    return _gather_if(final, single and nk > 0)
