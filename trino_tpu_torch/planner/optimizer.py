"""Plan optimizer: cross-join flattening + stats-greedy join ordering,
filter pushdown, join distribution choice, column pruning.

The deliberately small stand-in for sql/planner/PlanOptimizers' 228 iterative
rules (reference: iterative/rule/ReorderJoins.java,
DetermineJoinDistributionType.java, PushPredicateIntoTableScan.java,
PruneUnreferencedOutputs.java).  Rules operate on channel indices, so every
rewrite returns (new_node, mapping old-channel -> new-channel) and parents
remap their expressions — the moral equivalent of Trino's symbol mapper.

Join ordering: comma/CROSS-join clusters under a Filter are flattened into a
join graph; the spine starts at the largest estimated relation and greedily
joins the smallest connected relation next (build sides stay small); every
available equality edge becomes a hash-join key, including cycle-closing
edges (Q5's c_nationkey = s_nationkey).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ..connectors.catalog import Catalog
from ..spi import knobs
from ..spi.types import BOOLEAN
from ..sql.ir import Call, InputRef, Literal, RowExpression, walk
from .plan import (
    Aggregate,
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

__all__ = ["optimize", "estimate_rows", "final_passes", "OPTIMIZER_MODES"]

# the reference selects with TRINO_TPU_OPTIMIZER; the port takes the mode
# as an argument (StandaloneQueryRunner(optimizer=...))
OPTIMIZER_MODES = ("iterative", "legacy")


# Damped selectivity of one extra equality join clause whose NDV is unknown
# (Trino's UNKNOWN_FILTER_COEFFICIENT idiom): before the fix, every clause
# past the first contributed selectivity 1.0, so stacked conjuncts never
# tightened a join estimate at all.
_EXTRA_JOIN_CLAUSE_SEL = 0.9


def optimize(root: PlanNode, catalog: Catalog,
             mode: str = "iterative") -> PlanNode:
    """``iterative``: the memo/fixpoint rule engine (planner/iterative/);
    ``legacy``: the single-pass rule pipeline below.  Any other mode
    raises ValueError."""
    if mode == "iterative":
        from .iterative import optimize_iterative

        return optimize_iterative(root, catalog)
    if mode == "legacy":
        return _optimize_legacy(root, catalog)
    raise ValueError(f"unknown optimizer mode {mode!r}; expected one of "
                     f"{OPTIMIZER_MODES}")


def _optimize_legacy(root: PlanNode, catalog: Catalog) -> PlanNode:
    node, mapping = _rewrite(root, catalog)
    assert mapping == list(range(len(node.output_types))), "root remap escaped"
    return final_passes(node, catalog)


def final_passes(node: PlanNode, catalog: Catalog) -> PlanNode:
    """Mapping-free tail passes both optimizer modes share: column pruning,
    advisory scan constraints, LIMIT-into-scan."""
    node = _prune(node, set(range(len(node.output_types))))[0]
    node = _attach_scan_constraints(node)
    node = _push_limit_into_scan(node, catalog)
    return node


def _push_limit_into_scan(node: PlanNode, catalog: Catalog) -> PlanNode:
    """LIMIT over a (projected) scan lets the scan stop opening further
    splits once the bound is satisfied (reference: iterative/rule/
    PushLimitIntoTableScan.java; the engine Limit stays for exactness).
    Planning is side-effect free: the bound travels on the TableScan node,
    never as connector state."""
    from dataclasses import replace as _replace

    def pushable_scan(n: PlanNode) -> Optional[TableScan]:
        # only row-preserving hops between Limit and scan
        if isinstance(n, TableScan):
            return n if n.constraint is None else None
        if isinstance(n, Project):
            return pushable_scan(n.source)
        return None

    def walk(n: PlanNode) -> PlanNode:
        kids = tuple(walk(c) for c in n.children)
        if kids != tuple(n.children):
            n = _replace_children(n, kids)
        if isinstance(n, Limit):
            scan = pushable_scan(n.source)
            if scan is not None:
                cap = (min(scan.limit, n.count) if scan.limit is not None
                       else n.count)

                def set_limit(m: PlanNode) -> PlanNode:
                    if isinstance(m, TableScan):
                        return _replace(m, limit=cap)
                    return _replace_children(
                        m, tuple(set_limit(c) for c in m.children))

                n = _replace(n, source=set_limit(n.source))
        return n

    def _replace_children(n: PlanNode, kids) -> PlanNode:
        names = [f.name for f in n.__dataclass_fields__.values()]
        if "source" in names and len(kids) == 1:
            return _replace(n, source=kids[0])
        if "left" in names and len(kids) == 2:
            return _replace(n, left=kids[0], right=kids[1])
        if "sources" in names:
            return _replace(n, sources=tuple(kids))
        return n

    return walk(node)


def _attach_scan_constraints(node: PlanNode) -> PlanNode:
    """Final pass: Filter directly over TableScan derives an advisory
    TupleDomain on the scan (planner/domains.py; reference:
    PushPredicateIntoTableScan.java with enforced=false — the Filter stays)."""
    from .domains import extract_tuple_domain

    if isinstance(node, Filter) and isinstance(node.source, TableScan):
        scan = node.source
        td = extract_tuple_domain(
            node.predicate,
            {i: scan.columns[i] for i in range(len(scan.columns))})
        if not td.is_all:
            return replace(node, source=replace(scan, constraint=td))
        return node
    kids = node.children
    if not kids:
        return node
    new_kids = [_attach_scan_constraints(c) for c in kids]
    if all(a is b for a, b in zip(kids, new_kids)):
        return node
    if isinstance(node, Union):
        return replace(node, sources=tuple(new_kids))
    if len(kids) == 1:
        return replace(node, source=new_kids[0])
    return (replace(node, left=new_kids[0], right=new_kids[1])
            if hasattr(node, "left")
            else replace(node, source=new_kids[0], filter_source=new_kids[1]))


# --------------------------------------------------------------------------
# helpers


def _remap_expr(e: RowExpression, mapping: list[Optional[int]]) -> RowExpression:
    if isinstance(e, InputRef):
        new = mapping[e.index]
        assert new is not None, f"channel #{e.index} pruned but referenced"
        return InputRef(e.type, new)
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(_remap_expr(a, mapping) for a in e.args))
    return e


def _refs(e: RowExpression) -> set[int]:
    return {x.index for x in walk(e) if isinstance(x, InputRef)}


def _channel_ndv(node: PlanNode, ch: int, catalog: Catalog) -> Optional[float]:
    """Distinct-value estimate for an output channel, traced down identity
    projections/filters to a TableScan column (the NDV half of Trino's
    StatsCalculator — cost/ScalarStatsCalculator + table stats)."""
    while True:
        if isinstance(node, TableScan):
            stats = catalog.connector(node.catalog).get_table_statistics(node.table)
            return stats.ndv.get(node.columns[ch])
        if isinstance(node, Filter):
            node = node.source
            continue
        if isinstance(node, Project):
            e = node.expressions[ch]
            if isinstance(e, InputRef):
                node, ch = node.source, e.index
                continue
            return None
        if isinstance(node, Join):
            lw = len(node.left.output_types)
            if ch < lw:
                node = node.left
            else:
                node, ch = node.right, ch - lw
            continue
        if isinstance(node, SemiJoin):
            if ch < len(node.source.output_types):
                node = node.source
                continue
            return None
        return None


def _conjunct_selectivity(c: RowExpression, source: PlanNode,
                          catalog: Catalog) -> float:
    """Per-predicate selectivity from column NDV when available (mirrors
    cost/FilterStatsCalculator's equality/range rules), 0.3 fallback."""
    if isinstance(c, Call) and c.name == "eq":
        for a, b in (c.args, reversed(c.args)):
            if isinstance(a, InputRef) and isinstance(b, Literal):
                ndv = _channel_ndv(source, a.index, catalog)
                if ndv:
                    return 1.0 / ndv
        return 0.1
    if isinstance(c, Call) and c.name == "$in":
        col = c.args[0]
        if isinstance(col, InputRef):
            ndv = _channel_ndv(source, col.index, catalog)
            if ndv:
                return min(1.0, (len(c.args) - 1) / ndv)
        return 0.2
    if isinstance(c, Call) and c.name in ("lt", "le", "gt", "ge"):
        return 0.4  # one-sided range (BETWEEN splits into two of these)
    if isinstance(c, Call) and c.name == "$like":
        return 0.25
    return 0.3


def estimate_rows(node: PlanNode, catalog: Catalog, history=None) -> float:
    if history is not None:
        observed = history.observed_rows(node)
        if observed is not None:
            return float(observed)
    if isinstance(node, TableScan):
        stats = catalog.connector(node.catalog).get_table_statistics(node.table)
        r = stats.row_count
        return r if r == r else 10_000.0  # NaN check
    if isinstance(node, Filter):
        sel = 1.0
        for c in _split_and(node.predicate):
            sel *= _conjunct_selectivity(c, node.source, catalog)
        return estimate_rows(node.source, catalog, history) * max(sel, 1e-9)
    if isinstance(node, Project):
        return estimate_rows(node.source, catalog, history)
    if isinstance(node, Aggregate):
        src = estimate_rows(node.source, catalog, history)
        if not node.group_keys:
            return 1.0
        groups = 1.0
        known = False
        for k in node.group_keys:
            ndv = _channel_ndv(node.source, k, catalog)
            if ndv:
                groups *= ndv
                known = True
        if known:
            return max(1.0, min(groups, src))
        return max(1.0, src * 0.1)
    if isinstance(node, Join):
        l = estimate_rows(node.left, catalog, history)
        r = estimate_rows(node.right, catalog, history)
        if not node.left_keys:
            return l * r if node.join_type == "CROSS" else l
        # |L ⋈ R| ≈ |L||R| / max(ndv(lk), ndv(rk)) (textbook equi-join)
        lnd = _channel_ndv(node.left, node.left_keys[0], catalog)
        rnd = _channel_ndv(node.right, node.right_keys[0], catalog)
        if lnd and rnd:
            out = max(1.0, l * r / max(lnd, rnd))
        else:
            out = max(l, r)
        # every equality clause past the first tightens the estimate; an
        # unknown-NDV clause is floored at the damped per-conjunct default
        # instead of the old implicit selectivity of 1.0
        for lk, rk in zip(node.left_keys[1:], node.right_keys[1:]):
            nd = max(_channel_ndv(node.left, lk, catalog) or 0.0,
                     _channel_ndv(node.right, rk, catalog) or 0.0)
            sel = max(1.0 / nd, _EXTRA_JOIN_CLAUSE_SEL) if nd \
                else _EXTRA_JOIN_CLAUSE_SEL
            out = max(1.0, out * sel)
        return out
    if isinstance(node, SemiJoin):
        return estimate_rows(node.source, catalog, history)
    if isinstance(node, (Sort,)):
        return estimate_rows(node.source, catalog, history)
    if isinstance(node, (TopN, Limit)):
        return float(getattr(node, "count", 1000))
    if isinstance(node, Values):
        return float(len(node.rows))
    if isinstance(node, Union):
        return sum(estimate_rows(s, catalog, history) for s in node.sources)
    if isinstance(node, GroupId):
        return estimate_rows(node.source, catalog, history) * max(1, len(node.sets))
    if isinstance(node, Unnest):
        return estimate_rows(node.source, catalog, history) * 3.0  # avg fan-out guess
    for c in node.children:
        return estimate_rows(c, catalog, history)
    return 1000.0


# --------------------------------------------------------------------------
# main rewrite (returns node + channel mapping old->new)


def _identity(node: PlanNode) -> list[int]:
    return list(range(len(node.output_types)))


def _rewrite(node: PlanNode, catalog: Catalog) -> tuple[PlanNode, list[int]]:
    if isinstance(node, Filter):
        return _rewrite_filter_cluster(node, catalog)
    if isinstance(node, Join) and node.join_type in ("CROSS", "INNER"):
        return _rewrite_filter_cluster(node, catalog)

    if isinstance(node, (Output,)):
        child, m = _rewrite(node.source, catalog)
        if m != list(range(len(child.output_types))):
            child = _restore_layout(child, m, node.source)
        return replace(node, source=child), _identity(node)

    if isinstance(node, Project):
        child, m = _rewrite(node.source, catalog)
        exprs = tuple(_remap_expr(e, m) for e in node.expressions)
        return replace(node, source=child, expressions=exprs), _identity(node)

    if isinstance(node, Aggregate):
        child, m = _rewrite(node.source, catalog)
        return (
            replace(
                node,
                source=child,
                group_keys=tuple(m[k] for k in node.group_keys),
                aggregates=tuple(
                    replace(a, arg=m[a.arg] if a.arg >= 0 else -1)
                    for a in node.aggregates
                ),
            ),
            _identity(node),
        )

    if isinstance(node, Join):  # LEFT / SINGLE
        left, lm = _rewrite(node.left, catalog)
        right, rm = _rewrite(node.right, catalog)
        lw_old = len(node.left.output_types)
        lw_new = len(left.output_types)
        mapping = [lm[i] for i in range(lw_old)] + [rm[i - lw_old] + lw_new
                                                   for i in range(lw_old, lw_old + len(rm))]
        names = tuple(left.output_names) + tuple(right.output_names)
        types = tuple(left.output_types) + tuple(right.output_types)
        residual = (_remap_expr(node.residual, mapping)
                    if node.residual is not None else None)
        out = replace(
            node, output_names=names, output_types=types, left=left, right=right,
            left_keys=tuple(lm[k] for k in node.left_keys),
            right_keys=tuple(rm[k] for k in node.right_keys),
            residual=residual,
            distribution=_choose_distribution(right, catalog, node.join_type),
        )
        return out, mapping

    if isinstance(node, SemiJoin):
        src, sm = _rewrite(node.source, catalog)
        filt, fm = _rewrite(node.filter_source, catalog)
        sw_old = len(node.source.output_types)
        sw_new = len(src.output_types)
        mapping = [sm[i] for i in range(sw_old)] + [sw_new]  # mark at end
        residual = None
        if node.residual is not None:
            # residual layout: source ++ filter channels
            rmap = sm + [fm[i] + sw_new for i in range(len(fm))]
            residual = _remap_expr(node.residual, rmap)
        names = tuple(src.output_names) + (node.output_names[-1],)
        types = tuple(src.output_types) + (BOOLEAN,)
        out = replace(
            node, output_names=names, output_types=types,
            source=src, filter_source=filt,
            source_keys=tuple(sm[k] for k in node.source_keys),
            filter_keys=tuple(fm[k] for k in node.filter_keys),
            residual=residual,
        )
        return out, mapping

    if isinstance(node, (Sort, TopN, Limit, TableWriter, Exchange,
                         DistinctLimit, Replicate)):
        child, m = _rewrite(node.source, catalog)
        kwargs = dict(source=child, output_names=child.output_names,
                      output_types=child.output_types)
        if isinstance(node, (Sort, TopN)):
            kwargs["keys"] = tuple(replace(k, channel=m[k.channel]) for k in node.keys)
        if isinstance(node, Exchange):
            kwargs["partition_keys"] = tuple(m[k] for k in node.partition_keys)
        if isinstance(node, Replicate):
            kwargs["count_channel"] = m[node.count_channel]
        return replace(node, **kwargs), m

    if isinstance(node, GroupId):
        child, m = _rewrite(node.source, catalog)
        out = replace(node, source=child,
                      key_channels=tuple(m[c] for c in node.key_channels),
                      passthrough=tuple(m[c] for c in node.passthrough))
        return out, _identity(node)

    if isinstance(node, Unnest):
        child, m = _rewrite(node.source, catalog)
        out = replace(node, source=child,
                      replicate=tuple(m[c] for c in node.replicate),
                      unnest_channels=tuple(m[c] for c in node.unnest_channels))
        return out, _identity(node)

    if isinstance(node, MatchRecognize):
        child, m = _rewrite(node.source, catalog)
        if m != list(range(len(child.output_types))):
            child = _restore_layout(child, m, node.source)
        return replace(node, source=child), _identity(node)

    if isinstance(node, Window):
        child, m = _rewrite(node.source, catalog)
        sw_old = len(node.source.output_types)
        sw_new = len(child.output_types)
        funcs = tuple(
            replace(f, args=tuple(m[a] for a in f.args))
            for f in node.functions)
        names = tuple(child.output_names) + tuple(
            node.output_names[sw_old + j] for j in range(len(funcs)))
        types = tuple(child.output_types) + tuple(f.type for f in funcs)
        out = replace(
            node, output_names=names, output_types=types, source=child,
            partition_keys=tuple(m[k] for k in node.partition_keys),
            order_keys=tuple(replace(k, channel=m[k.channel])
                             for k in node.order_keys),
            functions=funcs)
        mapping = [m[i] for i in range(sw_old)] + [
            sw_new + j for j in range(len(funcs))]
        return out, mapping

    if isinstance(node, Union):
        new_sources = []
        for s in node.sources:
            child, m = _rewrite(s, catalog)
            if m != list(range(len(child.output_types))):
                child = _restore_layout(child, m, s)
            new_sources.append(child)
        return replace(node, sources=tuple(new_sources)), _identity(node)

    if isinstance(node, (TableScan, Values, TableFunctionScan)):
        return node, _identity(node)

    raise NotImplementedError(f"optimizer: {type(node).__name__}")


def _restore_layout(child: PlanNode, mapping: list[int], original: PlanNode) -> PlanNode:
    exprs = tuple(InputRef(t, mapping[i]) for i, t in enumerate(original.output_types))
    return Project(tuple(original.output_names), tuple(original.output_types),
                   child, exprs)


def _choose_distribution(build: PlanNode, catalog: Catalog,
                         join_type: str = "INNER", history=None) -> str:
    # RIGHT/FULL must partition: a broadcast build would emit its unmatched
    # rows once per task (reference: DetermineJoinDistributionType.java —
    # right/full joins cannot use REPLICATED)
    if join_type in ("RIGHT", "FULL"):
        return "PARTITIONED"
    # override hook for mis-estimation drills: force a wrong static choice
    # and let the adaptive plane (execution/adaptive.py) correct it at the
    # activation barrier from OBSERVED bytes
    # (an empty value means the declared default, as unset does)
    limit = knobs.get_int("TRINO_TPU_BROADCAST_ROW_LIMIT")
    if limit is None:
        limit = int(knobs.knob("TRINO_TPU_BROADCAST_ROW_LIMIT").default)
    if history is not None:
        stats = history.stats_for(build)
        if stats is not None:
            # observed build bytes against the same threshold the adaptive
            # activation barrier uses: the plan-time version of its flip
            if stats.bytes is not None:
                from ..execution.adaptive import broadcast_threshold_bytes

                return ("BROADCAST"
                        if stats.bytes <= broadcast_threshold_bytes(None)
                        else "PARTITIONED")
            if stats.rows is not None:
                return ("BROADCAST" if stats.rows <= limit
                        else "PARTITIONED")
    return ("BROADCAST" if estimate_rows(build, catalog, history) <= limit
            else "PARTITIONED")


# --------------------------------------------------------------------------
# cross-join cluster flattening


def _shift(e: RowExpression, by: int) -> RowExpression:
    if isinstance(e, InputRef):
        return InputRef(e.type, e.index + by)
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(_shift(a, by) for a in e.args))
    return e


def _flatten(node: PlanNode, catalog: Catalog):
    """Collect cluster leaves with their ORIGINAL channel offsets."""
    leaves: list[tuple[PlanNode, list[int]]] = []
    conjuncts: list[RowExpression] = []

    def go(n: PlanNode, offset: int) -> int:
        """Returns width of n's original layout; appends leaves/conjuncts."""
        if isinstance(n, Join) and n.join_type in ("CROSS", "INNER"):
            lw = go(n.left, offset)
            rw = go(n.right, offset + lw)
            for lk, rk in zip(n.left_keys, n.right_keys):
                conjuncts.append(Call(BOOLEAN, "eq", (
                    InputRef(n.left.output_types[lk], offset + lk),
                    InputRef(n.right.output_types[rk], offset + lw + rk))))
            if n.residual is not None:
                conjuncts.append(_shift(n.residual, offset))
            return lw + rw
        leaf, m = _rewrite(n, catalog)
        leaves.append((leaf, offset, m))
        return len(n.output_types)

    total = go(node, 0)
    return leaves, conjuncts, total


def _hoist_common_or(e: RowExpression) -> list[RowExpression]:
    """(A ∧ X) ∨ (A ∧ Y) → [A, X ∨ Y] — extract conjuncts common to every
    OR arm (reference: sql/planner/iterative/rule/... ExtractCommonPredicates
    ExpressionRewriter; Kleene 3VL is distributive, so this is exact).  The
    unlocked equality conjuncts turn Q19-style OR-of-ANDs cross joins into
    hash joins."""
    if not (isinstance(e, Call) and e.name == "$or"):
        return [e]
    arms = [_split_and(a) for a in e.args]
    common = [t for t in arms[0]
              if all(any(t == u for u in arm) for arm in arms[1:])]
    if not common:
        return [e]
    reduced = [[t for t in arm if t not in common] for arm in arms]
    out = list(common)
    if all(reduced):  # an empty remainder makes the OR vacuous given common
        out.append(Call(BOOLEAN, "$or",
                        tuple(_conjoin(r) for r in reduced)))
    return out


def _rewrite_filter_cluster(node: PlanNode, catalog: Catalog):
    if isinstance(node, Filter):
        cluster_root = node.source
        preds = [p for c in _split_and(node.predicate)
                 for p in _hoist_common_or(c)]
    else:
        cluster_root = node
        preds = []
    if not (isinstance(cluster_root, Join)
            and cluster_root.join_type in ("CROSS", "INNER")):
        # plain filter over a non-join child
        child, m = _rewrite(cluster_root, catalog)
        if not isinstance(node, Filter):
            return child, m
        pred = _conjoin([_remap_expr(p, m) for p in preds])
        out = Filter(child.output_names, child.output_types, child, pred)
        return out, m

    leaves, conjuncts, total_width = _flatten(cluster_root, catalog)
    conjuncts = conjuncts + preds

    # original channel -> (leaf idx, local channel through leaf's mapping)
    chan_leaf: dict[int, tuple[int, int]] = {}
    for li, (leaf, offset, m) in enumerate(leaves):
        for local_old, local_new in enumerate(m):
            chan_leaf[offset + local_old] = (li, local_new)

    def leaf_of(e: RowExpression) -> Optional[int]:
        ls = {chan_leaf[i][0] for i in _refs(e)}
        return ls.pop() if len(ls) == 1 else None

    # push single-leaf conjuncts into the leaf
    leaf_nodes = [leaf for (leaf, _, _) in leaves]
    leaf_filters: list[list[RowExpression]] = [[] for _ in leaves]
    edges: list[tuple[int, int, RowExpression, RowExpression]] = []
    residual: list[RowExpression] = []
    for c in conjuncts:
        refs = _refs(c)
        involved = {chan_leaf[i][0] for i in refs}
        if len(involved) == 1:
            li = involved.pop()
            local = _remap_to_leaf(c, chan_leaf, li)
            leaf_filters[li].append(local)
        elif (isinstance(c, Call) and c.name == "eq" and len(involved) == 2
              and _single_leaf(c.args[0], chan_leaf) is not None
              and _single_leaf(c.args[1], chan_leaf) is not None):
            a, b = c.args
            la, lb = _single_leaf(a, chan_leaf), _single_leaf(b, chan_leaf)
            edges.append((la, lb,
                          _remap_to_leaf(a, chan_leaf, la),
                          _remap_to_leaf(b, chan_leaf, lb)))
        else:
            residual.append(c)

    for li, filters in enumerate(leaf_filters):
        if filters:
            leaf = leaf_nodes[li]
            leaf_nodes[li] = Filter(leaf.output_names, leaf.output_types,
                                    leaf, _conjoin(filters))

    est = [estimate_rows(l, catalog) for l in leaf_nodes]

    # greedy: spine = largest; next = the connected relation with the
    # SMALLEST ESTIMATED JOIN OUTPUT (|A><B| ~ |A|*|B| / max key NDV —
    # cost/JoinStatsRule's core rule).  Size-only greediness exploded Q5 at
    # scale: customer joined the spine over the 25-value nationkey edge
    # (fan-out x6000) before orders made the custkey edge available.
    order = [max(range(len(leaf_nodes)), key=lambda i: est[i])]
    remaining = set(range(len(leaf_nodes))) - set(order)
    spine_est = est[order[0]]

    ndv_cache: dict[tuple[int, int], Optional[float]] = {}

    def _leaf_ndv(leaf: int, expr) -> Optional[float]:
        if not isinstance(expr, InputRef):
            return None
        key = (leaf, expr.index)
        if key not in ndv_cache:
            ndv_cache[key] = _channel_ndv(leaf_nodes[leaf], expr.index,
                                          catalog)
        return ndv_cache[key]

    def _edge_ndv(i: int) -> Optional[float]:
        """max(NDV) over BOTH endpoints of the best usable edge
        (|A><B| ~ |A|*|B| / max(ndv_A, ndv_B) — cost/JoinStatsRule)."""
        best: Optional[float] = None
        for (a, b, ea, eb) in edges:
            if a in order and b == i:
                se, ce = ea, eb
                sl = a
            elif b in order and a == i:
                se, ce = eb, ea
                sl = b
            else:
                continue
            nd = max((x for x in (_leaf_ndv(i, ce), _leaf_ndv(sl, se))
                      if x), default=None)
            if nd:
                best = max(best or 0.0, nd)
        return best

    # key expressions must be channels; all edge endpoint exprs that are
    # plain InputRefs can be used directly, others appended via projection.
    while remaining:
        connected = [
            i for i in remaining
            if any((a in order and b == i) or (b in order and a == i)
                   for (a, b, _, _) in edges)
        ]
        if connected:

            def out_est(i: int) -> float:
                nd = _edge_ndv(i)
                if nd:
                    return spine_est * est[i] / max(nd, 1.0)
                # keyed join with unknown NDV: PK-FK-ish assumption
                return max(spine_est, est[i])

            outs = {i: out_est(i) for i in connected}
            pick = min(connected, key=lambda i: (outs[i], est[i]))
            spine_est = max(outs[pick], 1.0)
        else:
            pick = min(remaining, key=lambda i: est[i])
            spine_est = spine_est * max(est[pick], 1.0)  # cross join
        order.append(pick)
        remaining.discard(pick)

    # build the tree left-deep; track mapping (leaf idx, local ch) -> spine ch
    spine = leaf_nodes[order[0]]
    pos: dict[tuple[int, int], int] = {
        (order[0], i): i for i in range(len(spine.output_types))
    }
    used_edges = set()
    for step in range(1, len(order)):
        li = order[step]
        right = leaf_nodes[li]
        lkeys, rkeys = [], []
        for ei, (a, b, ea, eb) in enumerate(edges):
            if ei in used_edges:
                continue
            if a in order[:step] and b == li:
                sa, rb = ea, eb
            elif b in order[:step] and a == li:
                sa, rb = eb, ea
                a, b = b, a
            else:
                continue
            used_edges.add(ei)
            # spine-side expr: remap leaf-local -> spine channels
            sa_spine = _remap_leaf_to_spine(sa, a, pos)
            lkeys.append(sa_spine)
            rkeys.append(rb)
        lch, spine = _exprs_as_channels(lkeys, spine)
        rch, right = _exprs_as_channels(rkeys, right)
        names = tuple(spine.output_names) + tuple(right.output_names)
        types = tuple(spine.output_types) + tuple(right.output_types)
        sw = len(spine.output_types)
        jt = "INNER" if lch else "CROSS"
        spine = Join(names, types, spine, right, jt, tuple(lch), tuple(rch),
                     None, distribution=_choose_distribution(right, catalog))
        for i in range(len(right.output_types)):
            pos[(li, i)] = sw + i

    # residual conjuncts over the final spine
    if residual:
        def remap_residual(e: RowExpression) -> RowExpression:
            if isinstance(e, InputRef):
                li, local = chan_leaf[e.index]
                return InputRef(e.type, pos[(li, local)])
            if isinstance(e, Call):
                return Call(e.type, e.name, tuple(remap_residual(a) for a in e.args))
            return e
        spine = Filter(spine.output_names, spine.output_types, spine,
                       _conjoin([remap_residual(r) for r in residual]))

    # overall mapping: original concat channel -> spine channel
    mapping = []
    for i in range(total_width):
        li, local = chan_leaf.get(i, (None, None))
        mapping.append(pos.get((li, local)) if li is not None else None)
    return spine, mapping


def _remap_leaf_to_spine(e: RowExpression, leaf_idx: int,
                         pos: dict[tuple[int, int], int]) -> RowExpression:
    if isinstance(e, InputRef):
        return InputRef(e.type, pos[(leaf_idx, e.index)])
    if isinstance(e, Call):
        return Call(e.type, e.name,
                    tuple(_remap_leaf_to_spine(a, leaf_idx, pos) for a in e.args))
    return e


def _single_leaf(e: RowExpression, chan_leaf) -> Optional[int]:
    ls = {chan_leaf[i][0] for i in _refs(e)}
    return ls.pop() if len(ls) == 1 else None


def _remap_to_leaf(e: RowExpression, chan_leaf, li: int) -> RowExpression:
    if isinstance(e, InputRef):
        l, local = chan_leaf[e.index]
        assert l == li
        return InputRef(e.type, local)
    if isinstance(e, Call):
        return Call(e.type, e.name,
                    tuple(_remap_to_leaf(a, chan_leaf, li) for a in e.args))
    return e


def _exprs_as_channels(exprs: list[RowExpression], node: PlanNode):
    chans, extra, names = [], [], []
    for e in exprs:
        if isinstance(e, InputRef):
            chans.append(e.index)
        else:
            chans.append(len(node.output_types) + len(extra))
            extra.append(e)
            names.append(f"_jk{len(node.output_types) + len(extra) - 1}")
    if extra:
        base = [InputRef(t, i) for i, t in enumerate(node.output_types)]
        node = Project(tuple(node.output_names) + tuple(names),
                       tuple(node.output_types) + tuple(e.type for e in extra),
                       node, tuple(base + extra))
    return chans, node


def _split_and(e: RowExpression) -> list[RowExpression]:
    if isinstance(e, Call) and e.name == "$and":
        out = []
        for a in e.args:
            out.extend(_split_and(a))
        return out
    return [e]


def _conjoin(terms: list[RowExpression]) -> RowExpression:
    if len(terms) == 1:
        return terms[0]
    return Call(BOOLEAN, "$and", tuple(terms))


# --------------------------------------------------------------------------
# column pruning


def _prune(node: PlanNode, needed: set[int]) -> tuple[PlanNode, list[Optional[int]]]:
    """Drop unused output channels bottom-up.  Returns (node, mapping
    old-channel -> new-channel or None if dropped)."""

    def key_mapping(kept: list[int], width: int) -> list[Optional[int]]:
        m: list[Optional[int]] = [None] * width
        for new, old in enumerate(kept):
            m[old] = new
        return m

    if isinstance(node, Output):
        child, m = _prune(node.source, set(range(len(node.source.output_types))))
        assert all(x is not None for x in m)
        return replace(node, source=child), list(range(len(node.output_types)))

    if isinstance(node, Project):
        kept = sorted(needed)
        if not kept and node.expressions:
            # a zero-column batch cannot carry its row count (the padded
            # live-mask model needs at least one array): keep the cheapest
            # channel for count(*)-style consumers (the reference's pruning
            # keeps a smallest column for the same reason)
            kept = [0]
        child_needed = set()
        for i in kept:
            child_needed |= _refs(node.expressions[i])
        child, cm = _prune(node.source, child_needed)
        exprs = tuple(_remap_expr(node.expressions[i], cm) for i in kept)
        out = Project(tuple(node.output_names[i] for i in kept),
                      tuple(node.output_types[i] for i in kept), child, exprs)
        return out, key_mapping(kept, len(node.output_types))

    if isinstance(node, Filter):
        child_needed = set(needed) | _refs(node.predicate)
        child, cm = _prune(node.source, child_needed)
        pred = _remap_expr(node.predicate, cm)
        out = Filter(child.output_names, child.output_types, child, pred)
        return out, cm

    if isinstance(node, TableScan):
        kept = sorted(needed)
        if not kept:
            kept = [0]  # keep one channel for row counting
        out = TableScan(tuple(node.output_names[i] for i in kept),
                        tuple(node.output_types[i] for i in kept),
                        node.catalog, node.table,
                        tuple(node.columns[i] for i in kept))
        return out, key_mapping(kept, len(node.output_types))

    if isinstance(node, (Values, TableFunctionScan)):
        return node, list(range(len(node.output_types)))

    if isinstance(node, Aggregate):
        nk = len(node.group_keys)
        kept_aggs = [i for i in range(len(node.aggregates))
                     if (nk + i) in needed]
        child_needed = set(node.group_keys)
        for i in kept_aggs:
            if node.aggregates[i].arg >= 0:
                child_needed.add(node.aggregates[i].arg)
        child, cm = _prune(node.source, child_needed)
        aggs = tuple(
            replace(node.aggregates[i],
                    arg=cm[node.aggregates[i].arg] if node.aggregates[i].arg >= 0 else -1)
            for i in kept_aggs)
        keys = tuple(cm[k] for k in node.group_keys)
        kept = list(range(nk)) + [nk + i for i in kept_aggs]
        out = Aggregate(tuple(node.output_names[i] for i in kept),
                        tuple(node.output_types[i] for i in kept),
                        child, keys, aggs, node.step)
        return out, key_mapping(kept, len(node.output_types))

    if isinstance(node, Join):
        lw = len(node.left.output_types)
        left_needed = {i for i in needed if i < lw} | set(node.left_keys)
        right_needed = {i - lw for i in needed if i >= lw} | set(node.right_keys)
        if node.residual is not None:
            for r in _refs(node.residual):
                (left_needed if r < lw else right_needed).add(r if r < lw else r - lw)
        left, lm = _prune(node.left, left_needed)
        right, rm = _prune(node.right, right_needed)
        lw_new = len(left.output_types)
        mapping: list[Optional[int]] = []
        for i in range(lw):
            mapping.append(lm[i])
        for i in range(len(node.right.output_types)):
            mapping.append(rm[i] + lw_new if rm[i] is not None else None)
        residual = (_remap_expr(node.residual, mapping)
                    if node.residual is not None else None)
        names = tuple(left.output_names) + tuple(right.output_names)
        types = tuple(left.output_types) + tuple(right.output_types)
        out = replace(node, output_names=names, output_types=types,
                      left=left, right=right,
                      left_keys=tuple(lm[k] for k in node.left_keys),
                      right_keys=tuple(rm[k] for k in node.right_keys),
                      residual=residual)
        return out, mapping

    if isinstance(node, SemiJoin):
        sw = len(node.source.output_types)
        src_needed = {i for i in needed if i < sw} | set(node.source_keys)
        filt_needed = set(node.filter_keys)
        if node.residual is not None:
            for r in _refs(node.residual):
                (src_needed if r < sw else filt_needed).add(r if r < sw else r - sw)
        src, sm = _prune(node.source, src_needed)
        filt, fm = _prune(node.filter_source, filt_needed)
        sw_new = len(src.output_types)
        mapping = [sm[i] for i in range(sw)] + [sw_new]
        residual = None
        if node.residual is not None:
            # residual layout: source channels ++ filter-source channels
            full = [sm[i] for i in range(sw)] + \
                   [fm[i] + sw_new if fm[i] is not None else None
                    for i in range(len(node.filter_source.output_types))]
            residual = _remap_expr(node.residual, full)
        names = tuple(src.output_names) + (node.output_names[-1],)
        types = tuple(src.output_types) + (BOOLEAN,)
        out = replace(node, output_names=names, output_types=types,
                      source=src, filter_source=filt,
                      source_keys=tuple(sm[k] for k in node.source_keys),
                      filter_keys=tuple(fm[k] for k in node.filter_keys),
                      residual=residual)
        return out, mapping

    if isinstance(node, (Sort, TopN)):
        child_needed = set(needed) | {k.channel for k in node.keys}
        child, cm = _prune(node.source, child_needed)
        keys = tuple(replace(k, channel=cm[k.channel]) for k in node.keys)
        out = replace(node, source=child, keys=keys,
                      output_names=child.output_names,
                      output_types=child.output_types)
        return out, cm

    if isinstance(node, GroupId):
        # every output is load-bearing for the Aggregate above (keys + gid
        # are its grouping keys; passthroughs its arguments): prune below only
        child_needed = set(node.key_channels) | set(node.passthrough)
        child, cm = _prune(node.source, child_needed)
        out = replace(node, source=child,
                      key_channels=tuple(cm[c] for c in node.key_channels),
                      passthrough=tuple(cm[c] for c in node.passthrough))
        return out, list(range(len(node.output_types)))

    if isinstance(node, Unnest):
        child_needed = set(node.replicate) | set(node.unnest_channels)
        child, cm = _prune(node.source, child_needed)
        out = replace(node, source=child,
                      replicate=tuple(cm[c] for c in node.replicate),
                      unnest_channels=tuple(cm[c] for c in node.unnest_channels))
        return out, list(range(len(node.output_types)))

    if isinstance(node, MatchRecognize):
        # DEFINE/MEASURES reference source columns BY NAME in the host
        # pattern engine: the full input layout must survive
        child, cm = _prune(node.source,
                           set(range(len(node.source.output_types))))
        return replace(node, source=child), list(range(len(node.output_types)))

    if isinstance(node, Window):
        sw = len(node.source.output_types)
        kept_fns = [j for j in range(len(node.functions)) if (sw + j) in needed]
        child_needed = ({i for i in needed if i < sw}
                        | set(node.partition_keys)
                        | {k.channel for k in node.order_keys})
        for j in kept_fns:
            child_needed |= set(node.functions[j].args)
        child, cm = _prune(node.source, child_needed)
        sw_new = len(child.output_types)
        funcs = tuple(
            replace(node.functions[j],
                    args=tuple(cm[a] for a in node.functions[j].args))
            for j in kept_fns)
        names = tuple(child.output_names) + tuple(
            node.output_names[sw + j] for j in kept_fns)
        types = tuple(child.output_types) + tuple(f.type for f in funcs)
        out = replace(node, output_names=names, output_types=types,
                      source=child,
                      partition_keys=tuple(cm[k] for k in node.partition_keys),
                      order_keys=tuple(replace(k, channel=cm[k.channel])
                                       for k in node.order_keys),
                      functions=funcs)
        mapping: list[Optional[int]] = [cm[i] for i in range(sw)]
        fn_map = {j: sw_new + newj for newj, j in enumerate(kept_fns)}
        for j in range(len(node.functions)):
            mapping.append(fn_map.get(j))
        return out, mapping

    if isinstance(node, Union):
        kept = sorted(needed) or [0]
        new_sources = []
        for s in node.sources:
            child, cm = _prune(s, set(kept))
            if [cm[i] for i in kept] != list(range(len(child.output_types))):
                # re-project so every source keeps the identical layout
                child = Project(
                    tuple(node.output_names[i] for i in kept),
                    tuple(node.output_types[i] for i in kept),
                    child,
                    tuple(InputRef(node.output_types[i], cm[i]) for i in kept))
            new_sources.append(child)
        out = Union(tuple(node.output_names[i] for i in kept),
                    tuple(node.output_types[i] for i in kept),
                    tuple(new_sources))
        m: list[Optional[int]] = [None] * len(node.output_types)
        for new, old in enumerate(kept):
            m[old] = new
        return out, m

    if isinstance(node, Replicate):
        child, cm = _prune(node.source, set(needed) | {node.count_channel})
        return replace(node, source=child,
                       output_names=child.output_names,
                       output_types=child.output_types,
                       count_channel=cm[node.count_channel]), cm

    if isinstance(node, (Limit, Exchange, TableWriter)):
        if isinstance(node, TableWriter):
            needed = set(range(len(node.source.output_types)))
        child, cm = _prune(node.source, needed if not isinstance(node, TableWriter)
                           else set(range(len(node.source.output_types))))
        kwargs = dict(source=child)
        if not isinstance(node, TableWriter):
            kwargs["output_names"] = child.output_names
            kwargs["output_types"] = child.output_types
        if isinstance(node, Exchange):
            kwargs["partition_keys"] = tuple(cm[k] for k in node.partition_keys)
        return replace(node, **kwargs), cm if not isinstance(node, TableWriter) \
            else list(range(len(node.output_types)))

    raise NotImplementedError(f"prune: {type(node).__name__}")
