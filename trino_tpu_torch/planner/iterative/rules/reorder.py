"""Join ordering and distribution rules (the port of the reference
``planner/iterative/rules/reorder.py``; Trino: iterative/rule/
ReorderJoins.java + JoinEnumerator, and DetermineJoinDistributionType.java).

``ReorderJoins`` re-expresses the legacy optimizer's filter-cluster
machinery as a rule: flatten a maximal INNER/CROSS join cluster (with
the Filter above it, when present) into leaves + conjuncts, push
single-leaf conjuncts into their leaf, and rebuild a left-deep spine.
Two orderers share the expansion cost model (|A><B| ~ |A|*|B| /
max key NDV — cost/JoinStatsRule): exhaustive DP over connected
subsets when the cluster has at most ``ctx.dp_limit`` leaves (the
IterativeOptimizer's ``dp_limit``, 6 by default; JoinEnumerator's
memoized search, minimizing the sum of intermediate output estimates),
and the legacy greedy otherwise.

Unlike the legacy pass, leaves are NOT recursively rewritten here — the
driver explores nested groups with the same rule set; to keep a cluster
from being re-flattened at every nested join group, a firing records the
repr of every join subtree it produced and the rule skips those."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ....sql.ir import Call, InputRef, RowExpression
from ....spi.types import BOOLEAN
from ...optimizer import (
    _channel_ndv,
    _choose_distribution,
    _conjoin,
    _exprs_as_channels,
    _hoist_common_or,
    _refs,
    _remap_leaf_to_spine,
    _remap_to_leaf,
    _restore_layout,
    _shift,
    _single_leaf,
    _split_and,
    estimate_rows,
)
from ...plan import Filter, Join, PlanNode
from ..pattern import Pattern
from ..rule import Context, Rule

__all__ = ["DetermineJoinDistribution", "ReorderJoins"]


def _inner_join(n: PlanNode) -> bool:
    return isinstance(n, Join) and n.join_type in ("CROSS", "INNER")


def _cluster_top(n: PlanNode, ctx: Context) -> bool:
    if _inner_join(n):
        return True
    return isinstance(n, Filter) and _inner_join(ctx.resolve(n.source))


def _flatten_cluster(node: PlanNode):
    """Legacy _flatten without the recursive leaf rewrite: leaves stay
    whatever subtree the memo holds there (Filters included)."""
    leaves: list[tuple[PlanNode, int]] = []
    conjuncts: list[RowExpression] = []

    def go(n: PlanNode, offset: int) -> int:
        if _inner_join(n):
            lw = go(n.left, offset)
            rw = go(n.right, offset + lw)
            for lk, rk in zip(n.left_keys, n.right_keys):
                conjuncts.append(Call(BOOLEAN, "eq", (
                    InputRef(n.left.output_types[lk], offset + lk),
                    InputRef(n.right.output_types[rk], offset + lw + rk))))
            if n.residual is not None:
                conjuncts.append(_shift(n.residual, offset))
            return lw + rw
        leaves.append((n, offset))
        return len(n.output_types)

    total = go(node, 0)
    return leaves, conjuncts, total


def _dp_order(n: int, est: list[float], edges, out_est) -> list[int]:
    """Exhaustive left-deep enumeration: minimize the sum of intermediate
    join-output estimates PLUS build-side inputs, extending
    connected-first (cross joins only when nothing connects, like the
    greedy).  Charging each step for the relation it hashes is what keeps
    a big table from becoming a "cheap" build under a tiny probe spine —
    output estimates alone are orientation-blind (a 300-row spine probing
    a 24k-row build scores the same output as the reverse, but builds 80x
    the hash table, broadcast-replicated per task).  Deterministic
    tie-break on the order tuple."""
    # frozenset -> (cost, spine_est, order)
    best: dict[frozenset, tuple[float, float, tuple[int, ...]]] = {
        frozenset((i,)): (0.0, max(est[i], 1.0), (i,)) for i in range(n)
    }
    for _ in range(n - 1):
        nxt: dict[frozenset, tuple[float, float, tuple[int, ...]]] = {}
        for state, (cost, spine_est, order) in best.items():
            if len(order) != len(state):
                continue
            rest = [i for i in range(n) if i not in state]
            connected = [i for i in rest
                         if any((a in state and b == i)
                                or (b in state and a == i)
                                for (a, b, _, _) in edges)]
            for i in (connected or rest):
                oe = out_est(state, spine_est, i, bool(connected))
                cand = (cost + oe + max(est[i], 1.0), max(oe, 1.0),
                        order + (i,))
                ns = state | {i}
                cur = nxt.get(ns)
                if cur is None or (cand[0], cand[2]) < (cur[0], cur[2]):
                    nxt[ns] = cand
        best = nxt
    (_, _, order), = best.values() if len(best) == 1 else [
        min(best.values(), key=lambda v: (v[0], v[2]))]
    return list(order)


def _greedy_order(n: int, est: list[float], edges, out_est) -> list[int]:
    """The legacy greedy: spine = largest relation, then repeatedly the
    connected relation with the smallest estimated join output."""
    order = [max(range(n), key=lambda i: est[i])]
    remaining = set(range(n)) - set(order)
    spine_est = est[order[0]]
    while remaining:
        state = frozenset(order)
        connected = [i for i in sorted(remaining)
                     if any((a in state and b == i) or (b in state and a == i)
                            for (a, b, _, _) in edges)]
        if connected:
            outs = {i: out_est(state, spine_est, i, True) for i in connected}
            pick = min(connected, key=lambda i: (outs[i], est[i]))
            spine_est = max(outs[pick], 1.0)
        else:
            pick = min(remaining, key=lambda i: est[i])
            spine_est = spine_est * max(est[pick], 1.0)
        order.append(pick)
        remaining.discard(pick)
    return order


def _reorder_cluster(tree: PlanNode, ctx: Context) -> Optional[PlanNode]:
    catalog, history = ctx.catalog, ctx.history
    if isinstance(tree, Filter):
        cluster_root = tree.source
        preds = [p for c in _split_and(tree.predicate)
                 for p in _hoist_common_or(c)]
    else:
        cluster_root = tree
        preds = []
    if not _inner_join(cluster_root):
        return None

    leaves, conjuncts, total_width = _flatten_cluster(cluster_root)
    conjuncts = conjuncts + preds

    chan_leaf: dict[int, tuple[int, int]] = {}
    for li, (leaf, offset) in enumerate(leaves):
        for local in range(len(leaf.output_types)):
            chan_leaf[offset + local] = (li, local)

    leaf_nodes = [leaf for (leaf, _) in leaves]
    leaf_filters: list[list[RowExpression]] = [[] for _ in leaves]
    edges: list[tuple[int, int, RowExpression, RowExpression]] = []
    residual: list[RowExpression] = []
    for c in conjuncts:
        involved = {chan_leaf[i][0] for i in _refs(c)}
        if len(involved) == 1:
            li = involved.pop()
            leaf_filters[li].append(_remap_to_leaf(c, chan_leaf, li))
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

    est = [estimate_rows(l, catalog, history) for l in leaf_nodes]

    ndv_cache: dict[tuple[int, int], Optional[float]] = {}

    def _leaf_ndv(leaf: int, expr) -> Optional[float]:
        if not isinstance(expr, InputRef):
            return None
        key = (leaf, expr.index)
        if key not in ndv_cache:
            ndv_cache[key] = _channel_ndv(leaf_nodes[leaf], expr.index,
                                          catalog)
        return ndv_cache[key]

    def out_est(state: frozenset, spine_est: float, i: int,
                connected: bool) -> float:
        if not connected:
            return spine_est * max(est[i], 1.0)
        best: Optional[float] = None
        for (a, b, ea, eb) in edges:
            if a in state and b == i:
                se, ce, sl = ea, eb, a
            elif b in state and a == i:
                se, ce, sl = eb, ea, b
            else:
                continue
            nd = max((x for x in (_leaf_ndv(i, ce), _leaf_ndv(sl, se))
                      if x), default=None)
            if nd:
                best = max(best or 0.0, nd)
        if best:
            return spine_est * est[i] / max(best, 1.0)
        return max(spine_est, est[i])  # keyed, unknown NDV: PK-FK-ish

    n = len(leaf_nodes)
    if 3 <= n <= ctx.dp_limit:
        order = _dp_order(n, est, edges, out_est)
    else:
        order = _greedy_order(n, est, edges, out_est)

    # build the tree left-deep; (leaf idx, local ch) -> spine ch
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
            lkeys.append(_remap_leaf_to_spine(sa, a, pos))
            rkeys.append(rb)
        lch, spine = _exprs_as_channels(lkeys, spine)
        rch, right = _exprs_as_channels(rkeys, right)
        names = tuple(spine.output_names) + tuple(right.output_names)
        types = tuple(spine.output_types) + tuple(right.output_types)
        sw = len(spine.output_types)
        jt = "INNER" if lch else "CROSS"
        spine = Join(names, types, spine, right, jt, tuple(lch), tuple(rch),
                     None,
                     distribution=_choose_distribution(right, catalog,
                                                       "INNER", history))
        for i in range(len(right.output_types)):
            pos[(li, i)] = sw + i

    if residual:
        def remap_residual(e: RowExpression) -> RowExpression:
            if isinstance(e, InputRef):
                li, local = chan_leaf[e.index]
                return InputRef(e.type, pos[(li, local)])
            if isinstance(e, Call):
                return Call(e.type, e.name,
                            tuple(remap_residual(a) for a in e.args))
            return e
        spine = Filter(spine.output_names, spine.output_types, spine,
                       _conjoin([remap_residual(r) for r in residual]))

    mapping = [pos[chan_leaf[i]] for i in range(total_width)]
    if mapping != list(range(len(tree.output_types))) \
            or tuple(spine.output_names) != tuple(tree.output_names):
        spine = _restore_layout(spine, mapping, tree)
    return spine


def _record_subtrees(node: PlanNode, seen: set) -> None:
    """Mark every join subtree (and the Filter atop one) of a rebuilt
    cluster so nested groups don't get re-flattened."""
    if isinstance(node, (Filter, Join)):
        seen.add(repr(node))
    for c in node.children:
        _record_subtrees(c, seen)


class ReorderJoins(Rule):
    pattern = Pattern((Filter, Join)).matching(_cluster_top)

    def apply(self, node: PlanNode, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        tree = ctx.extract(node)
        key = repr(tree)
        if key in ctx.reordered:
            return None
        out = _reorder_cluster(tree, ctx)
        ctx.reordered.add(key)
        if out is None:
            return None
        _record_subtrees(out, ctx.reordered)
        if out == tree:
            return None
        return out


class DetermineJoinDistribution(Rule):
    """Pick BROADCAST vs PARTITIONED for non-reorderable joins from the
    build side's estimate — ReorderJoins already decides for the
    INNER/CROSS spines it builds."""

    pattern = Pattern(Join).matching(
        lambda n, ctx: n.join_type not in ("INNER", "CROSS"))

    def apply(self, node: Join, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        build = ctx.extract(node.right)
        dist = _choose_distribution(build, ctx.catalog, node.join_type,
                                    ctx.history)
        if dist == node.distribution:
            return None
        return replace(node, distribution=dist)
