"""AST -> logical plan.

The role of sql/planner/LogicalPlanner + QueryPlanner/RelationPlanner
(reference: sql/planner/LogicalPlanner.java:237 ``plan``, QueryPlanner.java,
RelationPlanner.java) including subquery planning: correlated scalar
aggregates, EXISTS and IN become joins/semi-joins here (Trino models them as
ApplyNode + TransformCorrelated* rules; we decorrelate directly while
translating, producing the same join shapes).

Channel discipline: every relation's fields map 1:1 to its plan node's output
channels; appends (subquery marks, scalar results) only ever add channels on
the right, so previously translated IR stays valid.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..connectors.catalog import Catalog
from ..spi.types import BIGINT, BOOLEAN, Type, UNKNOWN
from ..sql import ast
from ..sql.analyzer import (
    AGG_FUNCTIONS,
    AggregateCollector,
    AnalysisError,
    Field,
    Scope,
    Translator,
    WindowCollector,
    agg_result_type,
    cast_to,
    rewrite_expr,
    split_conjuncts,
)
from ..sql.ir import Call, InputRef, Literal, OuterRef, RowExpression, walk
from .plan import (
    AggCall,
    Aggregate,
    CorrelatedJoin,
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
    SortKey,
    TableFunctionScan,
    TableScan,
    TableWriter,
    TopN,
    Union,
    Unnest,
    Values,
    Window,
    WindowFunc,
)

__all__ = ["LogicalPlanner", "RelationPlan"]


@dataclass
class RelationPlan:
    node: PlanNode
    qualifiers: list[Optional[str]]

    def scope(self, parent: Optional[Scope] = None) -> Scope:
        return Scope(
            [
                Field(n, t, q)
                for n, t, q in zip(
                    self.node.output_names, self.node.output_types, self.qualifiers
                )
            ],
            parent,
        )

    @property
    def width(self) -> int:
        return len(self.node.output_names)

    def append(self, exprs: list[RowExpression], names: list[str],
               quals: Optional[list[Optional[str]]] = None) -> "RelationPlan":
        """Identity projection plus extra computed channels on the right."""
        base = [
            InputRef(t, i) for i, t in enumerate(self.node.output_types)
        ]
        node = Project(
            tuple(self.node.output_names) + tuple(names),
            tuple(self.node.output_types) + tuple(e.type for e in exprs),
            self.node,
            tuple(base + exprs),
        )
        return RelationPlan(node, self.qualifiers + (quals or [None] * len(exprs)))


def _has_outer(e: RowExpression, level: int = 1) -> bool:
    return any(isinstance(x, OuterRef) and x.level >= level for x in walk(e))


def _shift_outer(e: RowExpression, by: int = -1) -> RowExpression:
    """Decrement OuterRef levels (when an expression moves one scope out)."""
    if isinstance(e, OuterRef):
        if e.level + by <= 0:
            return InputRef(e.type, e.index)
        return OuterRef(e.type, e.index, e.level + by)
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(_shift_outer(a, by) for a in e.args))
    return e


def _shift_inputs(e: RowExpression, by: int) -> RowExpression:
    if isinstance(e, InputRef):
        return InputRef(e.type, e.index + by)
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(_shift_inputs(a, by) for a in e.args))
    return e


def _conjoin(terms: list[RowExpression]) -> Optional[RowExpression]:
    terms = [t for t in terms if t is not None]
    if not terms:
        return None
    if len(terms) == 1:
        return terms[0]
    return Call(BOOLEAN, "$and", tuple(terms))


class LogicalPlanner:
    """``optimizer`` is the mode the plan will be optimized in: under
    ``iterative`` correlated IN and scalar-aggregate subqueries become
    CorrelatedJoin placeholders for the decorrelation rules; under
    ``legacy`` they become the SemiJoin / LEFT Join those rules emit."""

    def __init__(self, catalog: Catalog, default_catalog: str = "tpch",
                 optimizer: str = "iterative"):
        self.catalog = catalog
        self.default_catalog = default_catalog
        self.optimizer = optimizer
        self._view_stack: set[str] = set()  # cycle detection for view inlining

    # ------------------------------------------------------------------ api
    def plan(self, stmt: ast.Statement) -> PlanNode:
        from ..sql.analyzer import SQL_FUNCTIONS

        SQL_FUNCTIONS.set(getattr(self.catalog, "sql_functions", {}))
        if isinstance(stmt, ast.QueryStatement):
            rel = self.plan_query(stmt.query, None, {})
            return Output(self.node_names(rel), rel.node.output_types, rel.node)
        if isinstance(stmt, ast.CreateTableAsSelect) or isinstance(stmt, ast.InsertInto):
            rel = self.plan_query(stmt.query, None, {})
            cat, table = self._split_table_name(stmt.table)
            writer = TableWriter(("rows",), (BIGINT,), rel.node, cat, table)
            return Output(("rows",), (BIGINT,), writer)
        raise AnalysisError(f"unsupported statement: {type(stmt).__name__}")

    def node_names(self, rel: RelationPlan) -> tuple[str, ...]:
        return tuple(rel.node.output_names)

    def _split_table_name(self, name: str) -> tuple[str, str]:
        parts = name.split(".")
        if len(parts) == 1:
            return self.default_catalog, parts[0]
        return parts[0], parts[-1]

    # ---------------------------------------------------------------- query
    def plan_query(self, q: ast.Query, outer: Optional[Scope],
                   ctes: dict[str, ast.Query]) -> RelationPlan:
        ctes = dict(ctes)
        for w in q.with_:
            if w.column_names:
                ctes[w.name] = replace(
                    w.query, body=_alias_body(w.query.body, w.column_names))
            else:
                ctes[w.name] = w.query
        rel, select_irs = self.plan_body(q.body, outer, ctes)

        # ORDER BY / LIMIT over the projected relation.  Keys not in the
        # select list become hidden channels appended to the projection and
        # pruned after the sort (Trino: QueryPlanner orderingScheme over
        # hidden symbols; SELECT DISTINCT forbids them per spec).
        if q.order_by:
            keys = []
            hidden: list[RowExpression] = []
            for item in q.order_by:
                try:
                    ch = self._order_channel(
                        item.expr, q.body, rel, select_irs, outer, ctes)
                except AnalysisError:
                    tr = self._select_context_translator(q.body, outer, ctes)
                    if tr is None:
                        raise
                    if isinstance(rel.node, Aggregate):
                        raise AnalysisError(
                            "for SELECT DISTINCT, ORDER BY expressions must "
                            f"appear in select list: {item.expr}")
                    hidden.append(tr(item.expr))
                    ch = -len(hidden)  # placeholder, resolved below
                nf = item.nulls_first
                if nf is None:
                    nf = not item.ascending  # SQL default: NULLS LAST asc
                keys.append(SortKey(ch, item.ascending, nf))
            base_width = rel.width
            if hidden:
                proj = rel.node
                if not isinstance(proj, Project):
                    raise AnalysisError(
                        f"ORDER BY expression not in select list: {q.order_by}")
                ext = Project(
                    tuple(proj.output_names) + tuple(
                        f"_ord{i}" for i in range(len(hidden))),
                    tuple(proj.output_types) + tuple(e.type for e in hidden),
                    proj.source,
                    tuple(proj.expressions) + tuple(hidden))
                rel = RelationPlan(ext, rel.qualifiers + [None] * len(hidden))
                keys = [
                    k if k.channel >= 0 else
                    SortKey(base_width + (-k.channel - 1), k.ascending,
                            k.nulls_first)
                    for k in keys
                ]
            if q.limit is not None:
                node = TopN(rel.node.output_names, rel.node.output_types,
                            rel.node, q.limit, tuple(keys))
            else:
                node = Sort(rel.node.output_names, rel.node.output_types,
                            rel.node, tuple(keys))
            rel = RelationPlan(node, rel.qualifiers)
            if hidden:  # prune the hidden sort channels
                prune = Project(
                    tuple(node.output_names[:base_width]),
                    tuple(node.output_types[:base_width]),
                    node,
                    tuple(InputRef(node.output_types[i], i)
                          for i in range(base_width)))
                rel = RelationPlan(prune, rel.qualifiers[:base_width])
        elif q.limit is not None:
            rel = RelationPlan(
                Limit(rel.node.output_names, rel.node.output_types, rel.node, q.limit),
                rel.qualifiers,
            )
        return rel

    def _order_channel(self, e: ast.Expr, spec: ast.QuerySpec, rel: RelationPlan,
                       select_irs: list[RowExpression], outer, ctes) -> int:
        # 1) name matches a select alias/output name
        if isinstance(e, ast.ColumnRef) and len(e.parts) == 1:
            names = rel.node.output_names
            if names.count(e.parts[0]) == 1:
                return names.index(e.parts[0])
        # 2) expression equal to a select item (translated in the same context)
        if isinstance(e, ast.IntLiteral):  # ORDER BY ordinal
            if 1 <= e.value <= len(select_irs):
                return e.value - 1
        tr = self._select_context_translator(spec, outer, ctes)
        if tr is not None:
            try:
                ir = tr(e)
            except AnalysisError:
                ir = None
            if ir is not None and ir in select_irs:
                return select_irs.index(ir)
        raise AnalysisError(f"ORDER BY expression not in select list: {e}")

    def _select_context_translator(self, spec, outer, ctes):
        ctx = getattr(self, "_last_select_ctx", None)
        if ctx is None or ctx[0] is not spec:
            return None
        _, translate = ctx
        return translate

    # ----------------------------------------------------------------- body
    def plan_body(self, body: ast.QueryBody, outer: Optional[Scope],
                  ctes: dict[str, ast.Query]) -> tuple[RelationPlan, list[RowExpression]]:
        if isinstance(body, ast.QuerySpec):
            return self.plan_spec(body, outer, ctes)
        if isinstance(body, ast.Query):  # parenthesized query term
            rel = self.plan_query(body, outer, ctes)
            return rel, [InputRef(t, i)
                         for i, t in enumerate(rel.node.output_types)]
        if isinstance(body, ast.SetOp):
            rel = self.plan_setop(body, outer, ctes)
            return rel, [InputRef(t, i)
                         for i, t in enumerate(rel.node.output_types)]
        if isinstance(body, ast.ValuesBody):
            rel = self.plan_values(body, outer, ctes)
            return rel, [InputRef(t, i)
                         for i, t in enumerate(rel.node.output_types)]
        raise AnalysisError(f"unsupported query body: {type(body).__name__}")

    def plan_values(self, body: ast.ValuesBody, outer, ctes) -> RelationPlan:
        """VALUES rows (reference: sql/tree/Values.java -> ValuesNode).
        Literal rows build a Values node directly; rows with computed
        expressions desugar to a UNION ALL of FROM-less selects."""
        width = len(body.rows[0])
        for row in body.rows:
            if len(row) != width:
                raise AnalysisError("VALUES rows have different column counts")
        dummy = RelationPlan(
            Values(("_row",), (BIGINT,), rows=((0,),)), [None])
        tr = Translator(dummy.scope(outer))
        rows_ir = [[tr.translate(e) for e in row] for row in body.rows]
        if all(isinstance(e, Literal) for r in rows_ir for e in r):
            from ..spi.types import common_super_type

            types: list[Type] = list(e.type for e in rows_ir[0])
            for r in rows_ir[1:]:
                for i in range(width):
                    c = common_super_type(types[i], r[i].type)
                    if c is None:
                        raise AnalysisError(
                            f"VALUES column {i + 1} type mismatch: "
                            f"{types[i]} vs {r[i].type}")
                    types[i] = c
            if any(t == UNKNOWN for t in types):
                raise AnalysisError(
                    "VALUES column is entirely NULL; add a CAST")
            names = tuple(f"_col{i}" for i in range(width))
            rows = tuple(tuple(e.value for e in r) for r in rows_ir)
            return RelationPlan(Values(names, tuple(types), rows),
                                [None] * width)
        # computed expressions: UNION ALL of single-row selects (plan_setop
        # performs the per-column coercions)
        def spec_of(row) -> ast.QueryBody:
            return ast.QuerySpec(tuple(ast.SelectItem(e) for e in row))

        acc: ast.QueryBody = spec_of(body.rows[0])
        for row in body.rows[1:]:
            acc = ast.SetOp("UNION", False, acc, spec_of(row))
        return self.plan_body(acc, outer, ctes)[0]

    def plan_setop(self, op: ast.SetOp, outer, ctes) -> RelationPlan:
        """UNION/INTERSECT/EXCEPT (reference: sql/planner/plan/
        SetOperationNode.java lowered per SetOperationNodeTranslator):
        UNION ALL -> Union; the distinct variants -> Union of marker-tagged
        inputs + group-by-all-channels counting each side + Filter.  Group-
        based lowering gives SQL set semantics (NULLs compare equal) for
        free because the grouping kernel treats NULL as one group."""
        left = self.plan_body(op.left, outer, ctes)[0]
        right = self.plan_body(op.right, outer, ctes)[0]
        if left.width != right.width:
            raise AnalysisError(
                f"{op.op} inputs have different column counts: "
                f"{left.width} vs {right.width}")
        from ..spi.types import common_super_type

        types = []
        for i, (lt, rt) in enumerate(zip(left.node.output_types,
                                         right.node.output_types)):
            c = common_super_type(lt, rt)
            if c is None:
                raise AnalysisError(
                    f"{op.op} column {i + 1} type mismatch: {lt} vs {rt}")
            types.append(c)
        names = tuple(left.node.output_names)
        sides = [_cast_side(left, types), _cast_side(right, types)]

        if op.op == "UNION":
            un = Union(names, tuple(types), tuple(s.node for s in sides))
            rel = RelationPlan(un, [None] * len(names))
            if op.distinct:
                agg = Aggregate(un.output_names, un.output_types, un,
                                tuple(range(len(names))), ())
                rel = RelationPlan(agg, [None] * len(names))
            return rel

        # INTERSECT / EXCEPT [ALL]: tag each side, count per group.  The
        # DISTINCT variants filter on the counts; the ALL variants replicate
        # each group min(l,r) / max(l-r, 0) times (multiset semantics).
        w = len(names)
        tagged = []
        for si, s in enumerate(sides):
            marks = [Literal(BIGINT, 1 if si == 0 else 0),
                     Literal(BIGINT, 1 if si == 1 else 0)]
            tagged.append(s.append(marks, ["_l", "_r"]).node)
        un = Union(names + ("_l", "_r"), tuple(types) + (BIGINT, BIGINT),
                   tuple(tagged))
        aggs = (AggCall("sum", w, BIGINT), AggCall("sum", w + 1, BIGINT))
        agg = Aggregate(names + ("_lc", "_rc"), tuple(types) + (BIGINT, BIGINT),
                        un, tuple(range(w)), aggs)
        lc = InputRef(BIGINT, w)
        rc = InputRef(BIGINT, w + 1)
        zero = Literal(BIGINT, 0)
        if not op.distinct:
            if op.op == "INTERSECT":
                count_ir = Call(BIGINT, "least", (lc, rc))
            else:  # EXCEPT ALL
                count_ir = Call(BIGINT, "greatest",
                                (Call(BIGINT, "subtract", (lc, rc)), zero))
            counted = Project(
                names + ("_n",), tuple(types) + (BIGINT,), agg,
                tuple(InputRef(t, i) for i, t in enumerate(types))
                + (count_ir,))
            repl = Replicate(counted.output_names, counted.output_types,
                             counted, w)
            proj = Project(names, tuple(types), repl,
                           tuple(InputRef(t, i) for i, t in enumerate(types)))
            return RelationPlan(proj, [None] * len(names))
        if op.op == "INTERSECT":
            pred = Call(BOOLEAN, "$and", (Call(BOOLEAN, "gt", (lc, zero)),
                                          Call(BOOLEAN, "gt", (rc, zero))))
        else:  # EXCEPT
            pred = Call(BOOLEAN, "$and", (Call(BOOLEAN, "gt", (lc, zero)),
                                          Call(BOOLEAN, "eq", (rc, zero))))
        filt = Filter(agg.output_names, agg.output_types, agg, pred)
        proj = Project(names, tuple(types), filt,
                       tuple(InputRef(t, i) for i, t in enumerate(types)))
        return RelationPlan(proj, [None] * len(names))

    # ----------------------------------------------------------------- spec
    def plan_spec(self, spec: ast.QuerySpec, outer: Optional[Scope],
                  ctes: dict[str, ast.Query]) -> tuple[RelationPlan, list[RowExpression]]:
        # FROM-less SELECT evaluates over one synthetic row (the reference
        # plans a single-row ValuesNode); the dummy channel is invisible to
        # SELECT * via star_width=0
        rel = (self.plan_relation(spec.from_, outer, ctes)
               if spec.from_ is not None
               else RelationPlan(Values(("_row",), (BIGINT,), rows=((0,),)), [None]))
        # capture the user-visible fields now: WHERE subquery handling appends
        # synthetic channels (_mark/_scalar/_key) that SELECT * must not see
        star_width = rel.width if spec.from_ is not None else 0

        # WHERE: plain conjuncts first (push down), then subquery conjuncts
        if spec.where is not None:
            conjuncts = split_conjuncts(spec.where)
            plain = [c for c in conjuncts if not _contains_subquery(c)]
            subq = [c for c in conjuncts if _contains_subquery(c)]
            if plain:
                tr = Translator(rel.scope(outer))
                pred = _conjoin([cast_to(tr.translate(c), BOOLEAN) for c in plain])
                rel = RelationPlan(
                    Filter(rel.node.output_names, rel.node.output_types, rel.node, pred),
                    rel.qualifiers,
                )
            for c in subq:
                rel = self._plan_subquery_conjunct(rel, c, outer, ctes)

        has_group = bool(spec.group_by)
        collector = AggregateCollector()
        wcollector = WindowCollector()
        rewrite: dict[RowExpression, RowExpression] = {}
        scope = rel.scope(outer)
        tr = Translator(scope, aggregates=collector, windows=wcollector)
        select_items = self._expand_stars(spec, rel, star_width)
        select_irs = [tr.translate(it.expr) for it in select_items]
        having_ir = None
        having_subqueries: list[tuple[ast.Expr, RelationPlan]] = []
        if spec.having is not None:
            # two-phase: translate now against the pre-agg scope (collecting
            # aggregates); subqueries become $subq markers planned standalone
            # for their type, attached above the Aggregate afterwards
            def stash_cb(node: ast.Expr) -> RowExpression:
                if isinstance(node, ast.ScalarSubquery):
                    sub = self.plan_query(node.query, None, ctes)
                    if sub.width != 1:
                        raise AnalysisError("scalar subquery must return one column")
                    having_subqueries.append((node, sub))
                    return Call(sub.node.output_types[0], "$subq",
                                (Literal(BIGINT, len(having_subqueries) - 1),))
                raise AnalysisError(
                    f"unsupported subquery in HAVING: {type(node).__name__}")

            htr = Translator(scope, aggregates=collector, subquery_cb=stash_cb)
            having_ir = _conjoin(
                [cast_to(htr.translate(c), BOOLEAN)
                 for c in split_conjuncts(spec.having)])

        has_aggs = bool(collector.calls)
        covered_check = None
        gs_ctx = None  # (group_irs, set_list, gid channel or None)
        if has_group or has_aggs:
            group_irs, set_list = self._expand_grouping(
                spec.group_by, select_items, rel, outer)
            grouping_calls = [
                x for e in (select_irs + ([having_ir] if having_ir is not None else []))
                for x in walk(e)
                if isinstance(x, Call) and x.name == "$grouping"]
            if len(set_list) > 1 or grouping_calls:
                rel, rewrite, gid_ch = self._plan_grouping_sets(
                    rel, group_irs, set_list, collector, outer)
                rewrite.update(self._grouping_mask_rewrites(
                    grouping_calls, group_irs, set_list, gid_ch))
                gs_ctx = (group_irs, set_list, gid_ch)
            else:
                rel, rewrite = self._plan_aggregation(
                    rel, group_irs, collector, outer)
                gs_ctx = (group_irs, set_list, None)

            # validate BEFORE rewriting: every select subtree must be a
            # group-by expression, an aggregate placeholder, or composed of
            # those — a surviving bare InputRef references a pre-agg channel
            def covered(e: RowExpression) -> bool:
                if e in rewrite or isinstance(e, Literal):
                    return True
                if isinstance(e, Call):
                    return all(covered(a) for a in e.args)
                return False

            covered_check = covered
            for it, e in zip(select_items, select_irs):
                if not covered(e):
                    raise AnalysisError(
                        f"'{it.expr}' must be an aggregate expression or "
                        "appear in GROUP BY clause")
            select_irs = [rewrite_expr(e, rewrite) for e in select_irs]
            if having_ir is not None:
                having_ir = rewrite_expr(having_ir, rewrite)
                # attach stashed HAVING subqueries above the Aggregate
                for i, (node, sub) in enumerate(having_subqueries):
                    names = tuple(rel.node.output_names) + (f"_scalar{rel.width}",)
                    types = tuple(rel.node.output_types) + (sub.node.output_types[0],)
                    jn = Join(names, types, rel.node, sub.node, "SINGLE", (), (), None)
                    rel = RelationPlan(jn, rel.qualifiers + [None])
                    marker = Call(sub.node.output_types[0], "$subq",
                                  (Literal(BIGINT, i),))
                    having_ir = rewrite_expr(
                        having_ir,
                        {marker: InputRef(types[-1], rel.width - 1)})
                rel = RelationPlan(
                    Filter(rel.node.output_names, rel.node.output_types,
                           rel.node, having_ir),
                    rel.qualifiers,
                )
        elif spec.having is not None:
            raise AnalysisError("HAVING requires aggregation")

        # window functions: evaluated after aggregation/HAVING, before
        # DISTINCT and ORDER BY (reference: sql/planner/QueryPlanner window
        # planning order)
        win_rewrite: dict[RowExpression, RowExpression] = {}
        if wcollector.calls:
            rel, win_rewrite = self._plan_windows(
                rel, wcollector, rewrite,
                require_covered=(has_group or has_aggs))
            select_irs = [rewrite_expr(e, win_rewrite) for e in select_irs]

        # SELECT projection
        names = []
        for i, it in enumerate(select_items):
            if it.alias:
                names.append(it.alias)
            elif isinstance(it.expr, ast.ColumnRef):
                names.append(it.expr.parts[-1])
            else:
                names.append(f"_col{i}")
        proj = Project(tuple(names), tuple(e.type for e in select_irs),
                       rel.node, tuple(select_irs))
        out = RelationPlan(proj, [None] * len(names))
        if spec.distinct:
            agg = Aggregate(proj.output_names, proj.output_types, proj,
                            tuple(range(len(names))), ())
            out = RelationPlan(agg, [None] * len(names))

        # stash context for ORDER BY expression matching.  ORDER BY hidden
        # channels run through the same coverage validation as select items:
        # an uncovered pre-aggregation reference must error, never silently
        # index a post-aggregation channel.
        planned_agg_count = len(collector.calls)

        def translate_in_select_ctx(e: ast.Expr) -> RowExpression:
            t = Translator(scope, aggregates=collector, windows=wcollector)
            ir = t.translate(e)
            if len(collector.calls) != planned_agg_count:
                raise AnalysisError(
                    f"ORDER BY aggregate not in select list: {e}")
            if has_group or has_aggs:
                # ORDER BY may carry grouping() calls not present in the
                # select list: give them the same $grouping_mask rewrite
                extra: dict = {}
                gcalls = [x for x in walk(ir)
                          if isinstance(x, Call) and x.name == "$grouping"]
                if gcalls:
                    g_irs, s_list, gid = gs_ctx
                    if gid is None:
                        # single grouping set: grouping() is constant 0
                        for x in gcalls:
                            for a in x.args:
                                if a not in g_irs:
                                    raise AnalysisError(
                                        "grouping() arguments must appear "
                                        "in GROUP BY")
                            extra[x] = Literal(BIGINT, 0)
                    else:
                        extra = self._grouping_mask_rewrites(
                            gcalls, g_irs, s_list, gid)
                if covered_check is not None and not covered_check(ir):
                    raise AnalysisError(
                        f"'{e}' must be an aggregate expression or appear "
                        "in GROUP BY clause")
                ir = rewrite_expr(ir, {**rewrite, **extra})
            if win_rewrite:
                ir = rewrite_expr(ir, win_rewrite)
            return ir

        self._last_select_ctx = (spec, translate_in_select_ctx)
        return out, select_irs

    def _expand_stars(self, spec: ast.QuerySpec, rel: RelationPlan,
                      star_width: int) -> list[ast.SelectItem]:
        out = []
        for it in spec.select:
            if it.expr is not None:
                out.append(it)
                continue
            for name, qual in list(zip(rel.node.output_names, rel.qualifiers))[:star_width]:
                if it.star_prefix is None or it.star_prefix == qual:
                    out.append(ast.SelectItem(ast.ColumnRef((name,)), None))
        if not out:
            raise AnalysisError("SELECT * matched no columns")
        return out

    # ---------------------------------------------------------- aggregation
    def _plan_aggregation(self, rel: RelationPlan, group_irs, collector, outer):
        """Pre-project group keys + agg args, emit Aggregate, return rewrite
        map for post-agg expressions."""
        pre_exprs: list[RowExpression] = []
        pre_names: list[str] = []

        def channel_of(e: RowExpression) -> int:
            if isinstance(e, InputRef):
                return e.index
            for j, pe in enumerate(pre_exprs):
                if pe == e:
                    return rel.width + j
            pre_exprs.append(e)
            pre_names.append(f"_expr{len(pre_exprs)}")
            return rel.width + len(pre_exprs) - 1

        key_channels = [channel_of(g) for g in group_irs]
        agg_calls = []
        for fn, arg, distinct, out_t in collector.calls:
            ch = channel_of(arg) if arg is not None else -1
            agg_calls.append(AggCall(fn, ch, out_t, distinct))
        src = rel
        if pre_exprs:
            src = rel.append(pre_exprs, pre_names)
        names = tuple(
            [src.node.output_names[c] for c in key_channels]
            + [f"_agg{j}" for j in range(len(agg_calls))]
        )
        types = tuple(
            [src.node.output_types[c] for c in key_channels]
            + [a.type for a in agg_calls]
        )
        agg = Aggregate(names, types, src.node, tuple(key_channels), tuple(agg_calls))
        quals = [src.qualifiers[c] for c in key_channels] + [None] * len(agg_calls)
        out = RelationPlan(agg, quals)
        rewrite: dict[RowExpression, RowExpression] = {}
        for i, g in enumerate(group_irs):
            rewrite[g] = InputRef(g.type, i)
        for j, (fn, arg, distinct, out_t) in enumerate(collector.calls):
            placeholder = Call(out_t, "$aggref", (Literal(BIGINT, j),))
            rewrite[placeholder] = InputRef(out_t, len(key_channels) + j)
        return out, rewrite

    # ------------------------------------------------------- grouping sets
    def _expand_grouping(self, group_by, select_items, rel, outer):
        """Expand GROUP BY elements (exprs, ROLLUP, CUBE, GROUPING SETS) into
        (group_irs, sets): the ordered distinct grouping columns as IR, and
        one tuple of column indices per grouping set.  Multiple elements
        combine by cross product (SQL:2016 7.9; reference:
        StatementAnalyzer.analyzeGroupBy computing the set product)."""

        def resolve(g: ast.Expr) -> ast.Expr:
            # GROUP BY <ordinal> resolves to the select item's expression
            if isinstance(g, ast.IntLiteral):
                if not 1 <= g.value <= len(select_items):
                    raise AnalysisError(
                        f"GROUP BY position {g.value} is not in select list")
                return select_items[g.value - 1].expr
            return g

        element_sets: list[list[tuple[ast.Expr, ...]]] = []
        for el in group_by:
            if isinstance(el, ast.Rollup):
                exprs = [resolve(e) for e in el.exprs]
                element_sets.append(
                    [tuple(exprs[:k]) for k in range(len(exprs), -1, -1)])
            elif isinstance(el, ast.Cube):
                exprs = [resolve(e) for e in el.exprs]
                subsets = [
                    tuple(e for i, e in enumerate(exprs) if mask & (1 << i))
                    for mask in range(1 << len(exprs))]
                subsets.sort(key=len, reverse=True)
                element_sets.append(subsets)
            elif isinstance(el, ast.GroupingSets):
                element_sets.append(
                    [tuple(resolve(e) for e in s) for s in el.sets])
            else:
                element_sets.append([(resolve(el),)])
        combined: list[tuple[ast.Expr, ...]] = [()]
        for sets in element_sets:
            combined = [c + s for c in combined for s in sets]

        tr = Translator(rel.scope(outer))
        group_irs: list[RowExpression] = []
        index: dict[RowExpression, int] = {}
        set_list: list[tuple[int, ...]] = []
        for s in combined:
            idxs: list[int] = []
            for e in s:
                ir = tr.translate(e)
                if ir not in index:
                    index[ir] = len(group_irs)
                    group_irs.append(ir)
                if index[ir] not in idxs:
                    idxs.append(index[ir])
            set_list.append(tuple(idxs))
        return group_irs, set_list

    def _plan_grouping_sets(self, rel, group_irs, set_list, collector, outer):
        """GroupId + Aggregate keyed on (all grouping columns, $groupid)
        (reference: sql/planner/QueryPlanner.planGroupingSets building
        GroupIdNode).  Returns (relation, rewrite, groupid channel in the
        aggregation output)."""
        pre_exprs: list[RowExpression] = []
        pre_names: list[str] = []

        def channel_of(e: RowExpression) -> int:
            if isinstance(e, InputRef):
                return e.index
            for j, pe in enumerate(pre_exprs):
                if pe == e:
                    return rel.width + j
            pre_exprs.append(e)
            pre_names.append(f"_expr{len(pre_exprs)}")
            return rel.width + len(pre_exprs) - 1

        key_channels = [channel_of(g) for g in group_irs]
        agg_specs = []
        for fn, arg, distinct, out_t in collector.calls:
            ch = channel_of(arg) if arg is not None else -1
            agg_specs.append((fn, ch, distinct, out_t))
        src = rel
        if pre_exprs:
            src = rel.append(pre_exprs, pre_names)

        # aggregation arguments pass through un-nulled copies: a grouping
        # column that is also an aggregate argument must keep its values
        pass_chs: list[int] = []
        for _, ch, _, _ in agg_specs:
            if ch >= 0 and ch not in pass_chs:
                pass_chs.append(ch)
        nk = len(key_channels)
        g_names = tuple(
            [src.node.output_names[c] for c in key_channels]
            + [src.node.output_names[c] for c in pass_chs]
            + ["$groupid"])
        g_types = tuple(
            [src.node.output_types[c] for c in key_channels]
            + [src.node.output_types[c] for c in pass_chs]
            + [BIGINT])
        gid_node = GroupId(g_names, g_types, src.node,
                           tuple(key_channels), tuple(pass_chs),
                           tuple(set_list))

        agg_calls = []
        for fn, ch, distinct, out_t in agg_specs:
            new_ch = nk + pass_chs.index(ch) if ch >= 0 else -1
            agg_calls.append(AggCall(fn, new_ch, out_t, distinct))
        gkeys = tuple(range(nk)) + (nk + len(pass_chs),)
        a_names = tuple(
            list(g_names[:nk]) + ["$groupid"]
            + [f"_agg{j}" for j in range(len(agg_calls))])
        a_types = tuple(
            list(g_types[:nk]) + [BIGINT] + [a.type for a in agg_calls])
        agg = Aggregate(a_names, a_types, gid_node, gkeys, tuple(agg_calls))
        out = RelationPlan(agg, [None] * len(a_names))
        rewrite: dict[RowExpression, RowExpression] = {}
        for i, g in enumerate(group_irs):
            rewrite[g] = InputRef(g.type, i)
        for j, (fn, arg, distinct, out_t) in enumerate(collector.calls):
            placeholder = Call(out_t, "$aggref", (Literal(BIGINT, j),))
            rewrite[placeholder] = InputRef(out_t, nk + 1 + j)
        return out, rewrite, nk

    def _grouping_mask_rewrites(self, grouping_calls, group_irs, set_list,
                                gid_ch):
        """Map each $grouping(cols…) marker onto a $grouping_mask(gid,
        mask-per-set…) gather (reference: planner/GroupingOperationRewriter:
        grouping() = bitmask of arguments absent from the row's set, first
        argument = most significant bit)."""
        out: dict[RowExpression, RowExpression] = {}
        for x in grouping_calls:
            if x in out:
                continue
            idxs = []
            for a in x.args:
                try:
                    idxs.append(group_irs.index(a))
                except ValueError:
                    raise AnalysisError(
                        "grouping() arguments must appear in GROUP BY")
            n = len(idxs)
            masks = []
            for s in set_list:
                m = 0
                for pos, gi in enumerate(idxs):
                    if gi not in s:
                        m |= 1 << (n - 1 - pos)
                masks.append(m)
            out[x] = Call(
                BIGINT, "$grouping_mask",
                tuple([InputRef(BIGINT, gid_ch)]
                      + [Literal(BIGINT, m) for m in masks]))
        return out

    # -------------------------------------------------------------- windows
    def _plan_windows(self, rel: RelationPlan, wcollector: WindowCollector,
                      agg_rewrite: dict, require_covered: bool):
        """Emit Window nodes (one per distinct (partition, order) spec so each
        gets exactly one sort) and return the $winref -> channel rewrite."""

        def covered(e: RowExpression) -> bool:
            if e in agg_rewrite or isinstance(e, Literal):
                return True
            if isinstance(e, Call):
                return all(covered(a) for a in e.args)
            return False

        def prep(e: RowExpression) -> RowExpression:
            if require_covered and not covered(e):
                raise AnalysisError(
                    f"'{e}' in window specification must be an aggregate "
                    "expression or appear in GROUP BY clause")
            return rewrite_expr(e, agg_rewrite)

        groups: dict = {}
        group_order: list = []
        for idx, spec in enumerate(wcollector.calls):
            partition = tuple(prep(p) for p in spec.partition)
            order = tuple(
                (prep(k.expr), k.ascending, k.nulls_first) for k in spec.order)
            args = tuple(prep(a) for a in spec.args)
            key = (partition, order)
            if key not in groups:
                groups[key] = []
                group_order.append(key)
            groups[key].append((idx, spec, args))

        win_rewrite: dict[RowExpression, RowExpression] = {}
        for key in group_order:
            partition, order = key
            calls = groups[key]
            pending: list[RowExpression] = []

            def channel_of(e: RowExpression) -> int:
                if isinstance(e, InputRef):
                    return e.index
                for j, pe in enumerate(pending):
                    if pe == e:
                        return rel.width + j
                pending.append(e)
                return rel.width + len(pending) - 1

            pch = [channel_of(p) for p in partition]
            okeys = [SortKey(channel_of(oe), asc, nf)
                     for (oe, asc, nf) in order]
            funcs = []
            for _idx, spec, args in calls:
                ach = tuple(channel_of(a) for a in args)
                funcs.append(WindowFunc(spec.fn, ach, spec.type,
                                        spec.offset, spec.frame))
            if pending:
                rel = rel.append(
                    pending, [f"_wk{rel.width + j}"
                              for j in range(len(pending))])
            base = rel.width
            names = tuple(rel.node.output_names) + tuple(
                f"_win{base + j}" for j in range(len(calls)))
            types = tuple(rel.node.output_types) + tuple(
                spec.type for (_i, spec, _a) in calls)
            node = Window(names, types, rel.node, tuple(pch), tuple(okeys),
                          tuple(funcs))
            rel = RelationPlan(node, rel.qualifiers + [None] * len(calls))
            for j, (idx, spec, _args) in enumerate(calls):
                placeholder = Call(spec.type, "$winref",
                                   (Literal(BIGINT, idx),))
                win_rewrite[placeholder] = InputRef(spec.type, base + j)
        return rel, win_rewrite

    # ------------------------------------------------------------ relations
    def plan_relation(self, r: ast.Relation, outer: Optional[Scope],
                      ctes: dict[str, ast.Query]) -> RelationPlan:
        if isinstance(r, ast.Table):
            if r.name in ctes:
                rel = self.plan_query(ctes[r.name], None, ctes)
                qual = r.alias or r.name
                return RelationPlan(rel.node, [qual] * rel.width)
            # views resolve by UNQUALIFIED name only: a qualified reference
            # (catalog.table) always names the real table, so a view can
            # never shadow another catalog's table
            vname = r.name if "." not in r.name else None
            view = self.catalog.views.get(vname) if vname else None
            if view is not None:
                if vname in self._view_stack:
                    raise AnalysisError(
                        f"view is recursive: {vname}")
                qual = r.alias or vname
                if view.materialized and view.backing is not None:
                    # read the last refresh's backing table
                    bcat, btable = view.backing
                    schema = self.catalog.connector(bcat).get_table_schema(
                        btable)
                    cols = tuple(c.name for c in schema.columns)
                    types = tuple(c.type for c in schema.columns)
                    node = TableScan(cols, types, bcat, btable, cols)
                    return RelationPlan(node, [qual] * len(cols))
                # plain view: inline the defining query (the reference
                # expands views during analysis — StatementAnalyzer views)
                self._view_stack.add(vname)
                try:
                    rel = self.plan_query(view.query, None, {})
                finally:
                    self._view_stack.discard(vname)
                return RelationPlan(rel.node, [qual] * rel.width)
            cat, table, schema = self.catalog.resolve_table(r.name, self.default_catalog)
            cols = tuple(c.name for c in schema.columns)
            types = tuple(c.type for c in schema.columns)
            node = TableScan(cols, types, cat, table, cols)
            qual = r.alias or table
            return RelationPlan(node, [qual] * len(cols))
        if isinstance(r, ast.SubqueryRelation):
            rel = self.plan_query(r.query, outer, ctes)
            node = rel.node
            if r.column_names is not None:
                if len(r.column_names) != rel.width:
                    raise AnalysisError(
                        f"column alias list has {len(r.column_names)} names "
                        f"but relation has {rel.width} columns")
                node = replace(node, output_names=tuple(r.column_names))
            return RelationPlan(node, [r.alias] * rel.width)
        if isinstance(r, ast.TableFunctionRelation):
            return self._plan_table_function(r, outer)
        if isinstance(r, ast.MatchRecognizeRelation):
            return self._plan_match_recognize(r, outer, ctes)
        if isinstance(r, ast.UnnestRelation):
            return self._plan_unnest(None, r, outer, ctes)
        if isinstance(r, ast.Join):
            return self.plan_join(r, outer, ctes)
        raise AnalysisError(f"unsupported relation: {type(r).__name__}")

    def _plan_match_recognize(self, r: ast.MatchRecognizeRelation,
                              outer, ctes) -> RelationPlan:
        """MATCH_RECOGNIZE -> MatchRecognize node (reference:
        RelationPlanner.visitPatternRecognitionRelation).  Output = partition
        columns ++ measures; measure types from host inference (the pattern
        engine evaluates python values)."""
        from ..exec.match_recognize import infer_measure_type
        from ..exec.row_pattern import parse_pattern, pattern_labels

        src = self.plan_relation(r.input, outer, ctes)
        tr = Translator(src.scope(outer))

        def channel_of(e: ast.Expr) -> int:
            ir = tr.translate(e)
            if not isinstance(ir, InputRef):
                raise AnalysisError(
                    "MATCH_RECOGNIZE partition/order keys must be columns")
            return ir.index

        pch = tuple(channel_of(e) for e in r.partition_by)
        okeys = tuple((channel_of(s.expr), s.ascending) for s in r.order_by)
        # validate pattern + labels now (parse errors surface at plan time)
        labels = set(pattern_labels(parse_pattern(r.pattern)))
        for lbl, _ in r.defines:
            if lbl.upper() not in labels:
                raise AnalysisError(
                    f"DEFINE label {lbl} not used in PATTERN")
        schema = {n.lower(): t for n, t in
                  zip(src.node.output_names, src.node.output_types)}
        names = tuple([src.node.output_names[c] for c in pch]
                      + [m[1] for m in r.measures])
        types = tuple([src.node.output_types[c] for c in pch]
                      + [infer_measure_type(m[0], schema)
                         for m in r.measures])
        node = MatchRecognize(names, types, src.node, pch, okeys,
                              r.pattern, tuple(r.defines),
                              tuple(r.measures), r.skip_past)
        return RelationPlan(node, [r.alias] * len(names))

    def _plan_table_function(self, r: ast.TableFunctionRelation,
                             outer) -> RelationPlan:
        """TABLE(fn(args)): bind constant arguments, fix the schema
        (reference: ConnectorTableFunction.analyze -> TableFunctionAnalysis)."""
        fn = self.catalog.table_functions.get(r.name)
        if fn is None:
            raise AnalysisError(f"table function not registered: {r.name}")
        dummy = RelationPlan(
            Values(("_row",), (BIGINT,), rows=((0,),)), [None])
        tr = Translator(dummy.scope(outer))
        arg_vals = []
        for a in r.args:
            ir = tr.translate(a)
            if not isinstance(ir, Literal):
                raise AnalysisError(
                    f"table function {r.name} arguments must be constants")
            arg_vals.append(ir.value)
        try:
            bound = fn.bind(arg_vals)
        except ValueError as e:
            raise AnalysisError(str(e))
        names = tuple(bound.names)
        if r.column_names is not None:
            if len(r.column_names) != len(names):
                raise AnalysisError(
                    f"column alias list has {len(r.column_names)} names "
                    f"but {r.name} produces {len(names)} columns")
            names = tuple(r.column_names)
        node = TableFunctionScan(names, tuple(bound.types), r.name, bound)
        return RelationPlan(node, [r.alias] * len(names))

    def _plan_unnest(self, left: Optional[RelationPlan],
                     u: ast.UnnestRelation, outer, ctes) -> RelationPlan:
        """UNNEST as a relation (reference: RelationPlanner.planJoinUnnest /
        plan(Unnest)): lateral — array arguments see the left relation's
        columns; standalone UNNEST runs over one synthetic row and emits
        only the element columns."""
        from ..spi.types import ArrayType

        standalone = left is None
        if standalone:
            left = RelationPlan(
                Values(("_row",), (BIGINT,), rows=((0,),)), [None])
        orig_width = left.width
        tr = Translator(left.scope(outer))
        irs = [tr.translate(e) for e in u.exprs]
        for ir in irs:
            if not isinstance(ir.type, ArrayType):
                raise AnalysisError("UNNEST argument must be an array")
        chans, left = _as_channels(irs, left)
        replicate = () if standalone else tuple(range(orig_width))

        n_el = len(irs)
        el_names = [f"_unnest{i}" for i in range(n_el)]
        ord_name = "ordinality"
        if u.column_names:
            expect = n_el + (1 if u.ordinality else 0)
            if len(u.column_names) != expect:
                raise AnalysisError(
                    f"UNNEST column alias list has {len(u.column_names)} "
                    f"names but produces {expect} columns")
            el_names = list(u.column_names[:n_el])
            if u.ordinality:
                ord_name = u.column_names[-1]
        names = tuple([left.node.output_names[c] for c in replicate]
                      + el_names + ([ord_name] if u.ordinality else []))
        types = tuple([left.node.output_types[c] for c in replicate]
                      + [ir.type.element for ir in irs]
                      + ([BIGINT] if u.ordinality else []))
        node = Unnest(names, types, left.node, replicate, tuple(chans),
                      u.ordinality)
        quals = ([left.qualifiers[c] for c in replicate]
                 + [u.alias] * (n_el + (1 if u.ordinality else 0)))
        return RelationPlan(node, quals)

    def plan_join(self, j: ast.Join, outer, ctes) -> RelationPlan:
        if isinstance(j.right, ast.UnnestRelation):
            # lateral CROSS JOIN UNNEST(left.col)
            if j.join_type not in ("CROSS", "INNER") or j.condition is not None:
                raise AnalysisError(
                    "only CROSS JOIN UNNEST (no condition) is supported")
            left = self.plan_relation(j.left, outer, ctes)
            return self._plan_unnest(left, j.right, outer, ctes)
        left = self.plan_relation(j.left, outer, ctes)
        right = self.plan_relation(j.right, outer, ctes)
        names = tuple(left.node.output_names) + tuple(right.node.output_names)
        types = tuple(left.node.output_types) + tuple(right.node.output_types)
        quals = left.qualifiers + right.qualifiers
        if j.join_type == "CROSS" or j.condition is None:
            node = Join(names, types, left.node, right.node, "CROSS", (), (), None)
            return RelationPlan(node, quals)
        combined = Scope(
            [Field(n, t, q) for n, t, q in zip(names, types, quals)], outer)
        tr = Translator(combined)
        conjuncts = [cast_to(tr.translate(c), BOOLEAN)
                     for c in split_conjuncts(j.condition)]
        lw = left.width
        lkeys, rkeys, residual = [], [], []
        for c in conjuncts:
            sides = _classify_sides(c, lw)
            if (isinstance(c, Call) and c.name == "eq" and sides == "both"
                    and _classify_sides(c.args[0], lw) in ("left", "right")
                    and _classify_sides(c.args[1], lw) in ("left", "right")
                    and _classify_sides(c.args[0], lw) != _classify_sides(c.args[1], lw)):
                a, b = c.args
                if _classify_sides(a, lw) == "right":
                    a, b = b, a
                lkeys.append(a)
                rkeys.append(_shift_inputs(b, -lw))
            else:
                residual.append(c)
        # key expressions must be plain channels: append projections if needed
        lch, left = _as_channels(lkeys, left)
        rch, right = _as_channels(rkeys, right)
        names = tuple(left.node.output_names) + tuple(right.node.output_names)
        types = tuple(left.node.output_types) + tuple(right.node.output_types)
        quals = left.qualifiers + right.qualifiers
        res = _conjoin(residual) if residual else None
        node = Join(names, types, left.node, right.node, j.join_type,
                    tuple(lch), tuple(rch), res)
        return RelationPlan(node, quals)

    # ------------------------------------------------------------ subqueries
    def _plan_subquery_conjunct(self, rel: RelationPlan, c: ast.Expr, outer, ctes,
                                agg_rewrite=None) -> RelationPlan:
        holder = {"rel": rel}

        def cb(node):
            new_rel, ir = self._handle_subquery(holder["rel"], node, outer, ctes)
            holder["rel"] = new_rel
            return ir

        collector = agg_rewrite[0] if agg_rewrite else None
        tr = Translator(holder["rel"].scope(outer), aggregates=collector,
                        subquery_cb=cb)
        ir = cast_to(tr.translate(c), BOOLEAN)
        if agg_rewrite:
            ir = rewrite_expr(ir, agg_rewrite[1])
        out = holder["rel"]
        return RelationPlan(
            Filter(out.node.output_names, out.node.output_types, out.node, ir),
            out.qualifiers,
        )

    def _handle_subquery(self, rel: RelationPlan, node: ast.Expr, outer, ctes):
        if isinstance(node, ast.InSubquery):
            return self._plan_in_subquery(rel, node, outer, ctes)
        if isinstance(node, ast.Exists):
            return self._plan_exists(rel, node, outer, ctes)
        if isinstance(node, ast.ScalarSubquery):
            return self._plan_scalar_subquery(rel, node, outer, ctes)
        raise AnalysisError(f"unsupported subquery form: {type(node).__name__}")

    def _plan_in_subquery(self, rel: RelationPlan, node: ast.InSubquery, outer, ctes):
        sub = self.plan_query(node.query, None, ctes)
        if sub.width != 1:
            raise AnalysisError("IN subquery must return one column")
        operand = Translator(rel.scope(outer)).translate(node.operand)
        if isinstance(operand, InputRef):
            src, s_ch = rel, operand.index
        else:
            src = rel.append([operand], ["_in_key"])
            s_ch = src.width - 1
        mark_name = f"_mark{src.width}"
        names = tuple(src.node.output_names) + (mark_name,)
        types = tuple(src.node.output_types) + (BOOLEAN,)
        if self.optimizer == "iterative":
            # leave a CorrelatedJoin placeholder for the decorrelate rules
            # (TransformCorrelatedInPredicate lowers it to this SemiJoin)
            sj: PlanNode = CorrelatedJoin(names, types, src.node, sub.node,
                                          "in", (s_ch,), (0,))
        else:
            sj = SemiJoin(names, types, src.node, sub.node, (s_ch,), (0,),
                          negated=False, residual=None, null_aware=True)
        new_rel = RelationPlan(sj, src.qualifiers + [None])
        mark = InputRef(BOOLEAN, new_rel.width - 1)
        ir = Call(BOOLEAN, "$not", (mark,)) if node.negated else mark
        return new_rel, ir

    def _plan_exists(self, rel: RelationPlan, node: ast.Exists, outer, ctes):
        spec = node.query.body
        if spec.group_by or spec.having:
            raise AnalysisError("EXISTS subquery with aggregation not supported")
        inner = (self.plan_relation(spec.from_, None, ctes)
                 if spec.from_ is not None else None)
        if inner is None:
            raise AnalysisError("EXISTS requires FROM")
        inner_filters: list[RowExpression] = []
        corr_pairs: list[tuple[RowExpression, RowExpression]] = []
        residuals: list[RowExpression] = []
        if spec.where is not None:
            scope = inner.scope(rel.scope(outer))
            tr = Translator(scope)
            for c in split_conjuncts(spec.where):
                ir = cast_to(tr.translate(c), BOOLEAN)
                if not _has_outer(ir):
                    inner_filters.append(ir)
                elif (isinstance(ir, Call) and ir.name == "eq"
                      and _is_outer_only(ir.args[0]) != _is_outer_only(ir.args[1])):
                    a, b = ir.args
                    if _is_outer_only(b):
                        a, b = b, a
                    # a: outer side, b: inner side
                    if _has_outer(b):
                        residuals.append(ir)
                    else:
                        corr_pairs.append((_shift_outer(a), b))
                else:
                    residuals.append(ir)
        if inner_filters:
            pred = _conjoin(inner_filters)
            inner = RelationPlan(
                Filter(inner.node.output_names, inner.node.output_types,
                       inner.node, pred), inner.qualifiers)
        if not corr_pairs and not residuals:
            raise AnalysisError("uncorrelated EXISTS not supported yet")
        src = rel
        s_chs, f_chs = [], []
        src_append, inner_append = [], []
        for outer_e, inner_e in corr_pairs:
            if isinstance(outer_e, InputRef):
                s_chs.append(outer_e.index)
            else:
                src_append.append(outer_e)
                s_chs.append(None)
            if isinstance(inner_e, InputRef):
                f_chs.append(inner_e.index)
            else:
                inner_append.append(inner_e)
                f_chs.append(None)
        if src_append:
            base = src.width
            src = src.append(src_append, [f"_k{base+i}" for i in range(len(src_append))])
            it = iter(range(base, base + len(src_append)))
            s_chs = [c if c is not None else next(it) for c in s_chs]
        if inner_append:
            base = inner.width
            inner = inner.append(inner_append,
                                 [f"_k{base+i}" for i in range(len(inner_append))])
            it = iter(range(base, base + len(inner_append)))
            f_chs = [c if c is not None else next(it) for c in f_chs]
        residual_ir = None
        if residuals:
            # over source channels ++ inner channels
            sw = src.width
            def remap(e: RowExpression) -> RowExpression:
                if isinstance(e, OuterRef) and e.level == 1:
                    return InputRef(e.type, e.index)
                if isinstance(e, InputRef):
                    return InputRef(e.type, e.index + sw)
                if isinstance(e, Call):
                    return Call(e.type, e.name, tuple(remap(a) for a in e.args))
                return e
            residual_ir = _conjoin([remap(r) for r in residuals])
        mark_name = f"_mark{src.width}"
        names = tuple(src.node.output_names) + (mark_name,)
        types = tuple(src.node.output_types) + (BOOLEAN,)
        sj = SemiJoin(names, types, src.node, inner.node,
                      tuple(s_chs), tuple(f_chs), negated=False,
                      residual=residual_ir, null_aware=False)
        new_rel = RelationPlan(sj, src.qualifiers + [None])
        mark = InputRef(BOOLEAN, new_rel.width - 1)
        ir = Call(BOOLEAN, "$not", (mark,)) if node.negated else mark
        return new_rel, ir

    def _plan_scalar_subquery(self, rel: RelationPlan, node: ast.ScalarSubquery,
                              outer, ctes):
        spec = node.query.body
        # detect correlation by planning the WHERE against a chained scope
        corr = self._try_correlated_scalar(rel, node.query, outer, ctes)
        if corr is not None:
            return corr
        sub = self.plan_query(node.query, None, ctes)
        if sub.width != 1:
            raise AnalysisError("scalar subquery must return one column")
        names = tuple(rel.node.output_names) + (f"_scalar{rel.width}",)
        types = tuple(rel.node.output_types) + (sub.node.output_types[0],)
        # single-row broadcast join (EnforceSingleRow + cross join in Trino)
        jn = Join(names, types, rel.node, sub.node, "SINGLE", (), (), None)
        new_rel = RelationPlan(jn, rel.qualifiers + [None])
        return new_rel, InputRef(types[-1], new_rel.width - 1)

    def _try_correlated_scalar(self, rel: RelationPlan, q: ast.Query, outer, ctes):
        spec = q.body
        if (spec.group_by or spec.having or q.order_by or q.limit is not None
                or spec.from_ is None or len(spec.select) != 1):
            return None
        inner = self.plan_relation(spec.from_, None, ctes)
        if spec.where is None:
            return None
        scope = inner.scope(rel.scope(outer))
        tr = Translator(scope)
        inner_filters, corr_pairs = [], []
        for c in split_conjuncts(spec.where):
            ir = cast_to(tr.translate(c), BOOLEAN)
            if not _has_outer(ir):
                inner_filters.append(ir)
            elif (isinstance(ir, Call) and ir.name == "eq"
                  and _is_outer_only(ir.args[0]) != _is_outer_only(ir.args[1])
                  and not (_has_outer(ir.args[0]) and _has_outer(ir.args[1]))):
                a, b = ir.args
                if _is_outer_only(b):
                    a, b = b, a
                corr_pairs.append((_shift_outer(a), b))
            else:
                raise AnalysisError(f"unsupported correlated predicate: {c}")
        if not corr_pairs:
            return None
        # aggregate the inner by its correlation keys
        collector = AggregateCollector()
        sel_tr = Translator(inner.scope(), aggregates=collector)
        sel_ir = sel_tr.translate(spec.select[0].expr)
        if not collector.calls:
            raise AnalysisError("correlated scalar subquery must aggregate")
        if inner_filters:
            inner = RelationPlan(
                Filter(inner.node.output_names, inner.node.output_types,
                       inner.node, _conjoin(inner_filters)), inner.qualifiers)
        group_irs = [b for (_, b) in corr_pairs]
        # zero-row marker: count(*) is non-NULL for every real group, so the
        # LEFT join null-extends it to NULL exactly when an outer row matched
        # zero inner rows — lets us restore each aggregate's zero-row value
        # for ANY select expression (Trino: TransformCorrelatedScalarAggregation
        # aggregates over the null-extended join for the same effect).
        mark_idx = collector.add("count", None, False, BIGINT)
        agg_rel, rewrite = self._plan_aggregation(inner, group_irs, collector, None)
        value_ir = rewrite_expr(sel_ir, rewrite)
        nkeys = len(group_irs)
        mark_ch = nkeys + mark_idx
        value_rel = agg_rel.append([value_ir], ["_scalar_value"])
        # prune to keys + value + marker
        keep = list(range(nkeys)) + [value_rel.width - 1, mark_ch]
        proj = Project(
            tuple(value_rel.node.output_names[i] for i in keep),
            tuple(value_rel.node.output_types[i] for i in keep),
            value_rel.node,
            tuple(InputRef(value_rel.node.output_types[i], i) for i in keep),
        )
        # outer-side keys as channels
        outer_keys = [a for (a, _) in corr_pairs]
        och, src = _as_channels(outer_keys, rel)
        names = tuple(src.node.output_names) + proj.output_names
        types = tuple(src.node.output_types) + proj.output_types
        if self.optimizer == "iterative":
            # placeholder for TransformCorrelatedScalarSubquery, which
            # lowers to exactly the LEFT join the legacy branch builds
            jn: PlanNode = CorrelatedJoin(names, types, src.node, proj,
                                          "scalar_agg", tuple(och),
                                          tuple(range(nkeys)))
        else:
            jn = Join(names, types, src.node, proj, "LEFT",
                      tuple(och), tuple(range(nkeys)), None)
        new_rel = RelationPlan(jn, src.qualifiers + [None] * (nkeys + 2))
        value_ref: RowExpression = InputRef(types[-2], new_rel.width - 2)
        mark_ref = InputRef(BIGINT, new_rel.width - 1)
        # Restore the select expression's zero-row value: substitute every
        # aggref with its value over zero rows (count -> 0, everything else ->
        # NULL) and switch on the marker, so e.g. coalesce(sum(x), 0) yields 0
        # (not NULL) for outer rows with no matches while a genuine NULL value
        # on a matched group (all-NULL sum) is preserved.
        aggrefs = [x for x in walk(sel_ir)
                   if isinstance(x, Call) and x.name == "$aggref"]
        subst: dict[RowExpression, RowExpression] = {}
        for a in aggrefs:
            fn = collector.calls[a.args[0].value][0]
            subst[a] = Literal(a.type, 0 if fn == "count" else None)
        default_expr = rewrite_expr(sel_ir, subst)
        if default_expr == Literal(value_ref.type, None):
            return new_rel, value_ref
        ir: RowExpression = Call(
            value_ref.type, "$if",
            (Call(BOOLEAN, "$is_null", (mark_ref,)), default_expr, value_ref))
        return new_rel, ir


def _alias_body(body: ast.QueryBody, colnames: tuple[str, ...]) -> ast.QueryBody:
    """Apply WITH-clause column aliases; a set operation takes its output
    names from its leftmost input (SQL spec 7.13)."""
    if isinstance(body, ast.QuerySpec):
        return replace(body, select=tuple(
            replace(s, alias=cn) for s, cn in zip(body.select, colnames)))
    if isinstance(body, ast.SetOp):
        return replace(body, left=_alias_body(body.left, colnames))
    if isinstance(body, ast.Query):
        return replace(body, body=_alias_body(body.body, colnames))
    return body


def _cast_side(rel: RelationPlan, types: list) -> RelationPlan:
    """Project a set-op input so its channel types match the unified types."""
    if list(rel.node.output_types) == list(types):
        return rel
    exprs = tuple(
        cast_to(InputRef(t0, i), t)
        for i, (t0, t) in enumerate(zip(rel.node.output_types, types)))
    node = Project(tuple(rel.node.output_names), tuple(types), rel.node, exprs)
    return RelationPlan(node, list(rel.qualifiers))


def _index_of(ir, irs):
    return irs.index(ir) if ir in irs else None


def _contains_subquery(e: ast.Expr) -> bool:
    if isinstance(e, (ast.InSubquery, ast.Exists, ast.ScalarSubquery)):
        return True
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, ast.Expr) and _contains_subquery(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, ast.Expr) and _contains_subquery(x):
                    return True
                if isinstance(x, ast.WhenClause):
                    if _contains_subquery(x.condition) or _contains_subquery(x.result):
                        return True
    return False


def _classify_sides(e: RowExpression, left_width: int) -> str:
    sides = set()
    for x in walk(e):
        if isinstance(x, InputRef):
            sides.add("left" if x.index < left_width else "right")
        elif isinstance(x, OuterRef):
            sides.add("outer")
    if sides == {"left"}:
        return "left"
    if sides == {"right"}:
        return "right"
    if not sides:
        return "none"
    return "both"


def _is_outer_only(e: RowExpression) -> bool:
    has_outer = False
    for x in walk(e):
        if isinstance(x, InputRef):
            return False
        if isinstance(x, OuterRef):
            has_outer = True
    return has_outer


def _as_channels(exprs: list[RowExpression], rel: RelationPlan):
    """Return ([channel...], possibly-extended relation) for key expressions."""
    chans = []
    to_append, names = [], []
    for e in exprs:
        if isinstance(e, InputRef):
            chans.append(e.index)
        else:
            chans.append(rel.width + len(to_append))
            to_append.append(e)
            names.append(f"_key{rel.width + len(to_append) - 1}")
    if to_append:
        rel = rel.append(to_append, names)
    return chans, rel
