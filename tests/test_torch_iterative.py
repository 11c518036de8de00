"""The port's iterative optimizer held rule for rule to the reference's.

Every test of the reference's tests/test_iterative_optimizer.py has a case
here: the same plan is built once with each package's own plan classes,
the same rule (or the driver on a TPC-H statement) runs on it in each
package, and the firings (phase, rule, node type, in order) and the
``plan_text`` of the result must be equal; each case also states the
firing count the reference test asserts.  The memo and ``estimate_rows``
tests of that file are held the same way, and so are the plans of the 22
TPC-H queries in both optimizer modes.  The reference runs with
``TRINO_TPU_OPTIMIZER=iterative`` (or ``legacy`` where a test says so) and
``TRINO_TPU_HBO=0``.
"""

from types import SimpleNamespace

import pytest

import trino_tpu.planner.iterative.rules as ref_rules
import trino_tpu_torch.planner.iterative.rules as port_rules
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.planner import optimizer as ref_optimizer
from trino_tpu.planner import plan as ref_plan
from trino_tpu.planner.iterative import driver as ref_driver
from trino_tpu.planner.iterative import memo as ref_memo
from trino_tpu.planner.iterative import rule as ref_rule
from trino_tpu.planner.iterative.rules import (  # noqa: F401 — submodules
    aggregates, decorrelate, limits, prune, reorder, simplify)
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.spi import types as ref_types
from trino_tpu.sql import ir as ref_ir
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.planner import optimizer as port_optimizer
from trino_tpu_torch.planner import plan as port_plan
from trino_tpu_torch.planner.iterative import driver as port_driver
from trino_tpu_torch.planner.iterative import memo as port_memo
from trino_tpu_torch.planner.iterative import rule as port_rule
from trino_tpu_torch.planner.iterative.rules import (  # noqa: F401
    aggregates as _pa, decorrelate as _pd, limits as _pl, prune as _pp,
    reorder as _pr, simplify as _ps)
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi import types as port_types
from trino_tpu_torch.sql import ir as port_ir

SF = 0.01

REF = SimpleNamespace(P=ref_plan, ir=ref_ir, T=ref_types, rules=ref_rules,
                      driver=ref_driver, memo=ref_memo, rule=ref_rule,
                      opt=ref_optimizer, catalog=ref_catalog(scale_factor=SF))
PORT = SimpleNamespace(P=port_plan, ir=port_ir, T=port_types,
                       rules=port_rules, driver=port_driver, memo=port_memo,
                       rule=port_rule, opt=port_optimizer,
                       catalog=default_catalog(SF))


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_OPTIMIZER", "iterative")
    monkeypatch.setenv("TRINO_TPU_HBO", "0")
    monkeypatch.setenv("TRINO_TPU_HASH_IMPL", "sort")
    monkeypatch.setenv("TRINO_TPU_PALLAS", "0")
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "0")


# ------------------------------------------------- plans built per package

def vals(m, n=10, cols=("k", "v")):
    return m.P.Values(tuple(cols), (m.T.BIGINT,) * len(cols),
                      tuple(tuple(i * 10 + c for c in range(len(cols)))
                            for i in range(n)))


def gt(m, ch, lit):
    return m.ir.Call(m.T.BOOLEAN, "gt", (m.ir.InputRef(m.T.BIGINT, ch),
                                         m.ir.Literal(m.T.BIGINT, lit)))


def col(m, ch):
    return m.ir.InputRef(m.T.BIGINT, ch)


def add01(m):
    return m.ir.Call(m.T.BIGINT, "add", (col(m, 0), col(m, 1)))


def filt(m, src, pred):
    return m.P.Filter(src.output_names, src.output_types, src, pred)


def join(m, left, right, jt="INNER", lkeys=(0,), rkeys=(0,), **kw):
    return m.P.Join(left.output_names + right.output_names,
                    left.output_types + right.output_types, left, right, jt,
                    lkeys, rkeys, None, **kw)


def semijoin(m, source):
    f = vals(m, cols=("k2",))
    return m.P.SemiJoin(source.output_names + ("mark",),
                        source.output_types + (m.T.BOOLEAN,), source, f,
                        (0,), (0,))


def agg_over_join(m, join_type="INNER", fn="sum", arg=1, distinct=False):
    j = join(m, vals(m), vals(m, cols=("k2", "w")), join_type)
    B = m.T.BIGINT
    return m.P.Aggregate(("k", "a"), (B, B), j, (0,),
                         (m.P.AggCall(fn, arg, B, distinct=distinct),))


def project(m, names, src, exprs):
    return m.P.Project(tuple(names), (m.T.BIGINT,) * len(names), src,
                       tuple(exprs))


def _limit(m, src, n=5):
    return m.P.Limit(src.output_names, src.output_types, src, n)


def _correlated(m, kind):
    src = vals(m)
    if kind == "in":
        sub = vals(m, cols=("k2",))
        return m.P.CorrelatedJoin(src.output_names + ("mark",),
                                  src.output_types + (m.T.BOOLEAN,), src,
                                  sub, "in", (0,), (0,))
    sub = vals(m, cols=("k2", "agg"))
    return m.P.CorrelatedJoin(src.output_names + sub.output_names,
                              (m.T.BIGINT,) * 4, src, sub, "scalar_agg",
                              (0,), (0,))


def _empty(m, cols=("k", "v")):
    return m.P.Values(tuple(cols), (m.T.BIGINT,) * len(cols), ())


# name -> (tree builder, [(rules module, rule class)], the firings the
# reference test asserts)
CASES = {
    "merge_adjacent_filters_fires": (
        lambda m: filt(m, filt(m, vals(m), gt(m, 0, 1)), gt(m, 1, 2)),
        [("simplify", "MergeAdjacentFilters")], 1),
    "merge_adjacent_filters_does_not_fire_on_single_filter": (
        lambda m: filt(m, vals(m), gt(m, 0, 1)),
        [("simplify", "MergeAdjacentFilters")], 0),
    "merge_adjacent_projects_fires_on_trivial_inner": (
        lambda m: project(m, ("k",), project(
            m, ("v", "k"), vals(m), (col(m, 1), col(m, 0))), (col(m, 1),)),
        [("simplify", "MergeAdjacentProjects")], 1),
    "merge_adjacent_projects_does_not_fire_on_computed_inner": (
        lambda m: project(m, ("a", "b"), project(
            m, ("s",), vals(m), (add01(m),)), (col(m, 0), col(m, 0))),
        [("simplify", "MergeAdjacentProjects")], 0),
    "inline_projections_fires_when_referenced_once": (
        lambda m: project(m, ("s2",), project(
            m, ("s",), vals(m), (add01(m),)), (col(m, 0),)),
        [("simplify", "InlineProjections")], 1),
    "inline_projections_does_not_fire_when_referenced_twice": (
        lambda m: project(m, ("a", "b"), project(
            m, ("s",), vals(m), (add01(m),)), (col(m, 0), col(m, 0))),
        [("simplify", "InlineProjections")], 0),
    "remove_redundant_identity_projection_fires": (
        lambda m: project(m, ("k", "v"), vals(m), (col(m, 0), col(m, 1))),
        [("simplify", "RemoveRedundantIdentityProjections")], 1),
    "remove_redundant_identity_projection_keeps_renames": (
        lambda m: project(m, ("x", "y"), vals(m), (col(m, 0), col(m, 1))),
        [("simplify", "RemoveRedundantIdentityProjections")], 0),
    "remove_trivial_filters_fires_on_constant_true": (
        lambda m: filt(m, vals(m), m.ir.Literal(m.T.BOOLEAN, True)),
        [("simplify", "RemoveTrivialFilters")], 1),
    "remove_trivial_filters_false_becomes_empty_values": (
        lambda m: filt(m, vals(m), m.ir.Literal(m.T.BOOLEAN, False)),
        [("simplify", "RemoveTrivialFilters")], 1),
    "remove_trivial_filters_does_not_fire_on_real_predicate": (
        lambda m: filt(m, vals(m), gt(m, 0, 1)),
        [("simplify", "RemoveTrivialFilters")], 0),
    "evaluate_zero_input_fires_through_row_preserving_chain": (
        lambda m: filt(m, _empty(m), gt(m, 0, 1)),
        [("simplify", "EvaluateZeroInput")], 1),
    "evaluate_zero_input_empties_inner_join": (
        lambda m: join(m, _empty(m, ("k",)), vals(m, cols=("k2", "w"))),
        [("simplify", "EvaluateZeroInput")], 1),
    "evaluate_zero_input_does_not_fire_on_populated_inputs": (
        lambda m: filt(m, vals(m), gt(m, 0, 1)),
        [("simplify", "EvaluateZeroInput")], 0),
    "push_limit_through_project_fires": (
        lambda m: _limit(m, project(m, ("v",), vals(m), (col(m, 1),))),
        [("limits", "PushLimitThroughProject")], 1),
    "push_limit_through_project_does_not_fire_elsewhere": (
        lambda m: _limit(m, vals(m)),
        [("limits", "PushLimitThroughProject")], 0),
    "push_limit_through_semijoin_fires_once": (
        lambda m: _limit(m, semijoin(m, vals(m))),
        [("limits", "PushLimitThroughSemiJoin")], 1),
    "push_limit_through_left_join_fires_and_keeps_outer": (
        lambda m: _limit(m, join(m, vals(m), vals(m, cols=("k2", "w")),
                                 "LEFT")),
        [("limits", "PushLimitThroughJoin")], 1),
    "push_limit_through_inner_join_does_not_fire": (
        lambda m: _limit(m, join(m, vals(m), vals(m, cols=("k2", "w")))),
        [("limits", "PushLimitThroughJoin")], 0),
    "push_partial_aggregation_through_join_fires": (
        lambda m: agg_over_join(m),
        [("aggregates", "PushPartialAggregationThroughJoin")], 1),
    "push_partial_aggregation_skips_distinct": (
        lambda m: agg_over_join(m, distinct=True),
        [("aggregates", "PushPartialAggregationThroughJoin")], 0),
    "push_aggregation_through_outer_join_fires_with_coalesce": (
        lambda m: agg_over_join(m, "LEFT", "count", 3),
        [("aggregates", "PushAggregationThroughOuterJoin")], 1),
    "push_aggregation_through_outer_join_skips_count_star": (
        lambda m: agg_over_join(m, "LEFT", "count_star", -1),
        [("aggregates", "PushAggregationThroughOuterJoin")], 0),
    "transform_correlated_in_predicate_fires": (
        lambda m: _correlated(m, "in"),
        [("decorrelate", "TransformCorrelatedInPredicate")], 1),
    "transform_correlated_scalar_subquery_fires": (
        lambda m: _correlated(m, "scalar_agg"),
        [("decorrelate", "TransformCorrelatedScalarSubquery")], 1),
    "decorrelate_rules_do_not_fire_without_correlation": (
        lambda m: join(m, vals(m), vals(m, cols=("k2",))),
        [("decorrelate", "TransformCorrelatedInPredicate"),
         ("decorrelate", "TransformCorrelatedScalarSubquery")], 0),
    "determine_join_distribution_fires_on_right_join": (
        lambda m: join(m, vals(m), vals(m, cols=("k2",)), "RIGHT",
                       distribution="BROADCAST"),
        [("reorder", "DetermineJoinDistribution")], 1),
    "determine_join_distribution_does_not_fire_when_settled": (
        lambda m: join(m, vals(m), vals(m, cols=("k2",)), "RIGHT",
                       distribution="PARTITIONED"),
        [("reorder", "DetermineJoinDistribution")], 0),
    "prune_join_columns_fires_on_narrow_projection": (
        lambda m: project(m, ("v",), join(
            m, vals(m, cols=("k", "v", "x")), vals(m, cols=("k2", "w", "y"))),
            (col(m, 1),)),
        [("prune", "PruneJoinColumns")], 1),
    "prune_join_columns_does_not_fire_when_all_used": (
        lambda m: project(m, ("k", "v", "k2", "w"), join(
            m, vals(m), vals(m, cols=("k2", "w"))),
            tuple(col(m, i) for i in range(4))),
        [("prune", "PruneJoinColumns")], 0),
}


def run_rules(m, root, rules):
    """One-phase fixpoint over the memo in package ``m``."""
    rule_objs = tuple(getattr(getattr(m.rules, mod), cls)()
                      for mod, cls in rules)
    ctx = m.rule.Context(catalog=m.catalog, history=None,
                         trace=m.rule.Trace())
    out = m.driver.IterativeOptimizer(
        phases=(("test", rule_objs),)).run(root, ctx)
    return out, ctx.trace


@pytest.mark.parametrize("case", list(CASES))
def test_rule_matches_reference(case):
    build, rules, fired = CASES[case]
    results = {}
    for name, m in (("ref", REF), ("port", PORT)):
        tree = build(m)
        out, trace = run_rules(m, tree, rules)
        # fixpoint: the rules must not fire again on their own output
        _, again = run_rules(m, out, rules)
        results[name] = (m.P.plan_text(tree), m.P.plan_text(out),
                         trace.fires, again.fires)
        assert sum(trace.fired(cls) for _, cls in rules) == fired
        assert not again.fires
        assert (out == tree) == (fired == 0)
    assert results["port"] == results["ref"]


def test_coalesce_lands_on_the_outer_join_count():
    """The reference test's own check: all-unmatched groups read 0, not
    NULL, because a $coalesce wraps the merged count."""
    build, rules, _ = CASES[
        "push_aggregation_through_outer_join_fires_with_coalesce"]
    out, _ = run_rules(PORT, build(PORT), rules)
    assert isinstance(out, port_plan.Project)
    assert [e.name for e in out.expressions
            if isinstance(e, port_ir.Call)] == ["$coalesce"]
    j = next(n for n in _walk(out) if isinstance(n, port_plan.Join))
    assert j.join_type == "LEFT" and isinstance(j.right, port_plan.Aggregate)


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


@pytest.mark.parametrize("sql,fires", [
    # a three-way join: ReorderJoins fires (the reference asserts >= 1)
    ("select c_name, o_totalprice, n_name from customer "
     "join orders on c_custkey = o_custkey "
     "join nation on c_nationkey = n_nationkey", True),
    # a single table: it does not
    ("select l_orderkey from lineitem where l_quantity > 10", False),
])
def test_reorder_joins_on_tpch_plans_matches_reference(sql, fires):
    want_plan = ref_plan.plan_text(RefRunner(REF.catalog).create_plan(sql))
    want = ref_driver.last_report()
    port = StandaloneQueryRunner(PORT.catalog, device="cpu")
    got_plan = port_plan.plan_text(port.create_plan(sql))
    got = port_driver.last_report()
    assert (got.fired("ReorderJoins") >= 1) == fires
    assert got.fires == want.fires and got_plan == want_plan


# ------------------------------------------------------------------ memo

def _memo_interning(m):
    v = vals(m)
    f1, f2 = (filt(m, vals(m), gt(m, 0, 1)) for _ in range(2))
    memo = m.memo.Memo(m.P.Union(v.output_names, v.output_types, (f1, f2)))
    kids = memo.child_groups(memo.root_group)
    assert len(kids) == 2 and kids[0] == kids[1]
    f3 = filt(m, vals(m), gt(m, 0, 99))
    memo2 = m.memo.Memo(m.P.Union(v.output_names, v.output_types, (f1, f3)))
    kids2 = memo2.child_groups(memo2.root_group)
    assert kids2[0] != kids2[1]
    return (kids, kids2, memo.group_count(), memo2.group_count(),
            m.P.plan_text(memo2.extract()))


def _memo_extract(m):
    v = vals(m)
    tree = filt(m, v, gt(m, 0, 1))
    memo = m.memo.Memo(tree)
    assert memo.extract() == tree
    root = memo.node(memo.root_group)
    assert isinstance(root.source, m.memo.GroupRef)
    assert memo.resolve(root.source) == v
    return (root.label(), root.source.label(), memo.group_count(),
            m.P.plan_text(memo.extract()))


def _memo_replace_group(m):
    v = vals(m)
    memo = m.memo.Memo(filt(m, v, gt(m, 0, 1)))
    memo.replace_group(memo.root_group, v)
    assert memo.extract() == v
    return m.P.plan_text(memo.extract()), memo.group_count()


@pytest.mark.parametrize("check", [_memo_interning, _memo_extract,
                                   _memo_replace_group],
                         ids=["interns_identical_subtrees",
                              "extract_round_trips_and_resolves_refs",
                              "replace_group_rewrites_extraction"])
def test_memo_matches_reference(check):
    assert check(PORT) == check(REF)


# ----------------------------------------------- estimate_rows regression

def _one_and_two_key_estimates(m):
    left, right = vals(m), vals(m, cols=("k2", "w"))
    one = join(m, left, right)
    two = join(m, left, right, lkeys=(0, 1), rkeys=(0, 1))
    return (m.opt.estimate_rows(one, m.catalog),
            m.opt.estimate_rows(two, m.catalog))


def test_extra_equality_conjuncts_tighten_unknown_ndv_estimate():
    est1, est2 = _one_and_two_key_estimates(PORT)
    assert (est1, est2) == _one_and_two_key_estimates(REF)
    assert est2 == pytest.approx(est1 * 0.9)


def test_single_key_join_estimate_unchanged_by_fix():
    est1, _ = _one_and_two_key_estimates(PORT)
    assert est1 == _one_and_two_key_estimates(REF)[0] == 10.0


# --------------------------------------------------------- the driver

@pytest.mark.parametrize("limit", [6, 2])
def test_dp_limit_matches_reference_knob(monkeypatch, limit):
    """``IterativeOptimizer(dp_limit=)`` takes the place of the reference's
    TRINO_TPU_JOIN_REORDER_DP_LIMIT: a 3-way cluster is ordered by DP at
    the default 6 and greedily at 2, in both packages alike."""
    from trino_tpu.planner.logical import LogicalPlanner as RefPlanner
    from trino_tpu.sql.parser import parse_statement as ref_parse
    from trino_tpu_torch.planner.logical import LogicalPlanner
    from trino_tpu_torch.sql.parser import parse_statement

    sql = ("select c_name, o_totalprice, n_name from nation, orders, "
           "customer where c_custkey = o_custkey "
           "and c_nationkey = n_nationkey")
    monkeypatch.setenv("TRINO_TPU_JOIN_REORDER_DP_LIMIT", str(limit))
    plans = []
    for m, raw in (
            (REF, RefPlanner(REF.catalog, "tpch").plan(ref_parse(sql))),
            (PORT, LogicalPlanner(PORT.catalog, "tpch").plan(
                parse_statement(sql)))):
        ctx = m.rule.Context(catalog=m.catalog, trace=m.rule.Trace())
        opt = (m.driver.IterativeOptimizer() if m is REF
               else m.driver.IterativeOptimizer(dp_limit=limit))
        out = opt.run(raw, ctx)
        assert ctx.trace.fired("ReorderJoins") == 1
        plans.append((m.P.plan_text(out), ctx.trace.fires))
    assert plans[1] == plans[0]


def test_unknown_optimizer_mode_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        StandaloneQueryRunner(PORT.catalog, device="cpu", optimizer="cbo")
    with pytest.raises(ValueError, match="unknown optimizer mode"):
        port_optimizer.optimize(vals(PORT), PORT.catalog, "cbo")


def test_firing_cap_raises():
    """A rule that never reaches fixpoint trips the cap; nothing falls back
    to the legacy pipeline."""
    class Flip(port_rule.Rule):
        pattern = None

        def apply(self, node, captures, ctx):
            names = tuple(reversed(node.output_names))
            return port_plan.Values(names, node.output_types, node.rows)

    ctx = port_rule.Context(catalog=PORT.catalog, trace=port_rule.Trace())
    opt = port_driver.IterativeOptimizer(phases=(("test", (Flip(),)),),
                                         max_firings=5)
    with pytest.raises(RuntimeError, match="exceeded 5 rule firings"):
        opt.run(vals(PORT), ctx)


# ------------------------------------------------- the 22 TPC-H plans

@pytest.fixture(scope="module")
def sf1_catalogs():
    return default_catalog(1.0), ref_catalog(scale_factor=1.0)


@pytest.mark.parametrize("q", sorted(QUERIES))
@pytest.mark.parametrize("mode,sf", [("iterative", SF), ("iterative", 1.0),
                                     ("legacy", SF)])
def test_tpch_plan_matches_reference(monkeypatch, sf1_catalogs, mode, sf, q):
    """The port's plan_text equals the reference's in each optimizer mode
    (at SF 1 by planning only); the reference reads the mode from
    TRINO_TPU_OPTIMIZER."""
    monkeypatch.setenv("TRINO_TPU_OPTIMIZER", mode)
    cats = (PORT.catalog, REF.catalog) if sf == SF else sf1_catalogs
    port = StandaloneQueryRunner(cats[0], device="cpu", optimizer=mode)
    got = port_plan.plan_text(port.create_plan(QUERIES[q]))
    want = ref_plan.plan_text(RefRunner(cats[1]).create_plan(QUERIES[q]))
    assert got == want
