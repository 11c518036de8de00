"""MATCH_RECOGNIZE operator: DEFINE/MEASURES evaluation over matches.

The port of the reference ``exec/match_recognize.py``.  The execution half of the row-pattern stack (reference:
operator/window/pattern/LabelEvaluator.java evaluating DEFINE conditions
with running semantics, MeasureComputation for MEASURES,
PatternRecognitionPartition driving the matcher).  Pattern matching is
sequential per partition, so rows come to host as python values; the
pattern NFA lives in exec/row_pattern.py.  The result is built on the
host and moved to the input batch's device, so the operators after it see
one device.

Expression semantics implemented (running semantics in DEFINE, final in
MEASURES, per SQL:2016 part 5):
- bare column  -> value of the CURRENT row (DEFINE) / LAST matched row
  (MEASURES)
- L.col        -> value at the LAST row labeled L so far (NULL if none)
- PREV(x[, n]) / NEXT(x[, n]) -> physical row navigation
- FIRST(L.col) / LAST(L.col)  -> first/last row labeled L
- CLASSIFIER() -> current/last row's label; MATCH_NUMBER() -> 1-based id
- sum/avg/min/max/count over (L.col | col) -> aggregate over the rows
  labeled L (or every matched row)
"""

from __future__ import annotations

from typing import Optional

from ..spi.batch import Column, ColumnBatch
from ..sql import ast
from .operators import Operator
from .row_pattern import PatternMatcher, parse_pattern

__all__ = ["MatchRecognizeOperator", "infer_measure_type"]


class _Ctx:
    """Evaluation context for one candidate row inside one match attempt."""

    def __init__(self, rows: list[dict], start: int, labels: list[str],
                 match_number: int, running: bool):
        self.rows = rows        # partition rows as dicts
        self.start = start      # partition-relative match start
        self.labels = labels    # labels assigned so far (per matched row)
        self.match_number = match_number
        self.running = running  # True in DEFINE (current row = last label)

    @property
    def cur(self) -> int:
        return self.start + len(self.labels) - 1

    def rows_with_label(self, label: Optional[str]) -> list[int]:
        out = []
        for i, l in enumerate(self.labels):
            if label is None or l == label:
                out.append(self.start + i)
        return out


def _eval(e: ast.Expr, ctx: _Ctx):
    if isinstance(e, ast.IntLiteral):
        return e.value
    if isinstance(e, ast.DoubleLiteral):
        return e.value
    if isinstance(e, ast.DecimalLiteral):
        import decimal

        return decimal.Decimal(e.text)
    if isinstance(e, ast.StringLiteral):
        return e.value
    if isinstance(e, ast.BooleanLiteral):
        return e.value
    if isinstance(e, ast.NullLiteral):
        return None
    if isinstance(e, ast.ColumnRef):
        if len(e.parts) == 2:
            # L.col: last row labeled L (running: up to the current row)
            rows = ctx.rows_with_label(e.parts[0].upper())
            if not rows:
                return None
            return ctx.rows[rows[-1]].get(e.parts[1].lower())
        return ctx.rows[ctx.cur].get(e.parts[0].lower())
    if isinstance(e, ast.BinaryOp):
        l = _eval(e.left, ctx)
        r = _eval(e.right, ctx)
        if l is None or r is None:
            return None
        op = e.op
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r if r != 0 else None
        if op == "%":
            return l % r if r != 0 else None
        if op == "||":
            return str(l) + str(r)
        raise NotImplementedError(f"MATCH_RECOGNIZE operator {op}")
    if isinstance(e, ast.Comparison):
        l = _eval(e.left, ctx)
        r = _eval(e.right, ctx)
        if l is None or r is None:
            return None
        return {"=": l == r, "<>": l != r, "!=": l != r, "<": l < r,
                "<=": l <= r, ">": l > r, ">=": l >= r}[e.op]
    if isinstance(e, ast.LogicalOp):
        vals = [_eval(t, ctx) for t in e.terms]
        if e.op == "AND":
            if any(v is False for v in vals):
                return False
            return None if any(v is None for v in vals) else True
        if any(v is True for v in vals):
            return True
        return None if any(v is None for v in vals) else False
    if isinstance(e, ast.Not):
        v = _eval(e.operand, ctx)
        return None if v is None else (not v)
    if isinstance(e, ast.IsNull):
        r = _eval(e.operand, ctx) is None
        return (not r) if e.negated else r
    if isinstance(e, ast.FunctionCall):
        return _eval_call(e, ctx)
    if isinstance(e, ast.Between):
        v = _eval(e.operand, ctx)
        lo = _eval(e.low, ctx)
        hi = _eval(e.high, ctx)
        if v is None or lo is None or hi is None:
            return None
        r = lo <= v <= hi
        return (not r) if e.negated else r
    raise NotImplementedError(
        f"MATCH_RECOGNIZE expression: {type(e).__name__}")


def _nav_target(e: ast.Expr, ctx: _Ctx, which: str):
    """FIRST/LAST(L.col) positional navigation."""
    if isinstance(e, ast.ColumnRef) and len(e.parts) == 2:
        rows = ctx.rows_with_label(e.parts[0].upper())
        col = e.parts[1].lower()
    elif isinstance(e, ast.ColumnRef):
        rows = ctx.rows_with_label(None)
        col = e.parts[0].lower()
    else:
        raise NotImplementedError(f"{which}() needs a column reference")
    if not rows:
        return None
    return ctx.rows[rows[0] if which == "first" else rows[-1]].get(col)


def _eval_call(e: ast.FunctionCall, ctx: _Ctx):
    name = e.name.lower()
    if name == "classifier":
        return ctx.labels[-1] if ctx.labels else None
    if name == "match_number":
        return ctx.match_number
    if name in ("prev", "next"):
        off = 1
        if len(e.args) > 1:
            off = int(_eval(e.args[1], ctx))
        arg = e.args[0]
        if not isinstance(arg, ast.ColumnRef):
            raise NotImplementedError(f"{name}() needs a column reference")
        col = arg.parts[-1].lower()
        if len(arg.parts) == 2:
            # PREV(A.x): navigate from the LAST row labeled A (SQL:2016)
            anchor = ctx.rows_with_label(arg.parts[0].upper())
            if not anchor:
                return None
            base = anchor[-1]
        else:
            base = ctx.cur
        idx = base + (-off if name == "prev" else off)
        if idx < 0 or idx >= len(ctx.rows):
            return None
        return ctx.rows[idx].get(col)
    if name in ("first", "last"):
        return _nav_target(e.args[0], ctx, name)
    if name in ("sum", "avg", "min", "max", "count"):
        if name == "count" and (e.is_star or not e.args):
            return len(ctx.rows_with_label(None))
        arg = e.args[0]
        if isinstance(arg, ast.ColumnRef) and len(arg.parts) == 2:
            rows = ctx.rows_with_label(arg.parts[0].upper())
            col = arg.parts[1].lower()
        elif isinstance(arg, ast.ColumnRef):
            rows = ctx.rows_with_label(None)
            col = arg.parts[0].lower()
        else:
            raise NotImplementedError(
                "MATCH_RECOGNIZE aggregates need a column reference")
        vals = [ctx.rows[i].get(col) for i in rows]
        vals = [v for v in vals if v is not None]
        if name == "count":
            return len(vals)
        if not vals:
            return None
        if name == "sum":
            return sum(vals)
        if name == "avg":
            return sum(vals) / len(vals)
        return min(vals) if name == "min" else max(vals)
    raise NotImplementedError(f"MATCH_RECOGNIZE function: {name}")


def infer_measure_type(e: ast.Expr, schema: dict):
    """Static type of a measure expression given {column -> Type}."""
    from ..spi.types import (
        BIGINT,
        BOOLEAN,
        DOUBLE,
        VARCHAR,
        common_super_type,
    )

    if isinstance(e, ast.IntLiteral):
        return BIGINT
    if isinstance(e, (ast.DoubleLiteral, ast.DecimalLiteral)):
        return DOUBLE
    if isinstance(e, ast.StringLiteral):
        return VARCHAR
    if isinstance(e, ast.BooleanLiteral):
        return BOOLEAN
    if isinstance(e, ast.ColumnRef):
        return schema.get(e.parts[-1].lower(), DOUBLE)
    if isinstance(e, ast.FunctionCall):
        n = e.name.lower()
        if n == "classifier":
            return VARCHAR
        if n in ("match_number", "count"):
            return BIGINT
        if n == "avg":
            return DOUBLE
        if n in ("sum", "min", "max", "first", "last", "prev", "next"):
            return infer_measure_type(e.args[0], schema) if e.args else DOUBLE
        return DOUBLE
    if isinstance(e, ast.BinaryOp):
        a = infer_measure_type(e.left, schema)
        b = infer_measure_type(e.right, schema)
        return common_super_type(a, b) or DOUBLE
    if isinstance(e, (ast.Comparison, ast.LogicalOp, ast.Not, ast.IsNull)):
        return BOOLEAN
    return DOUBLE


class MatchRecognizeOperator(Operator):
    """ONE ROW PER MATCH pattern recognition (reference:
    sql/planner/plan/PatternRecognitionNode.java:47 executed through
    WindowOperator's pattern partitioner)."""

    def __init__(self, partition_channels, order_keys, pattern_text: str,
                 defines, measures, skip_past: bool,
                 output_names, output_types, input_names):
        self.partition_channels = list(partition_channels)
        self.order_keys = list(order_keys)  # [(channel, ascending)]
        self.pattern = parse_pattern(pattern_text)
        self.defines = {k.upper(): v for k, v in defines}
        self.measures = list(measures)  # [(expr, name)]
        self.skip_past = skip_past
        self.output_names = list(output_names)
        self.output_types = list(output_types)
        self.input_names = [n.lower() for n in input_names]
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

    def _compute(self) -> Optional[ColumnBatch]:
        if not self._batches:
            return None
        inp = ColumnBatch.concat(self._batches)
        rows = [dict(zip(self.input_names, r)) for r in inp.to_pylist()]

        # partition + order on host (python values; partitions are small
        # relative to the scan — the heavy filtering already ran on device)
        def pkey(i):
            return tuple(
                (rows[i][self.input_names[c]] is None,
                 rows[i][self.input_names[c]])
                for c in self.partition_channels)

        def okey(i):
            out = []
            for c, asc in self.order_keys:
                v = rows[i][self.input_names[c]]
                # ASC defaults NULLS LAST, DESC defaults NULLS FIRST
                out.append((v is None if asc else v is not None,
                            v if asc else _Desc(v)))
            return tuple(out)

        idx = sorted(range(len(rows)), key=lambda i: (pkey(i), okey(i)))
        out_rows: list[tuple] = []
        start = 0
        while start < len(idx):
            end = start
            while end < len(idx) and pkey(idx[end]) == pkey(idx[start]):
                end += 1
            part_rows = [rows[i] for i in idx[start:end]]
            out_rows.extend(self._match_partition(part_rows))
            start = end
        cols = []
        for j, t in enumerate(self.output_types):
            cols.append(Column.from_values(
                t, [r[j] for r in out_rows]))
        return ColumnBatch(self.output_names, cols).to(inp.device)

    def _match_partition(self, part_rows: list[dict]) -> list[tuple]:
        holder: dict = {}

        def predicate(label: str, pos: int, labels: list[str]) -> bool:
            cond = self.defines.get(label)
            if cond is None:
                return True  # undefined label matches any row (spec)
            ctx = _Ctx(part_rows, pos - len(labels) + 1, labels,
                       holder["m"].next_match_number, True)
            return _eval(cond, ctx) is True

        matcher = PatternMatcher(self.pattern, predicate)
        holder["m"] = matcher
        out = []
        for m in matcher.find_matches(len(part_rows), self.skip_past):
            ctx = _Ctx(part_rows, m.start, m.labels, m.match_number, False)
            row = []
            for c in self.partition_channels:
                row.append(part_rows[m.start][self.input_names[c]])
            for expr, _name in self.measures:
                row.append(_eval(expr, ctx))
            out.append(tuple(row))
        return out

    def get_output(self) -> Optional[ColumnBatch]:
        if self._result is not None and not self._emitted:
            self._emitted = True
            return self._result
        return None

    def is_finished(self) -> bool:
        return self.input_done and (self._emitted or self._result is None)


class _Desc:
    """Order-inverting sort key: works for ANY comparable python value
    (negating strings char-by-char breaks on unequal lengths)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other) -> bool:
        return other.v < self.v

    def __eq__(self, other) -> bool:
        return self.v == other.v
