"""RowExpression -> torch lowering (the bytecode-generation replacement).

The port of the reference ``ops/expr.py`` for the functions the ported
queries use: decimal/integer/double arithmetic on scaled int64, date
arithmetic, ``add_months`` and calendar fields (``year`` ...), comparisons
(dictionary-aware for strings), three-valued AND/OR/NOT, IS NULL,
``$if``/CASE, ``$in``, LIKE, ``substring`` and CAST.  Unported
functions raise NotImplementedError at compile time.

Evaluation model, as in the reference:
- every expression evaluates to ``(data, valid)`` tensors (valid None =
  all valid), SQL three-valued logic throughout;
- literals are 0-d tensors on the expression's device and broadcast;
- strings never reach the device as bytes: a varchar expression carries a
  host-side sorted dictionary and string predicates become code compares
  or gathers of a host-computed per-entry table.

Errors (division by zero, integer overflow) are recorded as lane masks in
the active error scope, masked by the conditional branch that selects the
lane, and reduced to one int32 scalar per batch
(:func:`reduce_error_lanes`); the driver checks all scalars of a query in
one sync at the end (:func:`check_error_scalars`).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..spi.batch import _to_days, _to_micros, _to_scaled_int, torch_dtype
from ..spi.types import (
    BOOLEAN,
    DATE,
    TIMESTAMP,
    VARCHAR,
    DecimalType,
    Type,
    is_string,
)
from ..sql.ir import Call, InputRef, Literal, RowExpression
from . import datetime as dt
from .like_dfa import like_mask

__all__ = ["CompiledExpression", "compile_expression", "QueryError",
           "expr_error_scope", "expr_condition_mask", "reduce_error_lanes",
           "check_error_scalars"]

Cols = Sequence[tuple[Any, Optional[Any]]]  # per-channel (data, valid)


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


# ---------------------------------------------------------------------------
# masked-lane error channel (reference: expr.py:76-172)

DIVISION_BY_ZERO = 1
NUMERIC_OUT_OF_RANGE = 2
INVALID_CAST = 3
SUBQUERY_MULTIPLE_ROWS = 4
ERROR_NAMES = {
    DIVISION_BY_ZERO: "DIVISION_BY_ZERO: division by zero",
    NUMERIC_OUT_OF_RANGE: "NUMERIC_VALUE_OUT_OF_RANGE: value out of range",
    INVALID_CAST: "INVALID_CAST_ARGUMENT: invalid cast",
    SUBQUERY_MULTIPLE_ROWS:
        "SUBQUERY_MULTIPLE_ROWS: scalar subquery returned multiple rows",
}


class QueryError(RuntimeError):
    def __init__(self, code: int):
        super().__init__(ERROR_NAMES.get(code, f"error code {code}"))
        self.code = code


class _ErrState(threading.local):
    acc = None  # list[(code, lane_mask)] while a scope is active
    mask = None  # current conditional lane mask (None = all lanes)


_ERRS = _ErrState()


@contextmanager
def expr_error_scope():
    """Collect (code, lanes) pairs recorded while evaluating expressions."""
    prev_acc, prev_mask = _ERRS.acc, _ERRS.mask
    _ERRS.acc = acc = []
    _ERRS.mask = None
    try:
        yield acc
    finally:
        _ERRS.acc, _ERRS.mask = prev_acc, prev_mask


@contextmanager
def expr_condition_mask(mask):
    """Lanes where ``mask`` is False cannot raise (unselected branch /
    filtered-out row)."""
    prev = _ERRS.mask
    if mask is not None:
        _ERRS.mask = mask if prev is None else (prev & mask)
    try:
        yield
    finally:
        _ERRS.mask = prev


def _record_error(code: int, lanes) -> None:
    if _ERRS.acc is None:
        return
    if _ERRS.mask is not None:
        lanes = lanes & _ERRS.mask
    _ERRS.acc.append((code, lanes))


def reduce_error_lanes(acc, n: int, device):
    """One int32 scalar tensor (0 = ok, else the worst error code) for a
    scope's recordings, or None when nothing error-capable ran."""
    if n == 0 or not acc:
        return None
    err = torch.zeros((), dtype=torch.int32, device=device)
    for code, lanes in acc:
        hit = torch.as_tensor(lanes, device=device).any()
        err = torch.maximum(err, torch.where(
            hit, torch.tensor(code, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device)))
    return err


def check_error_scalars(scalars) -> None:
    """One batched fetch; raises QueryError on the worst code."""
    if not scalars:
        return
    worst = int(torch.stack([s.cpu() for s in scalars]).max())
    if worst:
        raise QueryError(worst)


@dataclass
class Lowered:
    type: Type
    dictionary: Optional[np.ndarray]
    fn: Callable[[Cols], tuple[Any, Optional[Any]]]
    literal: Any = None  # exact python value of a constant, else None


@dataclass
class CompiledExpression:
    """Public handle: callable on per-channel (data, valid) pairs."""

    type: Type
    dictionary: Optional[np.ndarray]
    _fn: Callable[[Cols], tuple[Any, Optional[Any]]]

    def __call__(self, cols: Cols) -> tuple[Any, Optional[Any]]:
        return self._fn(cols)


# ---------------------------------------------------------------------------
# elementwise numeric helpers


def _trunc_div(a, b):
    """SQL integer division truncates toward zero."""
    return torch.div(a, b, rounding_mode="trunc")


def _round_half_up_div(a, b):
    """Rounded division for decimal rescale: half away from zero."""
    q = torch.div(2 * torch.abs(a) + torch.abs(b), 2 * torch.abs(b),
                  rounding_mode="floor")
    return torch.where((a < 0) ^ (b < 0), -q, q)


def _decimal_rescale(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    return _round_half_up_div(
        data, torch.tensor(10 ** (from_scale - to_scale), dtype=data.dtype,
                           device=data.device))


def _scale_of(t: Type) -> int:
    return t.scale if isinstance(t, DecimalType) else 0


def _is_long_dec(t: Type) -> bool:
    return isinstance(t, DecimalType) and t.precision > 18


def _arith_handler(name: str):
    def handler(out_type: Type, args: list[Lowered], device) -> Lowered:
        a, b = args
        if _is_long_dec(a.type) or _is_long_dec(b.type) \
                or _is_long_dec(out_type):
            raise NotImplementedError("long-decimal arithmetic")
        out_dtype = torch_dtype(out_type.storage_dtype)

        def fn(cols: Cols):
            (av, avalid), (bv, bvalid) = a.fn(cols), b.fn(cols)
            valid = _and_valid(avalid, bvalid)
            if isinstance(out_type, DecimalType):
                av = av.to(torch.int64)
                bv = bv.to(torch.int64)
                os = out_type.scale
                if name in ("add", "subtract"):
                    av2 = _decimal_rescale(av, _scale_of(a.type), os)
                    bv2 = _decimal_rescale(bv, _scale_of(b.type), os)
                    data = av2 + bv2 if name == "add" else av2 - bv2
                elif name == "multiply":
                    data = _decimal_rescale(
                        av * bv, _scale_of(a.type) + _scale_of(b.type), os)
                elif name == "divide":
                    shift = os - _scale_of(a.type) + _scale_of(b.type)
                    num = (av * (10 ** shift) if shift >= 0
                           else _decimal_rescale(av, -shift, 0))
                    zero = bv == 0
                    data = _round_half_up_div(num, torch.where(zero, 1, bv))
                    _record_error(DIVISION_BY_ZERO, zero if valid is None
                                  else (zero & valid))
                    valid = _and_valid(valid, ~zero)
                else:  # modulus
                    s = max(_scale_of(a.type), _scale_of(b.type))
                    av2 = _decimal_rescale(av, _scale_of(a.type), s)
                    bv2 = _decimal_rescale(bv, _scale_of(b.type), s)
                    zero = bv2 == 0
                    safe_b = torch.where(zero, 1, bv2)
                    data = av2 - _trunc_div(av2, safe_b) * bv2
                    _record_error(DIVISION_BY_ZERO, zero if valid is None
                                  else (zero & valid))
                    valid = _and_valid(valid, ~zero)
                return data, valid
            av = av.to(out_dtype)
            bv = bv.to(out_dtype)
            is_int = not out_dtype.is_floating_point

            def ovf_err(ovf):
                _record_error(NUMERIC_OUT_OF_RANGE,
                              ovf if valid is None else (ovf & valid))

            if name == "add":
                data = av + bv
                if is_int:  # wraparound flips the sign against both
                    ovf_err(((av ^ data) & (bv ^ data)) < 0)
            elif name == "subtract":
                data = av - bv
                if is_int:
                    ovf_err(((av ^ bv) & (av ^ data)) < 0)
            elif name == "multiply":
                data = av * bv
                if is_int:  # a wrapped product no longer divides back
                    safe_a = torch.where(av == 0, 1, av)
                    ovf_err((av != 0) & (_trunc_div(data, safe_a) != bv))
            elif name == "divide":
                zero = bv == 0
                if is_int:
                    data = _trunc_div(av, torch.where(zero, 1, bv))
                    _record_error(DIVISION_BY_ZERO, zero if valid is None
                                  else (zero & valid))
                else:
                    data = av / torch.where(zero, 1.0, bv)
                valid = _and_valid(valid, ~zero)
            else:  # modulus
                zero = bv == 0
                safe_b = torch.where(zero, 1, bv)
                if is_int:
                    data = av - _trunc_div(av, safe_b) * bv
                    _record_error(DIVISION_BY_ZERO, zero if valid is None
                                  else (zero & valid))
                else:
                    data = av - torch.trunc(av / safe_b) * bv
                valid = _and_valid(valid, ~zero)
            return data, valid

        return Lowered(out_type, None, fn)

    return handler


# ---------------------------------------------------------------------------
# comparisons (dictionary-aware)

_CMP = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
    "le": torch.le, "gt": torch.gt, "ge": torch.ge,
}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq",
         "ne": "ne"}


def _dicts_equal(a, b) -> bool:
    if a is None or b is None:
        return False
    return a is b or (a.shape == b.shape and bool((a == b).all()))


def _cmp_dict_literal(name: str, col: Lowered, lit_value: str) -> Lowered:
    """Compare dictionary codes against a string literal using only the
    host-side sorted dictionary (order-correct by construction)."""
    d = col.dictionary
    lo = int(np.searchsorted(d, lit_value, side="left"))
    hi = int(np.searchsorted(d, lit_value, side="right"))
    present = lo < hi

    def fn(cols: Cols):
        codes, valid = col.fn(cols)
        if name == "eq":
            data = (codes == lo) if present else torch.zeros_like(
                codes, dtype=torch.bool)
        elif name == "ne":
            data = (codes != lo) if present else torch.ones_like(
                codes, dtype=torch.bool)
        elif name == "lt":
            data = codes < lo
        elif name == "le":
            data = codes < hi
        elif name == "gt":
            data = codes >= hi
        else:  # ge
            data = codes >= lo
        return data, valid

    return Lowered(BOOLEAN, None, fn)


def _cmp_handler(name: str):
    def handler(out_type: Type, args: list[Lowered], device) -> Lowered:
        a, b = args
        if is_string(a.type) or is_string(b.type):
            if a.literal is not None and b.literal is None:
                return _cmp_dict_literal(_FLIP[name], b, str(a.literal))
            if b.literal is not None and a.literal is None:
                return _cmp_dict_literal(name, a, str(b.literal))
            if not _dicts_equal(a.dictionary, b.dictionary):
                if name not in ("eq", "ne"):
                    raise NotImplementedError(
                        f"ordering comparison across distinct dictionaries "
                        f"({name})")
                # translate b's code space into a's
                trans = np.searchsorted(a.dictionary, b.dictionary).clip(
                    0, len(a.dictionary) - 1)
                hit = a.dictionary[trans] == b.dictionary
                trans_t = torch.as_tensor(trans.astype(np.int64),
                                          device=device)
                hit_t = torch.as_tensor(hit.astype(bool), device=device)

                def fn_x(cols: Cols):
                    (ac, avalid), (bc, bvalid) = a.fn(cols), b.fn(cols)
                    bl = bc.long()
                    eq = (ac.long() == trans_t[bl]) & hit_t[bl]
                    return ((eq if name == "eq" else ~eq),
                            _and_valid(avalid, bvalid))

                return Lowered(BOOLEAN, None, fn_x)

        def fn(cols: Cols):
            (av, avalid), (bv, bvalid) = a.fn(cols), b.fn(cols)
            return _CMP[name](av, bv), _and_valid(avalid, bvalid)

        return Lowered(BOOLEAN, None, fn)

    return handler


# ---------------------------------------------------------------------------
# boolean logic (three-valued)


def _and_handler(out_type, args, device):
    # FALSE if any definite FALSE; else NULL if any NULL.
    def fn(cols: Cols):
        data, valid = None, None
        for a in args:
            # short-circuit masking: once an earlier term is definite FALSE
            # the remaining terms cannot raise on that lane
            with expr_condition_mask(data):
                v, vv = a.fn(cols)
            eff = v if vv is None else (v | ~vv)
            data = eff if data is None else (data & eff)
            valid = _and_valid(valid, vv)
        if valid is not None:
            valid = valid | ~data  # definite false wins over null
        return data, valid

    return Lowered(BOOLEAN, None, fn)


def _or_handler(out_type, args, device):
    # TRUE if any definite TRUE; NULL lanes normalize to FALSE.
    def fn(cols: Cols):
        data, valid = None, None
        for a in args:
            with expr_condition_mask(None if data is None else ~data):
                v, vv = a.fn(cols)
            eff = v if vv is None else (v & vv)
            data = eff if data is None else (data | eff)
            valid = _and_valid(valid, vv)
        if valid is not None:
            valid = valid | data  # definite true wins over null
        return data, valid

    return Lowered(BOOLEAN, None, fn)


def _not_handler(out_type, args, device):
    (a,) = args

    def fn(cols: Cols):
        v, vv = a.fn(cols)
        return ~v, vv

    return Lowered(BOOLEAN, None, fn)


def _is_null_handler(out_type, args, device):
    (a,) = args

    def fn(cols: Cols):
        v, vv = a.fn(cols)
        if vv is None:
            return torch.zeros(v.shape, dtype=torch.bool, device=device), None
        return ~vv, None

    return Lowered(BOOLEAN, None, fn)


# ---------------------------------------------------------------------------
# conditionals


def _unify_pair(a: Lowered, b: Lowered, device):
    """Remap two dictionary-typed lowerings onto one merged dictionary."""
    if a.dictionary is None and b.dictionary is None:
        return a, b, None
    da = a.dictionary if a.dictionary is not None else np.array([], object)
    db = b.dictionary if b.dictionary is not None else np.array([], object)
    if _dicts_equal(da, db):
        return a, b, da
    merged = np.unique(np.concatenate([da, db]))

    def remapped(x: Lowered, d: np.ndarray) -> Lowered:
        remap = (torch.as_tensor(np.searchsorted(merged, d).astype(np.int32),
                                 device=device) if len(d) else None)

        def fn(cols: Cols):
            v, vv = x.fn(cols)
            return (remap[v.long()] if remap is not None else v), vv

        return Lowered(x.type, merged, fn)

    return remapped(a, da), remapped(b, db), merged


def _if_handler(out_type, args, device):
    cond, t, f = args
    t2, f2, merged = _unify_pair(t, f, device)
    dtype = torch_dtype(out_type.storage_dtype)

    def fn(cols: Cols):
        cv, cvalid = cond.fn(cols)
        take_true = cv if cvalid is None else (cv & cvalid)
        # a branch's errors only count on the lanes that select it
        with expr_condition_mask(take_true):
            tv, tvalid = t2.fn(cols)
        with expr_condition_mask(~take_true):
            fv, fvalid = f2.fn(cols)
        data = torch.where(take_true, tv.to(dtype), fv.to(dtype))
        if tvalid is None and fvalid is None:
            valid = None
        else:
            tvv = tvalid if tvalid is not None else torch.ones(
                (), dtype=torch.bool, device=device)
            fvv = fvalid if fvalid is not None else torch.ones(
                (), dtype=torch.bool, device=device)
            valid = torch.where(take_true, tvv, fvv)
        return data, valid

    return Lowered(out_type, merged, fn)


def _in_handler(out_type, args, device):
    col, *items = args
    if col.dictionary is not None:
        vals = []
        for it in items:
            if it.literal is None:
                raise NotImplementedError("IN over non-literal strings")
            vals.append(str(it.literal))
        mask = torch.as_tensor(
            np.isin(col.dictionary, np.array(vals, dtype=object)),
            device=device)

        def fn(cols: Cols):
            codes, valid = col.fn(cols)
            return mask[codes.long()], valid

        return Lowered(BOOLEAN, None, fn)

    def fn(cols: Cols):
        cv, cvalid = col.fn(cols)
        data = None
        for it in items:
            iv, _ = it.fn(cols)
            hit = cv == iv
            data = hit if data is None else (data | hit)
        return data, cvalid

    return Lowered(BOOLEAN, None, fn)


# ---------------------------------------------------------------------------
# LIKE and string functions as dictionary transforms (host) + gathers


def _like_handler(out_type, args, device):
    col, pat = args[0], args[1]
    esc = args[2] if len(args) > 2 else None
    if (col.dictionary is None or pat.dictionary is None
            or len(pat.dictionary) != 1):
        raise NotImplementedError(
            "LIKE requires a dictionary column and literal pattern")
    escape = (str(esc.dictionary[0])
              if esc is not None and esc.dictionary is not None else None)
    mask = torch.as_tensor(
        like_mask(col.dictionary, str(pat.dictionary[0]), escape),
        device=device)

    def fn(cols: Cols):
        codes, valid = col.fn(cols)
        return mask[codes.long()], valid

    return Lowered(BOOLEAN, None, fn)


def _dict_transform(col: Lowered, pyfn, out_type: Type, device) -> Lowered:
    """str -> str function as a host dictionary transform + device remap."""
    vals = np.array([pyfn(str(v)) for v in col.dictionary], dtype=object)
    newdict, remap = np.unique(vals, return_inverse=True)
    remap_t = torch.as_tensor(remap.astype(np.int32), device=device)

    def fn(cols: Cols):
        codes, valid = col.fn(cols)
        return remap_t[codes.long()], valid

    return Lowered(out_type, newdict, fn)


def _literal_int(x: Lowered) -> int:
    if x.literal is None or x.dictionary is not None:
        raise NotImplementedError("expected integer literal argument")
    return int(x.literal)


def _substring_handler(out_type, args, device):
    col = args[0]
    start = _literal_int(args[1])
    length = _literal_int(args[2]) if len(args) > 2 else None
    if col.dictionary is None:
        raise NotImplementedError("substring on non-dictionary column")

    def sub(s: str) -> str:
        i = start - 1 if start > 0 else len(s) + start
        return s[i: i + length] if length is not None else s[i:]

    return _dict_transform(col, sub, VARCHAR, device)


# ---------------------------------------------------------------------------
# casts and elementwise functions


def _cast_handler(out_type, args, device):
    (a,) = args
    src = a.type
    if src == out_type or (is_string(src) and is_string(out_type)):
        return a
    if _is_long_dec(src) or _is_long_dec(out_type):
        raise NotImplementedError(f"cast {src} -> {out_type}")
    ss, ds = _scale_of(src), _scale_of(out_type)
    out_dtype = torch_dtype(out_type.storage_dtype)

    def fn(cols: Cols):
        v, vv = a.fn(cols)
        if isinstance(out_type, DecimalType):
            if isinstance(src, DecimalType) or not v.is_floating_point():
                data = _decimal_rescale(v.to(torch.int64), ss, ds)
            else:  # float -> decimal
                data = torch.round(v * (10.0 ** ds)).to(torch.int64)
        elif isinstance(src, DecimalType):
            if out_dtype.is_floating_point:
                # in float64: int64 / a python float would give float32
                data = (v.to(torch.float64) / (10.0 ** ss)).to(out_dtype)
            else:
                data = _decimal_rescale(v, ss, 0).to(out_dtype)
        elif src == DATE and out_type == TIMESTAMP:
            data = v.to(torch.int64) * 86_400_000_000
        elif out_type == BOOLEAN:
            data = v != 0
        else:
            data = v.to(out_dtype)
        return data, vv

    return Lowered(out_type, None, fn)


def _elementwise(tfn):
    def handler(out_type, args, device):
        dtype = torch_dtype(out_type.storage_dtype)

        def fn(cols: Cols):
            vals, valids = zip(*[a.fn(cols) for a in args])
            valid = None
            for v in valids:
                valid = _and_valid(valid, v)
            return tfn(*vals).to(dtype), valid

        return Lowered(out_type, None, fn)

    return handler


def _days_field_handler(field_fn):
    """Calendar field extraction over DATE (days) or TIMESTAMP (micros)."""

    def handler(out_type, args, device):
        (a,) = args
        dtype = torch_dtype(out_type.storage_dtype)

        def fn(cols: Cols):
            v, vv = a.fn(cols)
            if a.type == TIMESTAMP:
                v = torch.div(v, dt.MICROS_PER_DAY, rounding_mode="floor")
            return field_fn(v).to(dtype), vv

        return Lowered(out_type, None, fn)

    return handler


HANDLERS: dict[str, Callable] = {
    "add": _arith_handler("add"),
    "subtract": _arith_handler("subtract"),
    "multiply": _arith_handler("multiply"),
    "divide": _arith_handler("divide"),
    "modulus": _arith_handler("modulus"),
    "eq": _cmp_handler("eq"),
    "ne": _cmp_handler("ne"),
    "lt": _cmp_handler("lt"),
    "le": _cmp_handler("le"),
    "gt": _cmp_handler("gt"),
    "ge": _cmp_handler("ge"),
    "$and": _and_handler,
    "$or": _or_handler,
    "$not": _not_handler,
    "$if": _if_handler,
    "$is_null": _is_null_handler,
    "$in": _in_handler,
    "$like": _like_handler,
    "$cast": _cast_handler,
    "add_months": _elementwise(dt.add_months),
    "year": _days_field_handler(dt.year_of),
    "month": _days_field_handler(dt.month_of),
    "day": _days_field_handler(dt.day_of),
    "quarter": _days_field_handler(dt.quarter_of),
    "substring": _substring_handler,
    "substr": _substring_handler,
}


# ---------------------------------------------------------------------------
# compiler entry points


def _lower_literal(expr: Literal, device) -> Lowered:
    t = expr.type
    v = expr.value
    dtype = torch_dtype(t.storage_dtype)
    if v is None:
        def fn_null(cols: Cols):
            return (torch.zeros((), dtype=dtype, device=device),
                    torch.zeros((), dtype=torch.bool, device=device))

        return Lowered(t, np.array([""], dtype=object) if is_string(t)
                       else None, fn_null)
    if is_string(t):
        d = np.array([v], dtype=object)

        def fn_str(cols: Cols):
            return torch.zeros((), dtype=torch.int32, device=device), None

        return Lowered(t, d, fn_str, v)
    if _is_long_dec(t):
        raise NotImplementedError("long-decimal literal")
    if isinstance(t, DecimalType):
        raw = _to_scaled_int(v, t.scale)
    elif t == DATE:
        raw = _to_days(v)
    elif t == TIMESTAMP:
        raw = _to_micros(v)
    else:
        raw = v
    value = torch.tensor(raw, dtype=dtype, device=device)

    def fn_lit(cols: Cols):
        return value, None

    return Lowered(t, None, fn_lit, raw)


def _lower(expr: RowExpression, input_dicts, device) -> Lowered:
    if isinstance(expr, InputRef):
        idx = expr.index

        def fn(cols: Cols):
            return cols[idx]

        return Lowered(expr.type, input_dicts[idx], fn)
    if isinstance(expr, Literal):
        return _lower_literal(expr, device)
    assert isinstance(expr, Call), expr
    handler = HANDLERS.get(expr.name)
    if handler is None:
        raise NotImplementedError(
            f"scalar function not implemented: {expr.name}")
    args = [_lower(a, input_dicts, device) for a in expr.args]
    return handler(expr.type, args, device)


def compile_expression(expr: RowExpression, input_types: Sequence[Type],
                       input_dicts: Optional[Sequence] = None,
                       device="cpu") -> CompiledExpression:
    dicts = (list(input_dicts) if input_dicts is not None
             else [None] * len(input_types))
    low = _lower(expr, dicts, torch.device(device))
    return CompiledExpression(low.type, low.dictionary, low.fn)
