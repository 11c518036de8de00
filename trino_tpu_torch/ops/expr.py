"""RowExpression -> torch lowering (the bytecode-generation replacement).

The port of the reference ``ops/expr.py``: decimal/integer/double
arithmetic on scaled int64 and ``negate``, date arithmetic, ``add_months``,
calendar fields and ``date_trunc``, comparisons (dictionary-aware for
strings), three-valued AND/OR/NOT, IS NULL, ``$if``/CASE, ``$coalesce``,
``$in``, LIKE, CAST, the elementwise math functions (``abs`` ... ``atan2``,
``round``, ``truncate``, ``greatest``/``least``), the string functions as
dictionary transforms, ``$grouping_mask``, the array, map and row
functions (``cardinality``, ``element_at``, ``contains``,
``array_position``, ``$row_field``, ``map_keys`` / ``map_values``,
``repeat``), the JSON functions (``json_extract[_scalar]``,
``json_array_length``) and long decimals (precision > 18: exact python-int
transforms over the sorted scaled-int dictionary, with a literal operand).

Evaluation model, as in the reference:
- every expression evaluates to ``(data, valid)`` tensors (valid None =
  all valid), SQL three-valued logic throughout;
- literals are 0-d tensors on the expression's device and broadcast;
- strings never reach the device as bytes: a varchar expression carries a
  host-side sorted dictionary and string predicates become code compares
  or gathers of a host-computed per-entry table; array, map, row, JSON and
  long-decimal values are dictionary entries in the same way.

Errors (division by zero, integer overflow) are recorded as lane masks in
the active error scope, masked by the conditional branch that selects the
lane, and reduced to one int32 scalar per batch
(:func:`reduce_error_lanes`); the driver checks all scalars of a query in
one sync at the end (:func:`check_error_scalars`).
"""

from __future__ import annotations

import decimal
import json
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..spi.batch import (Column, _object_array, _to_days, _to_micros,
                         _to_scaled_int, rescale_scaled_int, torch_dtype)
from ..spi.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    TIMESTAMP,
    VARCHAR,
    ArrayType,
    DecimalType,
    MapType,
    RowType,
    Type,
    is_string,
)
from ..sql.ir import Call, InputRef, Literal, RowExpression
from . import datetime as dt
from .json_fns import eval_json_path, json_scalar_text, parse_json_path
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
    """One batched fetch (the worst code per device, counted by
    exec/syncguard.py); raises QueryError on the worst code."""
    if not scalars:
        return
    from ..exec import syncguard as SG

    by_device: dict = {}
    for s in scalars:
        by_device.setdefault(s.device, []).append(s)
    worst = max(int(v) for v in SG.fetch(
        [torch.stack(v).max() for v in by_device.values()],
        "expr.error-scalars"))
    if worst:
        raise QueryError(worst)


@dataclass
class Lowered:
    type: Type
    dictionary: Optional[np.ndarray]
    fn: Callable[[Cols], tuple[Any, Optional[Any]]]
    literal: Any = None  # exact python value of a constant, else None
    null_literal: bool = False  # the constant NULL
    # a DECIMAL cast to a floating type: dividing it by zero raises, as
    # exact division does (a double's x / 0 stays NULL)
    from_decimal: bool = False


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


_NESTED = (ArrayType, RowType, MapType)


def _codes_only(t: Type) -> bool:
    """Array, map, row and long-decimal values exist only as dictionary
    entries: their codes carry order and identity, never the value."""
    return isinstance(t, _NESTED) or _is_long_dec(t)


def _no_codes(args: Sequence[Lowered], what: str) -> None:
    """Arithmetic on codes would give numbers that mean nothing: raise at
    compile time instead."""
    for a in args:
        if _codes_only(a.type):
            raise NotImplementedError(f"{what} over {a.type}")


def _long_dec_transform(col: Lowered, pyfn, out_type: Type,
                        device) -> Lowered:
    """Exact host transform over a long-decimal dictionary (python ints):
    ``pyfn`` returns a scaled int at ``out_type``'s scale, or None (NULL,
    e.g. a division by zero); the rows gather the new codes."""
    vals = [pyfn(int(v)) for v in col.dictionary]
    uniq = sorted({v for v in vals if v is not None} or {0})
    pos = {v: i for i, v in enumerate(uniq)}
    remap = torch.as_tensor(np.array([pos.get(v, 0) for v in vals],
                                     dtype=np.int32), device=device)
    entry_ok = np.array([v is not None for v in vals], dtype=bool)
    ok_t = (None if entry_ok.all()
            else torch.as_tensor(entry_ok, device=device))

    def fn(cols: Cols):
        codes, valid = col.fn(cols)
        idx = codes.long()
        if ok_t is not None:
            valid = _and_valid(valid, ok_t[idx])
        return remap[idx], valid

    return Lowered(out_type, _object_array(uniq), fn)


def _long_arith_value(name: str, va, sa, vb, sb, os: int):
    """Exact scaled-int arithmetic on python ints, HALF_UP, under an
    80-digit context (the default 28 digits would round wide decimals)."""
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        A = decimal.Decimal(va).scaleb(-sa)
        B = decimal.Decimal(vb).scaleb(-sb)
        if name in ("divide", "modulus") and B == 0:
            return None
        r = {"add": A.__add__, "subtract": A.__sub__, "multiply": A.__mul__,
             "divide": A.__truediv__, "modulus": A.__mod__}[name](B)
        return int(r.scaleb(os).quantize(0, rounding=decimal.ROUND_HALF_UP))


def _numeric_literal(x: Lowered):
    """The exact int of a numeric constant (a scaled int for decimals),
    else None."""
    if x.literal is None or is_string(x.type):
        return None
    return int(x.literal)


def _long_arith(name: str, out_type: Type, a: Lowered, b: Lowered,
                device) -> Lowered:
    """Arithmetic with a long-decimal operand: one side a dictionary
    column, the other a constant, computed per dictionary entry."""
    if a.null_literal or b.null_literal:
        # a NULL operand makes the whole expression NULL
        dtype = torch_dtype(out_type.storage_dtype)

        def fn_null(cols: Cols):
            return (torch.zeros((), dtype=dtype, device=device),
                    torch.zeros((), dtype=torch.bool, device=device))

        return Lowered(out_type, _object_array([0]) if _is_long_dec(
            out_type) else None, fn_null, null_literal=True)
    os = _scale_of(out_type)
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    la, lb = _numeric_literal(a), _numeric_literal(b)
    if _is_long_dec(a.type) and a.dictionary is not None and lb is not None:
        return _and_extra_valid(_long_dec_transform(
            a, lambda v: _long_arith_value(name, v, sa, lb, sb, os),
            out_type, device), [b])
    if _is_long_dec(b.type) and b.dictionary is not None and la is not None:
        return _and_extra_valid(_long_dec_transform(
            b, lambda v: _long_arith_value(name, la, sa, v, sb, os),
            out_type, device), [a])
    raise NotImplementedError(
        "long-decimal arithmetic between two columns is not supported "
        "(dictionary-encoded int128 path; rewrite with a literal operand "
        "or cast to double)")


def _arith_handler(name: str):
    def handler(out_type: Type, args: list[Lowered], device) -> Lowered:
        a, b = args
        if _is_long_dec(a.type) or _is_long_dec(b.type) \
                or _is_long_dec(out_type):
            return _long_arith(name, out_type, a, b, device)
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
                    if any(isinstance(x.type, DecimalType) or x.from_decimal
                           for x in (a, b)):
                        _record_error(DIVISION_BY_ZERO, zero if valid is None
                                      else (zero & valid))
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


def _cmp_dict_literal(name: str, col: Lowered, lit_value) -> Lowered:
    """Compare dictionary codes against a literal (a string, a long
    decimal's scaled int, or an array / row / map tuple) using only the
    host-side sorted dictionary (order-correct by construction)."""
    d = col.dictionary
    if isinstance(lit_value, tuple):
        # numpy reads a tuple needle as an array of needles, and tuple
        # entries sort by _canon_key: a linear scan (only eq / ne get here)
        hits = [i for i, v in enumerate(d) if v == lit_value]
        lo = hits[0] if hits else 0
        hi = lo + 1 if hits else 0
    else:
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
        if any(isinstance(t, _NESTED) for t in (a.type, b.type)) \
                and name not in ("eq", "ne"):
            raise NotImplementedError("array/row/map ordering comparison")
        codes_only = _codes_only(a.type) or _codes_only(b.type)
        if is_string(a.type) or is_string(b.type) or codes_only:
            # every such operand is dictionary codes: tuples and python
            # ints compare as themselves, strings as str
            def lit(x: Lowered):
                return x.literal if codes_only else str(x.literal)

            if a.literal is not None and b.literal is None:
                return _cmp_dict_literal(_FLIP[name], b, lit(a))
            if b.literal is not None and a.literal is None:
                return _cmp_dict_literal(name, a, lit(b))
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


def _coalesce_handler(out_type, args, device):
    """First non-NULL argument; string arguments share one merged
    dictionary.  Later arguments are evaluated under a condition mask, so
    they raise only on the lanes that reach them."""
    dtype = torch_dtype(out_type.storage_dtype)
    out = args[-1]
    for a in reversed(args[:-1]):
        a2, prev, merged = _unify_pair(a, out, device)

        def make_fn(a2=a2, prev=prev):
            def fn(cols: Cols):
                av, avalid = a2.fn(cols)
                if avalid is None:
                    return av.to(dtype), None
                with expr_condition_mask(~avalid):
                    pv, pvalid = prev.fn(cols)
                data = torch.where(avalid, av.to(dtype), pv.to(dtype))
                if pvalid is None:
                    return data, None  # the fallback is never NULL
                return data, avalid | pvalid

            return fn

        out = Lowered(out_type, merged, make_fn())
    return out


def _in_handler(out_type, args, device):
    col, *items = args
    if col.dictionary is not None:
        if any(it.literal is None for it in items):
            raise NotImplementedError("IN over non-literal strings")
        if _codes_only(col.type):
            # tuples and python ints match as themselves, never as str
            hit = {it.literal for it in items}
            table = np.fromiter((v in hit for v in col.dictionary),
                                dtype=bool, count=len(col.dictionary))
        else:
            table = np.isin(col.dictionary, np.array(
                [str(it.literal) for it in items], dtype=object))
        mask = torch.as_tensor(table, device=device)

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


def _dict_scalar(col: Lowered, pyfn, out_type: Type, device) -> Lowered:
    """str -> number function as a host table per entry + device gather."""
    arr = np.array([pyfn(str(v)) for v in col.dictionary],
                   dtype=out_type.storage_dtype)
    arr_t = torch.as_tensor(arr, device=device)

    def fn(cols: Cols):
        codes, valid = col.fn(cols)
        return arr_t[codes.long()], valid

    return Lowered(out_type, None, fn)


def _table_lookup(col: Lowered, values, out_type: Type, device) -> Lowered:
    """One python value (None = NULL) per dictionary entry -> a device
    gather of the typed table (strings re-dictionaried)."""
    tab = Column.from_values(out_type, list(values))
    data_t = tab.data.to(device)
    valid_t = None if tab.valid is None else tab.valid.to(device)

    def fn(cols: Cols):
        codes, valid = col.fn(cols)
        idx = codes.long()
        return data_t[idx], (valid if valid_t is None
                             else _and_valid(valid, valid_t[idx]))

    return Lowered(out_type, tab.dictionary, fn)


def _strfn_handler(pyfn, result: str = "str"):
    def handler(out_type, args, device):
        col = args[0]
        if col.dictionary is None:
            raise NotImplementedError(
                "string function on non-dictionary column")
        if result == "str":
            return _dict_transform(col, pyfn, VARCHAR, device)
        return _dict_scalar(col, pyfn, out_type, device)

    return handler


def _literal_str(x: Lowered) -> str:
    if x.dictionary is None or len(x.dictionary) != 1:
        raise NotImplementedError("expected string literal argument")
    return str(x.dictionary[0])


def _and_extra_valid(base: Lowered, extras: Sequence[Lowered]) -> Lowered:
    """AND further operands' validity into a result computed from their
    dictionaries alone (a NULL literal lowers to dictionary [""] and
    valid False: the value shortcut must not drop it)."""
    extras = [x for x in extras if x is not None]
    if not extras:
        return base

    def fn(cols: Cols):
        d, v = base.fn(cols)
        for x in extras:
            v = _and_valid(v, x.fn(cols)[1])
        return d, v

    return Lowered(base.type, base.dictionary, fn)


_CONCAT_DICT_LIMIT = 1 << 20  # largest product dictionary of col || col


def _concat_pair(a: Lowered, b: Lowered, device) -> Lowered:
    """String concatenation in dictionary space: a literal side transforms
    the other side's dictionary; column || column builds the product
    dictionary and remaps the combined code on the device."""
    if a.dictionary is None or b.dictionary is None:
        raise NotImplementedError("concat on non-dictionary operands")
    if len(b.dictionary) == 1:
        lit = str(b.dictionary[0])
        return _and_extra_valid(
            _dict_transform(a, lambda s: s + lit, VARCHAR, device), [b])
    if len(a.dictionary) == 1:
        lit = str(a.dictionary[0])
        return _and_extra_valid(
            _dict_transform(b, lambda s: lit + s, VARCHAR, device), [a])
    na, nb = len(a.dictionary), len(b.dictionary)
    if na * nb > _CONCAT_DICT_LIMIT:
        raise NotImplementedError(
            f"concat product dictionary too large ({na}x{nb})")
    prod = np.array([str(x) + str(y) for x in a.dictionary
                     for y in b.dictionary], dtype=object)
    newdict, remap = np.unique(prod, return_inverse=True)
    remap_t = torch.as_tensor(remap.astype(np.int32), device=device)

    def fn(cols: Cols):
        (ac, av), (bc, bv) = a.fn(cols), b.fn(cols)
        return (remap_t[ac.long() * nb + bc.long()], _and_valid(av, bv))

    return Lowered(VARCHAR, newdict, fn)


def _concat_handler(out_type, args, device):
    out = args[0]
    for nxt in args[1:]:
        out = _concat_pair(out, nxt, device)
    return out


def _replace_handler(out_type, args, device):
    col = args[0]
    search = _literal_str(args[1])
    rep = _literal_str(args[2]) if len(args) > 2 else ""
    if col.dictionary is None:
        raise NotImplementedError("replace on non-dictionary column")
    return _and_extra_valid(_dict_transform(
        col, lambda s: s.replace(search, rep), VARCHAR, device), args[1:])


def _strpos_handler(out_type, args, device):
    col = args[0]
    sub = _literal_str(args[1])
    if col.dictionary is None:
        raise NotImplementedError("strpos on non-dictionary column")
    return _and_extra_valid(
        _dict_scalar(col, lambda s: s.find(sub) + 1, BIGINT, device),
        args[1:])


def _starts_with_handler(out_type, args, device):
    col = args[0]
    prefix = _literal_str(args[1])
    if col.dictionary is None:
        raise NotImplementedError("starts_with on non-dictionary column")
    return _and_extra_valid(_dict_scalar(
        col, lambda s: s.startswith(prefix), BOOLEAN, device), args[1:])


def _split_part_handler(out_type, args, device):
    col = args[0]
    delim = _literal_str(args[1])
    idx = _literal_int(args[2])
    if col.dictionary is None:
        raise NotImplementedError("split_part on non-dictionary column")
    if not delim:
        raise ValueError("split_part: delimiter must not be empty")
    if idx < 1:
        raise ValueError("split_part: index must be >= 1")

    def part(s: str):
        parts = s.split(delim)
        # Trino: NULL when the index is past the last field
        return parts[idx - 1] if idx <= len(parts) else None

    return _and_extra_valid(_table_lookup(
        col, [part(str(v)) for v in col.dictionary], VARCHAR, device),
        args[1:])


def _pad_handler(left: bool):
    def handler(out_type, args, device):
        col = args[0]
        size = _literal_int(args[1])
        fill = _literal_str(args[2]) if len(args) > 2 else " "
        if col.dictionary is None:
            raise NotImplementedError("pad on non-dictionary column")
        if size < 0:
            raise ValueError("pad: target size must not be negative")
        if not fill:
            raise ValueError("pad: padding string must not be empty")

        def pad(s: str) -> str:
            if len(s) >= size:
                return s[:size]
            p = (fill * size)[: size - len(s)]
            return p + s if left else s + p

        return _and_extra_valid(_dict_transform(col, pad, VARCHAR, device),
                                args[1:])

    return handler


def _translate_handler(out_type, args, device):
    col = args[0]
    src = _literal_str(args[1])
    dst = _literal_str(args[2])
    if col.dictionary is None:
        raise NotImplementedError("translate on non-dictionary column")
    table: dict = {}
    for i, a in enumerate(src):  # the first duplicate wins (Trino)
        table.setdefault(ord(a), dst[i] if i < len(dst) else None)
    return _and_extra_valid(_dict_transform(
        col, lambda s: s.translate(table), VARCHAR, device), args[1:])


def _codepoint_handler(out_type, args, device):
    col = args[0]
    if col.dictionary is None:
        raise NotImplementedError("codepoint on non-dictionary column")
    # Trino raises unless the input is one character; the entries are
    # evaluated for the whole dictionary (a row may never select a bad
    # one), so the per-row error becomes NULL, as in the reference
    return _table_lookup(
        col, [ord(str(v)) if len(str(v)) == 1 else None
              for v in col.dictionary], BIGINT, device)


# ---------------------------------------------------------------------------
# casts and elementwise functions


def _nested_repr_compatible(a: Type, b: Type) -> bool:
    """True when two nested types hold the same python values in their
    dictionaries (so the codes pass through a cast unchanged)."""
    def kind(t: Type):
        if isinstance(t, ArrayType):
            return ("array", kind(t.element))
        if isinstance(t, RowType):
            return ("row", tuple(kind(ft) for _, ft in t.fields))
        if isinstance(t, MapType):
            return ("map", kind(t.key), kind(t.value))
        if is_string(t):
            return "str"
        if isinstance(t, DecimalType):
            return ("dec", t.scale)
        k = np.dtype(t.storage_dtype).kind
        return {"i": "int", "u": "int", "f": "float",
                "b": "bool"}.get(k, t.name)

    return kind(a) == kind(b)


def _one_entry(out_type: Type, raw, a: Lowered, device) -> Lowered:
    """A constant as a one-entry dictionary (code 0), keeping ``a``'s
    validity."""
    def fn(cols: Cols):
        return (torch.zeros((), dtype=torch.int32, device=device),
                a.fn(cols)[1])

    return Lowered(out_type, _object_array([raw]), fn, raw)


def _long_dec_cast(out_type, a: Lowered, device) -> Lowered:
    """Casts to and from decimal(>18): dictionary transforms (exact python
    ints); a device column cast to decimal(>18) raises, as in the
    reference."""
    src = a.type
    ss, ds = _scale_of(src), _scale_of(out_type)
    if _is_long_dec(out_type):
        if a.literal is not None and not is_string(src):
            return _one_entry(out_type,
                              rescale_scaled_int(int(a.literal), ss, ds), a,
                              device)
        if _is_long_dec(src) and a.dictionary is not None:
            return _long_dec_transform(
                a, lambda v: rescale_scaled_int(v, ss, ds), out_type, device)
        if is_string(src) and a.dictionary is not None:
            # varchar -> decimal(38): an exact parse of every entry
            vals = [_to_scaled_int(str(v), ds) for v in a.dictionary]
            uniq = sorted(set(vals))
            pos = {v: i for i, v in enumerate(uniq)}
            remap = torch.as_tensor(np.array([pos[v] for v in vals],
                                             dtype=np.int32), device=device)

            def fn_vd(cols: Cols):
                codes, valid = a.fn(cols)
                return remap[codes.long()], valid

            return Lowered(out_type, _object_array(uniq), fn_vd)
        raise NotImplementedError(
            "cast of a device-resident column to decimal(>18) "
            "(dictionary-encoded int128 path) — cast to decimal(18,s) or "
            "double instead")
    if a.dictionary is None:
        raise NotImplementedError("long-decimal column without dictionary")
    if out_type.storage_dtype.kind == "f":
        return _dict_scalar(a, lambda s: int(s) / (10.0 ** ss), out_type,
                            device)
    if is_string(out_type):
        def fmt(s: str) -> str:
            with decimal.localcontext() as ctx:
                ctx.prec = 80
                return str(decimal.Decimal(int(s)).scaleb(-ss))

        return _dict_transform(a, fmt, VARCHAR, device)
    if isinstance(out_type, DecimalType) or out_type.storage_dtype.kind == "i":
        shift = ds if isinstance(out_type, DecimalType) else 0
        return _dict_scalar(
            a, lambda s: rescale_scaled_int(int(s), ss, shift), out_type,
            device)
    raise NotImplementedError(f"cast decimal(38) -> {out_type}")


def _cast_handler(out_type, args, device):
    (a,) = args
    src = a.type
    if src == out_type or (is_string(src) and is_string(out_type)):
        return a
    if isinstance(src, _NESTED) and isinstance(out_type, _NESTED):
        # codes pass through only when the python values are the same
        # (named vs anonymous row fields, integer widths); anything else
        # (string -> number elements, array -> map) must not mistype
        if _nested_repr_compatible(src, out_type):
            return Lowered(out_type, a.dictionary, a.fn, a.literal,
                           a.null_literal)
        raise NotImplementedError(
            f"cast {src} -> {out_type}: nested element conversion is not "
            "supported")
    if _is_long_dec(src) or _is_long_dec(out_type):
        return _long_dec_cast(out_type, a, device)
    ss, ds = _scale_of(src), _scale_of(out_type)
    out_dtype = torch_dtype(out_type.storage_dtype)
    # the exact value of a constant passes through numeric casts, for the
    # handlers that need a constant operand (long-decimal arithmetic)
    literal = None
    if (isinstance(a.literal, (int, np.integer)) and not is_string(src)
            and (isinstance(out_type, DecimalType)
                 or out_type.storage_dtype.kind == "i")):
        literal = rescale_scaled_int(int(a.literal), ss, ds)

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
            data = v.to(torch.int64) * dt.MICROS_PER_DAY
        elif src == TIMESTAMP and out_type == DATE:
            data = torch.div(v, dt.MICROS_PER_DAY,
                             rounding_mode="floor").to(torch.int32)
        elif out_type == BOOLEAN:
            data = v != 0
        else:
            data = v.to(out_dtype)
        return data, vv

    return Lowered(out_type, None, fn, literal, from_decimal=isinstance(
        src, DecimalType) or a.from_decimal)


def _elementwise(tfn):
    def handler(out_type, args, device):
        _no_codes(args, tfn.__name__)
        dtype = torch_dtype(out_type.storage_dtype)

        def fn(cols: Cols):
            vals, valids = zip(*[a.fn(cols) for a in args])
            valid = None
            for v in valids:
                valid = _and_valid(valid, v)
            return tfn(*vals).to(dtype), valid

        return Lowered(out_type, None, fn)

    return handler


def _cbrt(x):
    x = x.to(torch.float64)
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _round_handler(out_type, args, device):
    """round(x[, d]): DECIMAL half away from zero in scaled-int space;
    floats half to even (torch.round, as jnp.round); integers unchanged."""
    x = args[0]
    _no_codes(args, "round")
    nd = _literal_int(args[1]) if len(args) > 1 else 0

    def fn(cols: Cols):
        v, vv = x.fn(cols)
        if isinstance(x.type, DecimalType):
            s = x.type.scale
            if nd >= s:
                return v, vv
            f = torch.tensor(10 ** (s - nd), dtype=v.dtype, device=v.device)
            return _round_half_up_div(v, f) * f, vv
        if not v.is_floating_point():
            return v, vv
        f = 10.0 ** nd
        return torch.round(v * f) / f, vv

    return Lowered(out_type, None, fn)


def _truncate_handler(out_type, args, device):
    (a,) = args
    _no_codes(args, "truncate")

    def fn(cols: Cols):
        v, vv = a.fn(cols)
        if isinstance(a.type, DecimalType):
            f = 10 ** a.type.scale
            return _trunc_div(v, f) * f, vv
        return torch.trunc(v), vv  # integers unchanged

    return Lowered(out_type, None, fn)


def _const_handler(value: float):
    def handler(out_type, args, device):
        t = torch.tensor(value, dtype=torch_dtype(out_type.storage_dtype),
                         device=device)

        def fn(cols: Cols):
            return t, None

        return Lowered(out_type, None, fn)

    return handler


def _variadic_minmax(tfn):
    """greatest / least: NULL if any argument is NULL (Trino)."""

    def handler(out_type, args, device):
        _no_codes(args, "greatest / least")
        dtype = torch_dtype(out_type.storage_dtype)

        def fn(cols: Cols):
            vals, valids = zip(*[a.fn(cols) for a in args])
            data = vals[0].to(dtype)
            for v in vals[1:]:
                data = tfn(data, v.to(dtype))
            valid = None
            for v in valids:
                valid = _and_valid(valid, v)
            return data, valid

        return Lowered(out_type, None, fn)

    return handler


def _date_trunc_handler(truncfn):
    """date_trunc on DATE (days) or TIMESTAMP (micros since the epoch)."""

    def handler(out_type, args, device):
        (a,) = args
        dtype = torch_dtype(out_type.storage_dtype)

        def fn(cols: Cols):
            v, vv = a.fn(cols)
            if a.type == TIMESTAMP:
                days = torch.div(v, dt.MICROS_PER_DAY, rounding_mode="floor")
                return truncfn(days) * dt.MICROS_PER_DAY, vv
            return truncfn(v).to(dtype), vv

        return Lowered(out_type, None, fn)

    return handler


def _grouping_mask_handler(out_type, args, device):
    """grouping(): a gather of one constant mask per grouping set by the
    ``$groupid`` channel (args = [groupid, one mask literal per set])."""
    gid = args[0]
    masks = torch.tensor([_literal_int(a) for a in args[1:]],
                         dtype=torch.int64, device=device)

    def fn(cols: Cols):
        v, vv = gid.fn(cols)
        return masks[v.long()], vv

    return Lowered(out_type, None, fn)


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


# ---------------------------------------------------------------------------
# array, map, row and JSON functions: a host table per dictionary entry
# and a device gather (the reference's operator/scalar array functions,
# ArraySubscript, JsonFunctions)


def _require_dict(col: Lowered, what: str) -> None:
    if col.dictionary is None:
        raise NotImplementedError(f"{what} on non-dictionary array column")


def _repeat_handler(out_type, args, device):
    """repeat(element, count) -> array(T) (operator/scalar/
    RepeatFunction.java): a dictionary element transforms entry by entry;
    a literal builds a one-entry array dictionary."""
    col = args[0]
    n = max(_literal_int(args[1]), 0)
    if col.dictionary is not None:
        vals = _object_array([(v if isinstance(v, tuple) else str(v),) * n
                              for v in col.dictionary])
        newdict, remap = np.unique(vals, return_inverse=True)
        remap_t = torch.as_tensor(remap.astype(np.int32), device=device)

        def fn(cols: Cols):
            codes, valid = col.fn(cols)
            return remap_t[codes.long()], valid

        return _and_extra_valid(Lowered(out_type, newdict, fn), args[1:])
    if col.literal is not None:
        raw = (col.literal,) * n

        def fn_lit(cols: Cols):
            return (torch.zeros((), dtype=torch.int32, device=device),
                    col.fn(cols)[1])

        return _and_extra_valid(
            Lowered(out_type, _object_array([raw]), fn_lit), args[1:])
    raise NotImplementedError(
        "repeat element must be a dictionary column or literal")


def _row_field_handler(out_type, args, device):
    """ROW field access (sql/tree/DereferenceExpression): the field of
    every row-dictionary entry, gathered by code."""
    col = args[0]
    _require_dict(col, "row field access")
    fi = _literal_int(args[1])
    return _table_lookup(col, [v[fi] if fi < len(v) else None
                               for v in col.dictionary], out_type, device)


def _map_element_at_handler(out_type, args, device):
    """element_at(map, key): a lookup per entry (entries are key-sorted
    pair tuples)."""
    col, key = args[0], args[1]
    _require_dict(col, "element_at(map)")
    if key.literal is not None:
        needle = key.literal
    elif key.dictionary is not None and len(key.dictionary) == 1:
        needle = str(key.dictionary[0])
    else:
        raise NotImplementedError("map key must be a literal")
    return _and_extra_valid(_table_lookup(
        col, [dict(v).get(needle) for v in col.dictionary], out_type,
        device), args[1:])


def _map_parts_handler(which: int):
    def handler(out_type, args, device):
        col = args[0]
        _require_dict(col, "map_keys/map_values")
        return _table_lookup(col, [tuple(p[which] for p in v)
                                   for v in col.dictionary], out_type,
                             device)

    return handler


def _cardinality_handler(out_type, args, device):
    col = args[0]
    _require_dict(col, "cardinality")
    return _table_lookup(col, [len(v) for v in col.dictionary], BIGINT,
                         device)


def _element_at_dispatch(out_type, args, device):
    if isinstance(args[0].type, MapType):
        return _map_element_at_handler(out_type, args, device)
    return _element_at_handler(out_type, args, device)


def _element_at_handler(out_type, args, device):
    col = args[0]
    _require_dict(col, "element_at")
    i = _literal_int(args[1])
    if i == 0:
        raise NotImplementedError("SQL array indexes are 1-based")

    def pick(v):
        j = i - 1 if i > 0 else len(v) + i
        return v[j] if 0 <= j < len(v) else None

    return _and_extra_valid(_table_lookup(
        col, [pick(v) for v in col.dictionary], out_type, device), args[1:])


def _array_needle(x: Lowered):
    if x.literal is not None and not isinstance(x.type, DecimalType):
        return x.literal
    if x.dictionary is not None and len(x.dictionary) == 1:
        return str(x.dictionary[0])
    raise NotImplementedError("contains/array_position needle must be a "
                              "non-decimal literal")


def _contains_handler(out_type, args, device):
    col = args[0]
    _require_dict(col, "contains")
    needle = _array_needle(args[1])
    return _and_extra_valid(_table_lookup(
        col, [needle in v for v in col.dictionary], BOOLEAN, device),
        args[1:])


def _array_position_handler(out_type, args, device):
    col = args[0]
    _require_dict(col, "array_position")
    needle = _array_needle(args[1])

    def pos(v):
        try:
            return v.index(needle) + 1
        except ValueError:
            return 0

    return _and_extra_valid(_table_lookup(
        col, [pos(v) for v in col.dictionary], BIGINT, device), args[1:])


def _json_extract_handler(scalar: bool):
    """json_extract[_scalar](json, '$.path'): the path evaluated once per
    dictionary entry (ops/json_fns.py), gathered by code."""

    def handler(out_type, args, device):
        col = args[0]
        if col.dictionary is None:
            raise NotImplementedError(
                "json function on non-dictionary column")
        steps = parse_json_path(_literal_str(args[1]))
        vals = []
        for v in col.dictionary:
            r = eval_json_path(str(v), steps)
            if scalar:
                vals.append(json_scalar_text(r))
            else:
                vals.append(None if r is None else json.dumps(r))
        return _and_extra_valid(_table_lookup(col, vals, VARCHAR, device),
                                args[1:])

    return handler


def _json_array_length_handler(out_type, args, device):
    col = args[0]
    if col.dictionary is None:
        raise NotImplementedError("json function on non-dictionary column")

    def length(v):
        try:
            doc = json.loads(str(v))
        except (ValueError, TypeError):
            return None
        return len(doc) if isinstance(doc, list) else None

    return _table_lookup(col, [length(v) for v in col.dictionary], BIGINT,
                         device)


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
    "$coalesce": _coalesce_handler,
    "$is_null": _is_null_handler,
    "$in": _in_handler,
    "$like": _like_handler,
    "$cast": _cast_handler,
    "$grouping_mask": _grouping_mask_handler,
    "negate": _elementwise(torch.neg),
    "abs": _elementwise(torch.abs),
    "sqrt": _elementwise(torch.sqrt),
    # on integer storage (BIGINT, scaled DECIMAL) these leave the value
    # as it is, as the reference's jnp functions do
    "floor": _elementwise(torch.floor),
    "ceiling": _elementwise(torch.ceil),
    "ceil": _elementwise(torch.ceil),
    "exp": _elementwise(torch.exp),
    "ln": _elementwise(torch.log),
    "log10": _elementwise(torch.log10),
    "log2": _elementwise(torch.log2),
    "power": _elementwise(torch.pow),
    "pow": _elementwise(torch.pow),
    "sign": _elementwise(torch.sign),
    "cbrt": _elementwise(_cbrt),
    "degrees": _elementwise(torch.rad2deg),
    "radians": _elementwise(torch.deg2rad),
    "sin": _elementwise(torch.sin),
    "cos": _elementwise(torch.cos),
    "tan": _elementwise(torch.tan),
    "asin": _elementwise(torch.asin),
    "acos": _elementwise(torch.acos),
    "atan": _elementwise(torch.atan),
    "atan2": _elementwise(torch.atan2),
    "is_nan": _elementwise(torch.isnan),
    "round": _round_handler,
    "truncate": _truncate_handler,
    "pi": _const_handler(np.pi),
    "e": _const_handler(np.e),
    "greatest": _variadic_minmax(torch.maximum),
    "least": _variadic_minmax(torch.minimum),
    "add_months": _elementwise(dt.add_months),
    "year": _days_field_handler(dt.year_of),
    "month": _days_field_handler(dt.month_of),
    "day": _days_field_handler(dt.day_of),
    "quarter": _days_field_handler(dt.quarter_of),
    "day_of_week": _days_field_handler(dt.day_of_week),
    "dow": _days_field_handler(dt.day_of_week),
    "day_of_year": _days_field_handler(dt.day_of_year),
    "doy": _days_field_handler(dt.day_of_year),
    "date_trunc_year": _date_trunc_handler(dt.trunc_year),
    "date_trunc_quarter": _date_trunc_handler(dt.trunc_quarter),
    "date_trunc_month": _date_trunc_handler(dt.trunc_month),
    "date_trunc_week": _date_trunc_handler(dt.trunc_week),
    "date_trunc_day": _date_trunc_handler(lambda d: d),
    "substring": _substring_handler,
    "substr": _substring_handler,
    "upper": _strfn_handler(str.upper),
    "lower": _strfn_handler(str.lower),
    "trim": _strfn_handler(str.strip),
    "ltrim": _strfn_handler(str.lstrip),
    "rtrim": _strfn_handler(str.rstrip),
    "length": _strfn_handler(len, result="scalar"),
    "reverse": _strfn_handler(lambda s: s[::-1]),
    "concat": _concat_handler,
    "replace": _replace_handler,
    "strpos": _strpos_handler,
    "starts_with": _starts_with_handler,
    "split_part": _split_part_handler,
    "lpad": _pad_handler(left=True),
    "rpad": _pad_handler(left=False),
    "translate": _translate_handler,
    "codepoint": _codepoint_handler,
    "repeat": _repeat_handler,
    "cardinality": _cardinality_handler,
    "element_at": _element_at_dispatch,
    "contains": _contains_handler,
    "array_position": _array_position_handler,
    "$row_field": _row_field_handler,
    "map_keys": _map_parts_handler(0),
    "map_values": _map_parts_handler(1),
    "json_extract": _json_extract_handler(scalar=False),
    "json_extract_scalar": _json_extract_handler(scalar=True),
    "json_array_length": _json_array_length_handler,
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

        if isinstance(t, _NESTED):
            d0 = _object_array([()])
        elif _is_long_dec(t):
            d0 = _object_array([0])
        else:
            d0 = np.array([""], dtype=object) if is_string(t) else None
        return Lowered(t, d0, fn_null, null_literal=True)

    def fn_code0(cols: Cols):
        return torch.zeros((), dtype=torch.int32, device=device), None

    if is_string(t):
        return Lowered(t, np.array([v], dtype=object), fn_code0, v)
    if _is_long_dec(t):
        raw = _to_scaled_int(v, t.scale)
        return Lowered(t, _object_array([raw]), fn_code0, raw)
    if isinstance(t, (RowType, MapType)):
        raw = (tuple(sorted(v.items())) if isinstance(v, dict)
               else tuple(v))
        return Lowered(t, _object_array([raw]), fn_code0, raw)
    if isinstance(t, ArrayType):
        raw = tuple(v)
        return Lowered(t, _object_array([raw]), fn_code0, raw)
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
                       input_dicts: Optional[Sequence] = None, *,
                       device) -> CompiledExpression:
    """Lower ``expr`` over inputs of ``input_types`` (string inputs with
    their dictionaries) to a program on ``device``, which the caller
    names."""
    dicts = (list(input_dicts) if input_dicts is not None
             else [None] * len(input_types))
    low = _lower(expr, dicts, torch.device(device))
    return CompiledExpression(low.type, low.dictionary, low.fn)
