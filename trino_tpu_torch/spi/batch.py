"""Columnar batch data model on torch tensors (the Page/Block equivalent).

The port of the reference ``spi/batch.py``.  A :class:`Column` is one 1-D
tensor plus an optional validity mask (True = non-null) and, for strings, a
host-side **sorted** dictionary (numpy object array) that the int32 codes
index.  A :class:`ColumnBatch` is an ordered set of equal-length columns with
an optional ``live`` row mask: filters mark rows dead instead of compacting,
and every operator understands ``live`` or compacts first.

Tensors live on one device per batch.  Host numpy arrays handed to a
constructor are wrapped with ``torch.from_numpy`` (zero-copy on the CPU);
:meth:`ColumnBatch.to` moves a batch to the runner's device.

Array, map and row columns and long decimals (precision > 18) are DICT
columns too: their dictionaries hold python tuples (arrays, rows, maps as
key-sorted pairs, ordered by :func:`_canon_key`) or python scaled ints
(long decimals, numeric order), so comparisons, ORDER BY and GROUP BY on
them run over the codes, as in the reference.

Only the FLAT and DICT encodings of the reference exist here (RLE and LAZY
are not ported yet), and there is no power-of-two padding: eager PyTorch
does not recompile per shape.
"""

from __future__ import annotations

import datetime
import decimal
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .types import (BOOLEAN, DATE, DOUBLE, TIMESTAMP, ArrayType, DecimalType,
                    MapType, RowType, Type, days_to_date, is_string)

__all__ = ["Column", "ColumnBatch", "unify_dictionaries", "torch_dtype",
           "as_tensor", "encode_arrays", "encode_sorted_objects",
           "rescale_scaled_int"]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy storage dtype (types.Type.storage_dtype)."""
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def as_tensor(x, device=None) -> torch.Tensor:
    """numpy array / tensor -> tensor (zero-copy for host numpy input)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    if not a.flags.c_contiguous or not a.flags.writeable:
        a = np.ascontiguousarray(a).copy()
    t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def _canon_key(v):
    """Sort key of a tuple dictionary entry: lexicographic with NULL
    elements last (a comparison must never meet None < x)."""
    return tuple((e is None, e if e is not None else 0) for e in v)


def _object_array(values) -> np.ndarray:
    # np.array of equal-length tuples would build a 2-D array: fill by slot
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def encode_arrays(values: Sequence) -> tuple:
    """Python sequences (None = NULL) -> (codes, valid, dictionary of
    tuples sorted by :func:`_canon_key`)."""
    filled = [tuple(v) if v is not None else () for v in values]
    valid = np.array([v is not None for v in values], dtype=np.bool_)
    uniq = sorted(set(filled), key=_canon_key)
    pos = {v: i for i, v in enumerate(uniq)}
    codes = np.array([pos[v] for v in filled], dtype=np.int32)
    return codes, valid, _object_array(uniq)


def encode_sorted_objects(values: Sequence, null_fill) -> tuple:
    """Orderable python objects (long-decimal scaled ints; None = NULL) ->
    (codes, valid, sorted dictionary)."""
    valid = np.array([v is not None for v in values], dtype=np.bool_)
    filled = [v if v is not None else null_fill for v in values]
    uniq = sorted(set(filled))
    pos = {v: i for i, v in enumerate(uniq)}
    codes = np.array([pos[v] for v in filled], dtype=np.int32)
    return codes, valid, _object_array(uniq)


class Column:
    """One column: ``data`` tensor + ``valid`` mask (or None) + dictionary."""

    __slots__ = ("type", "data", "valid", "dictionary")

    def __init__(self, type: Type, data, valid=None, dictionary=None):
        self.type = type
        self.dictionary = dictionary
        self.data = as_tensor(data)
        if valid is not None:
            valid = as_tensor(valid)
            # an all-valid mask carries nothing; checking costs a device
            # sync, so only host masks are normalized
            if valid.device.type == "cpu" and bool(valid.all()):
                valid = None
        self.valid = valid

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def __repr__(self) -> str:
        return f"Column(type={self.type}, len={len(self)})"

    def to(self, device) -> "Column":
        return Column(self.type, self.data.to(device),
                      None if self.valid is None else self.valid.to(device),
                      self.dictionary)

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(len(self), dtype=torch.bool,
                              device=self.data.device)
        return self.valid

    def filter(self, mask: torch.Tensor) -> "Column":
        valid = None if self.valid is None else self.valid[mask]
        return Column(self.type, self.data[mask], valid, self.dictionary)

    def take(self, idx: torch.Tensor) -> "Column":
        """Rows at integer positions ``idx`` (same device)."""
        valid = None if self.valid is None else self.valid[idx]
        return Column(self.type, self.data[idx], valid, self.dictionary)

    def slice_rows(self, start: int, stop: int) -> "Column":
        valid = None if self.valid is None else self.valid[start:stop]
        return Column(self.type, self.data[start:stop], valid,
                      self.dictionary)

    @staticmethod
    def from_values(type_: Type, values: Sequence) -> "Column":
        """A host column from python values (None = NULL).  Strings get a
        sorted dictionary; arrays, rows and maps (as key-sorted pairs) a
        tuple dictionary; long decimals a sorted dictionary of scaled
        ints."""
        if isinstance(type_, ArrayType):
            return Column(type_, *encode_arrays(values))
        if isinstance(type_, DecimalType) and type_.is_long:
            scaled = [None if v is None else _to_scaled_int(v, type_.scale)
                      for v in values]
            return Column(type_, *encode_sorted_objects(scaled, 0))
        if isinstance(type_, RowType):
            return Column(type_, *encode_arrays(
                [None if v is None else tuple(v) for v in values]))
        if isinstance(type_, MapType):
            return Column(type_, *encode_arrays(
                [None if v is None else tuple(sorted(
                    v.items() if isinstance(v, dict) else v))
                 for v in values]))
        if None not in values:  # no mask and no per-value fill
            if is_string(type_):
                # a set's sort: np.unique's object sort of a million
                # values costs seconds
                uniq = sorted(set(values))
                pos = {v: i for i, v in enumerate(uniq)}
                codes = np.fromiter(map(pos.__getitem__, values),
                                    dtype=np.int32, count=len(values))
                return Column(type_, codes, None, _object_array(uniq))
            if not isinstance(type_, DecimalType) and \
                    type_ not in (DATE, TIMESTAMP):
                return Column(type_, np.asarray(values,
                                                dtype=type_.storage_dtype))
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        if is_string(type_):
            filled = np.array([v if v is not None else "" for v in values],
                              dtype=object)
            dictionary, codes = np.unique(filled, return_inverse=True)
            return Column(type_, codes.astype(np.int32), valid, dictionary)
        if isinstance(type_, DecimalType):
            filled = [_to_scaled_int(v, type_.scale) if v is not None else 0
                      for v in values]
        elif type_ == DATE:
            filled = [_to_days(v) if v is not None else 0 for v in values]
        elif type_ == TIMESTAMP:
            filled = [_to_micros(v) if v is not None else 0 for v in values]
        else:
            zero = type_.zero_value()
            filled = [v if v is not None else zero for v in values]
        return Column(type_, np.asarray(filled, dtype=type_.storage_dtype),
                      valid)

    def to_pylist(self) -> list:
        """Decode to python values (None for NULL) — the client boundary."""
        data = self.data.cpu().numpy()
        valid = self.valid_mask().cpu().numpy()
        t = self.type
        d = self.dictionary
        out: list = []
        if isinstance(t, ArrayType):
            for i in range(len(data)):
                out.append(list(d[data[i]]) if valid[i] else None)
        elif isinstance(t, DecimalType) and t.is_long:
            with decimal.localcontext() as ctx:
                ctx.prec = 80  # the default 28 digits round wide values
                for i in range(len(data)):
                    out.append(decimal.Decimal(int(d[data[i]])).scaleb(
                        -t.scale) if valid[i] else None)
        elif isinstance(t, RowType):
            for i in range(len(data)):
                out.append(tuple(d[data[i]]) if valid[i] else None)
        elif isinstance(t, MapType):
            for i in range(len(data)):
                out.append(dict(d[data[i]]) if valid[i] else None)
        elif t.is_dictionary_encoded:
            for i in range(len(data)):
                out.append(str(d[data[i]]) if valid[i] else None)
        elif isinstance(t, DecimalType):
            for i in range(len(data)):
                # exact: scaled int -> decimal.Decimal (never through float)
                out.append(decimal.Decimal(int(data[i])).scaleb(-t.scale)
                           if valid[i] else None)
        elif t == DATE:
            for i in range(len(data)):
                out.append(days_to_date(data[i]) if valid[i] else None)
        elif t == BOOLEAN:
            for i in range(len(data)):
                out.append(bool(data[i]) if valid[i] else None)
        elif t == DOUBLE or t.name == "real":
            for i in range(len(data)):
                out.append(float(data[i]) if valid[i] else None)
        else:
            for i in range(len(data)):
                out.append(int(data[i]) if valid[i] else None)
        return out


def _to_days(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, str):
        v = datetime.date.fromisoformat(v)
    return (v - datetime.date(1970, 1, 1)).days


def _to_micros(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, str):
        v = datetime.datetime.fromisoformat(v)
    if isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return int((v - epoch) / datetime.timedelta(microseconds=1))
    raise TypeError(f"cannot convert {type(v).__name__} to timestamp")


def rescale_scaled_int(v: int, fs: int, ds: int) -> int:
    """Exact scaled-int rescale from scale ``fs`` to ``ds``, HALF_UP
    (python ints under an 80-digit context)."""
    if ds >= fs:
        return v * 10 ** (ds - fs)
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        return int(decimal.Decimal(v).scaleb(ds - fs).quantize(
            0, rounding=decimal.ROUND_HALF_UP))


def _to_scaled_int(v, scale: int) -> int:
    """Exact conversion to a scaled int64 (never through float64 for exact
    inputs — int/str/Decimal keep full 18-digit precision)."""
    if isinstance(v, (int, np.integer)):
        return int(v) * 10**scale
    if isinstance(v, (str, decimal.Decimal)):
        with decimal.localcontext() as ctx:
            ctx.prec = 80
            d = decimal.Decimal(v)
            return int((d * 10**scale).to_integral_value(
                rounding=decimal.ROUND_HALF_UP))
    return int(round(float(v) * 10**scale))


def _same_dictionary(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return a is b or (a.shape == b.shape and bool((a == b).all()))


def unify_dictionaries(columns: Sequence[Column]) -> list[Column]:
    """Remap dictionary columns onto one shared sorted dictionary (required
    before concatenating string columns of different sources).  The merge
    runs on the host over the dictionaries; the per-row remap is one gather
    on the columns' device."""
    empty = np.array([], dtype=object)
    dicts = [c.dictionary if c.dictionary is not None else empty
             for c in columns]
    if all(_same_dictionary(d, dicts[0]) for d in dicts):
        return list(columns)
    if any(len(d) and isinstance(d[0], tuple) for d in dicts):
        # tuples holding None do not sort in numpy: merge by _canon_key
        merged_list = sorted({x for d in dicts for x in d}, key=_canon_key)
        pos = {v: i for i, v in enumerate(merged_list)}
        merged = _object_array(merged_list)
        remaps = [np.array([pos[v] for v in d], dtype=np.int32)
                  for d in dicts]
    else:
        merged = np.unique(np.concatenate(dicts))
        remaps = [np.searchsorted(merged, d).astype(np.int32) for d in dicts]
    out = []
    for c, d, remap in zip(columns, dicts, remaps):
        if not len(d):
            data = torch.zeros(len(c), dtype=torch.int32,
                               device=c.data.device)
        else:
            data = as_tensor(remap, c.data.device)[c.data.long()]
        out.append(Column(c.type, data, c.valid, merged))
    return out


@dataclass
class ColumnBatch:
    """An ordered, named set of equal-length columns (the Page equivalent).
    ``live`` is an optional bool row mask (None = every row live)."""

    names: list[str]
    columns: list[Column]
    live: Optional[torch.Tensor] = None

    def __post_init__(self):
        assert len(self.names) == len(self.columns)
        if self.columns:
            n = len(self.columns[0])
            assert all(len(c) == n for c in self.columns), "ragged batch"

    @property
    def num_rows(self) -> int:
        """Physical row slots (including dead rows when ``live`` is set)."""
        return len(self.columns[0]) if self.columns else 0

    @property
    def live_count(self) -> int:
        if self.live is None:
            return self.num_rows
        return int(self.live.sum())

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def types(self) -> list[Type]:
        return [c.type for c in self.columns]

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def to(self, device) -> "ColumnBatch":
        return ColumnBatch(self.names, [c.to(device) for c in self.columns],
                           None if self.live is None else self.live.to(device))

    def compact(self) -> "ColumnBatch":
        """Drop dead rows (stays on the batch's device, ``live`` = None)."""
        if self.live is None:
            return self
        return ColumnBatch(self.names,
                           [c.filter(self.live) for c in self.columns])

    def filter(self, mask: torch.Tensor) -> "ColumnBatch":
        assert self.live is None, "filter() on a masked batch (compact first)"
        return ColumnBatch(self.names, [c.filter(mask) for c in self.columns])

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        assert self.live is None, "slice() on a masked batch (compact first)"
        return ColumnBatch(self.names,
                           [c.slice_rows(start, stop) for c in self.columns])

    def rename(self, names: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch(list(names), self.columns, self.live)

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"], keep_live: bool = False
               ) -> "ColumnBatch":
        """Concatenate batches of one schema.  ``keep_live`` carries dead
        rows along under a combined ``live`` mask instead of compacting."""
        if not batches:
            raise ValueError("ColumnBatch.concat of an empty batch list")
        if not keep_live:
            batches = [b.compact() for b in batches]
        if len(batches) == 1:
            return batches[0]
        names = batches[0].names
        out_cols = []
        for i in range(len(names)):
            cols = [b.columns[i] for b in batches]
            if cols[0].type.is_dictionary_encoded:
                cols = unify_dictionaries(cols)
            data = torch.cat([c.data for c in cols])
            valid = None
            if any(c.valid is not None for c in cols):
                valid = torch.cat([c.valid_mask() for c in cols])
            out_cols.append(Column(cols[0].type, data, valid,
                                   cols[0].dictionary))
        live = None
        if any(b.live is not None for b in batches):
            live = torch.cat([
                b.live if b.live is not None else torch.ones(
                    b.num_rows, dtype=torch.bool, device=b.device)
                for b in batches])
        return ColumnBatch(names, out_cols, live)

    def to_pylist(self) -> list[tuple]:
        """Rows as python tuples (client/oracle boundary)."""
        dense = self.compact()
        cols = [c.to_pylist() for c in dense.columns]
        return list(zip(*cols)) if cols else []
