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

from .types import BOOLEAN, DATE, DOUBLE, DecimalType, Type, days_to_date

__all__ = ["Column", "ColumnBatch", "unify_dictionaries", "torch_dtype",
           "as_tensor"]

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

    def to_pylist(self) -> list:
        """Decode to python values (None for NULL) — the client boundary."""
        data = self.data.cpu().numpy()
        valid = self.valid_mask().cpu().numpy()
        t = self.type
        out: list = []
        if t.is_dictionary_encoded:
            d = self.dictionary
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
    merged = np.unique(np.concatenate(dicts))
    out = []
    for c, d in zip(columns, dicts):
        if not len(d):
            data = torch.zeros(len(c), dtype=torch.int32,
                               device=c.data.device)
        else:
            remap = as_tensor(np.searchsorted(merged, d).astype(np.int32),
                              c.data.device)
            data = remap[c.data.long()]
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
