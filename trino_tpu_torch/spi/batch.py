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

Besides FLAT and DICT, a column may be RLE (one value and a run length,
expanded on its device only when something reads ``data``) or LAZY (a
thunk whose host data is copied to the column's device on first read):
the scan makes them (exec/prefetch.py) and encoding-aware operators pass
them through.  There is no power-of-two padding: eager PyTorch does not
recompile per shape.
"""

from __future__ import annotations

import datetime
import decimal
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..caching.executable_cache import memo
from .types import (BOOLEAN, DATE, DOUBLE, TIMESTAMP, ArrayType, DecimalType,
                    MapType, RowType, Type, days_to_date, is_string)

__all__ = ["Column", "ColumnBatch", "unify_dictionaries", "torch_dtype",
           "as_tensor", "encode_arrays", "encode_sorted_objects",
           "rescale_scaled_int", "maybe_rle", "RLE_DETECT_MIN_ROWS"]

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


def host_table(a, device) -> torch.Tensor:
    """A small host array (a remap or hash table) as a tensor on
    ``device``.  To the card it goes from pinned memory without blocking
    the host: a copy from pageable memory would wait for the stream, and
    under torch's sync debug mode it counts as a synchronization."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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


def _canon_device(device) -> torch.device:
    """``device`` with its index filled in ("cuda" -> "cuda:<current>"),
    so it compares equal to the device of the tensors made there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _normalized_valid(valid):
    """An all-valid mask carries nothing: None.  Checking costs a device
    sync, so only host masks are normalized."""
    if valid is None:
        return None
    valid = as_tensor(valid)
    if valid.device.type == "cpu" and bool(valid.all()):
        return None
    return valid


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a copy from pinned host memory does not block
    the host (the caller keeps the buffer until the copy's event)."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.device.type == "cpu"
                and device.type == "cuda" and t.is_pinned())


def _dictionary_nbytes(d) -> int:
    """Payload bytes of a dictionary: an object dictionary (strings,
    tuples) reports pointer bytes through .nbytes, so its payload is
    summed once per dictionary object (accounting, not an allocator
    figure)."""
    if d is None:
        return 0
    if d.dtype != object:
        return int(d.nbytes)
    return _object_payload_nbytes(d)


@memo("batch.dictionary_nbytes", maxsize=4096, weak=True)
def _object_payload_nbytes(d) -> int:
    return sum(len(str(v).encode("utf-8", "replace")) for v in d)


_MATERIALIZE_LOCK = threading.RLock()


class Column:
    """One column: ``data`` tensor + ``valid`` mask (or None) + dictionary.

    The reference's sealed Block shapes are an ``encoding`` tag:

    - ``FLAT``: a dense tensor; ``DICT``: FLAT int32 codes with a host
      ``dictionary`` (mandatory for strings);
    - ``RLE``: ONE stored value repeated ``len`` times on ``device``
      (``valid`` may still be a full-length mask);
    - ``LAZY``: a thunk yielding host ``(data, valid)`` on first touch,
      copied to ``device`` then; until touched the column costs no device
      memory and no copy.

    ``data`` / ``valid`` are properties: reading them on a LAZY column runs
    the thunk exactly once; on an RLE column ``data`` is a contiguous
    ``torch.full`` on the device, made once (kernel wrappers refuse strided
    inputs).  Encoding-aware operators check ``encoding`` first."""

    __slots__ = ("type", "dictionary", "_data", "_valid", "_length", "_enc",
                 "_rle_value", "_thunk", "_nbytes_hint", "_device",
                 "_on_materialize")

    def __init__(self, type: Type, data, valid=None, dictionary=None):
        self.type = type
        self.dictionary = dictionary
        self._data = as_tensor(data)
        self._length = int(self._data.shape[0])
        self._device = self._data.device
        self._enc = "FLAT"
        self._rle_value = None
        self._thunk = None
        self._nbytes_hint = 0
        self._on_materialize = None
        self._valid = _normalized_valid(valid)

    # -- encoded constructors ----------------------------------------------

    @staticmethod
    def rle(type_: Type, value, length: int, valid=None, dictionary=None, *,
            device) -> "Column":
        """Run-length column: ``value`` (the storage-dtype scalar, the int32
        code for a dictionary column) repeated ``length`` times on
        ``device``; ``valid`` may be a full-length mask (NULLs inside the
        run), moved to ``device``."""
        c = Column.__new__(Column)
        c.type = type_
        c.dictionary = dictionary
        dtype = np.int32 if dictionary is not None else type_.storage_dtype
        c._rle_value = np.asarray(value, dtype=dtype)
        c._enc = "RLE"
        c._data = None
        c._length = int(length)
        c._device = _canon_device(device)
        c._thunk = None
        c._nbytes_hint = 0
        c._on_materialize = None
        c._valid = _normalized_valid(
            None if valid is None else as_tensor(valid, c._device))
        return c

    @staticmethod
    def lazy(type_: Type, length: int, thunk, dictionary=None, *, device,
             nbytes_hint: int = 0, on_materialize=None) -> "Column":
        """Deferred column: ``thunk()`` returns host ``(data, valid)`` and
        runs at most once, on the first ``data`` / ``valid`` read; the
        column then copies both to ``device`` (non-blocking from pinned
        memory) and calls ``on_materialize(column)``.  ``nbytes_hint``
        stands for the bytes while nothing is materialized."""
        c = Column.__new__(Column)
        c.type = type_
        c.dictionary = dictionary
        c._enc = "LAZY"
        c._rle_value = None
        c._thunk = thunk
        c._nbytes_hint = int(nbytes_hint)
        c._on_materialize = on_materialize
        c._data = None
        c._valid = None
        c._length = int(length)
        c._device = _canon_device(device)
        return c

    # -- encoding accessors ------------------------------------------------

    @property
    def encoding(self) -> str:
        """``FLAT | DICT | RLE | LAZY``; DICT is a flat code tensor with a
        dictionary attached."""
        if self._enc == "FLAT" and self.dictionary is not None:
            return "DICT"
        return self._enc

    @property
    def rle_value(self) -> np.ndarray:
        """The RLE run's stored scalar (storage dtype; the code if DICT)."""
        if self._enc != "RLE":
            raise ValueError(f"rle_value of a {self.encoding} column")
        return self._rle_value

    @property
    def is_materialized(self) -> bool:
        return self._data is not None or self._enc == "RLE"

    @property
    def device(self) -> torch.device:
        return self._device

    def _materialize(self) -> None:
        # under one lock, ``_data`` set last: the live-mask views of a HASH
        # local exchange share this column across concurrent drivers, and
        # a reader that sees ``_data`` must see the mask and encoding too
        with _MATERIALIZE_LOCK:
            if self._data is not None:
                return
            if self._enc == "RLE":
                self._data = torch.full(
                    (self._length,), self._rle_value.item(),
                    dtype=torch_dtype(self._rle_value.dtype),
                    device=self._device)
                return
            thunk, self._thunk = self._thunk, None
            data, valid = thunk()
            data = _to_device(as_tensor(data), self._device)
            if int(data.shape[0]) != self._length:
                raise ValueError(f"lazy column thunk gave {data.shape[0]} "
                                 f"rows, expected {self._length}")
            self._valid = _normalized_valid(
                None if valid is None
                else _to_device(as_tensor(valid), self._device))
            self._enc = "FLAT"
            self._data = data
            if self._on_materialize is not None:
                self._on_materialize(self)

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._materialize()
        return self._data

    @property
    def valid(self) -> Optional[torch.Tensor]:
        if self._data is None and self._enc == "LAZY":
            self._materialize()
        return self._valid

    def __len__(self) -> int:
        return self._length

    def __repr__(self) -> str:
        return (f"Column(type={self.type}, encoding={self.encoding}, "
                f"len={self._length})")

    @property
    def tensor_nbytes(self) -> int:
        """Bytes of the column's tensors: the run's one value for RLE, the
        hint while LAZY, the data otherwise, plus the mask."""
        if self._enc == "RLE":
            n = int(self._rle_value.nbytes)
        elif self._data is None:
            n = self._nbytes_hint
        else:
            n = self._data.numel() * self._data.element_size()
        if self._valid is not None:
            n += self._valid.numel()
        return n

    @property
    def nbytes(self) -> int:
        """Bytes held: :attr:`tensor_nbytes` plus the dictionary's
        payload."""
        return self.tensor_nbytes + _dictionary_nbytes(self.dictionary)

    @property
    def flat_nbytes(self) -> int:
        """Bytes of the expanded flat representation (what execution
        without encodings carries): the baseline of bytes saved."""
        itemsize = np.dtype(np.int32 if self.dictionary is not None
                            else self.type.storage_dtype).itemsize
        n = self._length * itemsize
        if self._valid is not None:
            n += self._length
        return n + _dictionary_nbytes(self.dictionary)

    def to(self, device) -> "Column":
        """The column on ``device`` (itself when already there); an RLE run
        stays a run."""
        dev = _canon_device(device)
        if dev == self._device:
            return self
        if self._enc == "RLE":
            return Column.rle(self.type, self._rle_value, self._length,
                              self._valid, self.dictionary, device=dev)
        valid = self.valid
        return Column(self.type, self.data.to(dev),
                      None if valid is None else valid.to(dev),
                      self.dictionary)

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(len(self), dtype=torch.bool,
                              device=self._device)
        return self.valid

    def _empty_flat(self) -> "Column":
        """A zero-row flat column: an empty selection of a LAZY column
        skips its thunk."""
        dtype = np.int32 if self.dictionary is not None \
            else self.type.storage_dtype
        return Column(self.type, torch.empty(0, dtype=torch_dtype(dtype),
                                             device=self._device),
                      None, self.dictionary)

    def filter(self, mask: torch.Tensor) -> "Column":
        if self._enc == "RLE":
            # a selection of a constant run is still a constant run
            n = int(mask.sum())
            valid = None if self._valid is None else self._valid[mask]
            return Column.rle(self.type, self._rle_value, n, valid,
                              self.dictionary, device=self._device)
        if self._data is None and not bool(mask.any()):
            return self._empty_flat()
        valid = None if self.valid is None else self.valid[mask]
        return Column(self.type, self.data[mask], valid, self.dictionary)

    def take(self, idx: torch.Tensor) -> "Column":
        """Rows at integer positions ``idx`` (same device)."""
        if self._enc == "RLE":
            valid = None if self._valid is None else self._valid[idx]
            return Column.rle(self.type, self._rle_value, int(idx.shape[0]),
                              valid, self.dictionary, device=self._device)
        if self._data is None and int(idx.shape[0]) == 0:
            return self._empty_flat()
        valid = None if self.valid is None else self.valid[idx]
        return Column(self.type, self.data[idx], valid, self.dictionary)

    def slice_rows(self, start: int, stop: int) -> "Column":
        if self._enc == "RLE":
            stop = min(stop, self._length)
            valid = None if self._valid is None else self._valid[start:stop]
            return Column.rle(self.type, self._rle_value,
                              max(0, stop - start), valid, self.dictionary,
                              device=self._device)
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
        if c.encoding == "RLE":  # the run's one code moves
            out.append(Column.rle(
                c.type, remap[int(c.rle_value)] if len(d) else 0, len(c),
                c.valid, merged, device=c.device))
            continue
        if not len(d):
            data = torch.zeros(len(c), dtype=torch.int32, device=c.device)
        else:
            data = host_table(remap, c.device)[c.data.long()]
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
        return self.columns[0].device

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def to(self, device) -> "ColumnBatch":
        return ColumnBatch(self.names, [c.to(device) for c in self.columns],
                           None if self.live is None else self.live.to(device))

    def compact(self) -> "ColumnBatch":
        """Drop dead rows (stays on the batch's device, ``live`` = None):
        one host sync for the live positions, then a gather per column."""
        if self.live is None:
            return self
        idx = torch.nonzero(self.live).flatten()
        return ColumnBatch(self.names, [c.take(idx) for c in self.columns])

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
            rle = _concat_rle(cols)
            if rle is not None:
                out_cols.append(rle)
                continue
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


def _concat_rle(cols: Sequence[Column]) -> Optional[Column]:
    """One RLE column covering a concatenation of runs of one value (and
    one dictionary), or None."""
    first = cols[0]
    if not all(c.encoding == "RLE" for c in cols) or any(
            c.rle_value != first.rle_value or c.device != first.device
            or not _same_dictionary(c.dictionary, first.dictionary)
            for c in cols[1:]):
        return None
    valid = None
    if any(c.valid is not None for c in cols):
        valid = torch.cat([c.valid_mask() for c in cols])
    return Column.rle(first.type, first.rle_value, sum(len(c) for c in cols),
                      valid, first.dictionary, device=first.device)


# below this a run saves nothing worth the check
RLE_DETECT_MIN_ROWS = 64


def maybe_rle(col: Column) -> Column:
    """Constant-run detection at page build: a host FLAT / DICT column
    whose every element equals its first becomes RLE (on the CPU; the
    caller moves it).  A first / last probe rejects most columns in
    O(1)."""
    if (col.encoding not in ("FLAT", "DICT") or len(col) < RLE_DETECT_MIN_ROWS
            or col.device.type != "cpu"):
        return col
    data = col.data.numpy()
    if data[0] != data[-1] or not (data == data[0]).all():
        return col
    return Column.rle(col.type, data[0], len(col), col.valid, col.dictionary,
                      device="cpu")
