"""Page serialization and compression: the engine's wire and disk format.

The port of the reference ``execution/serde.py`` (the role of Trino's
PagesSerde: buffer/PageSerializer.java:58, PagesSerdeUtil): a ColumnBatch
becomes one length-prefixed binary page (a header, then per column its
name, type, dtype, data, validity and dictionary), optionally compressed
with zlib.  The byte format is the reference's exactly, so each package
reads the other's pages, spill files and tables:

- v1 pages (``TTP1``): every column flat; RLE columns are expanded and
  LAZY ones materialized first;
- v2 pages (``TTP2``, with a :class:`PageStreamEncoder`): an encoding byte
  per column (an RLE column is ONE value) and dictionary sidecars: the
  first page of a stream that carries a dictionary object defines it (DEF),
  later pages refer to it (REF);
- frames: v1 ``[u32 len][page]``, or a ``TTS2`` stream of CRC-checked
  ``[u32 len][u32 crc32][page]`` frames; :func:`iter_frames` tells them
  apart.

A batch is compacted first (live masks never cross a host boundary).  A
batch on the card is compacted there and each column is copied to the host
once, a read counted by exec/syncguard.py under ``serde.column``
(``serde.compact`` for the compaction's own read).  Deserialized columns
are CPU tensors of the dtype the page names.

The consumer's sidecar registry is this package's own (a page stream
written by the reference defines its dictionaries in the reader's
registry all the same).  Sidecars are counted as in the reference, in the
``trino_encoding_dict_sidecar_*`` and ``trino_encoding_exchange_code_pages``
metrics (telemetry/metrics.py), and per stream by the encoder
(``dict_sent``, ``dict_reused``, ``code_pages``).
"""

from __future__ import annotations

import ast as _ast
import itertools
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from ..caching.executable_cache import memo
from ..exec import syncguard as SG
from ..spi.batch import Column, ColumnBatch
from ..spi.errors import PAGE_TRANSPORT_ERROR, TrinoError
from ..spi.types import ArrayType, DecimalType, MapType, RowType, Type, \
    parse_type
from ..telemetry import metrics as tm

__all__ = ["serialize_batch", "deserialize_batch", "inflate_page",
           "decode_page", "write_frame",
           "iter_frames", "CODEC_NONE", "CODEC_ZLIB",
           "SPOOL_STREAM_MAGIC", "SpoolCorruptionError",
           "write_stream_header", "write_frame_crc", "PageStreamEncoder"]

# v2 spool-stream header: a file starting with these 4 bytes carries
# CRC-checked frames; any other first word is a v1 length prefix (as a
# length it would mean an ~844 MB frame, far past any page the engine
# writes, so the two formats cannot collide)
SPOOL_STREAM_MAGIC = b"TTS2"


class SpoolCorruptionError(TrinoError):
    """A frame failed its CRC32 (bit flip) or ended mid-frame (torn
    write).  PAGE_TRANSPORT_ERROR, an external and retryable error."""

    def __init__(self, path: str, detail: str):
        super().__init__(PAGE_TRANSPORT_ERROR,
                         f"spool corruption in {path}: {detail}")
        self.path = path


def write_frame(f, page: bytes) -> None:
    """Append one v1 frame: [u32 LE length][page]."""
    f.write(struct.pack("<I", len(page)))
    f.write(page)


def write_stream_header(f) -> None:
    """Start a TTS2 stream (once, before any :func:`write_frame_crc`)."""
    f.write(SPOOL_STREAM_MAGIC)


def write_frame_crc(f, page: bytes) -> None:
    """Append one TTS2 frame: [u32 LE length][u32 LE crc32][page]."""
    f.write(struct.pack("<II", len(page), zlib.crc32(page) & 0xFFFFFFFF))
    f.write(page)


def _iter_frames_crc(f, path: str):
    while True:
        hdr = f.read(8)
        if not hdr:
            return
        if len(hdr) < 8:
            raise SpoolCorruptionError(path, "truncated frame header")
        n, crc = struct.unpack("<II", hdr)
        payload = f.read(n)
        if len(payload) < n:
            raise SpoolCorruptionError(
                path, f"torn frame: expected {n} bytes, got {len(payload)}")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise SpoolCorruptionError(path, "frame CRC32 mismatch")
        yield payload


def iter_frames(f, path: str = "<stream>"):
    """Every frame's bytes of a file opened at the stream start: a TTS2
    header selects CRC-checked frames (raising :class:`SpoolCorruptionError`
    on a mismatch or a torn frame), anything else is v1 framing."""
    first = f.read(4)
    if first == SPOOL_STREAM_MAGIC:
        yield from _iter_frames_crc(f, path)
        return
    while True:
        if len(first) < 4:
            return
        (n,) = struct.unpack("<I", first)
        yield f.read(n)
        first = f.read(4)


_MAGIC = b"TTP1"
_MAGIC2 = b"TTP2"
CODEC_NONE = 0
CODEC_ZLIB = 1

# v2 per-column encoding byte
_ENC_FLAT = 0
_ENC_RLE = 1  # one stored value + the page's row count
# v2 per-column dictionary byte
_DICT_NONE = 0
_DICT_INLINE = 1  # values inline, as in v1
_DICT_DEF = 2     # sidecar definition: stream token + dict id + values
_DICT_REF = 3     # sidecar reference: stream token + dict id

_STREAM_TOKENS = itertools.count(1)
_STREAM_TOKENS_LOCK = threading.Lock()


class PageStreamEncoder:
    """Producer-side context of ONE ordered page stream: the first page
    carrying a dictionary object ships its values as a sidecar definition,
    later pages a fixed-size reference.  In-order delivery of the stream
    guarantees a REF never overtakes its DEF.  ``dict_sent`` /
    ``dict_reused`` count definitions and references, ``code_pages`` the
    pages that carried dictionary codes."""

    def __init__(self):
        with _STREAM_TOKENS_LOCK:
            self.token = next(_STREAM_TOKENS)
        self._ids: dict[int, int] = {}  # id(dictionary) -> dict id
        self._pins: list = []  # keep dictionaries alive: id() stays unique
        self.dict_sent = 0
        self.dict_reused = 0
        self.code_pages = 0

    def dict_id(self, dictionary) -> tuple[int, bool]:
        """(dict id, is new) of a dictionary object on this stream."""
        key = id(dictionary)
        did = self._ids.get(key)
        if did is not None:
            return did, False
        did = len(self._pins)
        self._ids[key] = did
        self._pins.append(dictionary)
        return did, True


# consumer-side sidecar registry: stream token -> dict id -> values, an LRU
# bounded by streams (tokens are unique per producer stream, so pages of
# interleaved producers never collide)
_DICT_REGISTRY: "OrderedDict[int, dict[int, np.ndarray]]" = OrderedDict()
_DICT_REGISTRY_LOCK = threading.Lock()
_DICT_REGISTRY_MAX = 256


def _register_dict(token: int, did: int, values: np.ndarray) -> None:
    with _DICT_REGISTRY_LOCK:
        stream = _DICT_REGISTRY.get(token)
        if stream is None:
            stream = _DICT_REGISTRY[token] = {}
            while len(_DICT_REGISTRY) > _DICT_REGISTRY_MAX:
                _DICT_REGISTRY.popitem(last=False)
        else:
            _DICT_REGISTRY.move_to_end(token)
        stream[did] = values


def _lookup_dict(token: int, did: int) -> np.ndarray:
    with _DICT_REGISTRY_LOCK:
        stream = _DICT_REGISTRY.get(token)
        if stream is not None:
            _DICT_REGISTRY.move_to_end(token)
            values = stream.get(did)
            if values is not None:
                return values
    raise TrinoError(
        PAGE_TRANSPORT_ERROR,
        f"dictionary sidecar miss: stream {token} dict {did} "
        "(reference arrived before / outlived its definition)")


def _pack_bytes(out: list, b: bytes) -> None:
    out.append(struct.pack("<I", len(b)))
    out.append(b)


def _pack_str(out: list, s: str) -> None:
    _pack_bytes(out, s.encode("utf-8"))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def blob(self) -> bytes:
        return self.take(self.u32())

    def text(self) -> str:
        return self.blob().decode("utf-8")


def _pack_dict_values(parts: list, dictionary) -> None:
    parts.append(_packed_dict(dictionary))


# the batches of one scan share their dictionaries, so each is packed once
# per dictionary object, not once a page
@memo("serde.packed_dicts", maxsize=64, weak=True)
def _packed_dict(dictionary) -> bytes:
    out = [struct.pack("<I", len(dictionary))]
    for v in dictionary:
        # tuples (array / row / map) and python ints (long decimals)
        # round-trip through repr; strings stay plain
        _pack_str(out, repr(v) if isinstance(v, (tuple, int)) else str(v))
    return b"".join(out)


def _unpack_dict_values(r: _Reader, type_: Type) -> np.ndarray:
    count = r.u32()
    texts = [r.text() for _ in range(count)]
    dictionary = np.empty(count, dtype=object)
    if isinstance(type_, (ArrayType, RowType, MapType)):
        for i, s in enumerate(texts):
            dictionary[i] = _ast.literal_eval(s)
    elif isinstance(type_, DecimalType) and type_.precision > 18:
        for i, s in enumerate(texts):
            dictionary[i] = int(s)
    else:
        dictionary[:] = texts
    return dictionary


def _skip_dict_values(r: _Reader) -> None:
    buf, pos = r.buf, r.pos
    (count,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    unpack = struct.unpack_from
    for _ in range(count):
        pos += 4 + unpack("<I", buf, pos)[0]
    r.pos = pos


# -- the batch's columns on the host ---------------------------------------


def _compacted(batch: ColumnBatch) -> ColumnBatch:
    """The batch without dead rows, on its own device (on the card, one
    counted read for the live positions)."""
    if batch.live is None:
        return batch
    if batch.live.device.type != "cpu":
        SG.count_sync("serde.compact")
    return batch.compact()


def _host_valid(valid) -> Optional[np.ndarray]:
    # an all-valid mask carries nothing (the reference normalizes host
    # masks to None, and so does a CPU copy of a card batch)
    if valid is None or valid.all():
        return None
    return valid


def _host_flat(col: Column) -> tuple:
    """(data, valid) of a column as host numpy arrays: one counted copy of
    a column on the card; a LAZY column is materialized first."""
    data, valid = col.data, col.valid
    if data.device.type == "cpu" and (valid is None
                                      or valid.device.type == "cpu"):
        return data.numpy(), _host_valid(
            None if valid is None else valid.numpy())
    got = SG.fetch([data] if valid is None else [data, valid],
                   "serde.column")
    return got[0], _host_valid(got[1] if valid is not None else None)


def _host_rle_valid(col: Column) -> Optional[np.ndarray]:
    v = col.valid
    if v is None:
        return None
    if v.device.type == "cpu":
        return _host_valid(v.numpy())
    return _host_valid(SG.fetch(v, "serde.column"))


def _pack_column_data(parts: list, data: np.ndarray) -> None:
    data = np.ascontiguousarray(data)
    _pack_str(parts, data.dtype.str)
    _pack_bytes(parts, data.tobytes())


def _pack_valid(parts: list, valid: Optional[np.ndarray]) -> None:
    if valid is not None:
        parts.append(b"\x01")
        _pack_bytes(parts, np.packbits(valid).tobytes())
    else:
        parts.append(b"\x00")


def serialize_batch(batch: ColumnBatch, codec: int = CODEC_ZLIB,
                    ctx: Optional[PageStreamEncoder] = None) -> bytes:
    """One page: MAGIC, codec, u32 payload length, then (compressed) u32
    rows, u32 cols and per column (name, type, dtype, data, has_valid
    [+bitmap], has_dict [+values]).  With a :class:`PageStreamEncoder`
    the page is v2; without one it is the v1 page, byte for byte the
    reference's."""
    if ctx is not None:
        return _serialize_batch_v2(batch, codec, ctx)
    batch = _compacted(batch)
    parts: list = [struct.pack("<II", batch.num_rows, batch.num_columns)]
    for name, col in zip(batch.names, batch.columns):
        _pack_str(parts, name)
        _pack_str(parts, str(col.type))
        if col.encoding == "RLE":  # expanded on the host, not the device
            data = np.full(len(col), col.rle_value,
                           dtype=col.rle_value.dtype)
            valid = _host_rle_valid(col)
        else:
            data, valid = _host_flat(col)
        _pack_column_data(parts, data)
        _pack_valid(parts, valid)
        if col.dictionary is not None:
            parts.append(b"\x01")
            _pack_dict_values(parts, col.dictionary)
        else:
            parts.append(b"\x00")
    return _finish_page(_MAGIC, parts, codec)


def _finish_page(magic: bytes, parts: list, codec: int) -> bytes:
    payload = b"".join(parts)
    if codec == CODEC_ZLIB:
        payload = zlib.compress(payload, level=1)
    return magic + struct.pack("<BI", codec, len(payload)) + payload


def _serialize_batch_v2(batch: ColumnBatch, codec: int,
                        ctx: PageStreamEncoder) -> bytes:
    batch = _compacted(batch)
    parts: list = [struct.pack("<II", batch.num_rows, batch.num_columns)]
    code_page = False
    for name, col in zip(batch.names, batch.columns):
        _pack_str(parts, name)
        _pack_str(parts, str(col.type))
        if col.encoding == "RLE":  # ONE stored value
            parts.append(struct.pack("<B", _ENC_RLE))
            _pack_column_data(parts, np.asarray(col.rle_value).reshape(1))
            valid = _host_rle_valid(col)
        else:
            parts.append(struct.pack("<B", _ENC_FLAT))
            data, valid = _host_flat(col)
            _pack_column_data(parts, data)
        _pack_valid(parts, valid)
        if col.dictionary is None:
            parts.append(struct.pack("<B", _DICT_NONE))
            continue
        did, is_new = ctx.dict_id(col.dictionary)
        if is_new:
            parts.append(struct.pack("<BQI", _DICT_DEF, ctx.token, did))
            _pack_dict_values(parts, col.dictionary)
            ctx.dict_sent += 1
            tm.ENCODING_DICT_SIDECAR_SENT.inc()
        else:
            parts.append(struct.pack("<BQI", _DICT_REF, ctx.token, did))
            ctx.dict_reused += 1
            tm.ENCODING_DICT_SIDECAR_REUSED.inc()
        code_page = True
    if code_page:
        ctx.code_pages += 1
        tm.ENCODING_EXCHANGE_CODE_PAGES.inc()
    return _finish_page(_MAGIC2, parts, codec)


def deserialize_batch(data: bytes,
                      columns: Optional[Sequence[str]] = None
                      ) -> ColumnBatch:
    """A page as a batch of CPU columns.  ``columns`` picks the columns to
    decode, in that order (the others' bytes are skipped); None decodes
    them all."""
    return decode_page(*inflate_page(data), columns)


def inflate_page(data) -> tuple:
    """(magic, payload) of a page: its header checked, its payload
    decompressed."""
    magic = bytes(data[:4])
    if magic not in (_MAGIC, _MAGIC2):
        raise TrinoError(PAGE_TRANSPORT_ERROR,
                         f"bad page magic {magic!r}")
    codec, plen = struct.unpack("<BI", data[4:9])
    payload = data[9:9 + plen]
    if codec == CODEC_ZLIB:
        payload = zlib.decompress(payload)
    return magic, payload


def decode_page(magic: bytes, payload,
                columns: Optional[Sequence[str]] = None) -> ColumnBatch:
    """The batch of an inflated page (see :func:`deserialize_batch`).
    Columns decode by position, so two columns of one name (a self-join's
    output) stay apart; a ``columns`` subset picks, for each name in the
    caller's order, the first column of that name."""
    r = _Reader(payload)
    num_rows, num_cols = struct.unpack("<II", r.take(8))
    v2 = magic == _MAGIC2
    got: list = []
    names: list[str] = []
    for _ in range(num_cols):
        name = r.text()
        keep = columns is None or (name in columns and name not in names)
        names.append(name)
        got.append(_read_column(r, num_rows, v2, keep=keep))
    if columns is None:
        return ColumnBatch(names, got)
    picks = [names.index(n) for n in columns]
    return ColumnBatch(list(columns), [got[i] for i in picks])


def _read_column(r: _Reader, num_rows: int, v2: bool,
                 keep: bool) -> Optional[Column]:
    """One column's bytes; None (bytes skipped) unless ``keep``.  A v2
    DEF is registered even when skipped, since later pages refer to it."""
    type_text = r.text()
    enc = struct.unpack("<B", r.take(1))[0] if v2 else _ENC_FLAT
    dtype_text = r.text()
    raw = r.blob()
    bits = r.blob() if r.take(1) == b"\x01" else None
    dmode = struct.unpack("<B", r.take(1))[0]  # v1: 0 or 1 (inline)
    type_ = parse_type(type_text) if (keep or dmode == _DICT_DEF) else None
    dictionary = None
    if dmode == _DICT_INLINE:
        if not keep:
            _skip_dict_values(r)
            return None
        dictionary = _unpack_dict_values(r, type_)
    elif dmode == _DICT_DEF:
        token, did = struct.unpack("<QI", r.take(12))
        dictionary = _unpack_dict_values(r, type_)
        _register_dict(token, did, dictionary)
    elif dmode == _DICT_REF:
        token, did = struct.unpack("<QI", r.take(12))
        dictionary = _lookup_dict(token, did)
    if not keep:
        return None
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_text)).copy()
    valid = None
    if bits is not None:
        valid = np.unpackbits(np.frombuffer(bits, dtype=np.uint8),
                              count=num_rows).astype(bool)
    if enc == _ENC_RLE:
        return Column.rle(type_, arr[0], num_rows, valid, dictionary,
                          device="cpu")
    return Column(type_, arr, valid, dictionary)
