"""The port's wire format (execution/serde.py) against the reference's.

The same seeded batches are built in both packages: every scalar type,
NULLs, an all-NULL column, RLE and LAZY columns, array / map / row columns
and decimal(38).  v1 pages must be byte-identical under both codecs; v2
pages byte-identical once the two encoders share a stream token (the only
field that differs: 8 bytes per dictionary column); and each package must
read the other's v1 pages, v2 DEF-then-REF streams and TTS2 streams to the
same rows.  Corrupt frames raise SpoolCorruptionError, a REF without its
DEF a PAGE_TRANSPORT_ERROR.  Then the serde cases of the reference's
tests/test_server_serde.py, tests/test_encoded_exec.py (v2) and
tests/test_wide_types.py (row / map / decimal(38)), on the port.
"""

import datetime
import io
import struct

import numpy as np
import pytest
import torch

import trino_tpu.execution.serde as RS
from trino_tpu.spi.batch import Column as RefColumn
from trino_tpu.spi.batch import ColumnBatch as RefBatch
from trino_tpu.spi.types import parse_type as ref_parse_type
from trino_tpu_torch.execution import serde as S
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.errors import PAGE_TRANSPORT_ERROR, TrinoError
from trino_tpu_torch.spi.types import (BIGINT, DOUBLE, VARCHAR, DecimalType,
                                       parse_type)

N = 97


def _values(seed: int) -> list:
    """(name, type text, python values) of one seeded batch."""
    rng = np.random.default_rng(seed)
    null = rng.random(N) < 0.2

    def nullable(vals):
        return [None if m else v for v, m in zip(vals, null)]

    ints = rng.integers(-10**6, 10**6, N)
    words = ["", "alpha", "beta", "gamma delta", "ünï", "x" * 40]
    day0 = datetime.date(1992, 1, 1)
    return [
        ("b", "boolean", nullable([bool(x) for x in rng.random(N) < 0.5])),
        ("t", "tinyint", [int(x) for x in rng.integers(-128, 128, N)]),
        ("sm", "smallint", nullable([int(x) for x in
                                     rng.integers(-2**15, 2**15, N)])),
        ("i", "integer", [int(x) for x in ints]),
        ("g", "bigint", nullable([int(x) * 10**9 for x in ints])),
        ("r", "real", nullable([float(np.float32(x))
                                for x in rng.normal(0, 100, N)])),
        ("f", "double", [float(x) for x in rng.normal(0, 1e6, N)]),
        ("dec", "decimal(12,2)", nullable([f"{int(x)}.{abs(int(x)) % 100:02d}"
                                           for x in ints])),
        ("day", "date", nullable([day0 + datetime.timedelta(days=int(x))
                                  for x in rng.integers(0, 2500, N)])),
        ("ts", "timestamp", [int(x) * 1_000_000 for x in
                             rng.integers(7 * 10**8, 9 * 10**8, N)]),
        ("s", "varchar", nullable([words[int(x)] for x in
                                   rng.integers(0, len(words), N)])),
        ("none", "bigint", [None] * N),
        ("arr", "array(bigint)", nullable([
            [int(v) for v in rng.integers(0, 9, int(k))]
            for k in rng.integers(0, 4, N)])),
        ("m", "map(varchar,bigint)", nullable([
            {words[int(k)]: int(v)} if k else {}
            for k, v in zip(rng.integers(0, 4, N), ints)])),
        ("row", "row(a bigint, b varchar)", nullable([
            (int(v), words[int(k)]) for k, v in
            zip(rng.integers(0, len(words), N), ints)])),
        ("wide", "decimal(38,3)", nullable([
            f"{int(x)}{int(y):012d}.{abs(int(x)) % 1000:03d}"
            for x, y in zip(ints, rng.integers(0, 10**12, N))])),
    ]


def _batches(seed: int = 0, live: bool = False, encoded: bool = False):
    """The same batch in both packages: (reference batch, port batch)."""
    spec = _values(seed)
    names = [n for n, _, _ in spec]
    ref = [RefColumn.from_values(ref_parse_type(t), v) for _, t, v in spec]
    port = [Column.from_values(parse_type(t), v) for _, t, v in spec]
    if encoded:
        run_valid = np.arange(N) % 5 != 0
        lazy_data = np.arange(N, dtype=np.int64) * 3
        names += ["run", "run_null", "lazy"]
        ref += [RefColumn.rle(ref_parse_type("bigint"), 7, N),
                RefColumn.rle(ref_parse_type("double"), 2.5, N, run_valid),
                RefColumn.lazy(ref_parse_type("bigint"), N,
                               lambda: (lazy_data, None))]
        port += [Column.rle(BIGINT, 7, N, device="cpu"),
                 Column.rle(DOUBLE, 2.5, N, torch.from_numpy(run_valid),
                            device="cpu"),
                 Column.lazy(BIGINT, N, lambda: (lazy_data, None),
                             device="cpu")]
    mask = None
    if live:
        mask = np.random.default_rng(seed + 1).random(N) < 0.6
    return (RefBatch(names, ref, mask),
            ColumnBatch(names, port,
                        None if mask is None else torch.from_numpy(mask)))


def _rows(batch) -> str:
    return repr(batch.to_pylist())  # NaN-tolerant, exact otherwise


BATCH_KINDS = {"plain": {}, "masked": {"live": True},
               "rle_lazy": {"encoded": True},
               "masked_rle_lazy": {"live": True, "encoded": True}}


@pytest.mark.parametrize("kind", sorted(BATCH_KINDS))
@pytest.mark.parametrize("codec", [S.CODEC_NONE, S.CODEC_ZLIB])
def test_v1_pages_byte_identical(codec, kind):
    ref, port = _batches(3, **BATCH_KINDS[kind])
    want = RS.serialize_batch(ref, codec=codec)
    got = S.serialize_batch(port, codec=codec)
    assert got[:4] == b"TTP1"
    assert got == want


@pytest.mark.parametrize("kind", sorted(BATCH_KINDS))
def test_v2_pages_identical_but_the_stream_token(kind):
    """DEF then REF pages: with the port's encoder on the reference's
    token, every byte agrees; with its own token only the 8-byte token
    fields differ."""
    ref, port = _batches(5, **BATCH_KINDS[kind])
    rctx, pctx = RS.PageStreamEncoder(), S.PageStreamEncoder()
    if pctx.token == rctx.token:  # two counters that happen to agree
        pctx = S.PageStreamEncoder()
    want = [RS.serialize_batch(ref, codec=S.CODEC_NONE, ctx=rctx)
            for _ in range(2)]
    own = [S.serialize_batch(port, codec=S.CODEC_NONE, ctx=pctx)
           for _ in range(2)]
    shared = S.PageStreamEncoder()
    shared.token = rctx.token
    got = [S.serialize_batch(port, codec=S.CODEC_NONE, ctx=shared)
           for _ in range(2)]
    assert got == want and got[0][:4] == b"TTP2"
    n_dict = sum(c.dictionary is not None for c in port.columns)
    tok_a, tok_b = (struct.pack("<Q", pctx.token),
                    struct.pack("<Q", rctx.token))
    for a, b in zip(own, want):
        assert len(a) == len(b)
        diff = [i for i in range(len(a)) if a[i] != b[i]]
        # the token follows a DEF (2) or REF (3) byte, once per dictionary
        fields = [j + 1 for j in range(len(a) - 8) if a[j] in (2, 3)
                  and a[j + 1:j + 9] == tok_a and b[j + 1:j + 9] == tok_b]
        assert len(fields) == n_dict
        assert diff and all(any(f <= i < f + 8 for f in fields)
                            for i in diff)
    assert (pctx.dict_sent, pctx.dict_reused) == (n_dict, n_dict)
    assert pctx.code_pages == 2


def _stream(pages: list) -> bytes:
    f = io.BytesIO()
    RS.write_stream_header(f)
    for p in pages:
        RS.write_frame_crc(f, p)
    return f.getvalue()


def _v2_pages(mod, batch) -> list:
    ctx = mod.PageStreamEncoder()
    return [mod.serialize_batch(batch, ctx=ctx) for _ in range(2)]


@pytest.mark.parametrize("fmt", ["v1", "v2", "tts2"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_pages(writer, fmt):
    ref, port = _batches(7, live=True, encoded=True)
    want = _rows(ref)
    assert _rows(port) == want
    src, src_batch, dst = ((RS, ref, S) if writer == "reference"
                           else (S, port, RS))
    if fmt == "v1":
        pages = [src.serialize_batch(src_batch)]
    elif fmt == "v2":  # a definition page, then a reference page
        pages = _v2_pages(src, src_batch)
    else:
        pages = list(dst.iter_frames(io.BytesIO(_stream(
            [src.serialize_batch(src_batch),
             *_v2_pages(src, src_batch)]))))
        assert len(pages) == 3
    for page in pages:
        out = dst.deserialize_batch(page)
        assert _rows(out) == want
    if dst is S:
        out = S.deserialize_batch(pages[-1])
        for c, t in zip(out.columns, port.types):
            assert str(c.type) == str(t) and c.device.type == "cpu"
            assert c.encoding in ("FLAT", "DICT", "RLE")


@pytest.mark.parametrize("damage", ["flip", "torn", "header"])
def test_corrupt_frames_raise(damage):
    ref, port = _batches(11)
    f = io.BytesIO()
    S.write_stream_header(f)
    S.write_frame_crc(f, S.serialize_batch(port))
    data = bytearray(f.getvalue())
    if damage == "flip":
        data[40] ^= 0x10
    elif damage == "torn":
        data = data[:-7]
    else:
        data = data[:4 + 5]
    with pytest.raises(S.SpoolCorruptionError) as e:
        list(S.iter_frames(io.BytesIO(bytes(data)), "spool-0"))
    assert e.value.code == PAGE_TRANSPORT_ERROR
    assert "spool-0" in str(e.value)


def test_reference_without_its_definition_is_a_transport_error():
    _, port = _batches(13)
    ctx = S.PageStreamEncoder()
    S.serialize_batch(port, ctx=ctx)  # the DEF page, read by no one
    with pytest.raises(TrinoError) as e:
        S.deserialize_batch(S.serialize_batch(port, ctx=ctx))
    assert e.value.code == PAGE_TRANSPORT_ERROR


def test_decoding_a_subset_of_columns():
    _, port = _batches(17, encoded=True)
    page = S.serialize_batch(port)
    out = S.deserialize_batch(page, ["s", "g", "lazy"])
    assert out.names == ["s", "g", "lazy"]
    assert _rows(out) == repr(list(zip(*[port.column(n).to_pylist()
                                         for n in out.names])))


def test_frames_of_both_formats():
    pages = [b"abc", b"", b"x" * 1000]
    v1, v2 = io.BytesIO(), io.BytesIO()
    for p in pages:
        S.write_frame(v1, p)
    S.write_stream_header(v2)
    for p in pages:
        S.write_frame_crc(v2, p)
    assert v1.getvalue() == b"".join(struct.pack("<I", len(p)) + p
                                     for p in pages)
    for buf in (v1, v2):
        buf.seek(0)
        assert list(S.iter_frames(buf)) == pages


# -- the reference's serde cases (test_server_serde.py:40-66) --------------


def _mixed_batch():
    return ColumnBatch(["k", "x", "d", "s"], [
        Column(BIGINT, np.array([1, 2, 3], np.int64),
               np.array([True, False, True])),
        Column(DOUBLE, np.array([1.5, np.nan, -0.0])),
        Column(DecimalType(18, 2), np.array([150, -275, 0], np.int64)),
        Column(VARCHAR, np.array([0, 1, 0], np.int32), None,
               np.array(["alpha", "beta"], dtype=object))])


@pytest.mark.parametrize("codec", [S.CODEC_NONE, S.CODEC_ZLIB])
def test_serde_roundtrip(codec):
    b = _mixed_batch()
    wire = S.serialize_batch(b, codec=codec)
    assert isinstance(wire, bytes)
    out = S.deserialize_batch(wire)
    assert out.names == b.names
    assert [str(t) for t in out.types] == [str(t) for t in b.types]
    assert repr(out.to_pylist()) == repr(b.to_pylist())


def test_serde_compresses():
    big = ColumnBatch(["x"], [Column(BIGINT, np.zeros(100_000, np.int64))])
    z = S.serialize_batch(big, codec=S.CODEC_ZLIB)
    raw = S.serialize_batch(big, codec=S.CODEC_NONE)
    assert len(z) < len(raw) / 10


def test_serde_live_mask_compacted():
    b = ColumnBatch(["x"], [Column(BIGINT, np.arange(8, dtype=np.int64))],
                    live=torch.tensor([True, False] * 4))
    out = S.deserialize_batch(S.serialize_batch(b))
    assert out.to_pylist() == [(0,), (2,), (4,), (6,)]


# -- the v2 cases of test_encoded_exec.py:190-231 --------------------------


def _dict_batch():
    d = np.array(["a", "b", "c"], dtype=object)
    return ColumnBatch(["s", "v"], [
        Column(VARCHAR, np.array([0, 1, 2, 1, 0], np.int32), None, d),
        Column(BIGINT, np.arange(5, dtype=np.int64),
               np.array([1, 1, 0, 1, 1], bool))])


def test_serde_v2_dict_sidecar_def_then_ref():
    b = _dict_batch()
    ctx = S.PageStreamEncoder()
    p1 = S.serialize_batch(b, codec=S.CODEC_NONE, ctx=ctx)  # definition
    p2 = S.serialize_batch(b, codec=S.CODEC_NONE, ctx=ctx)  # reference
    assert p1[:4] == b"TTP2" and len(p2) < len(p1)
    o1, o2 = S.deserialize_batch(p1), S.deserialize_batch(p2)
    assert o1.to_pylist() == b.to_pylist() == o2.to_pylist()
    assert list(o2.columns[0].dictionary) == ["a", "b", "c"]
    assert (ctx.dict_sent, ctx.dict_reused, ctx.code_pages) == (1, 1, 2)


def test_serde_v2_rle_column_round_trip():
    b = ColumnBatch(["r", "v"], [Column.rle(BIGINT, 7, 5, device="cpu"),
                                 Column(BIGINT, np.arange(5,
                                                          dtype=np.int64))])
    wire = S.serialize_batch(b, codec=S.CODEC_NONE,
                             ctx=S.PageStreamEncoder())
    out = S.deserialize_batch(wire)  # one value on the wire, still a run
    assert out.columns[0].encoding == "RLE"
    assert out.to_pylist() == b.to_pylist()


def test_serde_v1_unchanged_without_ctx():
    b = _dict_batch()
    wire = S.serialize_batch(b)
    assert wire[:4] == b"TTP1"
    assert S.deserialize_batch(wire).to_pylist() == b.to_pylist()


def test_serde_v2_sidecar_miss_is_transport_error():
    b = _dict_batch()
    ctx = S.PageStreamEncoder()
    S.serialize_batch(b, ctx=ctx)
    with pytest.raises(TrinoError):
        S.deserialize_batch(S.serialize_batch(b, ctx=ctx))


# -- test_wide_types.py:159 --------------------------------------------------


def test_row_map_serde_roundtrip():
    b = ColumnBatch(["r", "m", "d"], [
        Column.from_values(parse_type("row(a bigint, b varchar)"),
                           [(1, "x"), None, (2, "y")]),
        Column.from_values(parse_type("map(varchar, bigint)"),
                           [{"k": 1}, {"a": 2, "b": 3}, None]),
        Column.from_values(parse_type("decimal(38,3)"),
                           ["123456789012345678901234.5", None, "0.001"])])
    out = S.deserialize_batch(S.serialize_batch(b))
    assert out.to_pylist() == b.to_pylist()
