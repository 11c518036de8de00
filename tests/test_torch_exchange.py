"""The port's host exchange against the reference's.

``OutputBuffer`` / ``ExchangeClient`` run the same scripted sequence in
both packages (pull tokens, ack-on-advance freeing the pages before the
token, the byte budget that blocks a producer or, in non-blocking mode,
makes the sink refuse input, the done marker, ``abort``), and the port's
``PartitionedOutputSink`` routes every row of seeded numpy batches to the
partition the reference's sink routes it to: int, decimal, date and
string keys (two producers whose dictionaries give the same strings
different codes), NULL keys to partition 0, for 2, 3 and 4 partitions.
"""

import threading
import time

import numpy as np
import pytest
import torch

from trino_tpu.execution import exchange as RX
from trino_tpu.execution import task as RT
from trino_tpu.spi import batch as RB
from trino_tpu.spi import types as RTY
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.execution import exchange as PX
from trino_tpu_torch.execution import task as PT
from trino_tpu_torch.spi import batch as PB
from trino_tpu_torch.spi import types as PTY


class _Page:
    """A page of a given byte size (what the buffer accounts)."""

    def __init__(self, name: str, nbytes: int):
        self.name = name
        self.nbytes = nbytes
        self.num_rows = 1

    def __repr__(self):
        return self.name


def _script(X) -> list:
    """The scripted exchange sequence against package ``X``: what every
    step returns and the buffer's held bytes after it."""
    out = []
    buf = X.OutputBuffer(2, max_bytes=100)
    for i in range(4):
        buf.enqueue(i % 2, _Page(f"p{i}", 30))
    out.append(("bytes", buf._bytes, buf.pages_enqueued,
                buf.rows_enqueued, buf.bytes_enqueued))
    pages, tok, done = buf.get(0, 0, timeout=0)
    out.append(("get0@0", [repr(p) for p in pages], tok, done, buf._bytes))
    # a read at token 1 acks (frees) page 0 of partition 0
    pages, tok, done = buf.get(0, 1, timeout=0)
    out.append(("get0@1", [repr(p) for p in pages], tok, done, buf._bytes))
    out.append(("capacity", buf.has_capacity()))
    buf.enqueue(1, _Page("p4", 60), block=False)  # overshoots, no wait
    out.append(("overshoot", buf._bytes, buf.has_capacity()))
    pages, tok, done = buf.get(1, 3, timeout=0)  # acks p1, p3, p4
    out.append(("get1@3", [repr(p) for p in pages], tok, done, buf._bytes,
                buf.has_capacity()))
    buf.set_finished()
    pages, tok, done = buf.get(0, 2, timeout=0)
    out.append(("done0", [repr(p) for p in pages], tok, done, buf.drained))
    pages, tok, done = buf.get(1, 3, timeout=0)
    out.append(("done1", [repr(p) for p in pages], tok, done, buf.drained))
    # the client: one partition from two upstream buffers
    a, b = X.OutputBuffer(1), X.OutputBuffer(1)
    a.enqueue(0, _Page("a0", 1))
    b.enqueue(0, _Page("b0", 1))
    a.enqueue(0, _Page("a1", 1))
    a.set_finished()
    b.set_finished()
    client = X.ExchangeClient([a, b], 0)
    got = []
    while not client.is_finished():
        p = client.poll(timeout=0)
        if p is not None:
            got.append(repr(p))
    out.append(("client", got, a.drained, b.drained))
    # abort: an aborted buffer drops its pages and reports done
    c = X.OutputBuffer(1)
    c.enqueue(0, _Page("c0", 5))
    c.abort()
    c.enqueue(0, _Page("c1", 5))
    pages, tok, done = c.get(0, 0, timeout=0)
    out.append(("abort", [repr(p) for p in pages], done, c.aborted,
                c.drained, c._bytes))
    return out


def test_buffer_protocol_matches_reference():
    assert _script(PX) == _script(RX)


@pytest.mark.parametrize("X", [PX, RX], ids=["port", "reference"])
def test_full_budget_blocks_until_an_ack(X):
    """A blocking enqueue past the byte budget waits until a consumer's
    read at a later token frees pages."""
    buf = X.OutputBuffer(1, max_bytes=10)
    buf.enqueue(0, _Page("p0", 20))
    done = threading.Event()

    def produce():
        buf.enqueue(0, _Page("p1", 5))
        done.set()

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    time.sleep(0.3)
    assert not done.is_set()
    buf.get(0, 1, timeout=0)  # acks p0
    assert done.wait(5)
    th.join(5)
    assert buf._bytes == 5


def test_non_blocking_sink_refuses_input_when_full():
    buf = PX.OutputBuffer(1, max_bytes=1)
    sink = PT.PartitionedOutputSink(buf, "GATHER")
    sink.blocking = False
    assert sink.needs_input()
    sink.add_input(PB.ColumnBatch(["x"], [PB.Column(
        PTY.BIGINT, np.arange(4, dtype=np.int64))]))
    assert not sink.needs_input()  # parks until an ack
    buf.get(0, 1, timeout=0)
    assert sink.needs_input()


# ---------------------------------------------------------------------------
# partition routing


def _columns(rng, n: int, names: list, null: bool) -> dict:
    """numpy (data, valid, dictionary) per key kind; the string column's
    dictionary is a shuffled vocabulary, so two producers code the same
    string differently."""
    vocab = np.array(sorted({f"s{v:03d}" for v in range(40)}), dtype=object)
    perm = rng.permutation(len(vocab))
    cols = {
        "int": (rng.randint(-10**9, 10**9, n).astype(np.int64), None),
        "decimal": (rng.randint(-10**8, 10**8, n).astype(np.int64), None),
        "date": (rng.randint(8000, 11000, n).astype(np.int32), None),
        "string": (rng.randint(0, len(vocab), n).astype(np.int32),
                   vocab[perm]),
    }
    out = {}
    for k in names:
        d, dic = cols[k]
        valid = (rng.rand(n) > 0.2) if null else None
        out[k] = (d, valid, dic)
    return out


_TYPES = {"int": ("BIGINT", None), "decimal": ("decimal", (12, 2)),
          "date": ("DATE", None), "string": ("VARCHAR", None)}


def _type(mod, kind: str):
    name, args = _TYPES[kind]
    return mod.DecimalType(*args) if args else getattr(mod, name)


def _route(pkg: str, cols: dict, keys: list, n: int) -> list:
    """Per partition, the rows (key values as python) the sink put there."""
    X, B, TY, Tk = ((PX, PB, PTY, PT) if pkg == "port"
                    else (RX, RB, RTY, RT))
    names = list(cols)
    batch = B.ColumnBatch(names, [
        B.Column(_type(TY, k), d, v, dic)
        for k, (d, v, dic) in cols.items()])
    buf = X.OutputBuffer(n)
    sink = Tk.PartitionedOutputSink(buf, "REPARTITION",
                                    [names.index(k) for k in keys])
    sink.add_input(batch)
    sink.finish_input()
    parts = []
    for p in range(n):
        pages, _, _ = buf.get(p, 0, timeout=0)
        rows = []
        for page in pages:
            rows.extend(page.to_pylist())
        parts.append(rows)
    return parts


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("keys", [["int"], ["decimal"], ["date"],
                                  ["string"], ["int", "string", "date"],
                                  ["decimal", "date"]],
                         ids=lambda k: "+".join(k))
@pytest.mark.parametrize("null", [False, True], ids=["valid", "nulls"])
def test_every_row_lands_in_the_reference_partition(n, keys, null):
    rng = np.random.RandomState(7 + n)
    cols = _columns(rng, 500, ["int", "decimal", "date", "string"], null)
    got = _route("port", cols, keys, n)
    want = _route("reference", cols, keys, n)
    assert got == want
    assert sum(map(len, got)) == 500
    if null:
        # every row with a NULL key is in partition 0
        idx = [list(cols).index(k) for k in keys]
        for p, rows in enumerate(got):
            if p:
                assert all(all(r[i] is not None for i in idx) for r in rows)


def test_two_producers_route_strings_by_value():
    """The same strings under two different code spaces land in the same
    partitions: routing hashes the values (crc32), not the codes."""
    rng = np.random.RandomState(3)
    a = _columns(rng, 300, ["string"], False)
    b = _columns(rng, 300, ["string"], False)
    where = {}
    for cols in (a, b):
        for p, rows in enumerate(_route("port", cols, ["string"], 4)):
            for (s,) in rows:
                assert where.setdefault(s, p) == p
    assert len(set(where.values())) > 1


def test_partition_counts_are_one_counted_read():
    """Per batch the sink reads back only the partition row counts, once,
    under its own tag."""
    rng = np.random.RandomState(5)
    cols = _columns(rng, 256, ["int", "string"], True)
    before = SG.snapshot()
    _route("port", cols, ["int", "string"], 3)
    delta = SG.take_delta(before)
    assert delta.by_tag == {"exchange.partition-counts": 1}


def test_live_masked_batch_routes_only_live_rows():
    data = torch.arange(10, dtype=torch.int64)
    live = torch.tensor([True, False] * 5)
    batch = PB.ColumnBatch(["k"], [PB.Column(PTY.BIGINT, data)], live)
    buf = PX.OutputBuffer(3)
    sink = PT.PartitionedOutputSink(buf, "REPARTITION", [0])
    sink.add_input(batch)
    rows = sorted(r for p in range(3)
                  for page in buf.get(p, 0, timeout=0)[0]
                  for r in page.to_pylist())
    assert rows == [(v,) for v in range(0, 10, 2)]


@pytest.mark.parametrize("kind,n", [("BROADCAST", 3), ("ROUND_ROBIN", 3),
                                    ("GATHER", 1)])
def test_other_kinds_match_reference(kind, n):
    rng = np.random.RandomState(11)
    cols = _columns(rng, 64, ["int", "string"], True)
    out = []
    for X, B, TY, Tk in ((PX, PB, PTY, PT), (RX, RB, RTY, RT)):
        buf = X.OutputBuffer(n)
        sink = Tk.PartitionedOutputSink(buf, kind, ())
        for _ in range(2):
            sink.add_input(B.ColumnBatch(list(cols), [
                B.Column(_type(TY, k), d, v, dic)
                for k, (d, v, dic) in cols.items()]))
        sink.finish_input()
        out.append([[r for page in buf.get(p, 0, timeout=0)[0]
                     for r in page.to_pylist()] for p in range(n)])
    assert out[0] == out[1]


def test_serialized_pages_round_trip_to_the_task_device():
    rng = np.random.RandomState(2)
    cols = _columns(rng, 100, ["int", "string"], True)
    batch = PB.ColumnBatch(list(cols), [
        PB.Column(_type(PTY, k), d, v, dic)
        for k, (d, v, dic) in cols.items()])
    buf = PX.OutputBuffer(2)
    sink = PT.PartitionedOutputSink(buf, "REPARTITION", [0], serde=True)
    sink.add_input(batch)
    sink.finish_input()
    rows = []
    for p in range(2):
        for page in buf.get(p, 0, timeout=0)[0]:
            assert isinstance(page, PT.SerializedPage) and page.nbytes
            b = PT.maybe_deserialize(page, torch.device("cpu"))
            rows.extend(b.to_pylist())
    assert sorted(rows, key=repr) == sorted(batch.to_pylist(), key=repr)


def test_stall_watchdog_is_a_declared_knob(monkeypatch):
    """``task.STALL_TIMEOUT_S`` comes from the port's knob table, declared
    as the reference declares it (type and default), so one variable sets
    both packages' watchdogs."""
    from trino_tpu.spi import knobs as RK
    from trino_tpu_torch.spi import knobs as PK

    name = "TRINO_TPU_EXCHANGE_STALL_S"
    mine, theirs = PK.knob(name), RK.knob(name)
    assert (mine.type, mine.default) == (theirs.type, theirs.default)
    monkeypatch.delenv(name, raising=False)
    assert PT.STALL_TIMEOUT_S == PK.get_float(name) == RT.STALL_TIMEOUT_S
    monkeypatch.setenv(name, "7.5")
    assert PK.get_float(name) == 7.5
