"""The torch port's asynchronous scan ingest (exec/prefetch.py and the
ScanOperator's asynchronous path), against the reference's where both can
take the same input.

The reference's eleven cases (tests/test_prefetch.py) adapted to the port:
split order under concurrent prefetch, backpressure under a tiny budget,
early close with splits in flight, a pushed-down LIMIT that stops opening
splits, crash propagation, coalescing of dictionary columns with NULLs (no
padding in the port), dynamic filters with coalescing, on / off rows and the
EXPLAIN ANALYZE scan line, and parked producers that exit when the consumer
abandons the scan.  Then the 22 TPC-H queries with
``IngestConfig(enabled=False)`` against the default path (at least one
thread), and no prefetch thread alive after a query.  Everything runs on
``device="cpu"``, where the stager copies nothing;
tests/test_torch_gpu.py holds the pinned side-stream staging on the card.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_queries import _same_rows
from trino_tpu.exec.prefetch import BatchCoalescer as RefCoalescer
from trino_tpu.exec.prefetch import IngestConfig as RefIngestConfig
from trino_tpu.exec.prefetch import PrefetchingPageSource as RefSource
from trino_tpu.exec.prefetch import coalesce_pad as ref_coalesce_pad
from trino_tpu.spi.batch import Column as RefColumn
from trino_tpu.spi.batch import ColumnBatch as RefBatch
from trino_tpu.spi.connector import Split as RefSplit
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.dynamic_filter import DynamicFilterHolder
from trino_tpu_torch.exec.operators import ScanOperator
from trino_tpu_torch.exec.prefetch import (BatchCoalescer, IngestConfig,
                                           PrefetchingPageSource, coalesce,
                                           default_threads)
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.connector import (Connector, ConnectorPageSource,
                                           Split)
from trino_tpu_torch.spi.types import BIGINT, VARCHAR

THREADS = max(1, default_threads())


def _bigint_batch(values, pkg="port"):
    C, B = (Column, ColumnBatch) if pkg == "port" else (RefColumn, RefBatch)
    return B(["v"], [C(BIGINT, np.asarray(values, np.int64))])


class _SlowSource(ConnectorPageSource):
    def __init__(self, batches, delay=0.0, fail_at=None):
        self._batches = list(batches)
        self._i = 0
        self._delay = delay
        self._fail_at = fail_at

    def get_next_batch(self):
        if self._fail_at is not None and self._i >= self._fail_at:
            raise RuntimeError("connector exploded")
        if self._delay:
            time.sleep(self._delay)
        b = self._batches[self._i]
        self._i += 1
        return b

    def is_finished(self):
        return self._i >= len(self._batches) and self._fail_at is None


class _FakeConnector(Connector):
    """N splits, each yielding its batches through a throttled source."""

    name = "fake"

    def __init__(self, per_split_batches, delay=0.0, fail_split=None,
                 fail_at=0, split_cls=Split):
        self._per_split = per_split_batches
        self._delay = delay
        self._fail_split = fail_split
        self._fail_at = fail_at
        self._split_cls = split_cls
        self.opened = []

    def splits(self):
        return [self._split_cls("fake", "t", i)
                for i in range(len(self._per_split))]

    def create_page_source(self, split, columns, constraint=None):
        self.opened.append(split.info)
        fail = self._fail_at if split.info == self._fail_split else None
        return _SlowSource(self._per_split[split.info],
                           delay=self._delay, fail_at=fail)


def _drain(src):
    out = []
    while True:
        b = src.get_next_batch()
        if b is None:
            return out
        out.append(b)


def _values(batches) -> list:
    return [int(v) for b in batches for v in np.asarray(b.columns[0].data)]


def test_split_order_preserved():
    """Split k's values [100k, 100k+5) come out in split order from three
    workers, as from the reference's prefetcher."""
    def batches(pkg):
        return [[_bigint_batch([s * 100 + i], pkg) for i in range(5)]
                for s in range(6)]

    conn = _FakeConnector(batches("port"), delay=0.002)
    src = PrefetchingPageSource(conn, conn.splits(), ["v"],
                                IngestConfig(threads=3, queue_depth=4))
    got = _values(_drain(src))
    ref_conn = _FakeConnector(batches("ref"), delay=0.002,
                              split_cls=RefSplit)
    ref = RefSource(ref_conn, ref_conn.splits(), ["v"],
                    config=RefIngestConfig(threads=3, queue_depth=4))
    assert got == _values(_drain(ref)) == [s * 100 + i for s in range(6)
                                           for i in range(5)]
    assert src.stats.splits_opened == 6
    assert src.stats.scan_rows == 30


def test_backpressure_small_budget():
    conn = _FakeConnector([[_bigint_batch(list(range(64)))
                            for _ in range(8)] for _ in range(4)])
    cfg = IngestConfig(threads=2, queue_depth=2, queue_bytes=1)
    src = PrefetchingPageSource(conn, conn.splits(), ["v"], cfg)
    seen = 0
    while True:
        b = src.get_next_batch()
        if b is None:
            break
        seen += 1
        time.sleep(0.002)  # slow consumer: producers park, not pile up
    assert seen == 32
    # budget + one in-flight insert per producer + the starved-consumer
    # exemption
    assert src.stats.queue_depth_max <= cfg.queue_depth + cfg.threads + 1


def test_early_close_drops_unclaimed_splits():
    conn = _FakeConnector([[_bigint_batch([i]) for i in range(4)]
                           for _ in range(8)], delay=0.02)
    src = PrefetchingPageSource(conn, conn.splits(), ["v"],
                                IngestConfig(threads=1, queue_depth=2))
    assert src.get_next_batch() is not None
    src.close()
    src.join(timeout=5.0)
    assert not any(t.is_alive() for t in src._threads)
    assert src.stats.splits_opened < 8  # unclaimed splits never opened
    assert src.get_next_batch() is None


@pytest.mark.parametrize("enabled", [True, False])
def test_scan_limit_opens_no_further_split(enabled):
    """LIMIT 8 over splits of 16 rows: the scan opens one split and no
    further, on the asynchronous and on the synchronous path."""
    conn = _FakeConnector([[_bigint_batch(list(range(8))) for _ in range(2)]
                           for _ in range(8)], delay=0.02)
    scan = ScanOperator(conn, conn.splits(), ["v"], "cpu", limit=8,
                        ingest=IngestConfig(enabled=enabled, threads=THREADS,
                                            coalesce_rows=8))
    rows = 0
    while not scan.is_finished():
        b = scan.get_output()
        if b is None:
            break
        rows += b.live_count
    scan.shutdown()
    assert rows >= 8
    assert scan.ingest_stats.splits_opened == 1
    assert conn.opened == [0]


def test_crash_in_prefetch_thread_propagates():
    conn = _FakeConnector([[_bigint_batch([1])] for _ in range(3)],
                          fail_split=1, fail_at=1)
    src = PrefetchingPageSource(conn, conn.splits(), ["v"],
                                IngestConfig(threads=2))
    with pytest.raises(Exception, match="scan prefetch thread failed") as e:
        _drain(src)
    assert isinstance(e.value.__cause__, RuntimeError)


def test_coalesce_dictionary_and_valid():
    """Dictionary columns unify, NULLs keep their mask, no padding: the
    rows of the reference's coalesce_pad without its dead pad rows."""
    data = [{"s": (VARCHAR, ["apple", "pear", None]),
             "n": (BIGINT, [1, None, 3])},
            {"s": (VARCHAR, ["pear", "zebra"]), "n": (BIGINT, [4, 5])}]
    port_parts = [ColumnBatch(list(d), [Column.from_values(t, v)
                                        for t, v in d.values()])
                  for d in data]
    out, buffers = coalesce(port_parts)
    ref = ref_coalesce_pad([RefBatch.from_pydict(d) for d in data])
    assert out.num_rows == 5 and out.live is None and ref.num_rows == 8
    assert out.to_pylist() == ref.compact().to_pylist() == [
        ("apple", 1), ("pear", None), (None, 3), ("pear", 4), ("zebra", 5)]
    assert len(buffers) == 2 and buffers[1][1] is not None


def test_coalescer_merges_to_target():
    port, ref = BatchCoalescer(target_rows=16), RefCoalescer(target_rows=16)
    for i in range(5):
        vals = list(range(i * 6, i * 6 + 6))
        port.add(_bigint_batch(vals))
        ref.add(_bigint_batch(vals, "ref"))
        if port.ready():
            break
    assert port.ready() and ref.ready()
    out, _ = port.flush()
    want = ref.flush()
    assert out.num_rows == 18 and want.live_count == 18
    assert out.to_pylist() == want.compact().to_pylist()
    assert port.flush() is None


def test_scan_dynamic_filter_with_coalescing():
    conn = _FakeConnector([[_bigint_batch(list(range(s * 10, s * 10 + 10)))]
                           for s in range(4)])
    holder = DynamicFilterHolder()
    holder.fill(np.asarray([2, 3, 11, 35], np.int64), None, None)
    scan = ScanOperator(conn, conn.splits(), ["v"], "cpu",
                        dynamic_filters=[(0, holder)],
                        ingest=IngestConfig(threads=THREADS,
                                            coalesce_rows=32))
    vals = []
    while not scan.is_finished():
        b = scan.get_output()
        if b is None:
            break
        vals.extend(v for (v,) in b.to_pylist())
    assert vals == [2, 3, 11, 35]
    assert holder.rows_pruned == 36 == scan.ingest_stats.rows_pruned
    assert scan.ingest_stats.coalesced_batches >= 1


@pytest.fixture(scope="module")
def catalog():
    return default_catalog(0.01)


def test_prefetch_off_matches_on(catalog):
    sql = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "where l_quantity < 30 group by l_returnflag order by l_returnflag")
    sync_rows = StandaloneQueryRunner(
        catalog, device="cpu",
        ingest=IngestConfig(enabled=False)).execute(sql).rows()
    async_rows = StandaloneQueryRunner(
        catalog, device="cpu",
        ingest=IngestConfig(threads=THREADS, coalesce_rows=4096)
    ).execute(sql).rows()
    assert sync_rows == async_rows


def test_scan_stats_in_query_stats(catalog):
    r = StandaloneQueryRunner(catalog, device="cpu",
                              ingest=IngestConfig(threads=THREADS))
    text = "\n".join(v for (v,) in r.execute(
        "explain analyze select count(*) from orders").rows())
    assert "scan[prefetch]" in text and "GB/s" in text
    st = QueryStats()
    r.execute("select count(*) from orders", stats=st)
    assert st.scan.prefetch_enabled and st.scan.scan_rows == 15000
    assert st.scan.splits_opened == len(
        catalog.connector("tpch").get_splits("orders", 4, 1))


def _prefetch_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("scan-prefetch")]


def test_backpressure_threads_exit_on_consumer_abandon():
    """A consumer that stops pulling and closes unparks parked producers,
    and no thread outlives the abandoned scan."""
    conn = _FakeConnector([[_bigint_batch(list(range(64))) for _ in range(4)]
                           for _ in range(4)])
    cfg = IngestConfig(threads=2, queue_depth=1, queue_bytes=1)
    src = PrefetchingPageSource(conn, conn.splits(), ["v"], cfg)
    assert src.get_next_batch() is not None
    src.close()
    src.join(timeout=5.0)
    assert not any(t.is_alive() for t in src._threads)
    scan = ScanOperator(conn, conn.splits(), ["v"], "cpu",
                        ingest=IngestConfig(threads=2, queue_depth=1,
                                            queue_bytes=1, coalesce_rows=64))
    assert scan.get_output() is not None
    scan.shutdown()
    assert not _prefetch_threads()


def test_no_prefetch_thread_after_a_query(catalog):
    r = StandaloneQueryRunner(catalog, device="cpu",
                              ingest=IngestConfig(threads=THREADS))
    r.execute(QUERIES[3])
    r.execute("select * from lineitem limit 3")
    assert not _prefetch_threads()
    with pytest.raises(Exception):
        r.execute("select 1 / (l_quantity - l_quantity) from lineitem")
    assert not _prefetch_threads()


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_queries_ingest_off_match_default(catalog, q):
    """The 22 queries: the synchronous scan and the default asynchronous
    one (forced to at least one thread) give identical rows."""
    off = StandaloneQueryRunner(catalog, device="cpu",
                                ingest=IngestConfig(enabled=False))
    on = StandaloneQueryRunner(catalog, device="cpu",
                               ingest=IngestConfig(threads=THREADS))
    _same_rows(on.execute(QUERIES[q]).rows(), off.execute(QUERIES[q]).rows(),
               rel_tol=0.0)
