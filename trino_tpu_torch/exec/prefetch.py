"""Asynchronous scan ingest: split prefetch, batch coalescing, device staging.

The port of the reference ``exec/prefetch.py`` (ScanFilterAndProjectOperator.
java:68 lazy pages, MergePages.java:38 coalescing, split prefetch through
ConnectorSplitSource.getNextBatch futures).  The synchronous scan decodes a
split, copies the batch from pageable memory and computes, one after the
other; these pieces overlap the three:

- :class:`PrefetchingPageSource` drains connector splits on background
  threads into a queue bounded in bytes and batches.  Split order is kept
  (every batch of split k before any of split k+1), producers park while
  the queue is over budget, ``close()`` stops them (a satisfied LIMIT), and
  a prefetch thread's exception is raised on the consumer.  The threads do
  host work only: they never touch the card.
- :func:`coalesce` / :class:`BatchCoalescer` merge small host batches up to
  ``coalesce_rows``, writing every part into ONE preallocated buffer per
  column (on the card: pinned host buffers from a :class:`PinnedBufferPool`).
  Nothing is padded: eager PyTorch does not recompile per shape.
- :func:`encode_column` / :func:`encode_scan_batch` make RLE columns of
  constant runs and LAZY columns of the channels a filter only passes
  through (compressed execution).
- :class:`DeviceStager` copies a coalesced batch to the card with
  non-blocking copies on its own CUDA stream and an event the consumer's
  stream waits on, so batch N+1 crosses while batch N computes.  On a CPU
  device it copies nothing (the encodings still apply).

A failed pin or stream operation raises; nothing falls back to a pageable
synchronous copy.  Turning the path off is the caller's
``IngestConfig(enabled=False)``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import torch

from ..spi.batch import Column, ColumnBatch, maybe_rle, unify_dictionaries
from ..spi.errors import GENERIC_INTERNAL_ERROR, TrinoError
from .stats import EncodingStats, ScanIngestStats

__all__ = [
    "IngestConfig",
    "PrefetchingPageSource",
    "PinnedBufferPool",
    "BatchCoalescer",
    "DeviceStager",
    "coalesce",
    "encode_column",
    "encode_scan_batch",
]


def default_threads() -> int:
    """Prefetch threads from the host's cores: cpu_count - 1 (one core
    stays with the consumer), at most 4 (decoding is memory-bound past
    that).  A one-core host gets 0, which turns the path off: an extra
    thread there only contends for the interpreter lock."""
    return min(4, max(0, (os.cpu_count() or 1) - 1))


@dataclass(frozen=True)
class IngestConfig:
    """Scan-ingest settings (the reference's TRINO_TPU_PREFETCH* and
    TRINO_TPU_COALESCE_TARGET_ROWS knobs, with their defaults)."""

    enabled: bool = True
    threads: int = field(default_factory=default_threads)
    queue_depth: int = 8             # batches
    queue_bytes: int = 256 << 20
    coalesce_rows: int = 1 << 16

    @property
    def active(self) -> bool:
        """The asynchronous path runs: enabled, with at least one thread."""
        return self.enabled and self.threads > 0


class PrefetchingPageSource:
    """Order-preserving multi-split prefetcher with a bounded queue.

    Worker threads claim splits in order and append decoded batches to a
    per-split buffer; the consumer drains the buffers strictly in split
    order, so downstream row order equals the synchronous scan's.
    Producers park while the queue is over its byte or depth budget,
    except the producer of the consumer's current split while that split's
    buffer is empty (a starved consumer always makes progress)."""

    def __init__(self, connector, splits: Sequence, columns: Sequence[str],
                 config: IngestConfig,
                 stats: Optional[ScanIngestStats] = None,
                 limit_rows: Optional[int] = None):
        self.connector = connector
        self.splits = list(splits)
        self.columns = list(columns)
        self.cfg = config
        self.stats = stats if stats is not None else ScanIngestStats()
        self.stats.prefetch_enabled = True
        self.limit_rows = limit_rows
        self._cv = threading.Condition()
        self._buffers: list[deque] = [deque() for _ in self.splits]
        self._done = [False] * len(self.splits)
        self._next_claim = 0   # next split a worker picks up (in order)
        self._consume = 0      # split the consumer is draining
        self._inflight = 0     # splits claimed but not finished
        self._queued_bytes = 0
        self._queued_batches = 0
        self._queued_rows = 0
        # under a LIMIT: rows handed to the consumer and not yet accounted
        # (:meth:`consumed`), and rows that survived its masks
        self._pending_rows = 0
        self._kept_rows = 0
        self._error: Optional[BaseException] = None
        self._closed = False
        n = min(config.threads, max(1, len(self.splits)))
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"scan-prefetch-{i}")
            for i in range(n)]
        for t in self._threads:
            t.start()

    # -- producer side -----------------------------------------------------

    def _over_budget(self) -> bool:
        return (self._queued_bytes >= self.cfg.queue_bytes
                or self._queued_batches >= self.cfg.queue_depth)

    def _stopped(self) -> bool:
        return self._closed or self._error is not None

    def _claim(self) -> Optional[int]:
        """The next split index, or None when there is nothing to do."""
        with self._cv:
            # a pushed-down LIMIT claims lazily: one split in flight, none
            # while the rows queued, in the consumer's hands or kept by it
            # could satisfy the limit.  Filters may drop rows, so this only
            # pauses claiming; the consumer's accounting resumes it
            while (self.limit_rows is not None
                   and (self._inflight >= 1
                        or self._queued_rows + self._pending_rows
                        + self._kept_rows >= self.limit_rows)
                   and self._next_claim < len(self.splits)
                   and not self._stopped()):
                self._cv.wait(0.05)
            if self._stopped() or self._next_claim >= len(self.splits):
                return None
            idx = self._next_claim
            self._next_claim += 1
            self._inflight += 1
            self.stats.splits_opened += 1
            return idx

    def _work(self) -> None:
        try:
            while True:
                idx = self._claim()
                if idx is None:
                    return
                src = self.connector.create_page_source(self.splits[idx],
                                                        self.columns)
                try:
                    while True:
                        with self._cv:
                            while (self._over_budget()
                                   and not (idx == self._consume
                                            and not self._buffers[idx])
                                   and not self._stopped()):
                                self._cv.wait(0.05)
                            if self._stopped():
                                return
                        if src.is_finished():
                            break
                        t0 = time.perf_counter()
                        b = src.get_next_batch()
                        dt = time.perf_counter() - t0
                        with self._cv:
                            self.stats.source_read_s += dt
                            if b is not None:
                                self._buffers[idx].append(b)
                                self._queued_bytes += b.nbytes
                                self._queued_batches += 1
                                self._queued_rows += b.num_rows
                                self.stats.queue_depth_max = max(
                                    self.stats.queue_depth_max,
                                    self._queued_batches)
                            self._cv.notify_all()
                finally:
                    src.close()
                with self._cv:
                    self._done[idx] = True
                    self._inflight -= 1
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — raised on the consumer
            with self._cv:
                if self._error is None:
                    self._error = e
                self._cv.notify_all()

    # -- consumer side -----------------------------------------------------

    def _advance(self) -> None:
        while (self._consume < len(self.splits)
               and self._done[self._consume]
               and not self._buffers[self._consume]):
            self._consume += 1

    def get_next_batch(self) -> Optional[ColumnBatch]:
        """The next batch in split order; blocks while prefetch is behind.
        None when every split is drained (or after close)."""
        with self._cv:
            while True:
                if self._error is not None:
                    err = self._error
                    raise TrinoError(
                        GENERIC_INTERNAL_ERROR,
                        f"scan prefetch thread failed: {err}") from err
                if self._closed:
                    return None
                self._advance()
                if self._consume >= len(self.splits):
                    return None
                buf = self._buffers[self._consume]
                if buf:
                    b = buf.popleft()
                    self._queued_bytes -= b.nbytes
                    self._queued_batches -= 1
                    self._queued_rows -= b.num_rows
                    self._pending_rows += b.num_rows
                    s = self.stats
                    s.queue_depth_sum += self._queued_batches + 1
                    s.queue_samples += 1
                    s.observe_batch(b.nbytes, b.num_rows)
                    self._cv.notify_all()
                    return b
                t0 = time.perf_counter()
                self._cv.wait(0.05)
                self.stats.consumer_wait_s += time.perf_counter() - t0

    def consumed(self, rows: int, kept: int) -> None:
        """The consumer is done with a batch of ``rows`` rows and kept
        ``kept`` of them (after its masks): the LIMIT gate's count."""
        with self._cv:
            self._pending_rows -= rows
            self._kept_rows += kept
            self._cv.notify_all()

    def is_finished(self) -> bool:
        with self._cv:
            if self._stopped():
                return True
            self._advance()
            return self._consume >= len(self.splits)

    def close(self) -> None:
        """Early close (a satisfied LIMIT, a finished or failed query):
        producers stop at their next check, unclaimed splits are never
        opened."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout)


class PinnedBufferPool:
    """Pinned host buffers per (dtype, capacity), handed out again only
    after the event of the copy that last read one has completed.  A
    capacity is the row count rounded up to ``grain`` rows, so batches of
    nearly equal size share buffers."""

    def __init__(self, grain: int = 1 << 14):
        self.grain = grain
        self._free: dict = {}  # (dtype, capacity) -> [(buffer, event)]
        self.allocated = 0
        self.reused = 0

    def acquire(self, dtype: torch.dtype, rows: int) -> torch.Tensor:
        """A pinned buffer of at least ``rows`` elements (slice it)."""
        cap = max(self.grain, -(-rows // self.grain) * self.grain)
        free = self._free.get((dtype, cap))
        if free:
            for i, (buf, event) in enumerate(free):
                if event is None or event.query():
                    del free[i]
                    self.reused += 1
                    return buf
        self.allocated += 1
        return torch.empty(cap, dtype=dtype, pin_memory=True)

    def release(self, buf: torch.Tensor, event) -> None:
        """Give ``buf`` back; it is reused once ``event`` (the copy that
        read it; None = no copy) has completed."""
        self._free.setdefault((buf.dtype, buf.numel()), []).append(
            (buf, event))


def _host_alloc(dtype: torch.dtype, rows: int) -> torch.Tensor:
    return torch.empty(rows, dtype=dtype)


def coalesce(parts: Sequence[ColumnBatch],
             alloc: Callable = _host_alloc) -> tuple:
    """Merge dense host batches into one, writing each part into one
    preallocated buffer per array (``alloc(dtype, rows)`` gives at least
    ``rows`` elements: pinned buffers on the card).  Dictionary columns are
    unified onto one code space first.  Returns (batch, buffers): the
    allocated buffers per column, ``[data, valid]`` (valid may be None).
    This is the reference's ``coalesce_pad`` without the padding."""
    if not parts:
        raise ValueError("coalesce of no batches")
    names = parts[0].names
    total = sum(p.num_rows for p in parts)
    cols, buffers = [], []
    for i in range(len(names)):
        cs = [p.columns[i] for p in parts]
        if cs[0].type.is_dictionary_encoded:
            cs = unify_dictionaries(cs)
        dbuf = alloc(cs[0].data.dtype, total)
        data = dbuf[:total]
        vbuf = valid = None
        if any(c.valid is not None for c in cs):
            vbuf = alloc(torch.bool, total)
            valid = vbuf[:total]
        pos = 0
        for c in cs:
            n = len(c)
            data[pos:pos + n].copy_(c.data)
            if valid is not None:
                if c.valid is None:
                    valid[pos:pos + n] = True
                else:
                    valid[pos:pos + n].copy_(c.valid)
            pos += n
        cols.append(Column(cs[0].type, data, valid, cs[0].dictionary))
        buffers.append([dbuf, vbuf])
    return ColumnBatch(list(names), cols), buffers


class BatchCoalescer:
    """Accumulate dense host batches and emit merges of at least
    ``target_rows`` rows (or whatever is left at the end).  Batches already
    on the device, or of a device-resident table, never enter it: the
    scan hands those on as they are."""

    def __init__(self, target_rows: int,
                 stats: Optional[ScanIngestStats] = None,
                 alloc: Optional[Callable] = None):
        self.target_rows = target_rows
        self.stats = stats
        self.alloc = alloc
        self._parts: list[ColumnBatch] = []
        self._rows = 0

    @property
    def buffered_rows(self) -> int:
        return self._rows

    def add(self, batch: ColumnBatch) -> None:
        if batch.live is not None:
            raise ValueError("coalescer input must be dense")
        if batch.num_rows:
            self._parts.append(batch)
            self._rows += batch.num_rows

    def ready(self) -> bool:
        return self._rows >= self.target_rows

    def flush(self) -> Optional[tuple]:
        """(merged batch, buffers) of everything buffered, or None.  With
        no ``alloc`` a lone part is handed on as it is (no buffers)."""
        if not self._parts:
            return None
        parts, self._parts, self._rows = self._parts, [], 0
        if self.stats is not None:
            self.stats.coalesced_batches += 1
            self.stats.coalesced_rows += sum(p.num_rows for p in parts)
        if self.alloc is None:
            if len(parts) == 1:
                return parts[0], None
            return coalesce(parts)
        return coalesce(parts, self.alloc)


def encode_column(i: int, c: Column, lazy_channels, device,
                  enc_stats: Optional[EncodingStats] = None,
                  on_materialize=None) -> Optional[Column]:
    """Compressed execution of one host column bound for ``device``: an
    RLE run of a constant column, or a LAZY column for a channel the
    planner proved the filter only passes through.  None: copy it as it
    is."""
    rle = maybe_rle(c)
    if rle is not c:
        if enc_stats is not None:
            enc_stats.bytes_saved += rle.flat_nbytes - rle.nbytes
        return rle.to(device)
    if i in lazy_channels:
        data, valid = c.data, c.valid

        def thunk(data=data, valid=valid):
            return data, valid

        if enc_stats is not None:
            enc_stats.lazy_columns += 1
            enc_stats.lazy_skipped_bytes += c.nbytes
        return Column.lazy(c.type, len(c), thunk, c.dictionary,
                           device=device, nbytes_hint=c.nbytes,
                           on_materialize=on_materialize)
    return None


def _on_materialize(stats: Optional[ScanIngestStats],
                    enc_stats: Optional[EncodingStats], pool=None,
                    buffers=()):
    """on_materialize of a scan's LAZY column: count the thunk and the
    bytes it copied to the card, and hand the pool ``buffers`` the thunk
    read back behind the copy's event (the copy ran on the consumer's
    stream)."""
    def done(col: Column) -> None:
        if enc_stats is not None:
            enc_stats.lazy_materialized += 1
        if col.device.type != "cuda":
            return
        if stats is not None:
            stats.h2d_bytes += _array_bytes(col)
        if pool is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(col.device))
            for b in buffers:
                if b is not None:
                    pool.release(b, event)
    return done


def _array_bytes(col: Column) -> int:
    n = col.data.numel() * col.data.element_size()
    return n + (0 if col.valid is None else col.valid.numel())


def encode_scan_batch(batch: ColumnBatch, lazy_channels, device,
                      enc_stats: Optional[EncodingStats] = None,
                      stats: Optional[ScanIngestStats] = None
                      ) -> ColumnBatch:
    """Compressed execution for the synchronous scan: each column RLE,
    LAZY or as it was (the caller moves the batch to ``device``)."""
    if not batch.columns:
        return batch
    done = _on_materialize(stats, enc_stats)
    any_rle = changed = False
    cols = []
    for i, c in enumerate(batch.columns):
        enc = encode_column(i, c, lazy_channels, device, enc_stats, done)
        if enc is None:
            cols.append(c)
            continue
        any_rle = any_rle or enc.encoding == "RLE"
        changed = True
        cols.append(enc)
    if not changed:
        return batch
    if any_rle and enc_stats is not None:
        enc_stats.rle_batches += 1
    return ColumnBatch(batch.names, cols, batch.live)


class DeviceStager:
    """Host -> device staging of coalesced batches.

    On a CUDA device: the coalescer writes into pinned buffers from
    :attr:`pool`; :meth:`stage` issues one non-blocking copy per array on a
    dedicated stream, records an event there and returns at once, so the
    scan can stage batch N+1 before handing batch N downstream.  Each
    device tensor made on the side stream is marked used by the consumer's
    stream (``record_stream``), and the consumer's stream waits on the
    batch's event before it touches it (:meth:`ready`).  A buffer goes
    back to the pool with the event of the copy that read it; a LAZY
    column keeps its buffers until it is read (its copy then runs on the
    consumer's stream) or dropped.  On a CPU device nothing is copied (the
    encodings still apply).  Counts the bytes it copies in
    ``stats.h2d_bytes``."""

    def __init__(self, device, stats: Optional[ScanIngestStats] = None,
                 lazy_channels=(), enc_stats: Optional[EncodingStats] = None,
                 encoded: bool = True):
        self.device = torch.device(device)
        self.stats = stats
        self.lazy_channels = frozenset(lazy_channels)
        self.enc_stats = enc_stats
        self.encoded = encoded
        self.cuda = self.device.type == "cuda"
        self.pool = PinnedBufferPool() if self.cuda else None
        self.stream = (torch.cuda.Stream(device=self.device) if self.cuda
                       else None)

    @property
    def alloc(self) -> Optional[Callable]:
        """The coalescer's allocator: pinned buffers on the card."""
        return self.pool.acquire if self.cuda else None

    def stage(self, batch: ColumnBatch, buffers=None) -> tuple:
        """(batch on the device, event or None).  ``buffers``: the pool
        buffers behind each column (from :func:`coalesce`)."""
        if not self.cuda or not batch.columns:
            if self.encoded and batch.columns:
                batch = encode_scan_batch(batch, self.lazy_channels,
                                          self.device, self.enc_stats,
                                          self.stats)
            return batch, None
        if buffers is None:
            raise ValueError("staging to the card needs the coalescer's "
                             "pinned buffers")
        t0 = time.perf_counter()
        consumer = torch.cuda.current_stream(self.device)
        copied = 0
        any_rle = False
        cols: list = [None] * batch.num_columns
        after_copy = []  # buffers the side-stream copies read
        with torch.cuda.stream(self.stream):
            for i, (c, bufs) in enumerate(zip(batch.columns, buffers)):
                enc = None
                if self.encoded:
                    enc = encode_column(
                        i, c, self.lazy_channels, self.device,
                        self.enc_stats, _on_materialize(
                            self.stats, self.enc_stats, self.pool, bufs))
                if enc is not None and enc.encoding == "LAZY":
                    cols[i] = enc  # its buffers wait for its read
                    continue
                after_copy.extend(b for b in bufs if b is not None)
                if enc is not None:  # RLE: only the mask crosses
                    any_rle = True
                    if enc.valid is not None:
                        enc.valid.record_stream(consumer)
                        copied += enc.valid.numel()
                    cols[i] = enc
                    continue
                data = c.data.to(self.device, non_blocking=True)
                data.record_stream(consumer)
                valid = None
                if c.valid is not None:
                    valid = c.valid.to(self.device, non_blocking=True)
                    valid.record_stream(consumer)
                copied += _array_bytes(c)
                cols[i] = Column(c.type, data, valid, c.dictionary)
            event = torch.cuda.Event()
            event.record(self.stream)
        for b in after_copy:
            self.pool.release(b, event)
        if any_rle and self.enc_stats is not None:
            self.enc_stats.rle_batches += 1
        if self.stats is not None:
            self.stats.stage_s += time.perf_counter() - t0
            self.stats.staged_batches += 1
            self.stats.h2d_bytes += copied
        return ColumnBatch(batch.names, cols), event

    def ready(self, event) -> None:
        """Make the consumer's stream wait for a staged batch's copies."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
