"""Task-side exchange operators.

The port of the reference ``execution/task.py``.
RemoteExchangeSourceOperator = operator/ExchangeOperator.java:44 (pulls
upstream pages through an ExchangeClient); MergeSourceOperator =
operator/MergeOperator.java:46 (order-preserving gather);
PartitionedOutputSink = operator/output/PartitionedOutputOperator.java:47
+ TaskOutputOperator (hash / broadcast / round-robin / gather placement
into the task's OutputBuffer).

Pages stay device batches unless the sink serializes them
(``exchange_serde``); a serialized page is decoded on the host and moved to
the consuming task's device.  A REPARTITION sink routes rows on the
batch's device: the reference's ``partition_assignments`` over the key
columns (``exec/kernels.py``; a dictionary column hashes the crc32 of its
values, so producers with different code spaces agree), a stable sort of
the rows by partition, and one counted read of the per-partition row
counts (``exchange.partition-counts``) to cut the sorted rows into pages.
Every row lands in the partition the reference's host routing gives it.
"""

from __future__ import annotations

import heapq
import time
from typing import Optional, Sequence

import torch

from ..exec import kernels as K
from ..exec import syncguard as SG
from ..exec.local_exchange import partition_key_tuple
from ..exec.operators import Operator
from ..spi import knobs
from ..spi.batch import Column, ColumnBatch
from .exchange import ExchangeClient, OutputBuffer
from .serde import PageStreamEncoder, deserialize_batch, serialize_batch

__all__ = ["RemoteExchangeSourceOperator", "MergeSourceOperator",
           "PartitionedOutputSink", "SerializedPage", "maybe_deserialize",
           "STALL_TIMEOUT_S"]

# How long an exchange consumer waits with NO upstream page before declaring
# a stall (the reference's TRINO_TPU_EXCHANGE_STALL_S and default).
STALL_TIMEOUT_S = knobs.get_float("TRINO_TPU_EXCHANGE_STALL_S")


class SerializedPage:
    """A batch serialized to wire bytes (execution/serde.py) — what a real
    network transport would carry (buffer/PageSerializer.java:58)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    @property
    def nbytes(self) -> int:
        return len(self.data)


def maybe_deserialize(page, device=None):
    """A page as a batch: wire bytes are decoded (on the host) and moved to
    ``device`` when one is given; a batch is returned as it is."""
    if isinstance(page, SerializedPage):
        batch = deserialize_batch(page.data)
        return batch if device is None else batch.to(device)
    return page


def partition_rows(batch: ColumnBatch, keys: Sequence[int], n: int):
    """(order, counts): the batch's row positions sorted stably by their
    partition in [0, n) (dead rows last), and the host row count of each
    partition, read in one counted sync."""
    parts = K.partition_assignments(
        [partition_key_tuple(batch.columns[k]) for k in keys], n)
    if batch.live is not None:
        parts = torch.where(batch.live, parts, n)
    order = torch.argsort(parts, stable=True)
    counts = SG.fetch(torch.bincount(parts, minlength=n + 1),
                      "exchange.partition-counts")
    return order, [int(c) for c in counts[:n]]


class RemoteExchangeSourceOperator(Operator):
    # blocking=True: wait in place for upstream pages (thread-per-task mode).
    # The time-sharing executor flips this off so a waiting consumer parks
    # (yields its worker) instead of pinning it.
    blocking = True

    def __init__(self, client: ExchangeClient, device=None):
        self.client = client
        self.device = device
        self.input_done = True

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        if self._closed:
            return None
        if not self.blocking:
            page = self.client.poll(timeout=0)
            return (maybe_deserialize(page, self.device)
                    if page is not None else None)
        # block until a page or all upstream producers finish; the driver
        # treats a None from a non-finished source as "try again"
        deadline = time.monotonic() + STALL_TIMEOUT_S
        while not self.client.is_finished():
            page = self.client.poll(timeout=0.2)
            if page is not None:
                return maybe_deserialize(page, self.device)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"exchange source stalled >{STALL_TIMEOUT_S:.0f}s")
        return None

    def is_finished(self) -> bool:
        return self._closed or self.client.is_finished()


class MergeSourceOperator(Operator):
    """Order-preserving gather of pre-sorted per-producer streams (the
    MergeOperator.java:46 consumer of a MERGE exchange).

    Small results (client-facing ORDER BY outputs) k-way heap-merge the
    producer streams row-wise on the host, reproducing the global order
    without a re-sort, and move the result to ``device``; beyond
    ``MERGE_ROW_LIMIT`` rows the streams are concatenated and sorted again
    on their device (same result)."""

    blocking = True  # executor flips off: parks instead of pinning a worker
    MERGE_ROW_LIMIT = 100_000

    def __init__(self, producer_clients, sort_keys, names, types,
                 device=None):
        self.clients = list(producer_clients)
        self.sort_keys = list(sort_keys)
        self.names = list(names)
        self.types = list(types)
        self.device = device
        self.input_done = True
        self._streams: list[list] = [[] for _ in self.clients]
        self._emitted = False

    def needs_input(self) -> bool:
        return False

    def _poll_all(self, wait: bool) -> bool:
        """Accumulate available pages; True when every stream is complete."""
        deadline = time.monotonic() + STALL_TIMEOUT_S
        while True:
            all_done = True
            progressed = False
            for i, c in enumerate(self.clients):
                if c.is_finished():
                    continue
                page = c.poll(timeout=0.05 if wait else 0)
                if page is not None:
                    self._streams[i].append(
                        maybe_deserialize(page, self.device))
                    progressed = True
                if not c.is_finished():
                    all_done = False
            if all_done or not wait:
                return all_done
            if progressed:
                deadline = time.monotonic() + STALL_TIMEOUT_S
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"merge source stalled >{STALL_TIMEOUT_S:.0f}s")

    def _row_key(self, row):
        key = []
        for k in self.sort_keys:
            v = row[k.channel]
            null_rank = (0 if k.nulls_first else 1) if v is None else \
                (1 if k.nulls_first else 0)
            if v is None:
                key.append((null_rank, 0, _MIN_TOKEN))
                continue
            nan = isinstance(v, float) and v != v
            nan_rank = (1 if k.ascending else 0) if nan else (
                0 if k.ascending else 1)
            key.append((null_rank, nan_rank,
                        _Reversed(v) if not k.ascending and not nan else
                        (_MIN_TOKEN if nan else v)))
        return tuple(key)

    def _merge(self) -> Optional[ColumnBatch]:
        batches = [b for s in self._streams for b in s]
        if not batches:
            return None
        total = sum(b.num_rows for b in batches)
        if total > self.MERGE_ROW_LIMIT:
            inp = ColumnBatch.concat(batches)
            keys = [(inp.columns[k.channel].data,
                     inp.columns[k.channel].valid, k.ascending,
                     k.nulls_first) for k in self.sort_keys]
            outs, _ = K.device_sort(
                keys, [(c.data, c.valid) for c in inp.columns], None)
            return ColumnBatch(self.names, [
                Column(c.type, d, v, c.dictionary)
                for (d, v), c in zip(outs, inp.columns)])
        streams = []
        for s in self._streams:
            rows: list = []
            for b in s:
                rows.extend(b.to_pylist())
            streams.append(rows)
        merged = list(heapq.merge(*streams, key=self._row_key))
        if not merged:
            return None
        cols = [Column.from_values(t, [r[i] for r in merged])
                for i, t in enumerate(self.types)]
        out = ColumnBatch(self.names, cols)
        return out if self.device is None else out.to(self.device)

    def get_output(self):
        if self._emitted or self._closed:
            return None
        if not self._poll_all(wait=self.blocking):
            return None  # parked; the executor reschedules us
        self._emitted = True
        return self._merge()

    def is_finished(self) -> bool:
        return self._emitted or self._closed


class _Reversed:
    """Inverts comparison order for DESC sort keys in the merge heap."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


class _MinToken:
    __slots__ = ()

    def __lt__(self, other):
        return not isinstance(other, _MinToken)

    def __eq__(self, other):
        return isinstance(other, _MinToken)


_MIN_TOKEN = _MinToken()


class PartitionedOutputSink(Operator):
    """Routes task output into the OutputBuffer: REPARTITION hashes on the
    output keys (:func:`partition_rows`), BROADCAST replicates, ROUND_ROBIN
    rotates whole batches, GATHER / OUTPUT lands in partition 0.
    ``coalesce_rows`` > 0 buffers each partition's slivers into pages of
    about that many rows.  With ``serde`` the pages are wire bytes, and
    each partition's stream gets its own PageStreamEncoder, so a dictionary
    ships once per (task, partition).
    ``sketch`` (the adaptive plane's deferred edges,
    execution/adaptive.py): a HeavyHitterSketch fed the ``sketch_keys``
    hashes of every live row, so the coordinator can fold per-task key
    distributions at the consumer's activation barrier."""

    # blocking=True: wait inside OutputBuffer.enqueue when the byte budget
    # is exhausted (thread-per-task mode).  The time-sharing executor flips
    # this off; the sink then refuses input via ``needs_input`` and its
    # driver parks until consumer acks free capacity.
    blocking = True

    def __init__(self, buffer: OutputBuffer, kind: str,
                 keys: Sequence[int] = (), serde: bool = False,
                 sketch=None, sketch_keys: Sequence[int] = (),
                 coalesce_rows: int = 0):
        self.buffer = buffer
        self.kind = kind
        self.keys = list(keys)
        self.serde = serde
        self.sketch = sketch
        self.sketch_keys = list(sketch_keys)
        self._rr = 0  # ROUND_ROBIN rotation cursor
        self.coalesce_rows = coalesce_rows
        self._pend: dict[int, list] = {}  # partition -> [rows, [slivers]]
        # BROADCAST serializes one page for all partitions, which would
        # share one stream across consumers
        self._encode_pages = (serde and kind != "BROADCAST"
                              and isinstance(buffer, OutputBuffer))
        self._encoders: dict[int, PageStreamEncoder] = {}

    def needs_input(self) -> bool:
        if (not self.blocking and hasattr(self.buffer, "has_capacity")
                and not self.buffer.has_capacity()):
            return False
        return super().needs_input()

    def _enqueue(self, partition: int, page) -> None:
        if self.blocking:
            self.buffer.enqueue(partition, page)
        else:
            self.buffer.enqueue(partition, page, block=False)

    def _page(self, batch: ColumnBatch, partition: Optional[int] = None):
        if self.serde:
            ctx = None
            if self._encode_pages and partition is not None:
                ctx = self._encoders.get(partition)
                if ctx is None:
                    ctx = self._encoders[partition] = PageStreamEncoder()
            return SerializedPage(serialize_batch(batch, ctx=ctx))
        return batch

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        if self.sketch is not None and self.sketch_keys:
            batch = batch.compact()
            self.sketch.update(K.partition_key_hashes(
                [partition_key_tuple(batch.columns[k])
                 for k in self.sketch_keys]))
        n = self.buffer.num_partitions
        if self.kind == "REPARTITION" and n > 1:
            order, counts = partition_rows(batch, self.keys, n)
            start = 0
            for p, c in enumerate(counts):
                if not c:
                    continue
                idx = order[start:start + c]
                start += c
                sub = ColumnBatch(batch.names,
                                  [col.take(idx) for col in batch.columns])
                if self.coalesce_rows:
                    self._buffer_sliver(p, sub)
                else:
                    self._enqueue(p, self._page(sub, p))
            return
        # the exchange is a page boundary: dead rows do not cross it
        batch = batch.compact()
        if batch.num_rows == 0:
            return
        if self.kind == "BROADCAST" and n > 1:
            page = self._page(batch)
            for p in range(n):
                self._enqueue(p, page)
        elif self.kind == "ROUND_ROBIN" and n > 1:
            # batch-granular rotation (RandomExchanger / ArbitraryOutputBuffer
            # role: balance load without any key)
            p = self._rr % n
            self._enqueue(p, self._page(batch, p))
            self._rr += 1
        else:
            self._enqueue(0, self._page(batch, 0))

    def _buffer_sliver(self, p: int, sub: ColumnBatch) -> None:
        ent = self._pend.get(p)
        if ent is None:
            ent = self._pend[p] = [0, []]
        ent[0] += sub.num_rows
        ent[1].append(sub)
        if ent[0] >= self.coalesce_rows:
            self._flush_pending(p)

    def _flush_pending(self, p: int) -> None:
        ent = self._pend.pop(p, None)
        if ent is not None and ent[1]:
            self._enqueue(p, self._page(ColumnBatch.concat(ent[1]), p))

    def finish_input(self) -> None:
        super().finish_input()
        for p in list(self._pend):
            self._flush_pending(p)
        self.buffer.set_finished()

    def is_finished(self) -> bool:
        return self.input_done
