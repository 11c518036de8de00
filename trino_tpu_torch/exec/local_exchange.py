"""Intra-task local exchange: bounded repartitioning between pipelines.

The port of the reference ``exec/local_exchange.py`` (operator/exchange/
LocalExchange.java:67, inserted by optimizations/AddLocalExchanges.java:111):
N producer drivers deposit batches, M consumer drivers drain their
partition, and a bounded buffer per consumer gives BACKPRESSURE: a full
buffer makes the sink decline input (``needs_input() == False``), which
parks the producer driver instead of growing memory (the isBlocked()
contract of operator/Operator.java:21).

Modes (PartitioningExchanger / RandomExchanger / PassthroughExchanger):

- ``GATHER``      all batches to consumer 0 (the many-to-one union);
- ``PASSTHROUGH`` producer i feeds consumer i % M, whole batches;
- ``ROUND_ROBIN`` whole batches rotate across consumers;
- ``HASH``        rows route by the hash of the key channels
  (:func:`hash_partitions`; a row with a NULL key goes to partition 0).
  No row moves: every consumer receives the same tensors under a
  partition-restricted ``live`` mask, and the blocking operator downstream
  compacts its partition before any O(n log n) work.
"""

from __future__ import annotations

import threading
import zlib
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..caching.executable_cache import memo
from ..spi.batch import ColumnBatch, host_table
from . import kernels as K
from .operators import Operator

__all__ = ["LocalExchange", "LocalExchangeSinkOperator",
           "LocalExchangeSourceOperator", "GATHER", "PASSTHROUGH",
           "ROUND_ROBIN", "HASH"]

GATHER = "GATHER"
PASSTHROUGH = "PASSTHROUGH"
ROUND_ROBIN = "ROUND_ROBIN"
HASH = "HASH"


@memo("local_exchange.entry_hashes", maxsize=256, weak=True)
def _entry_hashes(dictionary, device) -> torch.Tensor:
    """A stable int64 hash of every dictionary entry's value, on
    ``device``, kept per dictionary object: codes are per-batch
    namespaces, values are not."""
    h = np.fromiter((zlib.crc32(str(v).encode()) for v in dictionary),
                    dtype=np.int64, count=len(dictionary))
    return host_table(h, device)


def partition_key_tuple(c) -> tuple:
    """(data, valid) of a routing key column on its device, as
    ``kernels.partition_assignments`` takes it: a dictionary column's codes
    become the crc32 of their values (the reference's
    ``_dict_value_hashes``), since code 3 in one batch's dictionary is a
    different string than code 3 in another's."""
    if c.dictionary is None:
        return c.data, c.valid
    if not len(c.dictionary):
        return (torch.zeros(len(c), dtype=torch.int64, device=c.device),
                c.valid)
    return _entry_hashes(c.dictionary, c.device)[c.data.long()], c.valid


def hash_partitions(batch: ColumnBatch, key_channels: Sequence[int],
                    m: int) -> torch.Tensor:
    """Each row's partition in [0, m): ``kernels.partition_assignments``
    (the 64-bit ``hash_combine`` modulo m as an unsigned number, 0 where a
    key is NULL) over the key channels that are not dictionary codes.
    Rows of one group agree on any subset of its keys, so when a key is a
    plain column the dictionary keys are left out; when all are dictionary
    keys, their values' hashes stand in for the codes."""
    cols = [batch.columns[ch] for ch in key_channels]
    use = [c for c in cols if c.dictionary is None] or cols
    return K.partition_assignments([partition_key_tuple(c) for c in use], m)


class LocalExchange:
    def __init__(self, n_producers: int, n_consumers: int, mode: str,
                 key_channels: Sequence[int] = (),
                 buffer_batches: int = 8):
        self.n_producers = n_producers
        self.n_consumers = n_consumers
        self.mode = mode
        self.key_channels = list(key_channels)
        self.buffer_batches = buffer_batches
        self._queues: list[deque] = [deque() for _ in range(n_consumers)]
        self._lock = threading.Lock()
        self._finished_producers = 0
        self._rr = 0

    # ------------------------------------------------------------- producers
    def can_accept(self, producer_index: int) -> bool:
        """False when a target buffer is full: the sink declines input and
        the producer driver parks."""
        with self._lock:
            if self.mode == PASSTHROUGH:
                q = [self._queues[producer_index % self.n_consumers]]
            else:
                q = self._queues
            return all(len(x) < self.buffer_batches for x in q)

    def deposit(self, producer_index: int, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        if self.mode == HASH:
            parts = self._partition(batch)
            with self._lock:
                for q, sub in zip(self._queues, parts):
                    q.append(sub)
            return
        with self._lock:
            if self.mode == GATHER:
                j = 0
            elif self.mode == PASSTHROUGH:
                j = producer_index % self.n_consumers
            else:
                assert self.mode == ROUND_ROBIN, self.mode
                j, self._rr = self._rr, (self._rr + 1) % self.n_consumers
            self._queues[j].append(batch)

    def _partition(self, batch: ColumnBatch) -> list[ColumnBatch]:
        """Split by key hash as live-mask views of the same tensors (no
        row moves, no host sync)."""
        part = hash_partitions(batch, self.key_channels, self.n_consumers)
        live = batch.live
        return [ColumnBatch(batch.names, list(batch.columns),
                            (part == j) if live is None
                            else live & (part == j))
                for j in range(self.n_consumers)]

    def producer_finished(self) -> None:
        with self._lock:
            self._finished_producers += 1

    # ------------------------------------------------------------- consumers
    def poll(self, consumer_index: int) -> Optional[ColumnBatch]:
        with self._lock:
            q = self._queues[consumer_index]
            return q.popleft() if q else None

    def consumer_finished(self, consumer_index: int) -> bool:
        with self._lock:
            return (self._finished_producers >= self.n_producers
                    and not self._queues[consumer_index])


class LocalExchangeSinkOperator(Operator):
    """Terminal operator of a producer pipeline
    (operator/exchange/LocalExchangeSinkOperator.java:31)."""

    def __init__(self, exchange: LocalExchange, producer_index: int,
                 names: Sequence[str]):
        self.exchange = exchange
        self.producer_index = producer_index
        self.names = list(names)

    def needs_input(self) -> bool:
        return (super().needs_input()
                and self.exchange.can_accept(self.producer_index))

    def add_input(self, batch: ColumnBatch) -> None:
        self.exchange.deposit(self.producer_index, batch.rename(self.names))

    def finish_input(self) -> None:
        super().finish_input()
        self.exchange.producer_finished()

    def is_finished(self) -> bool:
        return self.input_done


class LocalExchangeSourceOperator(Operator):
    """Source operator of a consumer pipeline
    (operator/exchange/LocalExchangeSourceOperator.java:27)."""

    def __init__(self, exchange: LocalExchange, consumer_index: int):
        self.exchange = exchange
        self.consumer_index = consumer_index
        self.input_done = True

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        if self._closed:
            return None
        return self.exchange.poll(self.consumer_index)

    def is_finished(self) -> bool:
        return self._closed or self.exchange.consumer_finished(
            self.consumer_index)
