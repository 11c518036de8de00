"""Task memory context and revocation: the device pool's spill trigger.

The port of the reference ``exec/revoking.py``.  It wires
``spi/memory.py`` (MemoryPool / LocalMemoryContext, the
lib/trino-memory-context port) into the blocking operators: each reserves
the bytes of the batches it buffers as revocable memory; when a
reservation would exceed the pool, the context asks the largest holders to
revoke.  A holder moves its buffered batches to host memory (pinned on the
card) and drops its references, so the caching allocator frees them; they
come back with a non-blocking copy when the operator finishes.  This is the
first spill tier of the reference's
``execution/MemoryRevokingScheduler.java:47`` +
``operator/aggregation/builder/SpillableHashAggregationBuilder.java``
design: device -> host RAM.  The second, host -> disk, is exec/spill.py:
the context carries the session's ``spill_to_disk_bytes``, the buffered
bytes past which an operator writes its buffer to a spill file.

The reference counts a jax array as device bytes on every backend and a
host numpy array as none.  In the port every column is a tensor with a
device, so residency is explicit instead: an operator's ``_batches`` count
as device bytes wherever their tensors are (CPU tests then see the
reference's revocation sequence), and revoked batches move to its
``_revoked`` list, which :func:`batch_device_residual` does not count.  A
batch that aliases tensors held elsewhere (a staged memory table, or the
live-mask views a HASH local exchange hands each partition) frees less than
it counts; the accounting is the reference's all the same.
"""

from __future__ import annotations

import threading
import weakref
from typing import Protocol

import torch

from ..spi.memory import (AggregatedMemoryContext, ExceededMemoryLimitError,
                          MemoryPool)

__all__ = ["TaskMemoryContext", "tensor_nbytes", "batch_device_nbytes",
           "batch_device_residual", "to_host", "to_device",
           "restore_to_device"]


def tensor_nbytes(t) -> int:
    """Bytes a tensor holds (0 for None)."""
    if t is None:
        return 0
    return t.numel() * t.element_size()


def batch_device_nbytes(batch) -> int:
    """Bytes of a buffered batch's columns, masks and live mask (an RLE
    column's one value, a LAZY one's size hint; dictionaries stay on the
    host and do not count)."""
    return sum(c.nbytes - _dict_nbytes(c) for c in batch.columns) \
        + tensor_nbytes(batch.live)


def _dict_nbytes(c) -> int:
    from ..spi.batch import _dictionary_nbytes

    return _dictionary_nbytes(c.dictionary)


def to_host(batch):
    """The batch in host memory: on the card, pinned buffers filled by
    non-blocking copies, then one counted wait for them (a revocation is
    the slow path; the columns check their masks on the host), so the
    card's buffers can be freed at once and the copy back is non-blocking;
    on the CPU the batch itself."""
    if batch.device.type != "cuda":
        return batch
    from ..spi.batch import Column, ColumnBatch
    from . import syncguard as SG

    def pinned(t):
        if t is None:
            return None
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    parts = [None if c.encoding == "RLE" else (pinned(c.data),
                                               pinned(c.valid))
             for c in batch.columns]
    live = pinned(batch.live)
    SG.count_sync("memory.revoke")
    torch.cuda.current_stream().synchronize()
    cols = [c.to("cpu") if p is None else Column(c.type, p[0], p[1],
                                                 c.dictionary)
            for c, p in zip(batch.columns, parts)]
    return ColumnBatch(batch.names, cols, live)


def to_device(batch, device):
    """A revoked batch back on ``device``: non-blocking copies from its
    pinned buffers, ordered on the current stream."""
    if batch.device == device:
        return batch
    from ..spi.batch import Column, ColumnBatch

    def back(t):
        return None if t is None else t.to(device, non_blocking=True)

    cols = [c.to(device) if c.encoding == "RLE" else
            Column(c.type, back(c.data), back(c.valid), c.dictionary)
            for c in batch.columns]
    return ColumnBatch(batch.names, cols, back(batch.live))


def restore_to_device(batch, device):
    """A host batch read back from a spill file, on ``device``: on the card
    its pageable columns are first copied into pinned buffers (a host
    memcpy, no device sync), so the copies to the card are non-blocking
    like a revoked batch's."""
    if batch.device == device:
        return batch
    if device.type == "cuda":
        from ..spi.batch import Column, ColumnBatch

        def pin(t):
            return None if t is None else t.pin_memory()

        batch = ColumnBatch(batch.names, [
            c if c.encoding == "RLE" else
            Column(c.type, pin(c.data), pin(c.valid), c.dictionary)
            for c in batch.columns], pin(batch.live))
    return to_device(batch, device)


class Revocable(Protocol):
    def revoke_memory(self) -> int:
        """Move buffered device state to the host; return bytes freed."""


class TaskMemoryContext:
    """Per-task accounting root: one device pool shared by the task's
    operators.

    ``update(op, nbytes)`` adjusts op's revocable reservation; on overflow it
    revokes from the largest other holders first (MemoryRevokingScheduler's
    TASK_THRESHOLD ordering), then from ``op`` itself, and only then raises
    ExceededMemoryLimitError.  Operators of concurrent drivers share one
    context, so updates take its lock.  It holds its operators weakly: an
    operator refers to its context, and a cycle would keep the operators'
    device buffers (a join's build, an aggregation's result) alive past
    the query until the cyclic collector runs."""

    def __init__(self, hbm_limit_bytes: int, spill_to_disk_bytes: int = 0):
        self.pool = MemoryPool("hbm", hbm_limit_bytes)
        # an operator's buffered bytes past which it spills to disk
        # (0 = no disk tier; exec/spill.py)
        self.spill_to_disk_bytes = spill_to_disk_bytes
        self.root = AggregatedMemoryContext(pool=self.pool, revocable=True)
        self._locals: dict[int, object] = {}
        self._ops: dict[int, "weakref.ref[Revocable]"] = {}
        self._lock = threading.RLock()

    def register(self, op) -> None:
        key = id(op)
        with self._lock:
            if key not in self._locals:
                self._locals[key] = self.root.new_local(type(op).__name__)
                self._ops[key] = weakref.ref(op)

    def update(self, op, nbytes: int) -> None:
        """Set op's revocable reservation to ``nbytes``, revoking other
        holders (largest first) and finally op itself when the pool is
        full.  Revocable reservations never raise in MemoryPool.reserve (as
        in the reference), so capacity is checked here and spills run
        synchronously: the stand-in for MemoryRevokingScheduler's
        listener."""
        key = id(op)
        self.register(op)
        with self._lock:
            ctx = self._locals[key]
            delta = nbytes - ctx.reserved
            if delta > 0 and self.pool.free_bytes < delta:
                holders = sorted(
                    ((k, c) for k, c in self._locals.items()
                     if c.reserved > 0 and k != key),
                    key=lambda kv: kv[1].reserved, reverse=True)
                for k, c in holders:
                    holder = self._ops[k]()
                    freed = holder.revoke_memory() if holder else 0
                    if freed:
                        c.set_bytes(max(0, c.reserved - freed))
                    if self.pool.free_bytes >= delta:
                        break
                if self.pool.free_bytes < delta:
                    # last resort: the requester moves its own buffer
                    op.revoke_memory()
                    nbytes = batch_device_residual(op)
                    delta = nbytes - ctx.reserved
                    if delta > 0 and self.pool.free_bytes < delta:
                        raise ExceededMemoryLimitError(
                            self.pool.name, delta, self.pool.max_bytes)
            ctx.set_bytes(nbytes)

    def reserved_bytes(self) -> int:
        return self.pool.reserved + self.pool.reserved_revocable


def batch_device_residual(op) -> int:
    """Bytes of an operator's buffered batches still counted on the
    device (its ``_batches``; revoked ones are on the host)."""
    batches = getattr(op, "_batches", None)
    if not batches:
        return 0
    return sum(batch_device_nbytes(b) for b in batches)
