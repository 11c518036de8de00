"""Hierarchical memory accounting (mirrors ``lib/trino-memory-context``).

The port of the reference ``spi/memory.py``, unchanged in behaviour and
messages.

Reference: AggregatedMemoryContext.java / LocalMemoryContext and
core/trino-main ``memory/MemoryPool.java:44`` (``reserve:130`` /
``reserveRevocable:163``).  The engine accounts the device's memory in
one pool per task; revocation moves buffered batches to host RAM.

Semantics kept from the reference:
- a Local context's ``set_bytes`` deltas roll up through parent Aggregated
  contexts into the pool;
- *revocable* memory is tracked separately and can be reclaimed by asking the
  owning operator to spill (see exec/revoking.py);
- exceeding the pool limit raises :class:`ExceededMemoryLimitError`
  (the per-node OOM).
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "ExceededMemoryLimitError",
    "MemoryPool",
    "AggregatedMemoryContext",
    "LocalMemoryContext",
]


class ExceededMemoryLimitError(RuntimeError):
    def __init__(self, pool: str, requested: int, limit: int):
        super().__init__(
            f"Query exceeded per-node memory limit of {limit} bytes in pool "
            f"{pool} (requested {requested} additional bytes)"
        )
        self.pool = pool


class MemoryPool:
    """Per-worker byte pool (one for HBM, one for host RAM)."""

    def __init__(self, name: str, max_bytes: int):
        self.name = name
        self.max_bytes = max_bytes
        self.reserved = 0
        self.reserved_revocable = 0

    def reserve(self, delta: int, revocable: bool = False) -> None:
        if delta > 0 and self.reserved + self.reserved_revocable + delta > self.max_bytes:
            if not revocable:
                raise ExceededMemoryLimitError(self.name, delta, self.max_bytes)
        if revocable:
            self.reserved_revocable += delta
        else:
            self.reserved += delta

    def free(self, delta: int, revocable: bool = False) -> None:
        self.reserve(-delta, revocable)

    @property
    def free_bytes(self) -> int:
        return self.max_bytes - self.reserved - self.reserved_revocable


class AggregatedMemoryContext:
    """Sums children; roots into a MemoryPool."""

    def __init__(self, pool: Optional[MemoryPool] = None,
                 parent: Optional["AggregatedMemoryContext"] = None,
                 revocable: bool = False):
        self._pool = pool
        self._parent = parent
        self._revocable = revocable
        self._closed = False
        self.reserved = 0

    def new_child(self) -> "AggregatedMemoryContext":
        return AggregatedMemoryContext(parent=self, revocable=self._revocable)

    def new_local(self, tag: str = "") -> "LocalMemoryContext":
        return LocalMemoryContext(self, tag)

    def _update(self, delta: int) -> None:
        if delta == 0:
            return
        if self._closed:
            raise RuntimeError("memory context used after close")
        # reserve in the pool first so failures don't corrupt accounting
        if self._parent is not None:
            self._parent._update(delta)
        elif self._pool is not None:
            self._pool.reserve(delta, self._revocable)
        self.reserved += delta

    def close(self) -> None:
        """Free this subtree's reservation.  Children must already be closed
        (or simply abandoned); further use of this context or any child
        raises, preventing double-frees from driving the pool negative."""
        if self._closed:
            return
        self._update(-self.reserved)
        self._closed = True


class LocalMemoryContext:
    def __init__(self, parent: AggregatedMemoryContext, tag: str = ""):
        self._parent = parent
        self.tag = tag
        self.reserved = 0

    def set_bytes(self, new_bytes: int) -> None:
        delta = new_bytes - self.reserved
        self._parent._update(delta)
        self.reserved = new_bytes

    def close(self) -> None:
        if self.reserved:
            self.set_bytes(0)
