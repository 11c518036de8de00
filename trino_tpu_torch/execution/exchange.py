"""In-memory exchange data plane: pull-token output buffers.

The port of the reference ``execution/exchange.py``.  Pages are the
producers' device ``ColumnBatch``es, or ``task.SerializedPage`` wire bytes
when the session sets ``exchange_serde``.  Implements the reference's
page-streaming protocol in-process (reference:
execution/buffer/ClientBuffer.java:318-376 — a read at token T implicitly
acknowledges and frees every page before T; execution/buffer/
PartitionedOutputBuffer.java:42 / BroadcastOutputBuffer.java:56).  The
network hop is a method call here; the protocol (token sequencing, ack-on-
advance, done marker) is kept so a real DCN/HTTP transport can slot in
without changing operators.

Backpressure: per-buffer byte budget; producers block in ``enqueue`` until
consumers drain (OutputBufferMemoryManager.java's blocking future).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..spi.batch import ColumnBatch

__all__ = ["OutputBuffer", "ExchangeClient"]


class OutputBuffer:
    """Per-task output: ``num_partitions`` independent page streams."""

    def __init__(self, num_partitions: int, max_bytes: int = 256 << 20):
        self.num_partitions = num_partitions
        self.max_bytes = max_bytes
        self._pages: list[list[Optional[ColumnBatch]]] = [
            [] for _ in range(num_partitions)]
        self._acked: list[int] = [0] * num_partitions
        self._finished = False
        self._aborted = False
        self._bytes = 0
        self._cv = threading.Condition()
        self.pages_enqueued = 0
        self.rows_enqueued = 0
        # cumulative (never decremented on ack) — the adaptive scheduler's
        # observed-output counter for activation barriers and join-
        # distribution decisions
        self.bytes_enqueued = 0

    def enqueue(self, partition: int, batch: ColumnBatch,
                block: bool = True) -> None:
        """``block=False`` skips the backpressure wait (time-sharing mode:
        the sink's driver parks via ``needs_input`` instead of pinning its
        executor worker here; at most one batch's partitions overshoot the
        byte budget between capacity checks)."""
        with self._cv:
            while (block and self._bytes > self.max_bytes
                   and not self._aborted):
                self._cv.wait(timeout=0.5)
            if self._aborted:
                return
            self._pages[partition].append(batch)
            self._bytes += batch.nbytes
            self.pages_enqueued += 1
            # wire relays enqueue SerializedPage, which carries no row count
            self.rows_enqueued += getattr(batch, "num_rows", 0)
            self.bytes_enqueued += batch.nbytes
            self._cv.notify_all()

    def has_capacity(self) -> bool:
        """True while the byte budget admits another page (the non-blocking
        sink's park predicate; only consumer acks can turn this back on)."""
        with self._cv:
            return self._aborted or self._bytes <= self.max_bytes

    def set_finished(self) -> None:
        with self._cv:
            self._finished = True
            self._cv.notify_all()

    @property
    def finished(self) -> bool:
        return self._finished

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._pages = [[] for _ in range(self.num_partitions)]
            self._bytes = 0
            self._cv.notify_all()

    @property
    def aborted(self) -> bool:
        return self._aborted

    @property
    def drained(self) -> bool:
        """True once the producer finished AND every page has been acked
        away — the point at which a draining worker may drop the task
        without losing unfetched output."""
        with self._cv:
            if self._aborted:
                return True
            return self._finished and not any(self._pages)

    def get(self, partition: int, token: int, timeout: float = 10.0
            ) -> tuple[list[ColumnBatch], int, bool]:
        """Read pages from sequence id ``token``; implicitly acks (frees)
        everything before it.  Returns (pages, next_token, done)."""
        with self._cv:
            # ack: free pages below token
            acked = self._acked[partition]
            if token > acked:
                stream = self._pages[partition]
                for i in range(acked, min(token, acked + len(stream))):
                    b = stream[i - acked]
                    if b is not None:
                        self._bytes -= b.nbytes
                        stream[i - acked] = None
                # drop freed prefix
                drop = token - acked
                self._pages[partition] = stream[drop:]
                self._acked[partition] = token
                self._cv.notify_all()
            acked = self._acked[partition]
            deadline = threading.TIMEOUT_MAX if timeout is None else timeout
            stream = self._pages[partition]
            if not stream and not self._finished and not self._aborted:
                self._cv.wait(timeout=deadline)
                stream = self._pages[partition]
            pages = [b for b in stream if b is not None]
            next_token = acked + len(stream)
            # an aborted buffer reports done so consumers unwind instead of
            # polling a dead producer forever
            done = (self._finished and not stream) or self._aborted
            return pages, next_token, done


class ExchangeClient:
    """Consumer side: pulls one partition from many upstream task buffers
    (operator/DirectExchangeClient.java:56)."""

    def __init__(self, buffers: list[OutputBuffer], partition: int):
        self._sources = [[b, 0, False] for b in buffers]
        self.partition = partition

    def poll(self, timeout: float = 0.05) -> Optional[ColumnBatch]:
        """One batch if available anywhere; None if drained-for-now.
        Consuming a page advances the token by one; the NEXT get() at that
        token acks (frees) it — exactly the reference's ack-on-advance."""
        from ..telemetry import profiler

        t0 = profiler.now() if profiler.enabled() else 0.0
        for s in self._sources:
            buf, token, done = s
            if done:
                continue
            pages, _next_token, fin = buf.get(self.partition, token,
                                              timeout=timeout)
            if pages:
                s[1] = token + 1
                if t0:
                    # serde-wired buffers hand back SerializedPage (no
                    # num_rows until deserialization downstream)
                    rows = getattr(pages[0], "num_rows", None)
                    profiler.event(profiler.EXCHANGE, "exchange.poll", t0,
                                   rows=rows)
                return pages[0]
            s[2] = fin
        # only dry polls that actually blocked are worth a timeline slice —
        # the 50ms poll loop would otherwise flood the ring with no-ops
        if t0 and profiler.now() - t0 > 0.010:
            profiler.event(profiler.EXCHANGE, "exchange.poll", t0, empty=True)
        return None

    def is_finished(self) -> bool:
        return all(done for _, _, done in self._sources)
