"""Device-resident REPARTITION edges: the engine's collective data plane.

The port of the reference ``execution/collective_exchange.py``.  When a
REPARTITION edge connects two stages with equal task counts (the
PARTIAL->FINAL aggregation split being the canonical case), the host
exchange (PartitionedOutputSink pages + pull-token buffers) is replaced by
one shuffle over a mesh (``parallel/distributed.py``): every producer task
deposits its device batch, the last depositor runs the shuffle — hash
routing on the device and an all_to_all of every column — and each
consumer task takes its shard.  Row data never leaves the devices; the
only host reads are the tiled layout's one count matrix
(``exchange.tile-counts``).

Two layouts, as in the reference:

- the lane layout (deposits of at most ``TILED_THRESHOLD_ROWS`` rows,
  padded to a power of two ``cap``): every source sends its whole
  ``cap``-row block to every destination under a per-destination live
  mask, so a consumer receives ``n * cap`` lanes per column — right for
  slot-capped partial-aggregation states;
- the tiled sorted-bucket layout (larger deposits): each source sorts its
  rows by destination, one read of the [n, n] count matrix picks the tile
  (a power of two over the largest count), and destination d receives
  tile d of every source: about one copy of the data instead of n.

Dictionary columns are unified across the deposits on the host and cross
as codes; their route keys are the crc32 hashes of their values, exactly
as on the host edge (``local_exchange.partition_key_tuple``), so mixed
collective and host edges of one join agree on who owns a row.  An RLE
deposit expands on the device from its one value.

The mesh has one shard per task.  The distributed runner puts every
shard on the runner's device, where all its tasks run, so the shuffle is
a copy within that device's memory; the reference needs one device per
task.  Hence :func:`collectives_available` asks only for more than one
task.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..exec import kernels as K
from ..exec import local_exchange as LX
from ..exec import syncguard as SG
from ..exec.operators import Operator
from ..parallel.distributed import Mesh, all_to_all
from ..spi.batch import Column, ColumnBatch, torch_dtype, unify_dictionaries
from ..spi.errors import (DEVICE_FAULT, GENERIC_INTERNAL_ERROR,
                          PAGE_TRANSPORT_TIMEOUT, TrinoError, is_device_fault)
from ..telemetry import metrics as tm
from ..telemetry import profiler
from . import task as T

__all__ = ["CollectiveRepartitionExchange", "CollectiveOutputSink",
           "CollectiveSourceOperator", "collectives_available",
           "TILED_THRESHOLD_ROWS"]

# deposits at or below this row bucket use the lane layout (no host read);
# larger deposits take the tiled sorted-bucket layout.  Tests force the
# tiled path by setting this to 0.
TILED_THRESHOLD_ROWS = 8192


def collectives_available(n_tasks: int) -> bool:
    """An edge of ``n_tasks`` producers and consumers can run as a
    collective: any task count above one (shards may share a device)."""
    return n_tasks > 1


def _pad(x: torch.Tensor, cap: int, fill=0) -> torch.Tensor:
    if x.shape[0] < cap:
        x = torch.cat([x, torch.full((cap - x.shape[0],), fill,
                                     dtype=x.dtype, device=x.device)])
    return x


class CollectiveRepartitionExchange:
    """Rendezvous for one REPARTITION edge: ``n_tasks`` producers deposit,
    consumers take their shard (on ``mesh[task]``) after the shuffle
    runs."""

    def __init__(self, n_tasks: int, key_channels: Sequence[int],
                 names: Sequence[str], types: Sequence, mesh: Mesh):
        if len(mesh) != n_tasks:
            raise ValueError(f"mesh of {len(mesh)} shards for {n_tasks} "
                             f"tasks")
        self.n = n_tasks
        self.mesh = mesh
        self.key_channels = tuple(key_channels)
        self.names = list(names)
        self.types = list(types)
        self._deposits: list[Optional[ColumnBatch]] = [None] * n_tasks
        self._count = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._results: list[Optional[ColumnBatch]] = [None] * n_tasks
        self._error: Optional[BaseException] = None
        self.tiled = False  # the layout the shuffle took

    # ---------------------------------------------------------- producers
    def deposit(self, task_index: int, batches: list[ColumnBatch]) -> None:
        dev = self.mesh[task_index]
        if batches:
            batch = ColumnBatch.concat(batches, keep_live=True).to(dev)
        else:
            batch = ColumnBatch(self.names, [
                Column(t, torch.empty(0, dtype=torch_dtype(
                    np.int32 if t.is_dictionary_encoded
                    else t.storage_dtype), device=dev))
                for t in self.types])
        with self._lock:
            self._deposits[task_index] = batch
            self._count += 1
            run_it = self._count == self.n
        if run_it:
            try:
                self._run_collective()
            except BaseException as e:  # surfaced to every waiting consumer
                self._error = e
            self._done.set()

    def abort(self) -> None:
        self._error = RuntimeError("collective exchange aborted")
        self._done.set()

    # ----------------------------------------------------------- the shuffle
    def _run_collective(self) -> None:
        deposits = list(self._deposits)
        n, mesh = self.n, self.mesh
        cap = K.bucket(max(max(b.num_rows for b in deposits), 1))

        # unify dictionary columns across deposits (host work over the
        # dictionaries only; codes are remapped with a device gather)
        unified: list = []
        for ci, t in enumerate(self.types):
            if t.is_dictionary_encoded:
                cols = unify_dictionaries([b.columns[ci] for b in deposits])
                for b, c in zip(deposits, cols):
                    b.columns[ci] = c
                unified.append(cols[0].dictionary)
            else:
                unified.append(None)
        valid_flags = [any(b.columns[ci].valid is not None for b in deposits)
                       for ci in range(len(self.types))]
        self.tiled = cap > TILED_THRESHOLD_ROWS

        # per source: padded columns, valids, live lanes and destinations
        datas, valids, lives, dests = [], [], [], []
        for i, b in enumerate(deposits):
            dev = mesh[i]
            cols = []
            for c in b.columns:
                if c.encoding == "RLE":
                    # expands on the device from its one value; lanes past
                    # the deposit are dead anyway
                    cols.append(K.rle_fill(c.rle_value, cap, dev))
                else:
                    cols.append(_pad(c.data, cap))
            datas.append(cols)
            valids.append([_pad(b.columns[ci].valid_mask(), cap, False)
                           if valid_flags[ci] else None
                           for ci in range(len(self.types))])
            live = (b.live if b.live is not None else
                    torch.ones(b.num_rows, dtype=torch.bool, device=dev))
            lives.append(_pad(live, cap, False))
            keys = []
            for ki in self.key_channels:
                c = b.columns[ki]
                route, _ = LX.partition_key_tuple(
                    Column(c.type, cols[ki], None, unified[ki]))
                keys.append((route, valids[i][ki]))
            # NULL keys -> consumer 0, as partition_assignments places them
            dests.append(K.partition_assignments(keys, n))

        if self.tiled:
            out_cols, out_valids, out_live = self._tiled(
                datas, valids, lives, dests, cap)
        else:
            out_cols, out_valids, out_live = self._lanes(
                datas, valids, lives, dests)
        if any(d is not None for d in unified):
            # dictionary codes crossed the shuffle as resident int32 lanes:
            # each consumer shard is one code page that never decoded
            tm.ENCODING_EXCHANGE_CODE_PAGES.inc(n)
        for d in range(n):
            self._results[d] = ColumnBatch(list(self.names), [
                Column(t, out_cols[ci][d],
                       None if out_valids[ci] is None
                       else out_valids[ci][d], unified[ci])
                for ci, t in enumerate(self.types)], out_live[d])

    def _lanes(self, datas, valids, lives, dests):
        """Lane layout: destination d receives every source's whole block,
        live where the row routes to d."""
        n, mesh = self.n, self.mesh

        def bcast(xs):
            return all_to_all([[x] * n for x in xs], mesh)

        out_cols = [bcast([datas[s][ci] for s in range(n)])
                    for ci in range(len(self.types))]
        out_valids = [None if valids[0][ci] is None else
                      bcast([valids[s][ci] for s in range(n)])
                      for ci in range(len(self.types))]
        out_live = all_to_all(
            [[lives[s] & (dests[s] == d) for d in range(n)]
             for s in range(n)], mesh)
        return out_cols, out_valids, out_live

    def _tiled(self, datas, valids, lives, dests, cap: int):
        """Tiled sorted-bucket layout: stage 1 sorts each source's rows by
        destination (dead rows last) and counts them per destination; one
        read of the [n, n] counts picks the tile; stage 2 packs each
        destination's run into a [tile] lane block and all_to_alls it."""
        n, mesh = self.n, self.mesh
        orders, counts = [], []
        for s in range(n):
            dest = torch.where(lives[s], dests[s], n)
            orders.append(torch.argsort(dest, stable=True))
            counts.append(torch.bincount(dest, minlength=n + 1)[:n])
        host = SG.fetch(torch.stack([c.to(mesh[0]) for c in counts]),
                        "exchange.tile-counts")
        tile = K.bucket(max(int(host.max()), 1))
        rows, lane_live = [], []
        for s in range(n):
            c = counts[s]
            starts = torch.cumsum(c, 0) - c
            idx = torch.arange(tile, device=c.device)
            r = torch.clamp(starts[:, None] + idx[None, :], 0, cap - 1)
            rows.append(orders[s][r])
            lane_live.append(idx[None, :] < c[:, None])

        def shuffle(xs):
            blocks = []
            for s in range(n):
                lanes = xs[s][rows[s]]
                lanes = (lanes & lane_live[s] if lanes.dtype == torch.bool
                         else torch.where(lane_live[s], lanes,
                                          torch.zeros((), dtype=lanes.dtype,
                                                      device=lanes.device)))
                blocks.append([lanes[d] for d in range(n)])
            return all_to_all(blocks, mesh)

        out_cols = [shuffle([datas[s][ci] for s in range(n)])
                    for ci in range(len(self.types))]
        out_valids = [None if valids[0][ci] is None else
                      shuffle([valids[s][ci] for s in range(n)])
                      for ci in range(len(self.types))]
        out_live = all_to_all([[lane_live[s][d] for d in range(n)]
                               for s in range(n)], mesh)
        return out_cols, out_valids, out_live

    # ----------------------------------------------------------- consumers
    def take(self, task_index: int,
             timeout: Optional[float] = None) -> ColumnBatch:
        """Blocking take: the default timeout is ``task.STALL_TIMEOUT_S``
        (TRINO_TPU_EXCHANGE_STALL_S), and a stall raises a *retryable*
        PAGE_TRANSPORT_TIMEOUT, the contract of the host exchange.  A failed
        shuffle fails the query with its classification; nothing re-runs
        it over the host exchange."""
        if timeout is None:
            timeout = T.STALL_TIMEOUT_S
        t0 = profiler.now() if profiler.enabled() else 0.0
        ok = self._done.wait(timeout)
        if t0:
            profiler.event(profiler.EXCHANGE, "collective.take", t0,
                           stalled=not ok)
        if not ok:
            raise TrinoError(
                PAGE_TRANSPORT_TIMEOUT,
                f"collective exchange stalled after {timeout:.0f}s")
        if self._error is not None:
            if isinstance(self._error, TrinoError):
                raise self._error      # keep the original classification
            # a fault of the card keeps its code: it must not be retried
            code = (DEVICE_FAULT if is_device_fault(self._error)
                    else GENERIC_INTERNAL_ERROR)
            raise TrinoError(code, f"collective exchange failed: {self._error}") \
                from self._error
        return self._results[task_index]


class CollectiveOutputSink(Operator):
    """Producer-side terminal: buffers device batches, deposits at finish."""

    def __init__(self, exchange: CollectiveRepartitionExchange,
                 task_index: int):
        self.exchange = exchange
        self.task_index = task_index
        self._batches: list[ColumnBatch] = []

    def add_input(self, batch: ColumnBatch) -> None:
        if batch.num_rows:
            self._batches.append(batch)

    def finish_input(self) -> None:
        super().finish_input()
        self.exchange.deposit(self.task_index, self._batches)

    def is_finished(self) -> bool:
        return self.input_done


class CollectiveSourceOperator(Operator):
    """Consumer-side source: emits this task's shard once."""

    blocking = True  # see task.RemoteExchangeSourceOperator

    def __init__(self, exchange: CollectiveRepartitionExchange,
                 task_index: int):
        self.exchange = exchange
        self.task_index = task_index
        self.input_done = True
        self._emitted = False

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[ColumnBatch]:
        if self._emitted or self._closed:
            return None
        if not self.blocking and not self.exchange._done.is_set():
            return None  # park; the executor reschedules us
        self._emitted = True
        batch = self.exchange.take(self.task_index)
        return batch if batch.num_rows else None

    def is_finished(self) -> bool:
        return self._emitted or self._closed
