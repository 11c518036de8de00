"""In-memory table connector + /dev/null connector.

The port of the reference ``connectors/memory.py`` (``plugin/trino-memory``
— MemoryConnector, the write target — and ``plugin/trino-blackhole``).
Tables live as lists of ColumnBatches; splits partition the batch list.
:meth:`MemoryConnector.pin_to_device` moves a table into device memory once,
so later scans hand its tensors to the operators with no copy: the warmed
tables a benchmark reads (TPC-H staged by ``connectors/staging.py``).

Transactions roll INSERT / CTAS / CREATE TABLE back to a snapshot of the
batch lists, and ``CALL memory.truncate_table`` / ``memory.pin_table`` are
its procedures.  Not ported: result-cache invalidation (the port has no
result cache).
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..caching import result_cache
from ..spi.batch import ColumnBatch
from ..spi.connector import (
    Connector,
    ConnectorPageSink,
    ConnectorPageSource,
    Split,
    TableSchema,
    TableStatistics,
)

__all__ = ["MemoryConnector", "BlackholeConnector"]


class _ListPageSource(ConnectorPageSource):
    def __init__(self, batches: list[ColumnBatch], columns: Sequence[str]):
        self._batches = batches
        self._columns = list(columns)
        self._i = 0

    def get_next_batch(self) -> Optional[ColumnBatch]:
        if self._i >= len(self._batches):
            return None
        b = self._batches[self._i]
        self._i += 1
        return ColumnBatch(self._columns,
                           [b.column(c) for c in self._columns], b.live)

    def is_finished(self) -> bool:
        return self._i >= len(self._batches)


def _batch_overlaps(b: ColumnBatch, constraint) -> bool:
    """Min/max zone-map check of a host batch: can any row satisfy the
    TupleDomain?  Stats are computed once per batch and memoized on the
    batch object (the reference keeps per-page min/max in connector
    metadata, e.g. ORC stripe stats).  Callers pass host batches only."""
    stats = getattr(b, "_domain_stats", None)
    if stats is None:
        stats = {}
        b._domain_stats = stats
    missing = [n for n in constraint.domains
               if n not in stats and n in b.names]
    for name in missing:
        c = b.column(name)
        data = c.data.numpy()
        valid = None if c.valid is None else c.valid.numpy()
        has_null = bool((~valid).any()) if valid is not None else False
        present = data if valid is None else data[valid]
        if not present.size:
            stats[name] = (None, None, has_null)
        elif c.dictionary is not None:
            vals = c.dictionary[np.unique(present)]
            if isinstance(vals[0], tuple):
                continue  # arrays / rows / maps: no zone-map bounds
            # long-decimal dictionaries hold python ints: bounds stay in
            # storage space, not strings
            stats[name] = ((int(vals[0]), int(vals[-1]), has_null)
                           if isinstance(vals[0], int)
                           else (str(vals[0]), str(vals[-1]), has_null))
        else:
            mn, mx = present.min(), present.max()
            if isinstance(mn, np.floating) and (np.isnan(mn) or np.isnan(mx)):
                continue  # NaNs poison comparisons: no stats
            stats[name] = (mn.item(), mx.item(), has_null)
    mins = {k: v[0] for k, v in stats.items()}
    maxs = {k: v[1] for k, v in stats.items()}
    nulls = {k: v[2] for k, v in stats.items()}
    return constraint.overlaps_stats(mins, maxs, nulls)


class _MemoryPageSink(ConnectorPageSink):
    def __init__(self):
        self._staged: list[ColumnBatch] = []

    def append(self, batch: ColumnBatch) -> bool:
        self._staged.append(batch)
        return True

    def finish(self) -> list[Any]:
        return [self._staged]


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self):
        self._lock = threading.Lock()
        self._schemas: dict[str, TableSchema] = {}
        self._data: dict[str, list[ColumnBatch]] = {}
        # pinned tables: how many leading batches pin_to_device produced
        # (batches inserted later are host batches again)
        self._pinned_batches: dict[str, int] = {}
        # observability: batches skipped by TupleDomain min/max pruning
        self.batches_pruned = 0
        # data_version tokens come from one instance-wide monotonic counter,
        # so a drop/recreate cycle never reissues an old token
        self._versions: dict[str, int] = {}
        self._next_version = 0

    def _bump_version(self, table: str) -> None:
        # callers hold self._lock; the result cache drops what read the
        # table now, freeing its bytes (the new token alone already keeps
        # them from being served)
        self._next_version += 1
        self._versions[table] = self._next_version
        result_cache.invalidate_table(self.name, table)

    def data_version(self, table: str):
        with self._lock:
            if table not in self._schemas:
                raise KeyError(f"memory: no such table {table!r}")
            return self._versions.get(table, 0)

    def list_tables(self) -> list[str]:
        with self._lock:
            return sorted(self._schemas)

    def get_table_schema(self, table: str) -> TableSchema:
        with self._lock:
            if table not in self._schemas:
                raise KeyError(f"memory: no such table {table!r}")
            return self._schemas[table]

    def get_table_statistics(self, table: str) -> TableStatistics:
        analyzed = getattr(self, "_analyzed_stats", {}).get(table)
        if analyzed is not None:
            return analyzed
        with self._lock:  # shapes only: no device sync
            rows = sum(b.num_rows for b in self._data.get(table, []))
        return TableStatistics(row_count=float(rows))

    def create_table(self, schema: TableSchema) -> None:
        with self._lock:
            if schema.name in self._schemas:
                raise ValueError(
                    f"memory: table {schema.name!r} already exists")
            self._schemas[schema.name] = schema
            self._data[schema.name] = []
            self._bump_version(schema.name)

    def drop_table(self, table: str) -> None:
        with self._lock:
            self._forget(table)
            result_cache.invalidate_table(self.name, table)

    def _forget(self, table: str) -> None:
        # callers hold self._lock
        self._schemas.pop(table, None)
        self._data.pop(table, None)
        self._pinned_batches.pop(table, None)
        self._versions.pop(table, None)
        getattr(self, "_analyzed_stats", {}).pop(table, None)

    def row_count(self, table: str) -> int:
        """Rows held, from shapes (no device sync): stored batches are
        compact (the sink's writer and ``pin_to_device`` compact them)."""
        with self._lock:
            if table not in self._schemas:
                raise KeyError(f"memory: no such table {table!r}")
            return sum(b.num_rows for b in self._data[table])

    def get_procedures(self) -> dict:
        """CALL memory.truncate_table('t') / memory.pin_table('t')
        (reference: spi/procedure/Procedure.java — connector-registered
        procedures dispatched by CallTask).  ``pin_table`` takes the
        engine's device as the keyword ``device``, which the runner's CALL
        passes (as Trino injects the session into a procedure)."""

        def truncate_table(table: str) -> str:
            with self._lock:
                if table not in self._schemas:
                    raise KeyError(f"memory: no such table {table!r}")
                self._data[table] = []
                self._pinned_batches.pop(table, None)
                self._bump_version(table)
            return f"truncated {table}"

        def pin_table(table: str, *, device) -> str:
            self.get_table_schema(table)  # existence check
            self.pin_to_device(table, device)
            return f"pinned {table}"

        return {"truncate_table": truncate_table, "pin_table": pin_table}

    def get_splits(self, table: str, splits_per_node: int,
                   node_count: int) -> list[Split]:
        with self._lock:
            n = len(self._data.get(table, []))
        want = max(1, splits_per_node * node_count)
        n_splits = min(want, max(n, 1))
        bounds = np.linspace(0, n, n_splits + 1, dtype=np.int64)
        return [
            Split("memory", table, (int(bounds[i]), int(bounds[i + 1])))
            for i in range(n_splits)
            if bounds[i + 1] > bounds[i] or n == 0 and i == 0
        ]

    def is_resident(self, table: str) -> bool:
        with self._lock:
            n = len(self._data.get(table, []))
            return n > 0 and self._pinned_batches.get(table, 0) == n

    def create_page_source(self, split: Split, columns: Sequence[str],
                           constraint=None) -> ConnectorPageSource:
        lo, hi = split.info
        with self._lock:
            batches = self._data[split.table][lo:hi]
            pinned = self._pinned_batches.get(split.table, 0)
        if constraint is not None and not constraint.is_all:
            # a pinned batch, or one whose tensors are in device memory,
            # passes unchecked: reading its stats would pull it to the host
            kept = [b for i, b in enumerate(batches, lo)
                    if i < pinned or b.device.type != "cpu"
                    or _batch_overlaps(b, constraint)]
            self.batches_pruned += len(batches) - len(kept)
            batches = kept
        return _ListPageSource(batches, columns)

    def create_page_sink(self, table: str) -> ConnectorPageSink:
        self.get_table_schema(table)  # existence check
        return _MemoryPageSink()

    def finish_insert(self, table: str, fragments: list[Any]) -> None:
        with self._lock:
            for staged in fragments:
                self._data[table].extend(staged)
            self._bump_version(table)

    # ---- transactions ----------------------------------------------------
    def begin_transaction(self):
        """Snapshot handle: per-table batch-list lengths + the table set.
        Rollback undoes INSERT/CTAS/CREATE TABLE performed since BEGIN by
        truncating back to the snapshot (DELETE's drop-and-rewrite is not
        transactional — as in the reference memory connector, which only
        supports INSERT/CREATE in a transaction)."""
        with self._lock:
            return {
                "tables": set(self._schemas),
                "lengths": {t: len(b) for t, b in self._data.items()},
            }

    def commit_transaction(self, handle) -> None:
        pass  # writes applied eagerly; commit just drops the snapshot

    def rollback_transaction(self, handle) -> None:
        if handle is None:
            return
        with self._lock:
            for t in list(self._schemas):
                if t not in handle["tables"]:
                    self._forget(t)
            for t, n in handle["lengths"].items():
                if t in self._data and len(self._data[t]) > n:
                    del self._data[t][n:]
                    # the pinned batches lead the list: a table resident at
                    # BEGIN is resident again, over batches that still exist
                    if t in self._pinned_batches:
                        self._pinned_batches[t] = min(
                            self._pinned_batches[t], n)
                    self._bump_version(t)

    def pin_to_device(self, table: str, device) -> None:
        """Make a table device-resident: each batch is compacted and moved
        to ``device`` once; a batch already there (born on the device
        by the TPC-H device generator) is kept as it is.  Scans then hand
        the tensors to the operators with no copy per query (the reference
        keeps hot pages in worker heap, MemoryPagesStore; here the heap is
        device memory).  ``device="cuda"`` raises when CUDA is not
        available."""
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "pin_to_device(device='cuda'): CUDA is not available; pass "
                "device='cpu' to pin on the CPU")
        with self._lock:
            pinned = []
            for b in self._data.get(table, []):
                if b.device.type != dev.type or (
                        dev.index is not None and b.device != dev):
                    b = b.compact().to(dev)
                pinned.append(b)
            self._data[table] = pinned
            self._pinned_batches[table] = len(pinned)


class _NullSink(ConnectorPageSink):
    def __init__(self):
        self.rows = 0

    def append(self, batch: ColumnBatch) -> bool:
        self.rows += batch.num_rows
        return True

    def finish(self) -> list[Any]:
        return [self.rows]


class BlackholeConnector(Connector):
    """Accepts writes and drops them; its tables read as empty."""

    name = "blackhole"

    def __init__(self):
        self._schemas: dict[str, TableSchema] = {}

    def list_tables(self) -> list[str]:
        return sorted(self._schemas)

    def get_table_schema(self, table: str) -> TableSchema:
        if table not in self._schemas:
            raise KeyError(f"blackhole: no such table {table!r}")
        return self._schemas[table]

    def create_table(self, schema: TableSchema) -> None:
        self._schemas[schema.name] = schema

    def drop_table(self, table: str) -> None:
        self._schemas.pop(table, None)

    def get_splits(self, table, splits_per_node, node_count):
        return []

    def create_page_sink(self, table: str) -> ConnectorPageSink:
        self.get_table_schema(table)
        return _NullSink()
