"""Connector SPI — the vertical plug-in boundary.

Mirrors the minimal contract called out in SURVEY §2.3 from
``core/trino-spi/src/main/java/io/trino/spi/connector``:

- :class:`ConnectorMetadata`  (tables, columns, stats)        — ConnectorMetadata.java
- :class:`ConnectorSplitManager` → :class:`Split` batches     — ConnectorSplitManager.java,
  ConnectorSplitSource.java:31 (async ``getNextBatch`` becomes a generator)
- :class:`ConnectorPageSource` (reads)                        — ConnectorPageSource.java:24-59
- :class:`ConnectorPageSink` (writes)                         — ConnectorPageSink.java:62-79
- optional bucketing via ``bucket_count``/``bucket_of``       — ConnectorNodePartitioningProvider.java

TPU-first addition: ``ConnectorMetadata.column_dictionary`` exposes the
table-global sorted dictionary for a string column so scans across splits
share one code space (see spi/batch.py docstring).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from .batch import ColumnBatch
from .types import Type

__all__ = [
    "ColumnSchema",
    "TableSchema",
    "TableStatistics",
    "Split",
    "ConnectorPageSource",
    "ConnectorPageSink",
    "Connector",
]


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    type: Type


@dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[ColumnSchema, ...]

    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def column_type(self, name: str) -> Type:
        for c in self.columns:
            if c.name == name:
                return c.type
        raise KeyError(name)


@dataclass(frozen=True)
class TableStatistics:
    """Coarse stats for the cost model (mirrors spi/statistics/TableStatistics)."""

    row_count: float = float("nan")
    # per-column distinct-value estimates
    ndv: dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class Split:
    """A schedulable unit of table data (mirrors spi/connector/ConnectorSplit).

    ``info`` is connector-private (e.g. part index for the tpch generator).
    ``addresses`` optionally pins the split to hosts (locality)."""

    catalog: str
    table: str
    info: Any
    weight: float = 1.0
    addresses: tuple[str, ...] = ()


class ConnectorPageSource:
    """Pull-based reader for one split (mirrors ConnectorPageSource.java)."""

    def get_next_batch(self) -> Optional[ColumnBatch]:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConnectorPageSink:
    """Writer for one task (mirrors ConnectorPageSink.java).

    ``append`` may signal backpressure by returning False (caller yields);
    ``finish`` returns commit fragments handed to the coordinator commit."""

    def append(self, batch: ColumnBatch) -> bool:
        raise NotImplementedError

    def finish(self) -> list[Any]:
        return []

    def abort(self) -> None:
        pass


class Connector:
    """One catalog's implementation.  Subset of spi/Plugin + Connector*."""

    name: str = "connector"

    # --- metadata ---------------------------------------------------------
    def list_tables(self) -> list[str]:
        raise NotImplementedError

    def get_table_schema(self, table: str) -> TableSchema:
        raise NotImplementedError

    def get_table_statistics(self, table: str) -> TableStatistics:
        stats = getattr(self, "_analyzed_stats", {}).get(table)
        return stats if stats is not None else TableStatistics()

    def set_analyzed_statistics(self, table: str,
                                stats: TableStatistics) -> None:
        """ANALYZE writes collected stats here; connectors whose
        get_table_statistics overrides should consult them first
        (reference: the engine-computed stats StatisticsWriterOperator
        hands back to ConnectorMetadata.finishStatisticsCollection)."""
        if not hasattr(self, "_analyzed_stats"):
            self._analyzed_stats = {}
        self._analyzed_stats[table] = stats

    def get_procedures(self) -> dict:
        """name -> callable(**kwargs) (reference:
        spi/procedure/Procedure.java; invoked by CALL)."""
        return {}

    def data_version(self, table: str) -> Optional[Any]:
        """Opaque token that changes whenever the table's data changes
        (the caching plane's invalidation currency: result-cache keys and
        MV staleness both compare these).  None means *unversioned* —
        reads of this table are never result-cached (the right answer for
        volatile sources like the system connector).  Immutable sources
        return a constant (tpch: the scale factor)."""
        return None


    def column_dictionary(self, table: str, column: str) -> Optional[np.ndarray]:
        """Table-global sorted dictionary for a string column, if known."""
        return None

    # --- reads ------------------------------------------------------------
    def get_splits(self, table: str, splits_per_node: int, node_count: int) -> list[Split]:
        raise NotImplementedError

    def is_resident(self, table: str) -> bool:
        """Every batch of ``table`` is held in memory on its device (a
        pinned table): scans hand them on as they are, with no prefetch
        threads, masks or copies."""
        return False

    def create_page_source(self, split: Split, columns: Sequence[str],
                           constraint=None) -> ConnectorPageSource:
        """``constraint`` is an advisory spi/predicate.TupleDomain the
        connector MAY use to skip data (batches/splits); it need not enforce
        it (mirrors ConnectorPageSourceProvider.createPageSource receiving a
        dynamicFilter/TupleDomain it can use for pruning)."""
        raise NotImplementedError

    # --- transactions -----------------------------------------------------
    def begin_transaction(self):
        """Open a connector-private transaction handle (mirrors
        Connector.beginTransaction -> ConnectorTransactionHandle).  Default:
        autocommit-only connectors return None."""
        return None

    def commit_transaction(self, handle) -> None:
        pass

    def rollback_transaction(self, handle) -> None:
        pass

    # --- writes -----------------------------------------------------------
    def create_table(self, schema: TableSchema) -> None:
        raise NotImplementedError("connector does not support CREATE TABLE")

    def create_page_sink(self, table: str) -> ConnectorPageSink:
        raise NotImplementedError("connector does not support writes")

    def finish_insert(self, table: str, fragments: list[Any]) -> None:
        pass

    def drop_table(self, table: str) -> None:
        raise NotImplementedError
