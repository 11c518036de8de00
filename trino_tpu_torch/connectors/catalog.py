"""Catalog registry: name -> Connector instance.

Mirrors core/trino-main's catalog management (connector/StaticCatalogManager.
java + metadata resolution in metadata/MetadataManager) in miniature: a
session references one default catalog; qualified names pick others.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

from ..caching.result_cache import version_vector
from ..spi.connector import Connector, TableSchema

__all__ = ["Catalog", "default_catalog"]


class ViewDefinition:
    """A stored view: the defining query AST, plus (for materialized views)
    the backing table holding the last refresh (reference:
    spi/connector/ConnectorViewDefinition + MaterializedViewDefinition).

    ``base_versions`` is the connector data_version vector of the base
    tables captured at refresh time — the same tokens the result cache
    keys on — so staleness is a pure token comparison
    (:meth:`Catalog.mv_is_stale`), no data inspection."""

    __slots__ = ("query", "materialized", "backing", "base_versions")

    def __init__(self, query, materialized: bool = False, backing=None,
                 base_versions=None):
        self.query = query
        self.materialized = materialized
        self.backing = backing  # (catalog, table) of the refresh target
        self.base_versions = base_versions


_instance_ids = itertools.count(1)
_instance_lock = threading.Lock()


class Catalog:
    def __init__(self):
        self._connectors: dict[str, Connector] = {}
        # caching-plane identity: instance_id partitions the process-global
        # plan/result caches between catalogs (tests build many runners per
        # process); generation bumps on DDL/ANALYZE so schema or stats
        # changes invalidate every cached plan against this catalog
        with _instance_lock:
            self.instance_id = next(_instance_ids)
        self.generation = 0
        # CREATE FUNCTION registry: name -> (params, return_type, body AST)
        # (reference: metadata/GlobalFunctionCatalog for SQL routines)
        self.sql_functions: dict[str, tuple] = {}
        # polymorphic table functions: name -> spi.table_function.TableFunction
        from ..spi.table_function import builtin_table_functions

        self.table_functions: dict = builtin_table_functions()
        # view registry: name -> ViewDefinition (reference:
        # metadata/MetadataManager view/materialized-view maps)
        self.views: dict = {}

    def register(self, name: str, connector: Connector) -> None:
        self._connectors[name] = connector
        self.bump_generation()

    def bump_generation(self) -> None:
        """Schema/stats changed (DDL, ANALYZE, connector registration):
        cached plans built against the old catalog state must miss."""
        self.generation += 1

    def table_versions(self, tables) -> Optional[tuple]:
        """Sorted (catalog, table, version) vector for a (catalog, table)
        iterable; None when any table is unversioned or unresolvable."""
        return version_vector(tuple(tables), self)

    def mv_is_stale(self, name: str) -> bool:
        """A materialized view is stale when some base table's current
        data_version differs from the vector captured at refresh.  Views
        never refreshed, or with unversioned bases, report stale (the
        conservative answer)."""
        view = self.views.get(name)
        if view is None or not view.materialized:
            raise KeyError(f"no such materialized view: {name}")
        if view.backing is None or view.base_versions is None:
            return True
        current = self.table_versions(
            [(c, t) for c, t, _v in view.base_versions])
        return current != view.base_versions

    def connector(self, name: str) -> Connector:
        if name not in self._connectors:
            raise KeyError(f"catalog not found: {name!r}")
        return self._connectors[name]

    def names(self) -> list[str]:
        return sorted(self._connectors)

    def resolve_table(self, name: str, default: str) -> tuple[str, str, TableSchema]:
        """'table', 'catalog.table' or 'catalog.schema.table' ->
        (catalog, table, schema).  Connectors with schema-qualified table
        names (connectors/system.py: 'runtime.queries') resolve the
        'schema.table' form first; the historical flat-namespace fallback
        ('catalog.x.t' -> table 't') is preserved for everything else."""
        parts = name.split(".")
        if len(parts) == 1:
            cat, table = default, parts[0]
        elif len(parts) == 2:
            cat, table = parts
            if cat not in self._connectors and default in self._connectors:
                # 'runtime.queries' under default_catalog='system': treat
                # the whole name as a schema-qualified table of the default
                try:
                    schema = self._connectors[default].get_table_schema(name)
                    return default, name, schema
                except KeyError:
                    pass
        else:
            cat = parts[0]
            qualified = ".".join(parts[1:])
            try:
                schema = self.connector(cat).get_table_schema(qualified)
                return cat, qualified, schema
            except KeyError:
                table = parts[-1]
        schema = self.connector(cat).get_table_schema(table)
        return cat, table, schema


def default_catalog(scale_factor: float = 0.01,
                    file_root: Optional[str] = None) -> Catalog:
    """Catalog with the tpch, memory, blackhole and file connectors
    registered (the reference's ``system`` connector is not ported yet).
    ``file_root`` anchors the file connector's tables; by default it is a
    temp directory of its own, made at first use."""
    from .file import FileConnector
    from .memory import BlackholeConnector, MemoryConnector
    from .tpch import TpchConnector

    cat = Catalog()
    cat.register("tpch", TpchConnector(scale_factor))
    cat.register("memory", MemoryConnector())
    cat.register("blackhole", BlackholeConnector())
    cat.register("file", FileConnector(file_root))
    return cat
