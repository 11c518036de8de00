"""StandaloneQueryRunner: SQL string -> result batch, in process, on a device.

The port of the reference ``runner.py`` (StandaloneQueryRunner.execute):
parse -> analyze/plan -> optimize (the legacy rule pipeline) -> local plan
-> run the pipelines on ``device``.  CREATE TABLE and DROP TABLE run as
metadata statements (the reference's ``execute_ddl``); CREATE TABLE AS and
INSERT plan a TableWriter.  No plan or result cache, sessions, access
control, transactions, events or EXPLAIN ANALYZE (not ported yet).

The runner runs on the card unless the caller asks for the CPU:
``device="cuda"`` (the default) raises when CUDA is not available.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .connectors.catalog import Catalog, default_catalog
from .exec.driver import run_pipelines
from .exec.local_planner import LocalPlanner
from .exec.stats import QueryStats
from .planner.logical import LogicalPlanner
from .planner.optimizer import optimize
from .planner.plan import PlanNode, plan_text
from .spi.batch import Column, ColumnBatch
from .spi.connector import ColumnSchema, TableSchema
from .spi.types import BIGINT, parse_type
from .sql import ast
from .sql.parser import parse_statement

__all__ = ["QueryResult", "StandaloneQueryRunner", "execute_ddl"]


def count_result(name: str, n: int) -> "QueryResult":
    return QueryResult([name], ColumnBatch(
        [name], [Column(BIGINT, np.array([n], np.int64))]))


def _split_name(name: str, default: str) -> tuple[str, str]:
    parts = name.split(".")
    if len(parts) == 1:
        return default, parts[0]
    return parts[0], parts[-1]


def execute_ddl(stmt, catalog: Catalog,
                default_catalog_name: str) -> Optional["QueryResult"]:
    """CREATE TABLE (with columns) and DROP TABLE; None for any other
    statement (reference: runner.execute_ddl)."""
    if isinstance(stmt, ast.CreateTable):
        cat, table = _split_name(stmt.table, default_catalog_name)
        catalog.connector(cat).create_table(TableSchema(table, tuple(
            ColumnSchema(n, parse_type(t)) for n, t in stmt.columns)))
    elif isinstance(stmt, ast.DropTable):
        cat, table = _split_name(stmt.table, default_catalog_name)
        conn = catalog.connector(cat)
        try:
            conn.get_table_schema(table)
        except KeyError:
            if not stmt.if_exists:
                raise
            return count_result("rows", 0)
        conn.drop_table(table)
    else:
        return None
    return count_result("rows", 0)


@dataclass
class QueryResult:
    names: list[str]
    batch: ColumnBatch

    def rows(self) -> list[tuple]:
        return self.batch.to_pylist()


class StandaloneQueryRunner:
    def __init__(self, catalog: Optional[Catalog] = None,
                 device="cuda", default_catalog_name: str = "tpch",
                 splits_per_node: int = 4):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StandaloneQueryRunner(device='cuda'): CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        self.catalog = catalog if catalog is not None else default_catalog()
        self.default_catalog_name = default_catalog_name
        self.splits_per_node = splits_per_node

    def create_plan(self, sql: str) -> PlanNode:
        return self._plan(parse_statement(sql))

    def _plan(self, stmt) -> PlanNode:
        plan = LogicalPlanner(self.catalog,
                              self.default_catalog_name).plan(stmt)
        return optimize(plan, self.catalog)

    def explain(self, sql: str) -> str:
        return plan_text(self.create_plan(sql))

    def execute(self, sql: str,
                stats: Optional[QueryStats] = None) -> QueryResult:
        """Run one statement; ``stats`` (optional) collects per-operator
        times of a query."""
        stmt = parse_statement(sql)
        ddl = execute_ddl(stmt, self.catalog, self.default_catalog_name)
        if ddl is not None:
            return ddl
        plan = self._plan(stmt)
        local = LocalPlanner(self.catalog, self.device,
                             splits_per_node=self.splits_per_node).plan(plan)
        run_pipelines(local.pipelines, stats)
        batches = local.collector.batches
        if batches:
            batch = ColumnBatch.concat(batches)
        else:
            batch = ColumnBatch(local.output_names, [
                Column(t, np.empty(0, t.storage_dtype))
                for t in local.output_types])
        return QueryResult(local.output_names, batch)
