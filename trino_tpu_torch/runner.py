"""StandaloneQueryRunner: SQL string -> result batch, in process, on a device.

The port of the reference ``runner.py`` (StandaloneQueryRunner.execute):
parse -> analyze/plan -> optimize -> local plan -> run the pipelines on
``device``.  ``optimizer`` selects the optimizer: ``"iterative"`` (the
default, as in the reference) or ``"legacy"`` (the reference's
``TRINO_TPU_OPTIMIZER=legacy``).  CREATE TABLE and DROP TABLE run as
metadata statements (the reference's ``execute_ddl``); CREATE TABLE AS and
INSERT plan a TableWriter; EXPLAIN [ANALYZE] returns the plan text, the
iterative optimizer's rule firings and, under ANALYZE, the run's scan
and encoding roll-ups and per-operator times and rows.  The reference's
session and environment knobs of the scan are arguments, with the
reference's defaults: ``dynamic_filtering`` (build-side key domains prune
probe scans), ``ingest`` (an ``exec.prefetch.IngestConfig``: split
prefetch threads, coalescing into pinned buffers, side-stream copies to
the card; ``IngestConfig(enabled=False)`` is the synchronous scan) and
``encoded_exec`` (RLE and LAZY columns).  No plan or result cache,
sessions, access control, transactions or events (not ported yet).

The runner runs on the card unless the caller asks for the CPU:
``device="cuda"`` (the default) raises when CUDA is not available.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .connectors.catalog import Catalog, default_catalog
from .exec.driver import run_pipelines
from .exec.local_planner import LocalPlanner
from .exec.prefetch import IngestConfig
from .exec.stats import QueryStats
from .planner.iterative import last_report
from .planner.logical import LogicalPlanner
from .planner.optimizer import OPTIMIZER_MODES, optimize
from .planner.plan import PlanNode, plan_text
from .spi.batch import Column, ColumnBatch
from .spi.connector import ColumnSchema, TableSchema
from .spi.types import BIGINT, VARCHAR, parse_type
from .sql import ast
from .sql.parser import parse_statement

__all__ = ["QueryResult", "StandaloneQueryRunner", "execute_ddl"]


def text_result(name: str, lines: list[str]) -> "QueryResult":
    return QueryResult([name], ColumnBatch(
        [name], [Column.from_values(VARCHAR, lines)]))


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
                 splits_per_node: int = 4, optimizer: str = "iterative",
                 dynamic_filtering: bool = True,
                 ingest: Optional[IngestConfig] = None,
                 encoded_exec: bool = True):
        if optimizer not in OPTIMIZER_MODES:
            raise ValueError(f"unknown optimizer {optimizer!r}; expected "
                             f"one of {OPTIMIZER_MODES}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StandaloneQueryRunner(device='cuda'): CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        self.catalog = catalog if catalog is not None else default_catalog()
        self.default_catalog_name = default_catalog_name
        self.splits_per_node = splits_per_node
        self.optimizer = optimizer
        self.dynamic_filtering = dynamic_filtering
        self.ingest = ingest if ingest is not None else IngestConfig()
        self.encoded_exec = encoded_exec

    def create_plan(self, sql: str) -> PlanNode:
        return self._plan(parse_statement(sql))

    def _plan(self, stmt) -> PlanNode:
        plan = LogicalPlanner(self.catalog, self.default_catalog_name,
                              self.optimizer).plan(stmt)
        return optimize(plan, self.catalog, self.optimizer)

    def explain(self, sql: str) -> str:
        return plan_text(self.create_plan(sql))

    def execute(self, sql: str,
                stats: Optional[QueryStats] = None) -> QueryResult:
        """Run one statement; ``stats`` (optional) collects per-operator
        times, rows and batches of a query, and its scan and encoding
        roll-ups."""
        stmt = parse_statement(sql)
        if isinstance(stmt, ast.Explain):
            return self._execute_explain(stmt)
        ddl = execute_ddl(stmt, self.catalog, self.default_catalog_name)
        if ddl is not None:
            return ddl
        return self._run(self._plan(stmt), stats)

    def _execute_explain(self, stmt: ast.Explain) -> QueryResult:
        """EXPLAIN -> the plan text and the iterative optimizer's rule
        firings (timing-free); EXPLAIN ANALYZE also gives the planning ms,
        then runs the plan and appends its wall time and per-operator
        stats (reference: runner._execute_explain)."""
        plan = self._plan(stmt.statement)
        lines = plan_text(plan).splitlines()
        if self.optimizer == "iterative":
            lines.extend(last_report().lines(timings=stmt.analyze))
        if stmt.analyze:
            stats = QueryStats()
            t0 = time.perf_counter()
            self._run(plan, stats)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            lines.append(f"total: {(time.perf_counter() - t0) * 1e3:.1f} ms")
            lines.extend(stats.text().splitlines())
        return text_result("Query Plan", lines)

    def _run(self, plan: PlanNode,
             stats: Optional[QueryStats]) -> QueryResult:
        local = LocalPlanner(self.catalog, self.device,
                             splits_per_node=self.splits_per_node,
                             dynamic_filtering=self.dynamic_filtering,
                             ingest=self.ingest,
                             encoded_exec=self.encoded_exec).plan(plan)
        run_pipelines(local.pipelines, stats)
        batches = local.collector.batches
        if batches:
            batch = ColumnBatch.concat(batches)
        else:
            batch = ColumnBatch(local.output_names, [
                Column(t, np.empty(0, t.storage_dtype))
                for t in local.output_types])
        return QueryResult(local.output_names, batch)
