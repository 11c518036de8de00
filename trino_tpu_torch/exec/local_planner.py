"""Local execution planner: plan tree -> operator pipelines.

The port of the reference ``exec/local_planner.py`` (LocalExecutionPlanner.
java:403) for the plan nodes the ported queries produce.  A join's build
side becomes its own pipeline connected through a JoinBridge; pipelines
come back in dependency order (every build before the probe that reads it),
so a sequential run is correct.  A TableWriter (CTAS, INSERT) ends its
pipeline in a TableWriterOperator.  No local exchange, dynamic filters,
spill or revocation (not ported yet).
"""

from __future__ import annotations

from typing import Sequence

from ..connectors.catalog import Catalog
from ..planner import plan as P
from ..spi.connector import ColumnSchema, TableSchema
from ..spi.types import BOOLEAN, Type
from ..sql.ir import Call
from .operators import (
    FilterProjectOperator,
    HashAggregationOperator,
    JoinBridge,
    JoinBuildSink,
    LimitOperator,
    LookupJoinOperator,
    Operator,
    OutputCollector,
    RenameOperator,
    ScanOperator,
    SemiJoinOperator,
    SortOperator,
    TableWriterOperator,
    TopNOperator,
)

__all__ = ["LocalExecutionPlan", "LocalPlanner"]


class LocalExecutionPlan:
    def __init__(self, pipelines: list[list[Operator]],
                 collector: OutputCollector, output_names: Sequence[str],
                 output_types: Sequence[Type]):
        self.pipelines = pipelines
        self.collector = collector
        self.output_names = list(output_names)
        self.output_types = list(output_types)


class LocalPlanner:
    def __init__(self, catalog: Catalog, device, splits_per_node: int = 4,
                 node_count: int = 1):
        self.catalog = catalog
        self.device = device
        self.splits_per_node = splits_per_node
        self.node_count = node_count
        self.pipelines: list[list[Operator]] = []

    def plan(self, root: P.PlanNode) -> LocalExecutionPlan:
        chain = self._chain(root)
        collector = OutputCollector()
        chain.append(collector)
        self.pipelines.append(chain)
        return LocalExecutionPlan(self.pipelines, collector,
                                  root.output_names, root.output_types)

    def _chain(self, node: P.PlanNode) -> list[Operator]:
        if isinstance(node, P.TableScan):
            conn = self.catalog.connector(node.catalog)
            splits = conn.get_splits(node.table, self.splits_per_node,
                                     self.node_count)
            return [ScanOperator(conn, splits, node.columns, self.device,
                                 constraint=node.constraint)]

        if isinstance(node, P.Filter):
            chain = self._chain(node.source)
            last = chain[-1]
            if (isinstance(last, FilterProjectOperator)
                    and last.projections is None):
                # Filter over Filter: AND the predicates into one operator
                pred = node.predicate if last.predicate is None else Call(
                    BOOLEAN, "$and", (last.predicate, node.predicate))
                chain[-1] = FilterProjectOperator(
                    pred, None, node.output_names, node.output_types)
                return chain
            chain.append(FilterProjectOperator(
                node.predicate, None, node.output_names, node.output_types))
            return chain

        if isinstance(node, P.Project):
            chain = self._chain(node.source)
            last = chain[-1]
            if (isinstance(last, FilterProjectOperator)
                    and last.projections is None):
                # Project over Filter: one fused filter+project operator
                chain[-1] = FilterProjectOperator(
                    last.predicate, node.expressions,
                    node.output_names, node.output_types)
                return chain
            chain.append(FilterProjectOperator(
                None, node.expressions, node.output_names,
                node.output_types))
            return chain

        if isinstance(node, P.Aggregate):
            chain = self._chain(node.source)
            chain.append(HashAggregationOperator(
                node.group_keys, node.aggregates,
                node.output_names, node.output_types, node.step))
            return chain

        if isinstance(node, P.Join):
            bridge = JoinBridge()
            build = self._chain(node.right)
            build.append(JoinBuildSink(
                bridge, node.right_keys, node.right.output_types,
                node.right.output_names, self.device))
            self.pipelines.append(build)
            chain = self._chain(node.left)
            chain.append(LookupJoinOperator(
                bridge, node.left_keys, node.join_type, node.residual,
                node.output_names, node.output_types))
            return chain

        if isinstance(node, P.SemiJoin):
            bridge = JoinBridge()
            build = self._chain(node.filter_source)
            build.append(JoinBuildSink(
                bridge, node.filter_keys, node.filter_source.output_types,
                node.filter_source.output_names, self.device))
            self.pipelines.append(build)
            chain = self._chain(node.source)
            chain.append(SemiJoinOperator(
                bridge, node.source_keys, node.null_aware, node.residual,
                node.output_names, node.output_types))
            return chain

        if isinstance(node, P.Sort):
            chain = self._chain(node.source)
            chain.append(SortOperator(node.keys))
            return chain

        if isinstance(node, P.TopN):
            chain = self._chain(node.source)
            chain.append(TopNOperator(node.count, node.keys))
            return chain

        if isinstance(node, P.Limit):
            chain = self._chain(node.source)
            chain.append(LimitOperator(node.count))
            return chain

        if isinstance(node, P.Output):
            chain = self._chain(node.source)
            chain.append(RenameOperator(node.output_names))
            return chain

        if isinstance(node, P.Exchange):
            # single node: exchanges are pass-through
            return self._chain(node.source)

        if isinstance(node, P.TableWriter):
            chain = self._chain(node.source)
            conn = self.catalog.connector(node.catalog)
            try:
                schema = conn.get_table_schema(node.table)
            except KeyError:  # CTAS: create the target from the source
                schema = TableSchema(node.table, tuple(
                    ColumnSchema(n, t) for n, t in
                    zip(node.source.output_names, node.source.output_types)))
                conn.create_table(schema)
            # INSERT maps the query's output to table columns by position
            chain.append(RenameOperator([c.name for c in schema.columns]))
            chain.append(TableWriterOperator(
                conn.create_page_sink(node.table),
                on_finish=lambda frags: conn.finish_insert(node.table,
                                                           frags)))
            return chain

        raise NotImplementedError(f"no operator for {type(node).__name__}")
