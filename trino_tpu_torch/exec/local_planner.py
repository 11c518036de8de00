"""Local execution planner: plan tree -> operator pipelines.

The port of the reference ``exec/local_planner.py`` (LocalExecutionPlanner.
java:403) for the single-node plan nodes: TableScan, Values, Filter,
Project, Aggregate, GroupId, Join (INNER, CROSS, LEFT, RIGHT, FULL,
SINGLE), SemiJoin, Union, Replicate, Window, MatchRecognize, Unnest,
TableFunctionScan, Sort, TopN, Limit, Output, TableWriter, and Exchange as
a pass-through.  A join's build
side becomes its own pipeline connected through a JoinBridge; each Union
input becomes a pipeline ending in a UnionSinkOperator and the consumer
starts from a UnionSourceOperator.  Pipelines come back in dependency order
(every build and every union input before the pipeline that reads it, a
branch's own builds before the branch), so a sequential run is correct.  A
TableWriter (CTAS, INSERT) ends its pipeline in a TableWriterOperator.
INNER and RIGHT joins attach dynamic filters to their probe-side scan
(exec/dynamic_filter.py), a scan takes the TableScan's pushed-down LIMIT,
and :func:`plan_lazy_scan` marks the channels a scan's filter only passes
through.  ``dynamic_filtering``, ``ingest`` and ``encoded_exec`` are the
reference's ``Session.dynamic_filtering``, ``TRINO_TPU_PREFETCH*`` and
``TRINO_TPU_ENCODED_EXEC`` as arguments, with their defaults.

Each plan gets one ``TaskMemoryContext(hbm_limit_bytes,
spill_to_disk_bytes)`` (exec/revoking.py) that every blocking operator
reserves its buffer in, and whose disk threshold sends a buffer past it
to a spill file (exec/spill.py).  With
``task_concurrency`` > 1, a pipeline whose source is a multi-split scan
forks into parallel driver chains behind local exchanges
(:meth:`LocalPlanner._parallelize`).

Under the distributed runner (execution/distributed_runner.py) a planner
plans one task of a fragment: ``task_index`` of ``task_count`` takes every
``task_count``-th split of each scan, and a ``RemoteSource`` reads the
upstream fragment through ``remote_clients[fragment_id]``: a collective
exchange (CollectiveSourceOperator), a list of per-producer clients for a
MERGE edge (MergeSourceOperator) or one ExchangeClient
(RemoteExchangeSourceOperator); a FINAL aggregation over a fused stage's
edge (execution/stage_compiler.py) becomes that stage's
FusedStageSourceOperator.  DistinctLimit (which only
``planner/add_exchanges`` emits) becomes a DistinctLimitOperator.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..connectors.catalog import Catalog
from ..planner import plan as P
from ..spi.batch import Column, ColumnBatch
from ..spi.connector import ColumnSchema, TableSchema
from ..spi.types import BOOLEAN, Type
from ..sql.ir import Call, InputRef
from .dynamic_filter import DynamicFilterHolder
from .local_exchange import (GATHER, HASH, LocalExchange,
                             LocalExchangeSinkOperator,
                             LocalExchangeSourceOperator)
from .match_recognize import MatchRecognizeOperator
from .operators import (
    BufferedInputMixin,
    DistinctLimitOperator,
    FilterProjectOperator,
    GroupIdOperator,
    HashAggregationOperator,
    JoinBridge,
    JoinBuildSink,
    LimitOperator,
    LocalUnionBridge,
    LookupJoinOperator,
    Operator,
    OutputCollector,
    RenameOperator,
    ReplicateOperator,
    ScanOperator,
    SemiJoinOperator,
    SortOperator,
    TableFunctionOperator,
    TableWriterOperator,
    TopNOperator,
    UnionSinkOperator,
    UnionSourceOperator,
    UnnestOperator,
    ValuesOperator,
    WindowOperator,
    plan_lazy_scan,
)
from .prefetch import IngestConfig
from .revoking import TaskMemoryContext

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
                 node_count: int = 1, dynamic_filtering: bool = True,
                 ingest: Optional[IngestConfig] = None,
                 encoded_exec: bool = True,
                 hbm_limit_bytes: int = 16 << 30,
                 task_concurrency: int = 1,
                 spill_to_disk_bytes: int = 0,
                 task_index: int = 0, task_count: int = 1,
                 remote_clients: Optional[dict] = None):
        self.catalog = catalog
        self.device = device
        self.splits_per_node = splits_per_node
        self.node_count = node_count
        # distributed: this task's share of the splits and the exchange
        # clients per upstream fragment id (filled by the stage scheduler)
        self.task_index = task_index
        self.task_count = task_count
        self.remote_clients = remote_clients or {}
        self.dynamic_filtering = dynamic_filtering
        self.ingest = ingest if ingest is not None else IngestConfig()
        self.encoded_exec = encoded_exec
        self.task_concurrency = task_concurrency
        # the task's device pool: blocking operators reserve their buffered
        # bytes as revocable memory (exec/revoking.py)
        self.memory = TaskMemoryContext(hbm_limit_bytes,
                                        spill_to_disk_bytes)
        self.pipelines: list[list[Operator]] = []

    def plan(self, root: P.PlanNode) -> LocalExecutionPlan:
        chain = self._chain(root)
        collector = OutputCollector()
        chain.append(collector)
        self.pipelines.append(chain)
        if self.task_concurrency > 1:
            self.pipelines = [q for p in self.pipelines
                              for q in self._parallelize(p)]
        for p in self.pipelines:
            plan_lazy_scan(p)
            for op in p:
                if isinstance(op, BufferedInputMixin):
                    op.attach_memory(self.memory)
        return LocalExecutionPlan(self.pipelines, collector,
                                  root.output_names, root.output_types)

    def _parallelize(self, pipeline: list[Operator]) -> list[list[Operator]]:
        """Intra-task parallelism (LocalExchange.java:67 +
        AddLocalExchanges.java:111): a pipeline whose source is a
        multi-split scan forks into ``task_concurrency`` driver chains, each
        scanning every c-th split with its own prefetch threads and copy
        stream.  Row-parallel operators (filter / project, keyed INNER /
        LEFT / SINGLE lookup joins and keyed semi-joins, all probing the one
        shared build) clone into every chain; at the first grouped
        aggregation the rows cross a bounded HASH local exchange into
        ``task_concurrency`` aggregation drivers (disjoint groups, so their
        outputs simply concatenate); everything further down runs in one
        consumer chain behind a GATHER exchange.  The pipelines of one
        cluster share a ``_concurrent_group`` tag, and run_pipelines runs
        them at once."""
        scan = pipeline[0]
        if not isinstance(scan, ScanOperator):
            return [pipeline]
        c = min(self.task_concurrency, len(scan.splits))
        if c < 2:
            return [pipeline]

        def clone(op: Operator) -> Optional[Operator]:
            if isinstance(op, FilterProjectOperator):
                return FilterProjectOperator(
                    op.predicate, op.projections, op.output_names,
                    op.output_types)
            if isinstance(op, LookupJoinOperator) and op.join_type in (
                    "INNER", "LEFT", "SINGLE") and op.left_keys:
                return LookupJoinOperator(
                    op.bridge, op.left_keys, op.join_type, op.residual_expr,
                    op.output_names, op.output_types)
            if isinstance(op, SemiJoinOperator) and op.source_keys:
                return SemiJoinOperator(
                    op.bridge, op.source_keys, op.null_aware,
                    op.residual_expr, op.output_names, op.output_types)
            return None

        n_prefix = 1
        while (n_prefix < len(pipeline)
               and clone(pipeline[n_prefix]) is not None):
            n_prefix += 1
        rest = pipeline[n_prefix:]
        if not rest:
            return [pipeline]
        last = pipeline[n_prefix - 1]
        names = scan.columns if last is scan else last.output_names
        # partition point: a grouped aggregation -> HASH exchange + c clones
        agg = rest[0] if (isinstance(rest[0], HashAggregationOperator)
                          and rest[0].group_keys) else None
        gid = object()  # this exchange cluster's tag

        def tag(p: list[Operator]) -> list[Operator]:
            p[0]._concurrent_group = gid
            return p

        exch = LocalExchange(c, c if agg is not None else 1,
                             HASH if agg is not None else GATHER,
                             key_channels=(agg.group_keys if agg is not None
                                           else ()))
        chains = []
        for i in range(c):
            shard = ScanOperator(
                scan.connector, scan.splits[i::c], scan.columns, self.device,
                constraint=scan.constraint,
                dynamic_filters=scan.dynamic_filters, limit=scan.limit,
                ingest=scan.ingest_cfg, encoded=scan.encoded)
            chains.append(tag([shard] + [clone(op) for op in
                                         pipeline[1:n_prefix]]
                              + [LocalExchangeSinkOperator(exch, i, names)]))
        if agg is None:
            return chains + [tag([LocalExchangeSourceOperator(exch, 0)]
                                 + rest)]
        gather = LocalExchange(c, 1, GATHER)
        for j in range(c):
            chains.append(tag([
                LocalExchangeSourceOperator(exch, j),
                HashAggregationOperator(agg.group_keys, agg.aggs,
                                        agg.output_names, agg.output_types,
                                        agg.step, self.device),
                LocalExchangeSinkOperator(gather, j, agg.output_names)]))
        return chains + [tag([LocalExchangeSourceOperator(gather, 0)]
                             + rest[1:])]

    def _chain(self, node: P.PlanNode) -> list[Operator]:
        if isinstance(node, P.TableScan):
            conn = self.catalog.connector(node.catalog)
            splits = conn.get_splits(node.table, self.splits_per_node,
                                     self.node_count)
            mine = [s for i, s in enumerate(splits)
                    if i % self.task_count == self.task_index]
            return [ScanOperator(conn, mine, node.columns, self.device,
                                 constraint=node.constraint,
                                 limit=node.limit, ingest=self.ingest,
                                 encoded=self.encoded_exec)]

        if isinstance(node, P.RemoteSource):
            from ..execution.collective_exchange import (
                CollectiveRepartitionExchange, CollectiveSourceOperator)
            from ..execution.task import (MergeSourceOperator,
                                          RemoteExchangeSourceOperator)

            client = self.remote_clients[node.fragment_id]
            if isinstance(client, CollectiveRepartitionExchange):
                return [CollectiveSourceOperator(client, self.task_index)]
            if isinstance(client, list):  # MERGE: per-producer streams
                return [MergeSourceOperator(
                    client, node.sort_keys, node.output_names,
                    node.output_types, self.device)]
            return [RemoteExchangeSourceOperator(client, self.device)]

        if isinstance(node, P.Values):
            return [ValuesOperator(_values_batch(node).to(self.device))]

        if isinstance(node, P.TableFunctionScan):
            return [TableFunctionOperator(node.bound, node.output_names,
                                          self.device)]

        if isinstance(node, P.Unnest):
            chain = self._chain(node.source)
            chain.append(UnnestOperator(
                node.replicate, node.unnest_channels, node.ordinality,
                node.output_names, node.output_types))
            return chain

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
            if (node.step == "FINAL"
                    and isinstance(node.source, P.RemoteSource)):
                from ..execution.stage_compiler import (
                    FusedStageExec, FusedStageSourceOperator)

                client = self.remote_clients.get(node.source.fragment_id)
                if isinstance(client, FusedStageExec):
                    # whole-stage compilation: the producer stage already
                    # ran PARTIAL, the shuffle and FINAL in its programs;
                    # this pipeline takes its shard
                    return [FusedStageSourceOperator(client,
                                                     self.task_index)]
            chain = self._chain(node.source)
            chain.append(HashAggregationOperator(
                node.group_keys, node.aggregates,
                node.output_names, node.output_types, node.step,
                self.device))
            return chain

        if isinstance(node, P.GroupId):
            chain = self._chain(node.source)
            chain.append(GroupIdOperator(
                node.key_channels, node.passthrough, node.sets,
                node.output_names, node.output_types))
            return chain

        if isinstance(node, P.Union):
            bridge = LocalUnionBridge(len(node.sources))
            for src in node.sources:
                chain = self._chain(src)  # appends the branch's builds
                chain.append(UnionSinkOperator(bridge, node.output_names))
                self.pipelines.append(chain)
            return [UnionSourceOperator(bridge)]

        if isinstance(node, P.Replicate):
            chain = self._chain(node.source)
            chain.append(ReplicateOperator(node.count_channel))
            return chain

        if isinstance(node, P.Join):
            bridge = JoinBridge()
            # dynamic filtering: INNER / RIGHT probe rows that cannot match
            # are droppable, so the build keys' domain prunes the probe
            # scan (server/DynamicFilterService.java:105)
            holders = [None] * len(node.right_keys)
            scan_attach = []
            if (self.dynamic_filtering and node.left_keys
                    and node.join_type in ("INNER", "RIGHT")):
                for k, lch in enumerate(node.left_keys):
                    col = _trace_to_scan_col(node.left, lch)
                    if col is not None:
                        holders[k] = DynamicFilterHolder()
                        scan_attach.append((col, holders[k]))
            build = self._chain(node.right)
            build.append(JoinBuildSink(
                bridge, node.right_keys, node.right.output_types,
                node.right.output_names, self.device,
                dynamic_filter_holders=holders))
            self.pipelines.append(build)
            chain = self._chain(node.left)
            if scan_attach and isinstance(chain[0], ScanOperator):
                chain[0].dynamic_filters.extend(scan_attach)
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

        if isinstance(node, P.MatchRecognize):
            chain = self._chain(node.source)
            chain.append(MatchRecognizeOperator(
                node.partition_channels, node.order_keys, node.pattern,
                node.defines, node.measures, node.skip_past,
                node.output_names, node.output_types,
                node.source.output_names))
            return chain

        if isinstance(node, P.Window):
            chain = self._chain(node.source)
            chain.append(WindowOperator(
                node.partition_keys, node.order_keys, node.functions,
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

        if isinstance(node, P.DistinctLimit):
            chain = self._chain(node.source)
            chain.append(DistinctLimitOperator(node.count))
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
                try:
                    conn.create_table(schema)
                except ValueError:
                    # parallel writer tasks (scale_writers) race to create
                    # the target; the first one wins
                    schema = conn.get_table_schema(node.table)
            # INSERT maps the query's output to table columns by position
            chain.append(RenameOperator([c.name for c in schema.columns]))
            chain.append(TableWriterOperator(
                conn.create_page_sink(node.table),
                on_finish=lambda frags: conn.finish_insert(node.table,
                                                           frags)))
            return chain

        raise NotImplementedError(f"no operator for {type(node).__name__}")


def _trace_to_scan_col(node: P.PlanNode, ch: int) -> Optional[int]:
    """Map an output channel down the probe side's left spine to a
    TableScan column index, or None when the channel is computed or
    crosses a union boundary.  Descends only where rows pass through
    unchanged (dropping a probe row cannot change other rows' results)."""
    while True:
        if isinstance(node, P.TableScan):
            return ch
        if isinstance(node, (P.Filter, P.Exchange)):
            node = node.source
            continue
        if isinstance(node, P.Project):
            e = node.expressions[ch]
            if isinstance(e, InputRef):
                node, ch = node.source, e.index
                continue
            return None
        if isinstance(node, P.Join):
            if ch < len(node.left.output_types):
                node = node.left
                continue
            return None
        if isinstance(node, P.SemiJoin):
            if ch < len(node.source.output_types):
                node = node.source
                continue
            return None
        return None


def _values_batch(node: P.Values) -> ColumnBatch:
    cols = [Column.from_values(t, [row[i] for row in node.rows])
            for i, t in enumerate(node.output_types)]
    return ColumnBatch(list(node.output_names), cols)
