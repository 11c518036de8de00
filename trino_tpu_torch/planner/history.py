"""History-based optimization: journaled runtime truth fed back into the
cost model.  The port of the reference ``planner/history.py`` (the HBO
design Trino/Presto ship as HistoryBasedPlanStatisticsCalculator —
observed plan-node statistics keyed by a logical plan fingerprint,
consulted before estimates).  Host code only: fingerprints, the stats
table and the records are the reference's, byte for byte, so each
package reads the plan_stats the other wrote.

Two halves, both here so the fingerprint definition cannot drift:

- **Recording** (:func:`record_query_stats`): at the end of a successful
  distributed query the runner hands over its fragments, stages and the
  adaptive controller; every fragment's observed output (sink
  ``rows_enqueued``/``bytes_enqueued``, adaptive staging counters, probe
  heavy-hitter share) is written to the query journal as one
  ``plan_stats`` record keyed by each fragment root's *logical
  fingerprint*.
- **Reading** (:class:`HistoryProvider`): ``estimate_rows`` and the
  iterative optimizer's reorder/distribution rules look observed stats up
  by the same fingerprint; a hit replaces the estimate.  The provider's
  table is kept between lookups: a lookup reads only what the journal's
  files gained since the last one, and rebuilds the table only when a
  plan_stats record came or went.

The fingerprint is **row-equivalence** hashing, not structural hashing:
two plan shapes that must produce the same row stream hash equal, so a
stat recorded against the *executed* plan (post-prune, post-fragmentation,
adaptively flipped) still matches the *candidate* subtree the optimizer
is costing on the next run.  Concretely:

- expressions render by channel **name**, never index (names are assigned
  once at translation and survive pruning/projection);
- Project / Sort / Output / Exchange are transparent (row-preserving);
- TableScan keys on (catalog, table) only — columns, advisory constraint
  and pushed limit are row-irrelevant or derived;
- Aggregate ignores the step: FINAL is transparent-to-source, so the
  plan-time SINGLE aggregation and the executed PARTIAL->shuffle->FINAL
  chain share one fingerprint;
- INNER/CROSS joins hash their sides and key pairs orderless, so the
  run-1 order and the reordered run-2 plan (and BROADCAST vs PARTITIONED)
  share one fingerprint;
- RemoteSource substitutes the producer fragment's fingerprint.

Misses degrade to estimates; history can change plans, never results.
Plan-cache poisoning is prevented by :func:`history_epoch`, a digest of
the plan_stats corpus mixed into the Tier A key (caching/plan_cache.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..spi import knobs
from ..sql.ir import Call, InputRef, Literal, OuterRef, RowExpression
from .plan import (
    Aggregate,
    DistinctLimit,
    Exchange,
    Filter,
    GroupId,
    Join,
    Limit,
    Output,
    PlanNode,
    Project,
    RemoteSource,
    SemiJoin,
    Sort,
    TableScan,
    TopN,
    Union,
    Unnest,
    Values,
    Window,
)

__all__ = [
    "NodeStats", "HistoryProvider", "hbo_enabled", "provider_if_enabled",
    "history_epoch", "logical_fingerprint", "fragment_fingerprints",
    "record_query_stats",
]


def hbo_enabled() -> bool:
    return knobs.get_str("TRINO_TPU_HBO").strip().lower() not in ("0", "off")


# ---------------------------------------------------------------- fingerprint


def _render(e: RowExpression, names: tuple) -> str:
    """Name-based expression rendering: stable across channel remapping."""
    if isinstance(e, InputRef):
        return names[e.index] if e.index < len(names) else f"#{e.index}"
    if isinstance(e, Literal):
        return f"lit:{e.value!r}"
    if isinstance(e, Call):
        return f"{e.name}({','.join(_render(a, names) for a in e.args)})"
    if isinstance(e, OuterRef):
        return f"outer:{e.index}"
    return repr(e)


def _digest(parts: tuple) -> str:
    return hashlib.sha1(repr(parts).encode("utf-8")).hexdigest()[:16]


def logical_fingerprint(node: PlanNode,
                        resolve: Optional[Callable[[int], str]] = None) -> str:
    """Row-equivalence fingerprint of a plan subtree.  ``resolve`` maps a
    RemoteSource's fragment id to the producer fragment's fingerprint
    (record side); plan-time trees have no RemoteSource."""

    def fp(n: PlanNode) -> str:
        if isinstance(n, (Project, Sort, Output, Exchange)):
            return fp(n.source)
        if isinstance(n, TableScan):
            return _digest(("scan", n.catalog, n.table))
        if isinstance(n, Filter):
            from .optimizer import _split_and

            names = n.source.output_names
            conjuncts = tuple(sorted(
                _render(c, names) for c in _split_and(n.predicate)))
            return _digest(("filter", conjuncts, fp(n.source)))
        if isinstance(n, Aggregate):
            if n.step == "FINAL":
                return fp(n.source)
            names = n.source.output_names
            keys = tuple(sorted(names[k] for k in n.group_keys))
            aggs = tuple(sorted(
                (a.fn, names[a.arg] if a.arg >= 0 else "*", a.distinct)
                for a in n.aggregates))
            return _digest(("agg", keys, aggs, fp(n.source)))
        if isinstance(n, Join):
            lnames = n.left.output_names
            rnames = n.right.output_names
            pairs = tuple(sorted(
                tuple(sorted((lnames[l], rnames[r])))
                for l, r in zip(n.left_keys, n.right_keys)))
            residual = ""
            if n.residual is not None:
                residual = _render(n.residual, tuple(lnames) + tuple(rnames))
            sides = (fp(n.left), fp(n.right))
            if n.join_type in ("INNER", "CROSS"):
                # orderless: the reordered plan keeps the fingerprint
                sides = tuple(sorted(sides))
            return _digest(("join", n.join_type, pairs, residual) + sides)
        if isinstance(n, SemiJoin):
            snames = n.source.output_names
            fnames = n.filter_source.output_names
            pairs = tuple((snames[s], fnames[f])
                          for s, f in zip(n.source_keys, n.filter_keys))
            residual = ""
            if n.residual is not None:
                residual = _render(n.residual, tuple(snames) + tuple(fnames))
            return _digest(("semijoin", n.negated, n.null_aware, pairs,
                            residual, fp(n.source), fp(n.filter_source)))
        if isinstance(n, Limit):
            return _digest(("limit", n.count, fp(n.source)))
        if isinstance(n, TopN):
            keys = tuple((n.source.output_names[k.channel], k.ascending)
                         for k in n.keys)
            return _digest(("topn", n.count, keys, fp(n.source)))
        if isinstance(n, DistinctLimit):
            return _digest(("distinctlimit", n.count, fp(n.source)))
        if isinstance(n, Values):
            return _digest(("values", len(n.rows)))
        if isinstance(n, Union):
            return _digest(("union",) + tuple(sorted(fp(s)
                                                     for s in n.sources)))
        if isinstance(n, Window):
            names = n.source.output_names
            fns = tuple((f.fn, tuple(names[a] for a in f.args))
                        for f in n.functions)
            return _digest(("window",
                            tuple(names[k] for k in n.partition_keys),
                            fns, fp(n.source)))
        if isinstance(n, GroupId):
            return _digest(("groupid", n.sets, fp(n.source)))
        if isinstance(n, Unnest):
            return _digest(("unnest", n.unnest_channels, fp(n.source)))
        if isinstance(n, RemoteSource):
            if resolve is not None:
                return resolve(n.fragment_id)
            return _digest(("remote", n.fragment_id))
        # coarse default: type + children (TableWriter, Replicate, ...)
        return _digest((type(n).__name__,) + tuple(fp(c)
                                                   for c in n.children))

    return fp(node)


def fragment_fingerprints(fragments) -> dict:
    """Fingerprint every fragment root, resolving RemoteSources to their
    producer fragment's fingerprint (fragments form a DAG; iterate until
    all dependencies are available)."""
    fps: dict[int, str] = {}
    pending = list(fragments)
    while pending:
        rest = []
        for f in pending:
            try:
                fps[f.id] = logical_fingerprint(
                    f.root, resolve=lambda fid: fps[fid])
            except KeyError:
                rest.append(f)
        if len(rest) == len(pending):  # unresolvable — record what we have
            break
        pending = rest
    return fps


# ------------------------------------------------------------------- provider


@dataclass
class NodeStats:
    rows: Optional[int] = None
    bytes: Optional[int] = None
    groups: Optional[int] = None
    skew: Optional[float] = None


# The plan_stats records of each journal file, keyed by the file's
# identity (device, inode and its first bytes, so a rotation, which
# renames, keeps them and a new file on a reused inode does not):
# identity -> [bytes parsed, [(nodes, digest input)]].  A lookup opens each
# file and parses only the complete lines appended since the last lookup,
# and only those that name plan_stats: the query_created /
# query_completed records every query appends cost a read of their own
# bytes, not a re-parse of the journal.
_FILES: dict = {}
_HEAD = 64  # bytes of a file's start kept in its identity
# (the files' record counts in read order, table, epoch)
_TABLE_CACHE: Optional[tuple] = None
_TABLE_LOCK = threading.Lock()


def _scan(path: str) -> Optional[tuple]:
    """Bring ``_FILES``'s entry for the file at ``path`` up to its end;
    returns its identity (None when it cannot be read)."""
    try:
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        st = os.fstat(f.fileno())
        head = f.read(min(st.st_size, _HEAD))
        key = (st.st_dev, st.st_ino, head)
        ent = _FILES.get(key)
        if ent is None or ent[0] > st.st_size:
            ent = _FILES[key] = [0, []]
        if st.st_size > ent[0]:
            f.seek(ent[0])
            data = f.read(st.st_size - ent[0])
            end = data.rfind(b"\n") + 1  # a line still being written waits
            ent[0] += end
            for line in data[:end].split(b"\n"):
                if b'"plan_stats"' not in line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn line (a crash mid-write)
                if not isinstance(rec, dict) or "schema" not in rec or \
                        rec.get("event") != "plan_stats":
                    continue
                nodes = rec.get("nodes")
                if isinstance(nodes, dict):
                    ent[1].append((nodes, repr(sorted(nodes.items()))
                                   .encode("utf-8")))
    return key


def _stats_table() -> tuple[dict, str]:
    """(fingerprint -> NodeStats, epoch) from the journal's plan_stats
    records, newest record winning per fingerprint: the reference's table
    and epoch, read incrementally (``_FILES``) and rebuilt only when a
    plan_stats record came or went."""
    global _TABLE_CACHE
    from ..telemetry import journal

    j = journal.get_journal()
    if j is None:
        return {}, ""
    with _TABLE_LOCK:
        keys = [k for k in map(_scan, j.fleet_files()) if k is not None]
        for stale in set(_FILES).difference(keys):
            del _FILES[stale]  # rotated out of the set, or deleted
        counts = tuple((k, len(_FILES[k][1])) for k in keys)
        if _TABLE_CACHE is not None and _TABLE_CACHE[0] == counts:
            return _TABLE_CACHE[1], _TABLE_CACHE[2]
        table: dict[str, NodeStats] = {}
        h = hashlib.sha1()
        for k in keys:
            for nodes, digest_input in _FILES[k][1]:
                h.update(digest_input)
                for fp, st in nodes.items():
                    if not isinstance(st, dict):
                        continue
                    cur = table.setdefault(fp, NodeStats())
                    for field_name in journal.PLAN_STATS_FIELDS:
                        v = st.get(field_name)
                        if v is not None:
                            setattr(cur, field_name, v)
        epoch = h.hexdigest()[:12] if table else ""
        _TABLE_CACHE = (counts, table, epoch)
        return table, epoch


def history_epoch() -> str:
    """Digest of the observed-stats corpus the planner would consult right
    now; mixed into the Tier A plan-cache key so history-driven plans
    never outlive the history that shaped them.  "" when HBO is off or
    no stats exist."""
    if not hbo_enabled():
        return ""
    try:
        return _stats_table()[1]
    except Exception:
        return ""


class HistoryProvider:
    """Per-planning view over the shared stats table (fresh instance per
    optimize call so lookup/hit counters are per-query for the trace)."""

    def __init__(self, table: dict):
        self.table = table
        self.lookups = 0
        self.hits = 0
        self._fp_cache: dict[int, str] = {}

    def fingerprint(self, node: PlanNode) -> str:
        key = id(node)
        fp = self._fp_cache.get(key)
        if fp is None:
            fp = logical_fingerprint(node)
            self._fp_cache[key] = fp
        return fp

    def stats_for(self, node: PlanNode) -> Optional[NodeStats]:
        self.lookups += 1
        st = self.table.get(self.fingerprint(node))
        if st is not None:
            self.hits += 1
        return st

    def observed_rows(self, node: PlanNode) -> Optional[float]:
        st = self.stats_for(node)
        if st is None:
            return None
        if st.rows is not None:
            return float(st.rows)
        if st.groups is not None:  # summed partial groups: upper bound
            return float(st.groups)
        return None


def provider_if_enabled() -> Optional[HistoryProvider]:
    """A fresh HistoryProvider when HBO is on and observed stats exist;
    None otherwise (planning falls back to estimates)."""
    if not hbo_enabled():
        return None
    try:
        table, _ = _stats_table()
    except Exception:
        return None
    if not table:
        return None
    return HistoryProvider(table)


def reset_for_test() -> None:
    global _TABLE_CACHE
    with _TABLE_LOCK:
        _TABLE_CACHE = None
        _FILES.clear()


# ------------------------------------------------------------------ recording


def _is_partial_agg_root(node: PlanNode) -> bool:
    while isinstance(node, (Exchange, Project, Output)):
        node = node.source
    return isinstance(node, Aggregate) and node.step == "PARTIAL"


def record_query_stats(fragments, stages, skip_fids, adaptive,
                       query_id: str, sql_fingerprint: str) -> int:
    """Write one plan_stats journal record for a finished distributed
    query.  ``stages`` maps fragment id -> stage (with sink ``buffers``);
    ``skip_fids`` holds fragments whose sinks bypassed the buffers (fused/
    resident/collective edges); ``adaptive`` (optional) supplies staging
    counters and skew for deferred producers.  Returns the number of
    fingerprints recorded; never raises into the query path."""
    from ..telemetry import journal

    if not hbo_enabled():
        return 0
    j = journal.get_journal()
    if j is None:
        return 0
    fps = fragment_fingerprints(fragments)
    observed = adaptive.observed_stats() if adaptive is not None else {}
    nodes: dict[str, dict] = {}
    for f in fragments:
        fp = fps.get(f.id)
        if fp is None:
            continue
        ob = observed.get(f.id)
        if ob is not None:
            rows, nbytes, skew = ob["rows"], ob["bytes"], ob.get("skew")
        else:
            if f.id in skip_fids:
                continue  # sink bypassed OutputBuffer: no counters
            st = stages.get(f.id)
            buffers = getattr(st, "buffers", None)
            if not buffers:
                continue
            rows = sum(b.rows_enqueued for b in buffers)
            nbytes = sum(b.bytes_enqueued for b in buffers)
            skew = None
            nparts = buffers[0].num_partitions
            if getattr(f, "output_kind", "") == "BROADCAST" and nparts > 1:
                # broadcast sinks enqueue every batch once per partition
                rows //= nparts
                nbytes //= nparts
        entry = nodes.setdefault(fp, {})
        if _is_partial_agg_root(f.root):
            entry["groups"] = int(rows)
        else:
            entry["rows"] = int(rows)
            entry["bytes"] = int(nbytes)
        if skew is not None:
            entry["skew"] = float(skew)
    if not nodes:
        return 0
    j.plan_stats(query_id, sql_fingerprint, nodes, ts=time.time())
    return len(nodes)
