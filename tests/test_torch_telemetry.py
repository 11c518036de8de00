"""The port's telemetry plane held to the reference: the metrics registry
(byte-identical Prometheus text, equal percentiles and merges), tracing
(traceparent and span-dict round trips), the flight recorder (ring wrap,
context across threads, the bounded profile store, Chrome-trace kinds,
``profile(qid)`` of one query through both runners), event listeners and
``system.runtime.queries``.  Every run gets fresh caches and a journal in
``tmp_path``, in both packages."""

import threading

import numpy as np
import pytest
import torch

from trino_tpu import caching as ref_caching
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import tracing as ref_tracing
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.telemetry import journal as ref_journal
from trino_tpu.telemetry import metrics as ref_metrics
from trino_tpu.telemetry import profiler as ref_profiler

from trino_tpu_torch import caching
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.execution import tracing
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.eventlistener import EventListener
from trino_tpu_torch.telemetry import journal, metrics, profiler
from trino_tpu_torch.telemetry import runtime as rt

SF = 0.01


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """tests/test_caching.py's fresh-cache fixture, for both packages."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    for knob in ("TRINO_TPU_PLAN_CACHE", "TRINO_TPU_RESULT_CACHE",
                 "TRINO_TPU_PROFILE"):
        monkeypatch.delenv(knob, raising=False)
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_HBO", "0"), ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)
    for pkg_caching, pkg_journal in ((caching, journal),
                                     (ref_caching, ref_journal)):
        pkg_caching.reset_for_test()
        pkg_journal.reset_for_test()
    yield
    for pkg_caching, pkg_journal in ((caching, journal),
                                     (ref_caching, ref_journal)):
        pkg_caching.reset_for_test()
        pkg_journal.reset_for_test()


# ---------------------------------------------------------------------------
# metrics: one recorded sequence, both registries


def _record(pkg, seed: int):
    """Record the seed's sequence into a fresh registry of ``pkg``."""
    rng = np.random.default_rng(seed)
    reg = pkg.MetricsRegistry()
    c = reg.counter("trino_test_events_total", "events")
    g = reg.gauge("trino_test_level", "level")
    d = reg.distribution("trino_test_wall_seconds", "wall", lo=1e-3)
    d2 = reg.distribution("trino_test_bytes", "bytes", lo=1.0, growth=4.0,
                          buckets=12)
    for v in rng.lognormal(-3.0, 2.0, size=200):
        c.inc()
        d.record(float(v))
    for v in rng.integers(0, 1 << 22, size=50):
        d2.record(int(v))
        c.inc(int(v) % 7)
    g.set(float(rng.normal()))
    # a cell recorded on a thread that then dies is folded, not lost
    t = threading.Thread(target=lambda: (c.inc(5), d.record(0.25)))
    t.start()
    t.join()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prometheus_text_byte_identical(seed):
    port = _record(metrics, seed)
    ref = _record(ref_metrics, seed)
    assert port.render_prometheus() == ref.render_prometheus()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_percentiles_and_merge_equal(seed):
    port = _record(metrics, seed)
    ref = _record(ref_metrics, seed)
    ps, rs = port.snapshot(), ref.snapshot()
    assert ps == rs
    other = _record(ref_metrics, seed + 100).snapshot()
    for name in ("trino_test_wall_seconds", "trino_test_bytes"):
        port._metrics[name].merge(other[name])
        ref._metrics[name].merge(other[name])
        p, r = port._metrics[name].snapshot(), ref._metrics[name].snapshot()
        for q in ("count", "sum", "min", "max", "buckets", "p50", "p90",
                  "p99"):
            assert p[q] == r[q], (name, q)
    assert port.render_prometheus() == ref.render_prometheus()


def test_merge_snapshot_and_snapshot_render_equal():
    a, b = _record(metrics, 7).snapshot(), _record(metrics, 8).snapshot()
    ra, rb = _record(ref_metrics, 7).snapshot(), \
        _record(ref_metrics, 8).snapshot()
    metrics.merge_snapshot(a, b)
    ref_metrics.merge_snapshot(ra, rb)
    assert a == ra
    helps = {"trino_test_events_total": "events"}
    assert metrics.render_snapshot_prometheus(a, helps) == \
        ref_metrics.render_snapshot_prometheus(ra, helps)


@pytest.mark.parametrize("kind,name", [
    ("counter", "trino_no_suffix"), ("counter", "no_prefix_total"),
    ("gauge", "trino bad name"), ("distribution", "9trino_x_seconds")])
def test_name_checks_as_reference(kind, name):
    for pkg in (metrics, ref_metrics):
        with pytest.raises(ValueError):
            getattr(pkg.MetricsRegistry(), kind)(name)


def test_registry_kind_clash_raises():
    reg = metrics.MetricsRegistry()
    reg.counter("trino_clash_total")
    with pytest.raises(ValueError):
        reg.gauge("trino_clash_total")


def test_engine_metrics_are_the_references():
    """Every metric the port registers is the reference's: same name, kind
    and help text.  The resource-group gauges are registered per group
    tree when a distributed runner first admits a query, so a port runner
    that ran earlier in this process has some the reference may not have
    yet: the reference's own ``resource_group_gauges`` registers them for
    the port's group paths before the comparison."""
    prefix = "trino_resource_group_running_"
    for n, m in list(metrics.REGISTRY._metrics.items()):
        if n.startswith(prefix):
            ref_metrics.resource_group_gauges(
                m.help[len("queries running in resource group "):])
    port = {n: (m.kind, m.help) for n, m in metrics.REGISTRY._metrics.items()}
    ref = {n: (m.kind, m.help)
           for n, m in ref_metrics.REGISTRY._metrics.items()}
    assert port and all(ref.get(n) == v for n, v in port.items()), \
        [n for n, v in port.items() if ref.get(n) != v]
    for family in ("trino_scan_", "trino_exec_", "trino_encoding_",
                   "trino_queries_", "trino_cache_", "trino_device_memory_",
                   "trino_profile_", "trino_journal_", "trino_optimizer_"):
        assert any(n.startswith(family) for n in port), family


def test_device_memory_watermark_cpu_is_none():
    assert metrics.update_device_memory_watermark(torch.device("cpu")) \
        is None
    assert metrics.update_device_memory_watermark(None) is None


# ---------------------------------------------------------------------------
# tracing


def test_traceparent_round_trips_across_packages():
    span = tracing.Span("trino.query")
    header = tracing.traceparent(span)
    assert tracing.parse_traceparent(header) == (span.trace_id, span.span_id)
    assert ref_tracing.parse_traceparent(header) == \
        tracing.parse_traceparent(header)
    rspan = ref_tracing.Span("trino.query")
    rheader = ref_tracing.traceparent(rspan)
    assert tracing.parse_traceparent(rheader) == (rspan.trace_id,
                                                  rspan.span_id)


@pytest.mark.parametrize("header", [None, "", "00-abc-def-01",
                                    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",
                                    "garbage"])
def test_malformed_traceparent_is_none(header):
    assert tracing.parse_traceparent(header) is None
    assert ref_tracing.parse_traceparent(header) is None


def test_span_dict_round_trips_across_packages():
    t = tracing.Tracer()
    with t.span("trino.query", query_id="q1") as root:
        with t.span("trino.planner"):
            pass
        with t.span("trino.execution") as ex:
            ex.set("trino.scan.rows", 25)
    assert t.finished[-1] is root
    d = root.to_dict()
    back = ref_tracing.Span.from_dict(d).to_dict()
    again = tracing.Span.from_dict(back).to_dict()
    for x in (back, again):
        assert x["name"] == "trino.query"
        assert [c["name"] for c in x["children"]] == \
            ["trino.planner", "trino.execution"]
        assert x["children"][1]["attributes"] == {"trino.scan.rows": 25}
        assert x["children"][0]["parent_id"] == root.span_id
        assert x["trace_id"] == root.trace_id


def test_runner_root_span_has_execution_annotations():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    r.execute("select count(*) from nation")
    root = r.tracer.finished[-1]
    assert root.name == "trino.query"
    names = [c.name for c in root.children]
    assert names == ["trino.planner", "trino.execution"]
    ex = root.children[1]
    assert ex.attributes["trino.scan.rows"] == 25
    assert ex.attributes["trino.scan.batches"] >= 1


# ---------------------------------------------------------------------------
# the flight recorder


@pytest.fixture
def small_rings(monkeypatch):
    for pkg in (profiler, ref_profiler):
        monkeypatch.setattr(pkg, "_CAP", 8)
        pkg.reset_for_test()
    yield
    for pkg in (profiler, ref_profiler):
        pkg.reset_for_test()


def _ring_events(pkg, n: int) -> list:
    def body():
        pkg.set_context("q_ring")
        for i in range(n):
            pkg.event(pkg.OPERATOR, f"op{i}", float(i), float(i) + 0.5,
                      rows=i)
    t = threading.Thread(target=body)
    t.start()
    t.join()
    return [(e["name"], e["ts"], e["dur"], e.get("args"))
            for e in sorted(pkg.collect("q_ring"), key=lambda e: e["ts"])]


@pytest.mark.parametrize("n", [5, 8, 13, 30])
def test_ring_wrap_as_reference(small_rings, n):
    got = _ring_events(profiler, n)
    assert got == _ring_events(ref_profiler, n)
    assert len(got) == min(n, 8)
    assert got[-1][0] == f"op{n - 1}"  # the newest events survive


def test_context_reaches_threads(small_rings):
    profiler.set_context("q_ctx", "t1")
    ctx = profiler.capture_context()
    assert ctx == ("q_ctx", "t1")

    def body():
        profiler.apply_context(ctx)
        profiler.instant(profiler.SPILL, "spill.write", bytes=3)
    t = threading.Thread(target=body)
    t.start()
    t.join()
    evs = profiler.collect("q_ctx")
    assert [(e["name"], e["task"]) for e in evs] == [("spill.write", "t1")]
    profiler.set_context("")


def test_a_thread_that_records_nothing_costs_no_ring(small_rings):
    profiler.set_context("q_lazy")
    ctx = profiler.capture_context()
    n = len(profiler._RINGS)

    def idle():
        profiler.apply_context(ctx)
    t = threading.Thread(target=idle)
    t.start()
    t.join()
    assert len(profiler._RINGS) == n

    def records():
        profiler.apply_context(ctx)
        assert profiler.capture_context() == ("q_lazy", "")
        profiler.instant(profiler.STAGE, "scan.stage")
    t = threading.Thread(target=records)
    t.start()
    t.join()
    assert len(profiler._RINGS) == n + 1
    assert [e["name"] for e in profiler.collect("q_lazy")] == ["scan.stage"]
    profiler.set_context("")


def test_dead_thread_rings_are_swept_once(small_rings):
    """A harvest reads the live rings and its own query's events: a dead
    thread's ring is swept once into the store by query id and dropped,
    so the rings do not pile up with the threads the process has run."""
    def body(qid):
        profiler.set_context(qid)
        profiler.instant(profiler.OPERATOR, f"op_{qid}")
    for i in range(20):
        t = threading.Thread(target=body, args=(f"q_dead{i % 2}",))
        t.start()
        t.join()
    assert len(profiler._RINGS) >= 20
    profiler.set_context("q_dead0")
    profiler.instant(profiler.STAGE, "scan.stage")
    assert profiler.harvest("q_dead0") == 11
    assert all(profiler._alive(r) for r in profiler._RINGS)
    assert len(profiler._RINGS) == 1  # this thread's own
    assert "q_dead0" not in profiler._RETIRED
    assert len(profiler.collect("q_dead1")) == 10  # still held, by id
    assert profiler.harvest("q_dead1") == 10
    assert profiler._RETIRED == {}
    trace = profiler.chrome_trace("q_dead0")
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == 11
    profiler.set_context("")


def test_profile_store_is_bounded(small_rings):
    for i in range(profiler._MAX_PROFILES + 5):
        profiler.set_context(f"q_{i}")
        profiler.instant(profiler.OPERATOR, "x")
        profiler.harvest(f"q_{i}")
    profiler.set_context("")
    assert len(profiler._PROFILES) == profiler._MAX_PROFILES
    assert profiler.chrome_trace("q_0") is None  # evicted, rings wrapped
    assert profiler.chrome_trace(f"q_{profiler._MAX_PROFILES + 4}")


def test_off_level_records_nothing(small_rings):
    prev = profiler.set_level(0)
    try:
        profiler.set_context("q_off")
        profiler.event(profiler.OPERATOR, "x", 0.0)
        assert profiler.collect("q_off") == []
    finally:
        profiler.set_level(prev)
        profiler.set_context("")


def _trace_summary(trace: dict) -> tuple:
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    kinds = sorted({e["cat"] for e in xs})
    ops = sorted({e["name"] for e in xs if e["cat"] == "operator"})
    return kinds, ops


PROFILE_QUERIES = {
    "count": "select count(*) from nation",
    "group": "select n_regionkey, count(*) from nation group by n_regionkey",
    "join": "select r_name, count(*) from nation, region "
            "where n_regionkey = r_regionkey group by r_name",
}


@pytest.mark.parametrize("name", sorted(PROFILE_QUERIES))
def test_profile_of_one_query_through_both_runners(name):
    sql = PROFILE_QUERIES[name]
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    port.execute(sql, query_id="q_prof")
    ref.execute(sql, query_id="q_prof_ref")
    p, r = port.profile("q_prof"), ref.profile("q_prof_ref")
    assert p["otherData"]["query_id"] == "q_prof"
    assert _trace_summary(p) == _trace_summary(r)
    assert port.profile("q_unknown") is None


def test_chrome_trace_kinds_cover_stage_and_spill():
    profiler.set_context("q_kinds")
    profiler.event(profiler.STAGE, "scan.stage", 1.0, 1.5, rows=3)
    profiler.event(profiler.SPILL, "spill.write", 1.1, 1.2)
    profiler.event(profiler.OPERATOR, "ScanOperator", 1.0, 1.4)
    profiler.harvest("q_kinds")
    profiler.set_context("")
    trace = profiler.chrome_trace("q_kinds")
    cats = [e["cat"] for e in trace["traceEvents"] if e["ph"] == "X"]
    # sorted by start time, ties in recording order
    assert cats == ["batch-staged", "operator", "spill"]
    metas = [e["name"] for e in trace["traceEvents"] if e["ph"] == "M"]
    assert metas[:2] == ["process_name", "thread_name"]
    x0 = next(e for e in trace["traceEvents"] if e["ph"] == "X")
    assert x0["ts"] == 0.0 and x0["dur"] == pytest.approx(0.5e6)


def test_default_level_adds_no_host_sync():
    """Recording at the default level is a clock read and a ring store:
    the same query counts the same host syncs with the profiler off."""
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    sql = PROFILE_QUERIES["join"]
    counts = {}
    for level in (0, 1, 0, 1):
        prev = profiler.set_level(level)
        try:
            with caching.result_cache.disabled():
                before = SG.snapshot()
                r.execute(sql)
                counts.setdefault(level, []).append(
                    SG.take_delta(before).host_syncs)
        finally:
            profiler.set_level(prev)
    assert counts[0] == counts[1]


def test_full_level_on_cpu_adds_no_sync():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    prev = profiler.set_level(2)
    try:
        with caching.result_cache.disabled():
            before = SG.snapshot()
            r.execute(PROFILE_QUERIES["group"])
            delta = SG.take_delta(before)
    finally:
        profiler.set_level(prev)
    assert "profiler.full" not in delta.by_tag


# ---------------------------------------------------------------------------
# events and the runtime registry


class _Failing(EventListener):
    def query_created(self, event):
        raise RuntimeError("listener down")

    def query_completed(self, event):
        raise RuntimeError("listener down")


class _Capture(EventListener):
    def __init__(self):
        self.created, self.completed = [], []

    def query_created(self, event):
        self.created.append(event)

    def query_completed(self, event):
        self.completed.append(event)


def test_listener_failures_never_fail_a_query():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    cap = _Capture()
    r.event_listeners.add(_Failing())
    r.event_listeners.add(cap)
    assert r.execute("select count(*) from region").rows() == [(5,)]
    assert [e.query_id for e in cap.created] == \
        [e.query_id for e in cap.completed]
    ev = cap.completed[-1]
    assert ev.state == "FINISHED" and ev.output_rows == 1
    assert ev.input_rows == 5 and ev.error_code is None


def test_failed_query_event_carries_the_error_code():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    cap = _Capture()
    r.event_listeners.add(cap)
    with pytest.raises(Exception):
        r.execute("select no_such_column from region")
    ev = cap.completed[-1]
    assert ev.state == "FAILED" and ev.output_rows == -1
    assert ev.error_code and ev.error
    # query ids repeat across runners: the newest record is this one
    rec = [q for q in rt.queries() if q.query_id == ev.query_id][-1]
    assert rec.state == "FAILED" and rec.error == ev.error


def test_nation_input_rows_in_both_packages():
    """tests/test_telemetry.py's standalone check, in both packages: a
    count(*) over nation credits 25 input rows to its record."""
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    got = []
    for r in (port, ref):
        r.execute("select count(*) from nation")
        rows = r.execute("select query_id, state, input_rows "
                         "from system.runtime.queries").rows()
        fin = [row for row in rows if row[1] == "FINISHED"]
        got.append(fin[-1][2])
    assert got == [25, 25]


def test_query_metrics_count_each_statement():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    snap0 = metrics.REGISTRY.snapshot()
    r.execute("select count(*) from nation")
    with pytest.raises(Exception):
        r.execute("select broken from")
    snap1 = metrics.REGISTRY.snapshot()

    def delta(name):
        return snap1[name]["value"] - snap0[name]["value"]

    assert delta("trino_queries_started_total") == 2
    assert delta("trino_queries_finished_total") == 1
    assert delta("trino_queries_failed_total") == 1
    assert delta("trino_scan_rows_total") == 25
    assert snap1["trino_query_wall_seconds"]["count"] == \
        snap0["trino_query_wall_seconds"]["count"] + 2


def test_fingerprint_is_the_references():
    from trino_tpu.telemetry import runtime as ref_rt

    for sql in ("SELECT 1", "  select   *\nfrom Nation ", "select 'A'"):
        assert rt.fingerprint(sql) == ref_rt.fingerprint(sql)
