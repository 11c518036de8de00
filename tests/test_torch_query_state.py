"""The port's write-ahead query-state log (execution/query_state.py),
resume, and spool retention (execution/spool_gc.py) against the
reference.

The reference's tests/test_query_state.py cases that need no worker
process (the WAL lifecycle, the torn tail and the discard, the session
restore, a resume that re-executes no committed attempt) and the seven
cases of tests/test_spool_gc.py (CRC framing, the spool writer's v2
header, leases, sweep rules, the byte budget) run on the port.  The WAL
a port query writes is read by the reference's loader to the same
committed map and attempt counts, and the port's resumed query gives the
rows the reference's FTE run gives.  The dispatcher's boot recovery and
the kill -9 drills wait for worker processes (ROADMAP queue 1 item 5).
"""

import json
import os
import struct
import time

import pytest
import torch

from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import query_state as ref_qs
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution import query_state, spool_gc
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.execution.failure_injector import (TASK_FAILURE,
                                                        FailureInjector)
from trino_tpu_torch.execution.serde import (SPOOL_STREAM_MAGIC,
                                             SpoolCorruptionError,
                                             iter_frames, write_frame,
                                             write_frame_crc,
                                             write_stream_header)
from trino_tpu_torch.runner import Session

SF = 0.01
SQL = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
       "group by l_returnflag order by l_returnflag")
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)
    with result_cache.disabled(), ref_result_cache.disabled():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def state_env(tmp_path, monkeypatch):
    state = tmp_path / "query-state"
    spool = tmp_path / "spool"
    spool.mkdir()
    monkeypatch.setenv("TRINO_TPU_QUERY_STATE", "1")
    monkeypatch.setenv("TRINO_TPU_QUERY_STATE_DIR", str(state))
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(spool))
    return str(state), str(spool)


# ------------------------------------------------------------------ WAL
def test_wal_lifecycle_and_load(tmp_path):
    wal = query_state.QueryStateLog("q1", dir=str(tmp_path))
    wal.begin("select 1", {"plan": 1}, "/spool/root", Session(),
              task_counts={2: 2, 1: 2}, consumer_tasks={2: 2})
    wal.attempt_start(2, 0, 0, "STANDARD")
    wal.attempt_start(2, 1, 0, "STANDARD")
    wal.attempt_committed(2, 1, 0, "/spool/root/f2_t1/attempt-0",
                          "STANDARD")
    wal.close()
    pq = query_state.load(wal.path)
    assert pq.query_id == "q1" and pq.sql == "select 1" and pq.resumable
    assert pq.committed == {(2, 1): {
        "attempt": 0, "dir": "/spool/root/f2_t1/attempt-0",
        "kind": "STANDARD"}}
    assert pq.attempt_counts == {(2, 0): 1, (2, 1): 1}
    assert pq.fingerprint and pq.plan_b64
    assert query_state.decode_plan(pq.plan_b64) == {"plan": 1}
    assert pq.shape_matches({2: 2, 1: 2}, {2: 2})
    assert not pq.shape_matches({2: 4, 1: 2}, {2: 2})
    # the reference reads the port's log to the same state
    rq = ref_qs.load(wal.path)
    assert (rq.committed, rq.attempt_counts, rq.task_counts,
            rq.session_fields) == (pq.committed, pq.attempt_counts,
                                   pq.task_counts, pq.session_fields)
    assert ref_qs.decode_plan(rq.plan_b64) == {"plan": 1}
    wal2 = query_state.QueryStateLog("q1", dir=str(tmp_path))
    wal2.end("FINISHED")
    wal2.close()
    assert query_state.load(wal.path).ended == "FINISHED"
    assert not query_state.load(wal.path).resumable
    assert query_state.prune_ended(str(tmp_path)) == 1
    assert not os.path.exists(wal.path)


def test_wal_torn_tail_and_discard(tmp_path):
    wal = query_state.QueryStateLog("q2", dir=str(tmp_path))
    wal.begin("select 2", {"plan": 2}, "/s", Session())
    wal.attempt_committed(0, 0, 0, "/s/f0_t0/attempt-0", "STANDARD")
    wal.attempt_committed(1, 0, 0, "/s/f1_t0/attempt-0", "STANDARD")
    wal.attempt_discarded(1, 0, "spool corruption")
    wal.close()
    with open(wal.path, "a", encoding="utf-8") as f:
        f.write('{"event": "attempt_com')
    pq = query_state.load(wal.path)
    assert pq.resumable and set(pq.committed) == {(0, 0)}
    assert query_state.pending(str(tmp_path))[0].query_id == "q2"
    query_state.discard("q2", str(tmp_path))
    assert query_state.pending(str(tmp_path)) == []


def test_restore_session_replays_only_known_fields(tmp_path):
    wal = query_state.QueryStateLog("q3", dir=str(tmp_path))
    wal.begin("select 3", {"plan": 3}, "/s",
              Session(node_count=7, retry_policy="TASK",
                      task_retry_attempts=9,
                      properties={"writer_task_limit": 2}))
    wal.close()
    pq = query_state.load(wal.path)
    # the same fields the reference records
    rwal = ref_qs.QueryStateLog("q3r", dir=str(tmp_path))
    rwal.begin("select 3", {"plan": 3}, "/s",
               RefSession(node_count=7, retry_policy="TASK",
                          task_retry_attempts=9, writer_task_limit=2))
    rwal.close()
    assert pq.session_fields == ref_qs.load(rwal.path).session_fields
    pq.session_fields["not_a_field"] = "ignored"
    sess = query_state.restore_session(pq)
    assert sess.node_count == 7 and sess.retry_policy == "TASK"
    assert sess.task_retry_attempts == 9
    assert sess.get("writer_task_limit") == 2


def test_resume_skips_committed_attempts(state_env):
    """Coordinator death mid-query in miniature: the query fails after
    some stages committed with the WAL's terminal record and the spool
    release suppressed (the state a kill -9 leaves); a fresh runner
    resumes it, re-running no committed attempt, to the reference's
    rows."""
    state_dir, _spool = state_env
    inj = FailureInjector()
    r1 = DistributedQueryRunner(
        default_catalog(SF), worker_count=2, device="cpu",
        session=Session(node_count=2, retry_policy="TASK",
                        failure_injector=inj, fte_speculative=False,
                        task_retry_attempts=1))
    fragments = r1.create_subplan(SQL).all_fragments()
    non_leaf = [f.id for f in fragments if f.source_fragments]
    inj.inject(TASK_FAILURE, fragment_id=non_leaf[-1], task_index=None,
               attempt=None, times=10)
    crash = pytest.MonkeyPatch()
    crash.setattr(query_state.QueryStateLog, "end",
                  lambda self, *a, **kw: None)
    crash.setattr(spool_gc, "release", lambda root: 0)
    try:
        with pytest.raises(Exception):
            r1.execute(SQL)
    finally:
        crash.undo()
    pending = r1.pending_fte_recoveries()
    assert len(pending) == 1
    pq = pending[0]
    assert pq.resumable and len(pq.committed) >= 1
    starts_before = dict(pq.attempt_counts)
    committed = set(pq.committed)
    r2 = DistributedQueryRunner(
        default_catalog(SF), worker_count=2, device="cpu",
        session=Session(node_count=2, retry_policy="TASK"))
    got = r2.resume_fte_query(pq).rows()
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=2,
                  session=RefSession(node_count=2, retry_policy="TASK"))
    want = ref.execute(SQL, query_id="ref_run").batch.to_pylist()
    assert got == [tuple(r) for r in want]
    final = query_state.load(pq.path)
    assert final.ended == "FINISHED"
    for key in committed:
        assert final.attempt_counts.get(key, 0) == starts_before.get(key, 0)
    assert any(final.attempt_counts.get(k, 0) > starts_before.get(k, 0)
               for k in final.attempt_counts)
    assert ref_qs.load(pq.path).attempt_counts == final.attempt_counts


# ------------------------------------------------------------ spool_gc
def test_v2_roundtrip_and_v1_autodetect(tmp_path):
    pages = [b"alpha", b"", b"x" * 4096]
    v2 = tmp_path / "v2.bin"
    with open(v2, "wb") as f:
        write_stream_header(f)
        for p in pages:
            write_frame_crc(f, p)
    with open(v2, "rb") as f:
        assert list(iter_frames(f, str(v2))) == pages
    v1 = tmp_path / "v1.bin"
    with open(v1, "wb") as f:
        for p in pages:
            write_frame(f, p)
    with open(v1, "rb") as f:
        assert list(iter_frames(f, str(v1))) == pages


def test_v2_bit_flip_detected(tmp_path):
    path = tmp_path / "flip.bin"
    with open(path, "wb") as f:
        write_stream_header(f)
        write_frame_crc(f, b"payload-bytes")
    raw = bytearray(path.read_bytes())
    raw[12] ^= 0x01
    path.write_bytes(bytes(raw))
    with open(path, "rb") as f:
        with pytest.raises(SpoolCorruptionError) as ei:
            list(iter_frames(f, str(path)))
    assert "CRC32" in str(ei.value) and ei.value.path == str(path)
    assert ei.value.is_retryable()


def test_v2_torn_write_detected(tmp_path):
    path = tmp_path / "torn.bin"
    with open(path, "wb") as f:
        write_stream_header(f)
        write_frame_crc(f, b"will be cut short")
    path.write_bytes(path.read_bytes()[:-5])
    with open(path, "rb") as f:
        with pytest.raises(SpoolCorruptionError):
            list(iter_frames(f, str(path)))
    hdr_only = tmp_path / "hdr.bin"
    hdr_only.write_bytes(SPOOL_STREAM_MAGIC + struct.pack("<I", 9))
    with open(hdr_only, "rb") as f:
        with pytest.raises(SpoolCorruptionError):
            list(iter_frames(f, str(hdr_only)))


def test_durable_spool_writes_v2(tmp_path):
    from trino_tpu_torch.execution.durable_spool import DurableSpoolWriter

    w = DurableSpoolWriter(str(tmp_path / "f0_t0"), attempt=0,
                           num_partitions=1)
    w.set_finished()
    with open(os.path.join(w.committed, "part-0.bin"), "rb") as f:
        assert f.read(4) == SPOOL_STREAM_MAGIC


def _mkroot(base, name, nbytes=64, lease=None, mtime=None):
    root = base / name
    root.mkdir()
    (root / "part-0.bin").write_bytes(b"\0" * nbytes)
    if lease is not None:
        spool_gc.acquire(str(root), **lease)
    if mtime is not None:
        os.utime(root, (mtime, mtime))
    return str(root)


def test_release_reclaims_now(tmp_path):
    root = _mkroot(tmp_path, "trino-tpu-spool-a", lease={"query_id": "q1"})
    assert spool_gc.release(root) > 0
    assert not os.path.exists(root)
    assert spool_gc.release(root) == 0


def test_sweep_rules(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path))
    monkeypatch.setenv("TRINO_TPU_SPOOL_TTL_S", "3600")
    now = time.time()
    pinned = _mkroot(tmp_path, "trino-tpu-spool-pinned",
                     lease={"query_id": "qp", "ttl_s": 1.0})
    live = _mkroot(tmp_path, "trino-tpu-spool-live",
                   lease={"query_id": "ql"})
    dead = _mkroot(tmp_path, "trino-tpu-spool-dead")
    spool_gc.acquire(dead, "qd")
    lp = os.path.join(dead, spool_gc.LEASE_FILE)
    rec = json.load(open(lp))
    rec["pid"] = 2 ** 22 + 12345
    json.dump(rec, open(lp, "w"))
    expired = _mkroot(tmp_path, "trino-tpu-spool-expired",
                      lease={"query_id": "qe", "ttl_s": 0.001})
    stale = _mkroot(tmp_path, "trino-tpu-spool-stale", mtime=now - 7200)
    fresh = _mkroot(tmp_path, "trino-tpu-spool-fresh", mtime=now - 10)
    other = tmp_path / "unrelated-dir"
    other.mkdir()
    out = spool_gc.sweep(keep=[pinned], now=now + 5.0)
    assert pinned in out["kept"] and live in out["kept"]
    assert fresh in out["kept"]
    for root in (dead, expired, stale):
        assert root in out["reclaimed"] and not os.path.exists(root)
    assert other.exists() and out["live_bytes"] > 0


def test_sweep_byte_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path))
    monkeypatch.setenv("TRINO_TPU_SPOOL_TTL_S", "86400")
    monkeypatch.setenv("TRINO_TPU_SPOOL_MAX_BYTES", "1500")
    now = time.time()
    old = _mkroot(tmp_path, "trino-tpu-spool-old", nbytes=1000,
                  mtime=now - 500)
    new = _mkroot(tmp_path, "trino-tpu-spool-new", nbytes=1000,
                  mtime=now - 100)
    out = spool_gc.sweep(now=now)
    assert old in out["reclaimed"] and not os.path.exists(old)
    assert new in out["kept"] and os.path.exists(new)
    assert out["live_bytes"] == 1000
