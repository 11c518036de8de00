"""The port's file connector and native page-file library.

The single-node cases of the reference's tests/test_file_connector.py on
the port (the native build, bitmap and zlib round trips, a table's
lifecycle, a table that survives a new catalog, DELETE), a failed build
that raises with the compiler's output, and two cross-package cases over
one ``file_root``: a table the reference wrote, read by the port, and a
table the port wrote, read by the reference, both giving the reference's
rows.  The reference is pinned as ROADMAP "Pinning the reference" says.
"""

import ctypes
import os
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch import native
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.file import FileConnector
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.caching import result_cache

SF = 0.01


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def runner(tmp_path):
    return StandaloneQueryRunner(
        default_catalog(SF, file_root=str(tmp_path)), device="cpu",
        session=Session(default_catalog="file"))


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def test_native_library_builds():
    lib = native.load()
    so = Path(native.lib_path())
    assert so.exists() and so.parent.name == "native"
    assert so.parent.parent.name == "build"
    assert not any(p.suffix == ".so" for p in
                   Path(native.source_path()).parent.iterdir())
    assert lib.ttp_deflate_bound(1000) >= 1000


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "pagefile.cpp"
    bad.write_text("int ttp_deflate(  // not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_SO", tmp_path / "out" / "libpagefile.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="pagefile.cpp") as e:
        native.load()
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").iterdir())  # no temp file left


def test_native_bitmap_roundtrip():
    lib = native.load()
    bools = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1], np.uint8)
    packed = np.zeros((len(bools) + 7) // 8, np.uint8)
    lib.ttp_pack_bits(_u8(bools), len(bools), _u8(packed))
    assert bytes(packed) == np.packbits(bools.astype(bool)).tobytes()
    out = np.zeros(len(bools), np.uint8)
    lib.ttp_unpack_bits(_u8(packed), len(bools), _u8(out))
    assert (out == bools).all()


def test_native_zlib_roundtrip():
    lib = native.load()
    payload = os.urandom(1000) + b"\x00" * 50_000
    src = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    cap = lib.ttp_deflate_bound(len(payload))
    dst = (ctypes.c_uint8 * cap)()
    n = lib.ttp_deflate(src, len(payload), dst, cap, 1)
    assert 0 < n < len(payload)
    assert zlib.decompress(bytes(dst[:n])) == payload
    back = (ctypes.c_uint8 * len(payload))()
    m = lib.ttp_inflate(dst, n, back, len(payload))
    assert m == len(payload) and bytes(back) == payload


def test_file_table_lifecycle(runner, tmp_path):
    runner.execute("create table ft as select n_nationkey, n_name, "
                   "n_regionkey from tpch.nation")
    assert os.path.exists(tmp_path / "ft" / "schema.json")
    rows = runner.execute(
        "select n_regionkey, count(*) from ft group by n_regionkey").rows()
    assert sorted(rows) == [(i, 5) for i in range(5)]
    runner.execute("insert into ft select n_nationkey, n_name, n_regionkey "
                   "from tpch.nation where n_regionkey = 0")
    conn = runner.catalog.connector("file")
    assert len(conn.get_splits("ft", 4, 1)) == 2  # one split per page file
    assert runner.execute("select count(*) from ft").rows() == [(30,)]
    assert conn.row_count("ft") == 30
    assert runner.execute("select n_name from ft where n_nationkey = 3 "
                          "limit 1").rows() == [("CANADA",)]
    # an INSERT of no rows leaves no page file behind
    version = conn.data_version("ft")
    runner.execute("insert into ft select n_nationkey, n_name, n_regionkey "
                   "from tpch.nation where n_regionkey > 100")
    assert conn.data_version("ft") == version
    assert len(os.listdir(tmp_path / "ft")) == 3
    runner.execute("drop table ft")
    assert runner.execute("show tables").rows() == []


def test_file_table_survives_new_catalog(tmp_path):
    root = str(tmp_path)
    a = StandaloneQueryRunner(default_catalog(SF, file_root=root),
                              device="cpu",
                              session=Session(default_catalog="file"))
    a.execute("create table keep as select r_regionkey, r_name "
              "from tpch.region")
    b = StandaloneQueryRunner(default_catalog(SF, file_root=root),
                              device="cpu",
                              session=Session(default_catalog="file"))
    assert sorted(b.execute("select r_name from keep").rows()) == [
        ("AFRICA",), ("AMERICA",), ("ASIA",), ("EUROPE",), ("MIDDLE EAST",)]


def test_delete_on_file_table(runner):
    runner.execute("create table fd as select n_nationkey, n_regionkey "
                   "from tpch.nation")
    runner.execute("analyze fd")
    runner.execute("insert into fd select n_nationkey, n_regionkey "
                   "from tpch.nation where n_regionkey = 4")
    # the rows held (30), not the analyzed count (25)
    assert runner.execute(
        "delete from fd where n_regionkey < 2").rows() == [(10,)]
    assert runner.execute("select count(*) from fd").rows() == [(20,)]


def test_the_temp_root_is_made_at_first_use():
    conn = FileConnector()
    assert conn._root is None
    root = conn.root
    try:
        assert os.path.isdir(root) and conn.list_tables() == []
    finally:
        os.rmdir(root)


def test_reads_decode_only_the_scanned_columns(runner):
    runner.execute("create table li as select * from tpch.lineitem")
    conn = runner.catalog.connector("file")
    before = conn.read_stats.frames
    rows = runner.execute("select l_returnflag, count(*) from li "
                          "group by 1 order by 1").rows()
    assert [r[0] for r in rows] == ["A", "N", "R"]
    assert sum(r[1] for r in rows) == conn.row_count("li")
    st = conn.read_stats
    assert st.frames - before == len(conn.get_splits("li", 1, 1)) >= 1
    assert st.bytes_inflated > st.bytes_read > 0


CROSS_TABLE = (
    "create table t as select o_orderkey, o_custkey, o_orderstatus, "
    "o_totalprice, o_orderdate, o_orderpriority, "
    "case when o_orderkey % 7 = 0 then null else o_comment end as c, "
    "cast(o_orderkey % 13 as double) / 3 as x from tpch.orders "
    "where o_orderkey < 20000")
CROSS_QUERIES = (
    "select * from t order by o_orderkey",
    "select o_orderpriority, count(*), sum(o_totalprice), count(c), "
    "min(o_orderdate), max(x) from t group by 1 order by 1",
)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tables_cross_packages(tmp_path, writer):
    root = str(tmp_path)
    ref = RefRunner(ref_catalog(scale_factor=SF, file_root=root),
                    session=RefSession(default_catalog="file"))
    port = StandaloneQueryRunner(default_catalog(SF, file_root=root),
                                 device="cpu",
                                 session=Session(default_catalog="file"))
    (ref if writer == "reference" else port).execute(CROSS_TABLE)
    other = port if writer == "reference" else ref
    pages = sorted(os.listdir(tmp_path / "t"))
    for sql in CROSS_QUERIES:
        want = ref.execute(sql).rows()
        assert len(want) > 0
        assert repr(other.execute(sql).rows()) == repr(want)
        assert repr(port.execute(sql).rows()) == repr(want)
    assert sorted(os.listdir(tmp_path / "t")) == pages  # reads only
