"""The port's device-side TPC-H generator against the reference's.

``generate_table_device`` of the port (torch ops on an explicit device)
must give the reference's values (``trino_tpu``'s jitted generator, run by
JAX on the CPU as tests/test_tpch_device_gen.py runs it) and the port's
host generator's, every column decoded and exact, at SF 0.01.  Here the
port runs on the CPU.  The splitmix64 arithmetic the generator runs as
int64 bit patterns must equal numpy's uint64 version, keys with the top
bit set included.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from trino_tpu.connectors.tpch import TpchConnector as RefTpch
from trino_tpu.connectors.tpch import generate_table_device as ref_generate
from trino_tpu_torch.connectors import tpch as T
from trino_tpu_torch.connectors.tpch import (TpchConnector,
                                              generate_table_device)

SF = 0.01
TABLES = ("orders", "lineitem")


def _decoded(col, n=None):
    data = np.asarray(col.data.cpu() if isinstance(col.data, torch.Tensor)
                      else col.data)[:n]
    return col.dictionary[data] if col.dictionary is not None else data


def _host(conn, table, cols):
    return conn._generate(table, cols, 0, conn.row_count("orders"))


@pytest.fixture(scope="module")
def generated():
    """table -> (port device batch, reference device batch, port host
    batch), each from its own connector."""
    out = {}
    for t in TABLES:
        cols = T.SCHEMAS[t].column_names()
        out[t] = (generate_table_device(TpchConnector(SF), t, cols, "cpu"),
                  ref_generate(RefTpch(scale_factor=SF), t, cols),
                  _host(TpchConnector(SF), t, cols))
    return out


@pytest.mark.parametrize("table", TABLES)
def test_device_generator_matches_reference(generated, table):
    dev, ref, _ = generated[table]
    n = TpchConnector(SF).row_count(table)
    assert dev.num_rows == n and dev.live is None
    if ref.live is not None:  # the reference pads to a power of two
        assert np.asarray(ref.live)[:n].all()
        assert int(np.asarray(ref.live).sum()) == n
    for name in T.SCHEMAS[table].column_names():
        np.testing.assert_array_equal(
            _decoded(dev.column(name)), _decoded(ref.column(name), n),
            err_msg=f"{table}.{name}: port != reference")


@pytest.mark.parametrize("table", TABLES)
def test_device_generator_matches_host_generator(generated, table):
    dev, _, host = generated[table]
    assert dev.num_rows == host.num_rows
    for name in T.SCHEMAS[table].column_names():
        d, h = dev.column(name), host.column(name)
        assert d.data.dtype == h.data.dtype, name
        assert d.valid is None and h.valid is None
        np.testing.assert_array_equal(_decoded(d), _decoded(h),
                                      err_msg=f"{table}.{name}")


def test_generated_dictionaries_are_the_sorted_vocabularies(generated):
    dev = generated["lineitem"][0]
    assert list(dev.column("l_shipmode").dictionary) == sorted(T._SHIPMODES)
    d = dev.column("l_comment").dictionary
    assert len(d) == len(T._comment_vocab())
    assert (d[1:] > d[:-1]).all()
    clerks = generated["orders"][0].column("o_clerk").dictionary
    assert len(clerks) == max(1, int(1000 * SF)) and clerks[0] == "Clerk#000000001"


def test_other_tables_and_missing_cuda():
    conn = TpchConnector(SF)
    assert generate_table_device(conn, "customer", ["c_custkey"], "cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate_table_device(conn, "orders", ["o_orderkey"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate_table_device(conn, "orders", ["o_orderkey"], "cuda")


def test_projection_generates_only_the_asked_columns():
    conn = TpchConnector(SF)
    b = generate_table_device(conn, "lineitem", ["l_shipmode", "l_orderkey"],
                              "cpu")
    assert b.names == ["l_shipmode", "l_orderkey"]
    full = _host(conn, "lineitem", ["l_shipmode", "l_orderkey"])
    for name in b.names:
        np.testing.assert_array_equal(_decoded(b.column(name)),
                                      _decoded(full.column(name)))


@pytest.mark.parametrize("first", ["host", "device"])
def test_host_scan_unchanged_by_device_generation(first):
    """The generator leaves the connector's dictionaries alone: a host scan
    gives the same codes and dictionaries whether it runs before or after
    the device generator on the same connector."""
    cols = ["o_orderstatus", "o_comment", "o_clerk", "o_orderpriority"]
    conn = TpchConnector(SF)
    if first == "host":
        before = _host(conn, "orders", cols)
        generate_table_device(conn, "orders", cols, "cpu")
        after = _host(conn, "orders", cols)
    else:
        generate_table_device(conn, "orders", cols, "cpu")
        after = _host(conn, "orders", cols)
        before = _host(TpchConnector(SF), "orders", cols)
    for name in cols:
        b, a = before.column(name), after.column(name)
        assert torch.equal(a.data, b.data), name
        assert list(a.dictionary) == list(b.dictionary), name


_U64 = st.integers(min_value=0, max_value=2**64 - 1)


@settings(max_examples=60, deadline=None)
@given(keys=st.lists(_U64, min_size=1, max_size=32),
       stream=st.integers(min_value=0, max_value=1000),
       lo=st.integers(min_value=-10**6, max_value=10**6),
       span=st.integers(min_value=0, max_value=2**61))
def test_h64_and_randint_match_numpy(keys, stream, lo, span):
    u = np.array(keys, dtype=np.uint64)
    t = torch.from_numpy(u.view(np.int64).copy())
    np.testing.assert_array_equal(T._h64_t(t, stream).numpy(),
                                  T._h64(u, stream).view(np.int64))
    np.testing.assert_array_equal(T._randint_t(t, stream, lo, lo + span).numpy(),
                                  T._randint(u, stream, lo, lo + span))


def test_h64_and_randint_match_numpy_seeded():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2**64, size=200_000, dtype=np.uint64)
    u[:4] = [0, 2**63 - 1, 2**63, 2**64 - 1]
    assert (u >= 2**63).sum() > 90_000  # the top bit set on about half
    t = torch.from_numpy(u.view(np.int64).copy())
    for stream in (0, 11, 72, 9 * 7 + 4):
        np.testing.assert_array_equal(T._h64_t(t, stream).numpy(),
                                      T._h64(u, stream).view(np.int64))
        for lo, hi in ((1, 7), (0, 999_999), (-99999, 999999), (0, 2**62 - 1)):
            np.testing.assert_array_equal(
                T._randint_t(t, stream, lo, hi).numpy(),
                T._randint(u, stream, lo, hi))
