"""The torch port's data model and TPC-H source against the reference.

Every table the ported queries read (lineitem, orders, customer) is scanned
split by split through both packages' tpch connectors at SF 0.01; the port's
batches must equal the reference's column for column (codes, validity and
dictionaries).  The numpy interchange and the batch operations the operators
rely on are checked on seeded inputs.
"""

import numpy as np
import pytest
import torch

from trino_tpu.connectors.tpch import TpchConnector as RefTpch
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.interop import batch_from_numpy, batch_to_numpy
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT, DATE, VARCHAR, DecimalType

SF = 0.01


def _scan(conn, table):
    cols = conn.get_table_schema(table).column_names()
    for split in conn.get_splits(table, 4, 1):
        src = conn.create_page_source(split, cols)
        while not src.is_finished():
            b = src.get_next_batch()
            if b is not None:
                yield b


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer"])
def test_tpch_batches_equal_reference(table):
    ref = list(_scan(RefTpch(SF), table))
    port = list(_scan(TpchConnector(SF), table))
    assert len(ref) == len(port) > 0
    for rb, pb in zip(ref, port):
        assert rb.names == pb.names
        assert pb.live is None
        for rc, pc in zip(rb.columns, pb.columns):
            assert str(rc.type) == str(pc.type)
            np.testing.assert_array_equal(np.asarray(rc.data),
                                          pc.data.numpy())
            assert (rc.valid is None) == (pc.valid is None)
            if rc.dictionary is None:
                assert pc.dictionary is None
            else:
                np.testing.assert_array_equal(rc.dictionary, pc.dictionary)


def test_numpy_roundtrip_and_compact():
    rng = np.random.default_rng(0)
    n = 257
    names = ["k", "d", "s", "day"]
    types = [BIGINT, DecimalType(15, 2), VARCHAR, DATE]
    datas = [rng.integers(-5, 5, n), rng.integers(0, 10**6, n),
             rng.integers(0, 3, n).astype(np.int32),
             rng.integers(8000, 10000, n).astype(np.int32)]
    valids = [rng.random(n) < 0.8, None, None, rng.random(n) < 0.5]
    dicts = [None, None, np.array(["a", "b", "c"], object), None]
    live = rng.random(n) < 0.6
    b = batch_from_numpy(names, types, datas, valids, dicts, live,
                         device="cpu")
    names2, types2, datas2, valids2, dicts2, live2 = batch_to_numpy(b)
    assert names2 == names and types2 == types
    for a, c in zip(datas, datas2):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(valids2[0], valids[0])
    assert valids2[1] is None
    np.testing.assert_array_equal(live2, live)
    dense = b.compact()
    assert dense.live is None and dense.num_rows == int(live.sum())
    np.testing.assert_array_equal(dense.columns[0].data.numpy(),
                                  datas[0][live])
    rows = dense.to_pylist()
    i = int(np.nonzero(live)[0][0])
    assert rows[0][2] == dicts[2][datas[2][i]]
    assert rows[0][0] == (int(datas[0][i]) if valids[0][i] else None)


def test_concat_unifies_dictionaries_and_keeps_live():
    a = ColumnBatch(["s"], [Column(VARCHAR, np.array([0, 1], np.int32),
                                   None, np.array(["x", "z"], object))],
                    torch.tensor([True, False]))
    b = ColumnBatch(["s"], [Column(VARCHAR, np.array([0, 1], np.int32),
                                   None, np.array(["y", "z"], object))])
    c = ColumnBatch.concat([a, b], keep_live=True)
    assert list(c.columns[0].dictionary) == ["x", "y", "z"]
    assert c.columns[0].data.tolist() == [0, 2, 1, 2]
    assert c.live.tolist() == [True, False, True, True]
    assert [r[0] for r in ColumnBatch.concat([a, b]).to_pylist()] == [
        "x", "y", "z"]
