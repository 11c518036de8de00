"""Benchmark kernels: the fused TPC-H Q1 program (one device + SPMD).

The port of the reference ``bench_kernels.py``.  Q1 = scan(lineitem) →
filter(shipdate <= cutoff) → project(disc_price, charge) → group by
(returnflag, linestatus) → 7 sums/counts.  In the engine this is
ScanFilterAndProjectOperator + HashAggregationOperator; here the filter
becomes a row mask folded into the reduction (no compaction), money
columns are decimal-scaled int64 summed in float64 lanes, and the group
table is 8 static slots of ``parallel/static_agg.py`` (``hash_insert`` on
the card).  :func:`q1_spmd` runs the same step over a mesh through
``parallel/distributed.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .parallel.distributed import distributed_grouped_agg
from .parallel.static_agg import AggSpec, static_grouped_agg

__all__ = ["Q1Batch", "make_q1_inputs", "q1_step", "q1_spmd", "q1_numpy"]

Q1_CUTOFF_DAYS = 10471  # date '1998-12-01' - interval '90' day = 1998-09-02

_SPECS = [
    AggSpec("sum", torch.float64),   # sum_qty
    AggSpec("sum", torch.float64),   # sum_base_price
    AggSpec("sum", torch.float64),   # sum_disc_price
    AggSpec("sum", torch.float64),   # sum_charge
    AggSpec("sum", torch.float64),   # sum_discount (for avg_disc)
    AggSpec("count_star", torch.int64),  # count_order (and avg divisors)
]

_COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate"]


class Q1Batch(NamedTuple):
    returnflag: torch.Tensor  # int32 codes
    linestatus: torch.Tensor  # int32 codes
    quantity: torch.Tensor    # int64 scale-2
    extendedprice: torch.Tensor  # int64 scale-2
    discount: torch.Tensor    # int64 scale-2
    tax: torch.Tensor         # int64 scale-2
    shipdate: torch.Tensor    # int32 days


def make_q1_inputs(sf: float, device="cuda") -> Q1Batch:
    """The Q1 columns of lineitem at scale factor ``sf``, generated on
    ``device`` by the tpch connector's device generator (values
    bit-identical to the host generator's).  ``device="cuda"`` raises when
    CUDA is not available."""
    from .connectors.tpch import TpchConnector, generate_table_device

    b = generate_table_device(TpchConnector(scale_factor=sf), "lineitem",
                              _COLUMNS, device)
    return Q1Batch(*[b.column(c).data for c in _COLUMNS])


def _q1_project(b: Q1Batch):
    mask = b.shipdate <= Q1_CUTOFF_DAYS
    qty = b.quantity.to(torch.float64)
    price = b.extendedprice.to(torch.float64)
    disc = b.discount.to(torch.float64)
    tax = b.tax.to(torch.float64)
    disc_price = price * (100.0 - disc) / 100.0
    charge = disc_price * (100.0 + tax) / 100.0
    keys = [b.returnflag, b.linestatus]
    datas = [qty, price, disc_price, charge, disc, qty]
    return keys, datas, mask


def q1_step(b: Q1Batch):
    """Fused Q1 on the batch's device, 8 group slots: (keys, values,
    slot_used)."""
    keys, datas, mask = _q1_project(b)
    agg_inputs = [(s, d, None) for s, d in zip(_SPECS, datas)]
    r = static_grouped_agg(keys, [None, None], agg_inputs, cap=8,
                           row_mask=mask)
    return tuple(r.keys), tuple(r.values), r.slot_used


def q1_spmd(mesh, axis: str = "x"):
    """SPMD Q1 over a mesh: row shards -> partial agg -> all_to_all
    repartition of group slots -> final agg."""
    inner = distributed_grouped_agg(
        mesh, axis, [torch.int32, torch.int32], _SPECS, cap=8)

    def step(b: Q1Batch):
        keys, datas, mask = _q1_project(b)
        return inner(*keys, *datas, mask)

    return step


def q1_numpy(b: Q1Batch):
    """Reference single-thread numpy implementation (the CPU baseline):
    (sorted fused keys rf * 1000 + ls, {name: per-key sums / counts})."""
    b = Q1Batch(*[x.cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in b])
    mask = b.shipdate <= Q1_CUTOFF_DAYS
    rf = b.returnflag[mask]
    ls = b.linestatus[mask]
    qty = b.quantity[mask].astype(np.float64)
    price = b.extendedprice[mask].astype(np.float64)
    disc = b.discount[mask].astype(np.float64)
    tax = b.tax[mask].astype(np.float64)
    disc_price = price * (100.0 - disc) / 100.0
    charge = disc_price * (100.0 + tax) / 100.0
    key = rf.astype(np.int64) * 1000 + ls
    uniq, inv = np.unique(key, return_inverse=True)
    out = {}
    for name, col in (("qty", qty), ("price", price),
                      ("disc_price", disc_price), ("charge", charge),
                      ("disc", disc)):
        acc = np.zeros(len(uniq))
        np.add.at(acc, inv, col)
        out[name] = acc
    out["count"] = np.bincount(inv, minlength=len(uniq))
    return uniq, out
