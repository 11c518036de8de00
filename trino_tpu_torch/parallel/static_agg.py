"""Fully-static grouped aggregation — no host reads.

The port of the reference ``parallel/static_agg.py``.  The operators'
grouped aggregation reads the group count to the host to size its output;
this variant promises a static group-slot capacity ``cap`` up front (TPC-H
Q1 has 4 groups; planners pick ``cap`` from table stats / NDV estimates),
so filter, project, group and reduce are device work end to end and can
sit between the all_to_all lanes of ``parallel/distributed.py``.

Group ids come from ``exec/kernels.hash_row_gids``, the ``hash_insert``
kernel on the card (its plain version on the CPU), with the group count
kept on the device.  Slot ORDER is first occurrence, as on the
reference's hash route (its sort route gives key order): callers must not
rely on slot order, and ``combine_partials`` re-groups anyway.  NaN keys
form one group (SQL semantics, the reference's hash route).

Overflow contract: if the true group count exceeds ``cap``, ``num_groups``
in the result exceeds ``cap`` — the caller must check and re-run with a
bigger cap.  ``num_groups`` is a 0-d device tensor: checking it is the
caller's one host read.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple, Optional, Sequence

import torch

from ..exec import kernels as K

__all__ = ["AggSpec", "StaticAggResult", "static_grouped_agg",
           "combine_partials"]


class AggSpec(NamedTuple):
    """One aggregate column in kernel form.

    fn: sum | count | count_star | min | max | any_value
    (avg is decomposed into sum+count by the caller); dtype: a torch dtype.
    """

    fn: str
    dtype: torch.dtype


class StaticAggResult(NamedTuple):
    keys: list  # [cap] per key column (representative values)
    key_valids: list  # [cap] bool or None per key column
    values: list  # [cap] per agg
    value_valids: list  # [cap] bool or None per agg
    slot_used: torch.Tensor  # [cap] bool — slot holds a real group
    num_groups: torch.Tensor  # 0-d int32 (may exceed cap: overflow signal)


def _sentinel(fn: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if fn == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if fn == "min" else info.min


def _any_per_slot(keep, gid, cap: int):
    """Per slot: does any live row with a value land there."""
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=gid.device)
    out.scatter_reduce_(0, gid, keep.to(torch.uint8), "amax")
    return out[:cap].bool()


def _sum_per_slot(x, gid, cap: int, dtype):
    out = torch.zeros(cap + 1, dtype=dtype, device=gid.device)
    return out.index_add_(0, gid, x.to(dtype))[:cap]


def _group_slots(keys, key_valids, cap: int, row_mask):
    """(gid, num_groups): each row's slot in [0, cap) — dead rows in slot
    ``cap``, ids past the capacity clamped into the last slot — and the
    device group count."""
    n = int(keys[0].shape[0])
    dev = keys[0].device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    live = None if row_mask is None else row_mask.contiguous()
    with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
        row_gid, num_groups = K.hash_row_gids(
            list(zip(keys, key_valids)), live=live, count_on_device=True)
    S = K.bucket(2 * max(n, 1))
    gid = torch.where(row_gid < S, torch.clamp(row_gid, max=cap - 1), cap)
    return gid.long(), num_groups


def static_grouped_agg(
    keys: Sequence[torch.Tensor],
    key_valids: Sequence[Optional[torch.Tensor]],
    agg_inputs: Sequence[tuple],  # (AggSpec, data|None, valid|None)
    cap: int,
    row_mask: Optional[torch.Tensor] = None,
) -> StaticAggResult:
    """Group rows by ``keys`` and reduce into ``cap`` slots, all on the
    keys' device.

    ``row_mask`` folds an upstream filter into the reduction (selection-
    vector style): masked-out rows land in slot ``cap`` and drop out.
    """
    n = int(keys[0].shape[0])
    dev = keys[0].device
    gid, num_groups = _group_slots(keys, key_valids, cap, row_mask)
    live = (row_mask if row_mask is not None
            else torch.ones(n, dtype=torch.bool, device=dev))

    out_keys, out_kvalids = [], []
    for k, v in zip(keys, key_valids):
        rep = torch.zeros(cap + 1, dtype=k.dtype, device=dev)
        rep[gid] = k
        out_keys.append(rep[:cap])
        out_kvalids.append(None if v is None else
                           _any_per_slot(v, gid, cap))

    values, vvalids = [], []
    for spec, data, valid in agg_inputs:
        if spec.fn == "count_star":
            values.append(_sum_per_slot(live, gid, cap, torch.int64))
            vvalids.append(None)
            continue
        keep = live if valid is None else (live & valid)
        if spec.fn == "count":
            values.append(_sum_per_slot(keep, gid, cap, torch.int64))
            vvalids.append(None)
        elif spec.fn == "sum":
            x = torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                                    device=dev))
            values.append(_sum_per_slot(x, gid, cap, spec.dtype))
            vvalids.append(_any_per_slot(keep, gid, cap))
        elif spec.fn in ("min", "max"):
            d = data.to(torch.uint8) if data.dtype == torch.bool else data
            sent = _sentinel(spec.fn, d.dtype)
            x = torch.where(keep, d, torch.full((), sent, dtype=d.dtype,
                                                device=dev))
            red = torch.full((cap + 1,), sent, dtype=d.dtype, device=dev)
            red.scatter_reduce_(0, gid, x, "amin" if spec.fn == "min"
                                else "amax")
            red = red[:cap]
            values.append(red.bool() if data.dtype == torch.bool else red)
            vvalids.append(_any_per_slot(keep, gid, cap))
        elif spec.fn == "any_value":
            rep = torch.zeros(cap + 1, dtype=data.dtype, device=dev)
            rep[torch.where(keep, gid, cap)] = data
            values.append(rep[:cap])
            vvalids.append(_any_per_slot(keep, gid, cap))
        else:
            raise NotImplementedError(spec.fn)

    slot_used = torch.arange(cap, device=dev) < num_groups
    return StaticAggResult(out_keys, out_kvalids, values, vvalids, slot_used,
                           num_groups)


_COMBINE = {"sum": "sum", "count": "sum", "count_star": "sum",
            "min": "min", "max": "max", "any_value": "any_value"}


def combine_partials(
    keys: Sequence[torch.Tensor],
    key_valids: Sequence[Optional[torch.Tensor]],
    partial_inputs: Sequence[tuple],  # (AggSpec, values, valid|None)
    slot_used: torch.Tensor,
    cap: int,
) -> StaticAggResult:
    """FINAL step: re-group partial state rows by key, merge states
    (sum→sum, count→sum, min→min …) — Trino's partial/final split
    (AggregationNode.Step PARTIAL/FINAL)."""
    merged = []
    for spec, vals, valid in partial_inputs:
        merged.append((AggSpec(_COMBINE[spec.fn], spec.dtype), vals, valid))
    return static_grouped_agg(keys, key_valids, merged, cap,
                              row_mask=slot_used)
