"""Mesh-parallel relational programs: repartition = all_to_all of lanes.

The port of the reference ``parallel/distributed.py``.  The PartitionedOutput
→ Exchange data path (reference: operator/output/PagePartitioner.java:134
hash partition + HTTP page streaming) as one SPMD step over a
:class:`Mesh`: every shard holds a row slice (data parallelism over
splits), aggregates locally (PARTIAL step), hash-routes its group slots to
owner shards with :func:`all_to_all` (the FIXED_HASH_DISTRIBUTION analog),
and reduces again (FINAL step).  Broadcast joins use an all_gather of the
build side (:func:`broadcast_gather`, FIXED_BROADCAST_DISTRIBUTION —
SystemPartitioningHandle.java:52).

The mesh is a list of shards, each on a torch device; the all_to_all runs
in one process: shard d receives lane block d of every source shard
through ``.to(mesh[d], non_blocking=True)`` into one receive buffer.  On
one card that is a copy within its memory, across cards a peer copy.
:func:`make_mesh` places shard i on ``cuda:(i % device_count)``, so more
shards than cards share a card (the reference's mesh needs one device per
shard).

Capacity contract: each shard sends at most ``cap`` group slots to each
destination (lane block [n_dev, cap]); unused lanes carry a dead mask, so
a consumer receives ``n_dev * cap`` lanes per column.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .static_agg import AggSpec, combine_partials, static_grouped_agg

__all__ = ["Mesh", "make_mesh", "all_to_all", "distributed_grouped_agg",
           "broadcast_gather"]


class Mesh:
    """An ordered list of shard devices under one axis name."""

    def __init__(self, devices: Sequence[torch.device], axis: str = "x"):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = (axis,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, i: int) -> torch.device:
        return self.devices[i]

    def __iter__(self):
        return iter(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_names[0]!r})"


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis: str = "x") -> Mesh:
    """``n_devices`` shards (default: one per visible device) on the card
    (shard i on ``cuda:(i % device_count)``) or, with ``device="cpu"``, on
    the CPU.  ``device="cuda"`` raises when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): CUDA is not "
                               "available; pass device='cpu'")
        count = torch.cuda.device_count()
        n = n_devices if n_devices is not None else count
        return Mesh([torch.device("cuda", i % count) for i in range(n)],
                    axis)
    n = n_devices if n_devices is not None else 1
    return Mesh([dev] * n, axis)


def all_to_all(blocks: Sequence[Sequence[torch.Tensor]],
               mesh: Mesh) -> list[torch.Tensor]:
    """``blocks[s][d]`` is the lane block source shard s sends to shard d;
    shard d receives the concatenation over s of ``blocks[s][d]``, on
    ``mesh[d]`` (``jax.lax.all_to_all(..., tiled=False)`` flattened)."""
    return [torch.cat([blocks[s][d].to(mesh[d], non_blocking=True)
                       for s in range(len(blocks))])
            for d in range(len(mesh))]


def _route_hash(keys: Sequence[torch.Tensor], n_dev: int) -> torch.Tensor:
    """Destination shard of each slot: the reference's uint32 mix of the
    keys' low 32 bits, in int64 lanes masked to 32 bits."""
    mask = 0xFFFFFFFF
    h = torch.zeros(keys[0].shape, dtype=torch.int64,
                    device=keys[0].device)
    for k in keys:
        x = k.to(torch.int64) & mask
        h = ((h ^ x) * 0x9E3779B1) & mask
        h = h ^ (h >> 15)
    return h % n_dev


def _shards(x, mesh: Mesh) -> list[torch.Tensor]:
    """A global array as per-shard slices on the mesh's devices (axis 0
    split as ``P(axis)`` splits it), or a list already given per shard."""
    if isinstance(x, (list, tuple)):
        parts = list(x)
    else:
        parts = list(torch.tensor_split(x, len(mesh)))
    return [p.to(mesh[i], non_blocking=True) for i, p in enumerate(parts)]


def distributed_grouped_agg(
    mesh: Mesh,
    axis: str,
    key_dtypes: Sequence,
    agg_specs: Sequence[AggSpec],
    cap: int,
):
    """An SPMD step: (key columns, agg inputs, row mask) -> each shard's
    final group slots.

    Returned callable signature:
        fn(*keys, *agg_datas, row_mask) -> (out_keys, out_values, slot_used,
                                            overflow)
    Each input is a global tensor split over the shards along axis 0 (or a
    list of per-shard tensors).  Each output is the concatenation of the
    shards' ``cap`` slots on ``mesh[0]`` (each shard owns the groups that
    hash to it); ``overflow`` [n_dev] is each shard's largest group count,
    which must not exceed ``cap`` (else re-run with a bigger cap).
    """
    n_dev = mesh.shape[axis]
    nk = len(key_dtypes)

    def step(*args):
        keys = [_shards(a, mesh) for a in args[:nk]]
        datas = [_shards(a, mesh) for a in args[nk:nk + len(agg_specs)]]
        masks = _shards(args[-1], mesh)

        # ---- PARTIAL: local grouped reduction per shard --------------------
        parts = []
        for s in range(n_dev):
            parts.append(static_grouped_agg(
                [k[s] for k in keys], [None] * nk,
                [(spec, d[s], None) for spec, d in zip(agg_specs, datas)],
                cap, masks[s]))

        # ---- route: slot -> owner shard; lane (d, slot) live iff it routes
        # to d ---------------------------------------------------------------
        lane_live = []
        for p in parts:
            dest = _route_hash(p.keys, n_dev)
            lane_live.append([p.slot_used & (dest == d)
                              for d in range(n_dev)])

        def shuffle(per_shard):
            return all_to_all([[x] * n_dev for x in per_shard], mesh)

        rk = [shuffle([p.keys[i] for p in parts]) for i in range(nk)]
        rv = [shuffle([p.values[j] for p in parts])
              for j in range(len(agg_specs))]
        rvv = [None if parts[0].value_valids[j] is None else
               shuffle([p.value_valids[j] for p in parts])
               for j in range(len(agg_specs))]
        rlive = all_to_all(lane_live, mesh)

        # ---- FINAL: merge partial states from all sources ------------------
        finals = []
        for d in range(n_dev):
            finals.append(combine_partials(
                [k[d] for k in rk], [None] * nk,
                [(spec, v[d], None if vv is None else vv[d])
                 for spec, v, vv in zip(agg_specs, rv, rvv)],
                rlive[d], cap))

        def gather(per_shard):
            return torch.cat([t.to(mesh[0]) for t in per_shard])

        overflow = gather([torch.maximum(p.num_groups, f.num_groups)
                           .reshape(1) for p, f in zip(parts, finals)])
        return (tuple(gather([f.keys[i] for f in finals])
                      for i in range(nk)),
                tuple(gather([f.values[j] for f in finals])
                      for j in range(len(agg_specs))),
                gather([f.slot_used for f in finals]),
                overflow)

    return step


def broadcast_gather(mesh: Mesh, axis: str):
    """all_gather of a sharded build side — the broadcast-join distribution
    (BroadcastOutputBuffer.java:56 → one collective).  The callable takes
    the global tensor (or per-shard slices) and returns one full replica
    per shard, replica d on ``mesh[d]``."""
    n_dev = mesh.shape[axis]

    def step(x):
        parts = _shards(x, mesh)
        return all_to_all([[p] * n_dev for p in parts], mesh)

    return step
