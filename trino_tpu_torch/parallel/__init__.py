"""Distributed execution over a mesh of shards.

The port of the reference ``parallel/`` package, its replacement for
Trino's exchange data plane (reference:
operator/output/PartitionedOutputOperator.java:47 hash-shuffle +
operator/ExchangeOperator.java:44 consumer + execution/buffer/*OutputBuffer).
A mesh is an ordered list of shards, each on a torch device
(:class:`distributed.Mesh`); a repartition is an all_to_all of lane blocks
between them, run in one process: shard d receives block d of every
source shard through a device copy.  The rows never leave the devices.
The reference's ``parallel/compat.py`` (a ``jax.shard_map`` shim) has no
counterpart.
"""
