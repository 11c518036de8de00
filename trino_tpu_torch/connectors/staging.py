"""Stage TPC-H tables into the memory connector, resident on one device.

The port of the reference benchmark's table staging (``bench.py``,
``_stage_memory_tables``): the warmed tables Trino's benchto runs over.
``orders`` and ``lineitem`` are generated on the device
(:func:`~.tpch.generate_table_device`), so their rows never cross PCIe; the
small tables come from the host generator, concatenated and copied once.
Each table is stored as one batch, with the generator's statistics, and
pinned, so a query over ``memory.<table>``
(``StandaloneQueryRunner(default_catalog_name="memory",
splits_per_node=1)``) reads device memory only and plans as it does over
the tpch connector.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..spi.batch import ColumnBatch
from ..spi.connector import TableSchema
from .catalog import Catalog
from .tpch import generate_table_device

__all__ = ["stage_memory_tables"]


def _nbytes(batch: ColumnBatch) -> int:
    """Bytes of a batch's tensors (data, validity and live masks)."""
    ts = [c.data for c in batch.columns] + [
        c.valid for c in batch.columns if c.valid is not None]
    if batch.live is not None:
        ts.append(batch.live)
    return sum(t.numel() * t.element_size() for t in ts)


def _host_table(tpch, table: str, columns: list[str]) -> ColumnBatch:
    batches = []
    for split in tpch.get_splits(table, 4, 1):
        src = tpch.create_page_source(split, columns)
        while not src.is_finished():
            b = src.get_next_batch()
            if b is not None:
                batches.append(b)
    return ColumnBatch.concat(batches)


def stage_memory_tables(catalog: Catalog, tables: Sequence[str],
                        device) -> dict[str, dict]:
    """Copy each TPC-H ``table`` of the catalog's ``tpch`` connector into
    ``memory.<table>`` as one batch pinned on ``device``.  Returns, per
    table, its rows, bytes, staging seconds (device synchronized) and route
    ("device" or "host + pin").  ``device="cuda"`` raises when CUDA is not
    available."""
    dev = torch.device(device)
    tpch = catalog.connector("tpch")
    mem = catalog.connector("memory")
    out = {}
    for t in tables:
        t0 = time.perf_counter()
        schema = tpch.get_table_schema(t)
        cols = schema.column_names()
        batch = generate_table_device(tpch, t, cols, dev)
        route = "device"
        if batch is None:
            batch = _host_table(tpch, t, cols)
            route = "host + pin"
        mem.create_table(TableSchema(t, schema.columns))
        # the generator's row counts and key NDVs, as ANALYZE would record
        # them: with row counts alone the planner orders Q5's joins so that
        # a nationkey join expands 6 M lineitem rows by 6 k customers each
        mem.set_analyzed_statistics(t, tpch.get_table_statistics(t))
        mem.finish_insert(t, [[batch]])
        mem.pin_to_device(t, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[t] = {"rows": batch.num_rows, "bytes": _nbytes(batch),
                  "seconds": time.perf_counter() - t0, "route": route}
    return out
