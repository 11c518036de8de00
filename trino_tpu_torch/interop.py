"""Numpy <-> batch interchange.

The port's stand-in for carrying weights across from the JAX package: a
reference function and its port are fed the same numpy arrays (made from a
seed), and results come back as numpy for comparison.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .spi.batch import Column, ColumnBatch, as_tensor
from .spi.types import Type

__all__ = ["batch_from_numpy", "batch_to_numpy"]


def batch_from_numpy(names: Sequence[str], types: Sequence[Type],
                     datas: Sequence[np.ndarray],
                     valids: Optional[Sequence[Optional[np.ndarray]]] = None,
                     dictionaries: Optional[Sequence] = None,
                     live: Optional[np.ndarray] = None, *,
                     device) -> ColumnBatch:
    """Build a batch on ``device`` (which the caller names) from numpy
    columns (None = all valid / no dictionary / every row live)."""
    n = len(names)
    valids = list(valids) if valids is not None else [None] * n
    dictionaries = (list(dictionaries) if dictionaries is not None
                    else [None] * n)
    cols = [Column(t, as_tensor(np.asarray(d, t.storage_dtype), device),
                   None if v is None else as_tensor(np.asarray(v, bool),
                                                    device),
                   dct)
            for t, d, v, dct in zip(types, datas, valids, dictionaries)]
    return ColumnBatch(list(names), cols,
                       None if live is None
                       else as_tensor(np.asarray(live, bool), device))


def batch_to_numpy(batch: ColumnBatch):
    """(names, types, datas, valids, dictionaries, live) as host numpy;
    LAZY and RLE columns are materialized."""
    datas = [c.data.cpu().numpy() for c in batch.columns]
    valids = [None if c.valid is None else c.valid.cpu().numpy()
              for c in batch.columns]
    return (list(batch.names), list(batch.types), datas, valids,
            [c.dictionary for c in batch.columns],
            None if batch.live is None else batch.live.cpu().numpy())
