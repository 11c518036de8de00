"""Polymorphic table function SPI + built-ins.

The port's own copy of the reference ``spi/table_function.py``.  Mirrors ``spi/function/table/ConnectorTableFunction.java`` (analyze
arguments -> returned-type descriptor) and the leaf execution side
(``operator/LeafTableFunctionOperator.java:41``).  A table function binds
its (constant) arguments at plan time, fixing the output schema; execution
pulls batches of at most 65,536 rows from a generator (host columns; the
operator moves each one to the runner's device).

Built-ins: ``sequence(start, stop[, step])`` (reference:
operator/table/SequenceFunction.java).  Table-valued arguments
(exclude_columns, json_table) need TABLE(...) argument plumbing — a later
round."""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np

from .batch import Column, ColumnBatch
from .types import BIGINT, Type

__all__ = ["TableFunction", "BoundTableFunction", "builtin_table_functions"]

_BATCH = 1 << 16


class BoundTableFunction:
    """A table function with arguments resolved: fixed schema + batch source."""

    def __init__(self, names: Sequence[str], types: Sequence[Type],
                 batches: Callable[[], Iterator[ColumnBatch]]):
        self.names = list(names)
        self.types = list(types)
        self.batches = batches


class TableFunction:
    name: str = ""

    def bind(self, args: Sequence) -> BoundTableFunction:
        """``args`` are python constants (plan-time literals)."""
        raise NotImplementedError


class SequenceFunction(TableFunction):
    """TABLE(sequence(start, stop[, step])) -> sequential_number BIGINT
    (reference: operator/table/SequenceFunction.java — stop is inclusive)."""

    name = "sequence"

    def bind(self, args: Sequence) -> BoundTableFunction:
        if not 1 <= len(args) <= 3:
            raise ValueError("sequence(start, stop[, step])")
        if len(args) == 1:
            start, stop, step = 0, int(args[0]), 1
        else:
            start, stop = int(args[0]), int(args[1])
            step = int(args[2]) if len(args) > 2 else (
                1 if stop >= start else -1)
        if step == 0:
            raise ValueError("sequence step must not be zero")

        def gen() -> Iterator[ColumnBatch]:
            cur = start
            while (cur <= stop) if step > 0 else (cur >= stop):
                n = min(_BATCH, (stop - cur) // step + 1)
                data = np.arange(cur, cur + n * step, step, dtype=np.int64)
                yield ColumnBatch(["sequential_number"],
                                  [Column(BIGINT, data)])
                cur += n * step

        return BoundTableFunction(["sequential_number"], [BIGINT], gen)


def builtin_table_functions() -> dict[str, TableFunction]:
    fns = [SequenceFunction()]
    return {f.name: f for f in fns}
