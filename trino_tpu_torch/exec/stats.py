"""Per-operator execution statistics (the OperatorStats equivalent).

The Driver credits wall time, rows and batches to each operator as it moves
batches (reference: operator/OperatorStats.java, the port of
``exec/stats.py`` without its scan-ingest, sync, resilience, fused,
resident, adaptive and encoding counters).  Rows are live rows: on the
card a masked batch's count is a device reduction, so the driver adds
the counts up as tensors and :meth:`QueryStats.read_counts` reads them
all once the run has ended.  Device work is asynchronous, so a
:class:`QueryStats` created with ``sync`` set synchronizes the device
after every operator call: the times then charge each operator its own
device work, at the cost of the overlap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class OperatorStats:
    name: str
    input_rows: int = 0
    output_rows: int = 0
    input_batches: int = 0
    output_batches: int = 0
    wall_s: float = 0.0


@dataclass
class PipelineStats:
    operators: list[OperatorStats] = field(default_factory=list)


@dataclass
class QueryStats:
    pipelines: list[PipelineStats] = field(default_factory=list)
    sync: bool = False  # synchronize the device after each operator call

    def by_operator(self) -> dict[str, float]:
        """Wall seconds summed per operator class name."""
        out: dict[str, float] = {}
        for p in self.pipelines:
            for o in p.operators:
                out[o.name] = out.get(o.name, 0.0) + o.wall_s
        return out

    def read_counts(self) -> None:
        """Replace row counts held as device tensors by ints: one host
        read per device."""
        slots: dict = {}
        for p in self.pipelines:
            for o in p.operators:
                for attr in ("input_rows", "output_rows"):
                    v = getattr(o, attr)
                    if isinstance(v, torch.Tensor):
                        slots.setdefault(v.device, []).append((o, attr, v))
        for items in slots.values():
            values = torch.stack([v for _, _, v in items]).tolist()
            for (o, attr, _), n in zip(items, values):
                setattr(o, attr, int(n))

    def text(self) -> str:
        """The per-operator lines of EXPLAIN ANALYZE."""
        lines = []
        for i, p in enumerate(self.pipelines):
            lines.append(f"  pipeline {i}:")
            for op in p.operators:
                lines.append(
                    f"    {op.name}: {op.wall_s * 1e3:.1f} ms, "
                    f"in {op.input_rows} rows/{op.input_batches} batches, "
                    f"out {op.output_rows} rows/{op.output_batches} batches")
        return "\n".join(lines)
