"""The ``TRINO_TPU_*`` environment knobs the port reads.

The port's copy of the reference ``spi/knobs.py``: the same table of
declared knobs (name, type, default in its environment string form, one
line of doc) and the same typed accessors, which raise :class:`KeyError`
on an undeclared name.  Only the rows the port reads are declared: the
switches and sizes of the cache plane (caching/), the flight recorder's
level and ring (telemetry/profiler.py), the query journal
(telemetry/journal.py) and the exchange's stall watchdog
(execution/task.py).  Both packages read the same variables, so one
setting reaches both (a harness that sets ``TRINO_TPU_RESULT_CACHE=0``
turns the result tier off in each).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Knob", "KNOBS", "declared", "knob", "get_str", "get_int",
           "get_float", "get_bool"]


@dataclass(frozen=True)
class Knob:
    """One declared environment knob.  ``default`` is the *string* form as
    the environment would carry it ("" = unset, code-side fallback
    applies); ``type`` is one of ``str | int | float | bool | enum | json
    | path``."""

    name: str
    type: str
    default: str
    doc: str
    choices: Optional[tuple] = None


_DECLARATIONS = (
    Knob("TRINO_TPU_EXCHANGE_STALL_S", "float", "1800",
         "Exchange take() stall watchdog: a source that produces nothing "
         "for this long fails the take with PAGE_TRANSPORT_TIMEOUT."),
    Knob("TRINO_TPU_EXEC_CACHE", "bool", "1",
         "Tier B executable-registry switch; 0 keeps each memo bounded "
         "but out of the registry and its counters."),
    Knob("TRINO_TPU_EXEC_CACHE_ENTRIES", "int", "256",
         "LRU capacity (entries) of each registered executable memo."),
    Knob("TRINO_TPU_JOURNAL", "bool", "1",
         "Durable query journal (JSONL EventListener); 0 disables."),
    Knob("TRINO_TPU_JOURNAL_DIR", "path", "",
         "Journal directory; unset uses a per-uid tempdir."),
    Knob("TRINO_TPU_JOURNAL_FILES", "int", "3",
         "Rotated journal generations kept."),
    Knob("TRINO_TPU_JOURNAL_MAX_BYTES", "int", "4194304",
         "Journal rotate threshold per file."),
    Knob("TRINO_TPU_PLAN_CACHE", "bool", "1",
         "Tier A fingerprinted logical-plan cache; 0 disables (checked "
         "per lookup)."),
    Knob("TRINO_TPU_PLAN_CACHE_ENTRIES", "int", "256",
         "Plan-cache LRU capacity (entries)."),
    Knob("TRINO_TPU_PROFILE", "enum", "default",
         "Flight-recorder level: default is a clock read + tuple store "
         "with zero hot syncs; full brackets operators with a stream "
         "synchronize for true device time.",
         choices=("off", "default", "full")),
    Knob("TRINO_TPU_PROFILE_RING", "int", "4096",
         "Per-thread profiler event-ring capacity."),
    Knob("TRINO_TPU_RESULT_CACHE", "bool", "1",
         "Tier C versioned result cache; 0 disables (checked per "
         "lookup)."),
    Knob("TRINO_TPU_RESULT_CACHE_BYTES", "int", "67108864",
         "Result-cache LRU byte budget."),
)

KNOBS: dict = {k.name: k for k in _DECLARATIONS}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def declared(name: str) -> bool:
    return name in KNOBS


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"undeclared TRINO_TPU knob {name!r} — declare it in "
            f"trino_tpu_torch/spi/knobs.py") from None


def get_str(name: str) -> str:
    k = knob(name)
    return os.environ.get(k.name, k.default)


def get_int(name: str) -> Optional[int]:
    raw = get_str(name).strip()
    return int(raw) if raw else None


def get_float(name: str) -> Optional[float]:
    raw = get_str(name).strip()
    return float(raw) if raw else None


def get_bool(name: str) -> bool:
    raw = get_str(name).strip().lower()
    if raw in _FALSE or raw == "":
        return False
    return raw in _TRUE or raw not in _FALSE


def switched_on(name: str) -> bool:
    """A kill switch as the caching and journal modules read it: on unless
    the variable says 0 / off / false / no (an empty value is on)."""
    return get_str(name).strip().lower() not in _FALSE
