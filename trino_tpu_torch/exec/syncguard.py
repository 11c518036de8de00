"""SyncGuard: host-transfer accounting for the operator hot loops.

The port of the reference ``exec/syncguard.py``.  Every deliberate
device-to-host read of the exec layer goes through this module instead of a
raw ``.item()`` / ``.cpu()`` / ``int(t.sum())`` (``tools/lint_host_sync.py``
flags those spellings under ``exec/``), so the engine (a) COUNTS each host
transfer, attributed to a tag, (b) tells transfers that had to wait on the
card from reads of an asynchronous copy that had already landed, and (c) in
tests and on the card FORBIDS any blocking transfer inside a declared
hot-loop region, so the zero-sync contract of the probe is asserted rather
than assumed::

    from . import syncguard as SG
    n = int(SG.fetch(live.sum(), "join.live-rows"))      # blocking, counted

    h = SG.async_scalar(total, "join.pair-total")        # starts the copy
    ...enqueue more device work...
    v = h.get()      # a poll hit when the copy has already landed

A fetch of any tensor counts as blocking: torch gives a tensor no readiness
flag, and the reference counts its arrays as device values on every
backend.  An :class:`AsyncScalar` over a CUDA tensor starts a
``non_blocking`` copy into pinned host memory and records an event on the
current stream; it is ready when that event has completed.  Over a CPU
tensor it is always ready.

The counters roll up into :class:`SyncStats`, taken per query as a delta
(:func:`snapshot` / :func:`take_delta`) into ``QueryStats.sync`` and printed
by EXPLAIN ANALYZE.  ``hot_region`` marks a steady-state operator hot loop;
under ``forbidden`` a blocking transfer inside one raises
:class:`SyncViolation`, and ``forbidden(cuda_sync_debug=True)`` also sets
``torch.cuda.set_sync_debug_mode("error")`` while a hot region runs, so an
implicit synchronization there (``torch.nonzero``, boolean indexing, a
blocking copy) raises too.  That switch is global to the process: only a
single-driver run on the card uses it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field, fields

import torch

__all__ = [
    "SyncStats",
    "SyncViolation",
    "AsyncScalar",
    "fetch",
    "async_scalar",
    "count_sync",
    "count_overflow",
    "hot_region",
    "forbidden",
    "snapshot",
    "take_delta",
]


class SyncViolation(AssertionError):
    """A blocking host sync happened inside a declared hot-loop region while
    SyncGuard was in ``forbidden`` mode."""


@dataclass
class SyncStats:
    """Host-transfer counters of the exec layer (one global accumulator;
    ``take_delta`` gives a query its share).  ``host_syncs`` counts every
    device-to-host read the exec layer asked for; ``blocking_syncs`` those
    that had to wait on the device; ``async_polls`` / ``poll_hits`` the
    reads of asynchronous copies and how many had already landed.
    ``expand_overflows`` / ``expand_retries`` count padded-expand buckets
    that proved too small and the re-runs that fixed them."""

    host_syncs: int = 0
    blocking_syncs: int = 0
    async_polls: int = 0
    poll_hits: int = 0
    expand_overflows: int = 0
    expand_retries: int = 0
    hot_loop_syncs: int = 0      # blocking syncs inside hot regions (want: 0)
    by_tag: dict = field(default_factory=dict)

    def merge(self, other: "SyncStats") -> None:
        for f in fields(self):
            if f.name == "by_tag":
                for k, v in other.by_tag.items():
                    self.by_tag[k] = self.by_tag.get(k, 0) + v
            else:
                setattr(self, f.name, getattr(self, f.name)
                        + getattr(other, f.name))

    def text(self) -> str:
        tags = " ".join(f"{k}={v}" for k, v in sorted(self.by_tag.items()))
        return (
            f"exec: {self.host_syncs} host syncs "
            f"({self.blocking_syncs} blocking, {self.hot_loop_syncs} in hot "
            f"loops), {self.poll_hits}/{self.async_polls} async polls ready, "
            f"expand overflow {self.expand_overflows}/"
            f"retry {self.expand_retries}"
            + (f" [{tags}]" if tags else "")
        )


class _State(threading.local):
    hot_depth = 0


_STATE = _State()
_LOCK = threading.Lock()
_STATS = SyncStats()
_FORBID = False  # set by forbidden()
_CUDA_DEBUG = False  # forbidden(cuda_sync_debug=True)


def snapshot() -> SyncStats:
    """A copy of the current totals."""
    with _LOCK:
        s = SyncStats(**{f.name: getattr(_STATS, f.name)
                         for f in fields(_STATS) if f.name != "by_tag"})
        s.by_tag = dict(_STATS.by_tag)
        return s


def take_delta(since: SyncStats) -> SyncStats:
    """The counters accumulated after ``since`` (per-query attribution)."""
    now = snapshot()
    d = SyncStats()
    for f in fields(d):
        if f.name == "by_tag":
            for k, v in now.by_tag.items():
                dv = v - since.by_tag.get(k, 0)
                if dv:
                    d.by_tag[k] = dv
        else:
            setattr(d, f.name, getattr(now, f.name) - getattr(since, f.name))
    return d


def _has_tensor(x) -> bool:
    if isinstance(x, (tuple, list)):
        return any(_has_tensor(e) for e in x)
    return isinstance(x, torch.Tensor)


def _to_host(x):
    """Tensors (also inside lists / tuples) as numpy arrays."""
    if isinstance(x, (tuple, list)):
        return [_to_host(e) for e in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def count_sync(tag: str, blocking: bool = True) -> None:
    """Record a host sync performed elsewhere (e.g. the result fetch)."""
    in_hot = _STATE.hot_depth > 0
    if blocking and in_hot and _FORBID:
        raise SyncViolation(
            f"blocking host sync '{tag}' inside a SyncGuard hot region")
    with _LOCK:
        _STATS.host_syncs += 1
        if blocking:
            _STATS.blocking_syncs += 1
            if in_hot:
                _STATS.hot_loop_syncs += 1
        _STATS.by_tag[tag] = _STATS.by_tag.get(tag, 0) + 1


def count_overflow(retried: bool = True) -> None:
    with _LOCK:
        _STATS.expand_overflows += 1
        if retried:
            _STATS.expand_retries += 1


def fetch(x, tag: str):
    """Blocking device-to-host read, counted (and forbidden inside hot
    regions under ``forbidden``).  Returns numpy values: a tensor becomes
    an array (a 0-d one for a scalar), a list of tensors a list."""
    count_sync(tag, blocking=_has_tensor(x))
    return _to_host(x)


class AsyncScalar:
    """Handle for a device value whose copy to the host was started
    asynchronously.  ``get()`` blocks only when the copy has not landed
    (counted as a poll hit when it has); ``ready()`` / ``get_if_ready()``
    never block."""

    __slots__ = ("value", "tag", "_host", "_event")

    def __init__(self, value, tag: str):
        self.value = value
        self.tag = tag
        self._event = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            self._host = torch.empty(value.shape, dtype=value.dtype,
                                     pin_memory=True)
            self._host.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = value

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def _read(self):
        return _to_host(self._host)

    def get(self):
        hit = self.ready()
        with _LOCK:
            _STATS.async_polls += 1
            if hit:
                _STATS.poll_hits += 1
        if not hit:
            # the copy is in flight and the value is needed now: a genuine
            # blocking sync
            count_sync(self.tag, blocking=True)
            self._event.synchronize()
        return self._read()

    def get_if_ready(self):
        """Non-blocking: the value if the copy landed, else None."""
        hit = self.ready()
        with _LOCK:
            _STATS.async_polls += 1
            if hit:
                _STATS.poll_hits += 1
        return self._read() if hit else None


def async_scalar(x, tag: str) -> AsyncScalar:
    return AsyncScalar(x, tag)


@contextmanager
def hot_region():
    """Marks an operator's steady-state hot loop: blocking syncs inside are
    tallied apart (and raise under ``forbidden``)."""
    _STATE.hot_depth += 1
    debug = _CUDA_DEBUG and _STATE.hot_depth == 1
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode("default")
        _STATE.hot_depth -= 1


@contextmanager
def forbidden(cuda_sync_debug: bool = False):
    """Enforcement: any blocking sync inside a hot region raises
    SyncViolation; with ``cuda_sync_debug`` torch's sync debug mode is
    "error" while a hot region runs.  Not thread-safe by design: tests and
    single-driver runs on the card only."""
    global _FORBID, _CUDA_DEBUG
    prev = _FORBID, _CUDA_DEBUG
    _FORBID, _CUDA_DEBUG = True, cuda_sync_debug
    try:
        yield
    finally:
        _FORBID, _CUDA_DEBUG = prev
