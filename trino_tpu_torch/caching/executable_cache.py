"""Tier B: the bounded, observable registry of the port's module-level memos.

The port of the reference ``caching/executable_cache.py``.  In the
reference every jitted-program memo goes through ``jit_memo``; the port
compiles nothing at run time (its kernels are built once, by nvcc, into
``build/kernels/``), so what this registry holds are the engine's other
process-wide memos, each of which used to be a module dict bounded by
"clear when full" and visible nowhere:

- ``local_exchange.entry_hashes``: a dictionary's per-entry value hashes,
  on a device (exec/local_exchange.py);
- ``join_exec.estimate_seeds``: the largest candidate total seen per join
  plan shape, the padded expand's cross-run feedback (exec/join_exec.py);
- ``batch.dictionary_nbytes``: the payload bytes of an object dictionary
  (spi/batch.py);
- ``gpu_kernels.segment_grid``: the segment-sum kernel's grid per (card,
  group count) (ops/gpu_kernels.py);
- ``serde.packed_dicts``: a dictionary's packed page bytes
  (execution/serde.py).

Each is now a bounded LRU (:class:`BoundedCache`) in one process-wide
registry, with hits, misses and evictions per cache and in aggregate, in
the ``trino_cache_exec_*`` metrics and the ``system.runtime.caches`` table
(caching/__init__.py ``cache_rows``).  :func:`memo` is the decorator form
(the reference's ``jit_memo``).  With ``weak=True`` a call is keyed by the
identity of its first argument (a dictionary) and the rest; the entry
holds no reference to that argument and is dropped when it is freed, so
a memo keeps no per-query dictionary alive.

**The warm-key journal**, as in the reference: a memo miss remembers its
key when the key survives a JSON round trip (:func:`_record_warm_key`;
keys that hold a device, a dtype or a type object do not, and a ``weak``
memo's key is an object's identity, never journaled).  At the end of every
query the keys seen go to ``exec_warm.json`` next to the query journal
(:func:`flush_warm_keys`, called from ``runner.run_with_query_events``), in
the reference's format ``{"version": 1, "keys": [[name, key], ...]}``, so
each package reads the other's file.  A worker process replays it at boot
(:func:`warm_at_boot`, from execution/worker.py) under
``TRINO_TPU_EXEC_WARM``.  The reference's replay re-creates jitted
wrappers whose first call loads from XLA's disk cache; the port compiles
nothing, so its replay re-instantiates the memoized programs
(``resident._program``: the plan payload decoded and its expressions
compiled; ``stage._ingest_program``, ``stage._merge_program``).  A key
whose cache this process does not register, whose arguments no longer fit
(code drift, or a key the reference journaled) or whose payload names a
module of the reference is skipped, and the replay counts the keys it
skipped beside those it warmed.  XLA's persistent compile cache has no
counterpart: :func:`init_compile_cache` only reports the directory
nvcc's library lives in.

``TRINO_TPU_EXEC_CACHE=0`` (read when a cache is made) keeps every memo
bounded but leaves it out of the registry and its counters.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..spi import knobs

__all__ = [
    "BoundedCache", "bounded", "memo", "register_external", "enabled",
    "default_maxsize", "registry_stats", "aggregate_stats", "clear_all",
    "init_compile_cache", "warm_at_boot", "flush_warm_keys",
    "warm_file_path", "reset_warm_state_for_test",
]

_WARM_FILE = "exec_warm.json"
_WARM_KEY_CAP = 256  # most recent keys journaled per process
_WARM_REPLAY_LIMIT = 64  # most recent keys a boot replays


def enabled() -> bool:
    return knobs.switched_on("TRINO_TPU_EXEC_CACHE")


def default_maxsize() -> int:
    return knobs.get_int("TRINO_TPU_EXEC_CACHE_ENTRIES")


def _metrics():
    # bound lazily: a module that defines a memo need not import telemetry
    global _TM
    if _TM is None:
        from ..telemetry import metrics as tm

        _TM = tm
    return _TM


_TM = None


class _MISSING:  # sentinel (None is a legal cached value)
    pass


class BoundedCache:
    """One bounded LRU of the registry: ``get`` / ``put`` count hits,
    misses and evictions under the lock the OrderedDict needs anyway.
    ``counted=False`` (the kill switch) leaves the metrics alone."""

    def __init__(self, name: str, maxsize: int, counted: bool = True):
        self.name = name
        self.maxsize = maxsize
        self._counted = counted
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # keys a weak entry's finalizer dropped: the garbage collector may
        # run that finalizer inside a locked section of this cache on the
        # same thread, so it only queues the key (list.append takes no
        # lock) and the next holder of the lock removes it
        self._dead: list = []
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        """The value under ``key`` (a hit), or ``default`` (a miss)."""
        with self._lock:
            self._drop_dead()
            value = self._entries.get(key, _MISSING)
            if value is not _MISSING:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if self._counted:
            tm = _metrics()
            (tm.CACHE_EXEC_HITS if value is not _MISSING
             else tm.CACHE_EXEC_MISSES).inc()
        return default if value is _MISSING else value

    def peek(self, key, default=None):
        """The value under ``key`` without counting a hit or a miss or
        refreshing its LRU place (for a read-modify-write)."""
        with self._lock:
            self._drop_dead()
            return self._entries.get(key, default)

    def put(self, key, value) -> list:
        """Store ``value``; returns the values evicted to make room."""
        evicted = []
        with self._lock:
            self._drop_dead()
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                evicted.append(self._entries.popitem(last=False)[1])
            self.evictions += len(evicted)
            self._drop_dead()
        if evicted and self._counted:
            _metrics().CACHE_EXEC_EVICTIONS.inc(len(evicted))
        return evicted

    def discard(self, key) -> None:
        """Drop ``key`` if present (not counted as an eviction): now when
        the lock is free, else by the lock's holder before it lets go (it
        may be this thread, inside a collection that ran the finalizer
        calling this; waiting for the lock there never returns)."""
        self._dead.append(key)
        if self._lock.acquire(blocking=False):
            try:
                self._drop_dead()
            finally:
                self._lock.release()

    def _drop_dead(self) -> None:
        """Remove the queued keys (under the lock)."""
        while self._dead:
            self._entries.pop(self._dead.pop(), None)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> list:
        """Drop every entry; returns their values."""
        with self._lock:
            self._dead.clear()
            values = list(self._entries.values())
            self._entries.clear()
        return values

    def stats(self) -> dict:
        with self._lock:
            self._drop_dead()
            return {
                "tier": "exec", "name": self.name,
                "entries": len(self._entries), "bytes": 0,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "invalidations": 0,
            }


class _Memo:
    """A function memoized in a :class:`BoundedCache`.  A call is keyed by
    its (hashable) arguments; with ``weak`` by the ``id`` of its first
    argument and the rest, and a finalizer on that argument drops the
    entry when the argument is freed, so its id is never reused while the
    entry exists.  An argument that takes no weak reference is computed
    and not kept."""

    def __init__(self, fn: Callable, cache: BoundedCache, weak: bool):
        self.fn = fn
        self.cache = cache
        self._weak = weak
        self.__wrapped__ = fn
        self.__doc__ = fn.__doc__
        self.__name__ = getattr(fn, "__name__", cache.name)

    def __call__(self, *args):
        if not self._weak:
            hit = self.cache.get(args, _MISSING)
            if hit is not _MISSING:
                return hit
            # computed outside the lock: a factory may re-enter the registry
            value = self.fn(*args)
            self.cache.put(args, value)
            if self.cache._counted:
                _record_warm_key(self.cache.name, args)
            return value
        key = (id(args[0]),) + args[1:]
        hit = self.cache.get(key, _MISSING)
        if hit is not _MISSING:
            return hit[0]
        value = self.fn(*args)
        try:
            fin = weakref.finalize(args[0], self.cache.discard, key)
        except TypeError:
            return value
        # an evicted entry's finalizer goes with it, so a long-lived
        # argument evicted and stored again holds one finalizer, not many
        for _value, old in self.cache.put(key, (value, fin)):
            old.detach()
        return value

    def warm(self, key: tuple) -> bool:
        """Re-instantiate the entry of a journaled key; never raises: a
        key this memo cannot take (a weak memo's, or one whose arguments
        no longer fit) is skipped."""
        if self._weak:
            return False
        try:
            self(*key)
            return True
        except Exception:  # noqa: BLE001 — boot warming is best-effort
            return False

    def clear(self) -> None:
        for entry in self.cache.clear():
            if self._weak:
                entry[1].detach()

    def stats(self) -> dict:
        return self.cache.stats()


_REGISTRY: dict[str, Any] = {}
_EXTERNAL: dict[str, Callable[[], dict]] = {}
_REGISTRY_LOCK = threading.Lock()

# JSON-able (cache_name, key) pairs seen this process, flushed to the warm
# file at query end (flush_warm_keys) and replayed at worker boot
_WARM_LOCK = threading.Lock()
_WARM_SEEN: OrderedDict = OrderedDict()
_WARM_DIRTY = False


def _register(name: str, obj) -> None:
    with _REGISTRY_LOCK:
        if name in _REGISTRY:
            raise ValueError(f"duplicate executable cache name: {name!r}")
        _REGISTRY[name] = obj


def _new_cache(name: str, maxsize: Optional[int]) -> BoundedCache:
    return BoundedCache(
        name, maxsize if maxsize is not None else default_maxsize(),
        counted=enabled())


def bounded(name: str, maxsize: Optional[int] = None) -> BoundedCache:
    """A registered bounded LRU for a module-level store that is not a
    function memo (``get`` / ``put``).  ``name`` must be unique (dotted
    module.store convention); ``maxsize`` defaults to
    TRINO_TPU_EXEC_CACHE_ENTRIES."""
    cache = _new_cache(name, maxsize)
    if cache._counted:
        _register(name, cache)
    return cache


def memo(name: str, maxsize: Optional[int] = None, weak: bool = False):
    """Decorator: memoize a function in a registered bounded LRU (the
    reference's ``jit_memo``).  ``weak`` keys a call by the identity of
    its first argument (an unhashable dictionary) without keeping it
    alive."""

    def deco(fn: Callable) -> _Memo:
        m = _Memo(fn, _new_cache(name, maxsize), weak)
        if m.cache._counted:
            _register(name, m)
        return m

    return deco


def register_external(name: str, stats_fn: Callable[[], dict]) -> None:
    """Adopt a cache the registry does not own into the observability
    plane: ``stats_fn`` returns the same dict shape as
    :meth:`BoundedCache.stats`."""
    with _REGISTRY_LOCK:
        _EXTERNAL[name] = stats_fn


def registry_stats() -> list[dict]:
    with _REGISTRY_LOCK:
        caches = list(_REGISTRY.values())
        external = list(_EXTERNAL.values())
    out = [c.stats() for c in caches]
    for fn in external:
        try:
            out.append(fn())
        except Exception:  # noqa: BLE001 — observability must not throw
            continue
    return sorted(out, key=lambda r: r["name"])


def aggregate_stats() -> dict:
    agg = {"tier": "exec", "name": "exec", "entries": 0, "bytes": 0,
           "hits": 0, "misses": 0, "evictions": 0, "invalidations": 0}
    for row in registry_stats():
        for k in ("entries", "bytes", "hits", "misses", "evictions",
                  "invalidations"):
            agg[k] += row[k]
    # the entries gauge is refreshed on the observability pull path (here),
    # not on every insert
    _metrics().CACHE_EXEC_ENTRIES.set(agg["entries"])
    return agg


def clear_all() -> None:
    with _REGISTRY_LOCK:
        caches = list(_REGISTRY.values())
    for c in caches:
        c.clear()


# ---------------------------------------------------------------------------
# the kernel library's directory


def init_compile_cache() -> Optional[str]:
    """The directory of the port's compiled kernels (``build/kernels/``,
    filled once by nvcc; see ops/gpu_kernels.py), or None before it
    exists.  Nothing is compiled at run time, so unlike the reference
    there is no compile cache to point anywhere."""
    from ..ops import gpu_kernels as GK

    d = str(GK._BUILD_DIR)
    return d if os.path.isdir(d) else None


# ---------------------------------------------------------------------------
# the warm-key journal


def warm_file_path() -> str:
    """``exec_warm.json`` in the query journal's directory."""
    from ..telemetry import journal as tj

    return os.path.join(tj.journal_dir(), _WARM_FILE)


def _record_warm_key(cache_name: str, key: tuple) -> None:
    """Remember a JSON-round-trippable memo key for the warm journal.
    Keys holding devices / dtypes / type objects fail json.dumps and are
    not journaled."""
    global _WARM_DIRTY
    try:
        json.dumps(key)
    except (TypeError, ValueError):
        return
    pair = (cache_name, key)
    with _WARM_LOCK:
        if pair in _WARM_SEEN:
            _WARM_SEEN.move_to_end(pair)
            return
        _WARM_SEEN[pair] = True
        while len(_WARM_SEEN) > _WARM_KEY_CAP:
            _WARM_SEEN.popitem(last=False)
        _WARM_DIRTY = True


def flush_warm_keys() -> Optional[str]:
    """Write the seen-key set to the warm file if it changed since the
    last flush (called at query completion: one flag check, and at most
    one small atomic write, per query).  Returns the path written."""
    global _WARM_DIRTY
    if not enabled():
        return None
    with _WARM_LOCK:
        if not _WARM_DIRTY:
            return None
        pairs = [[name, list(key)] for (name, key) in _WARM_SEEN]
        _WARM_DIRTY = False
    path = warm_file_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "keys": pairs}, f)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def _freeze(v):
    """A JSON round trip turns tuples into lists; memo keys are tuples."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


# the modules that define the registered memos: a memo exists only once
# its module is imported
_MEMO_MODULES = ("exec.local_exchange", "exec.join_exec", "spi.batch",
                 "ops.gpu_kernels", "execution.stage_compiler",
                 "execution.serde", "execution.plan_compiler")


def warm_at_boot() -> dict:
    """Replay the warm journal: import the memo-owning modules, then
    re-instantiate up to 64 recorded entries (most recent first —
    the file is LRU-ordered oldest-first).  Returns ``{"read", "warmed",
    "skipped", "ms"}``: the keys taken from the file, those re-instantiated
    and those skipped (no registered memo of that name in this process, or
    the memo could not take the key), and the replay's wall; all zero when
    ``TRINO_TPU_EXEC_CACHE`` or ``TRINO_TPU_EXEC_WARM`` is off or there is
    no file."""
    out = {"read": 0, "warmed": 0, "skipped": 0, "ms": 0.0}
    if not enabled() or not knobs.switched_on("TRINO_TPU_EXEC_WARM"):
        return out
    t0 = time.perf_counter()
    try:
        with open(warm_file_path(), encoding="utf-8") as f:
            pairs = json.load(f).get("keys", [])
    except (OSError, ValueError, AttributeError):
        return out
    pkg = __package__.rsplit(".", 1)[0]
    for mod in _MEMO_MODULES:
        __import__(f"{pkg}.{mod}", fromlist=["_"])
    for pair in reversed(pairs[-_WARM_REPLAY_LIMIT:]):
        out["read"] += 1
        try:
            name, key = pair
            with _REGISTRY_LOCK:
                cache = _REGISTRY.get(name)
            ok = cache is not None and hasattr(cache, "warm") \
                and cache.warm(_freeze(key))
        except (TypeError, ValueError):
            ok = False
        out["warmed" if ok else "skipped"] += 1
    out["ms"] = (time.perf_counter() - t0) * 1e3
    return out


def reset_warm_state_for_test() -> None:
    global _WARM_DIRTY
    with _WARM_LOCK:
        _WARM_SEEN.clear()
        _WARM_DIRTY = False
