"""Error classification + deterministic backoff (the resilience vocabulary).

Mirrors the reference's error taxonomy (spi/StandardErrorCode.java:31,
spi/ErrorType.java:17) and the airlift ``Backoff`` used by
operator/HttpPageBufferClient.java:355: every failure the coordinator acts
on carries an :class:`ErrorCode` whose :class:`ErrorType` decides
*retryability* —

- ``USER``                    the query itself is wrong (syntax, division by
                              zero, bad cast); retrying re-runs the same bug,
                              so these NEVER retry anywhere;
- ``INTERNAL``                an engine bug or injected fault; retryable
                              (reference FTE retries internal task failures);
- ``EXTERNAL``                the world outside the engine failed (worker
                              unreachable, page transport timeout, remote
                              host gone); retryable;
- ``INSUFFICIENT_RESOURCES``  memory/admission pressure; retryable (the FTE
                              scheduler grows the memory budget on retry).

One INTERNAL code is the port's own and never retries: ``DEVICE_FAULT``,
a CUDA error or a kernel library that did not build, bind or launch.  A
CUDA error is sticky in its process (every later launch there fails too)
and a library that did not build does not build on a re-run, so a retry
would only hide the fault behind a second failure or a slow success.

``classify()`` maps arbitrary exceptions onto :class:`TrinoError` so the
worker can report ``error_type`` in its status JSON and the coordinator's
``retry_policy="QUERY"`` loop can decide fail-fast vs re-run without parsing
message strings.  :class:`Backoff` bounds how long an unreachable peer is
re-polled before it surfaces as a classified EXTERNAL failure.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "USER", "INTERNAL", "EXTERNAL", "INSUFFICIENT_RESOURCES", "ERROR_TYPES",
    "ErrorCode", "TrinoError", "Backoff",
    "GENERIC_USER_ERROR", "SUBQUERY_MULTIPLE_ROWS",
    "GENERIC_INTERNAL_ERROR", "REMOTE_TASK_ERROR",
    "REMOTE_HOST_GONE", "PAGE_TRANSPORT_TIMEOUT", "PAGE_TRANSPORT_ERROR",
    "EXCEEDED_MEMORY_LIMIT_CODE", "NO_NODES_AVAILABLE",
    "QUERY_QUEUE_FULL", "QUERY_QUEUED_TIMEOUT", "CLUSTER_OUT_OF_MEMORY",
    "EXCEEDED_GLOBAL_MEMORY_LIMIT", "DEVICE_FAULT",
    "classify", "is_device_fault", "is_retryable_type", "lookup_code",
]

USER = "USER"
INTERNAL = "INTERNAL"
EXTERNAL = "EXTERNAL"
INSUFFICIENT_RESOURCES = "INSUFFICIENT_RESOURCES"
ERROR_TYPES = (USER, INTERNAL, EXTERNAL, INSUFFICIENT_RESOURCES)

# only USER errors are deterministic re-failures; everything else names a
# condition a re-run can escape (reference: ErrorType retry semantics in
# execution/scheduler/faulttolerant + coordinator query retries)
_RETRYABLE_TYPES = frozenset({INTERNAL, EXTERNAL, INSUFFICIENT_RESOURCES})


def is_retryable_type(error_type: Optional[str]) -> bool:
    return error_type in _RETRYABLE_TYPES


@dataclass(frozen=True)
class ErrorCode:
    """(name, numeric code, type) — the StandardErrorCode.java:31 triple.
    Code blocks follow the reference: USER < 0x1_0000, INTERNAL from
    0x1_0000, INSUFFICIENT_RESOURCES from 0x2_0000, EXTERNAL from 0x3_0000."""

    name: str
    code: int
    error_type: str

    def is_retryable(self) -> bool:
        return self != DEVICE_FAULT and is_retryable_type(self.error_type)


GENERIC_USER_ERROR = ErrorCode("GENERIC_USER_ERROR", 0x0000, USER)
SYNTAX_ERROR = ErrorCode("SYNTAX_ERROR", 0x0001, USER)
DIVISION_BY_ZERO = ErrorCode("DIVISION_BY_ZERO", 0x0008, USER)
# a scalar subquery yielding >1 row is the query's own cardinality bug
# (reference: StandardErrorCode SUBQUERY_MULTIPLE_ROWS) — USER, never retried
SUBQUERY_MULTIPLE_ROWS = ErrorCode("SUBQUERY_MULTIPLE_ROWS", 0x0019, USER)
# admission rejections are USER on purpose: re-submitting an identical query
# into the same full queue re-fails identically, so the retry_policy=QUERY
# loop must never burn attempts on them (reference: StandardErrorCode
# QUERY_QUEUE_FULL / EXCEEDED_TIME_LIMIT family)
QUERY_QUEUE_FULL = ErrorCode("QUERY_QUEUE_FULL", 0x0009, USER)
QUERY_QUEUED_TIMEOUT = ErrorCode("QUERY_QUEUED_TIMEOUT", 0x000A, USER)
GENERIC_INTERNAL_ERROR = ErrorCode("GENERIC_INTERNAL_ERROR", 0x1_0000, INTERNAL)
# a CUDA error or a kernel library that did not build, bind or launch
# (ops/gpu_kernels.py); INTERNAL, but never retried (module docstring)
DEVICE_FAULT = ErrorCode("DEVICE_FAULT", 0x1_0001, INTERNAL)
EXCEEDED_MEMORY_LIMIT_CODE = ErrorCode(
    "EXCEEDED_LOCAL_MEMORY_LIMIT", 0x2_0000, INSUFFICIENT_RESOURCES)
NO_NODES_AVAILABLE = ErrorCode(
    "NO_NODES_AVAILABLE", 0x2_0001, INSUFFICIENT_RESOURCES)
# OOM-killer victims: INSUFFICIENT_RESOURCES, so an INTERNAL workload killed
# to relieve cluster pressure is eligible for a retry_policy=QUERY re-run
# once the pressure clears (reference: ClusterMemoryManager.java:90 +
# LowMemoryKiller)
CLUSTER_OUT_OF_MEMORY = ErrorCode(
    "CLUSTER_OUT_OF_MEMORY", 0x2_0002, INSUFFICIENT_RESOURCES)
EXCEEDED_GLOBAL_MEMORY_LIMIT = ErrorCode(
    "EXCEEDED_GLOBAL_MEMORY_LIMIT", 0x2_0003, INSUFFICIENT_RESOURCES)
REMOTE_TASK_ERROR = ErrorCode("REMOTE_TASK_ERROR", 0x3_0000, EXTERNAL)
PAGE_TRANSPORT_ERROR = ErrorCode("PAGE_TRANSPORT_ERROR", 0x3_0001, EXTERNAL)
PAGE_TRANSPORT_TIMEOUT = ErrorCode(
    "PAGE_TRANSPORT_TIMEOUT", 0x3_0002, EXTERNAL)
REMOTE_HOST_GONE = ErrorCode("REMOTE_HOST_GONE", 0x3_0003, EXTERNAL)

_CODES = {c.name: c for c in (
    GENERIC_USER_ERROR, SYNTAX_ERROR, DIVISION_BY_ZERO,
    SUBQUERY_MULTIPLE_ROWS, QUERY_QUEUE_FULL, QUERY_QUEUED_TIMEOUT,
    GENERIC_INTERNAL_ERROR, DEVICE_FAULT, EXCEEDED_MEMORY_LIMIT_CODE,
    NO_NODES_AVAILABLE, CLUSTER_OUT_OF_MEMORY, EXCEEDED_GLOBAL_MEMORY_LIMIT,
    REMOTE_TASK_ERROR, PAGE_TRANSPORT_ERROR, PAGE_TRANSPORT_TIMEOUT,
    REMOTE_HOST_GONE,
)}

_FALLBACK_BY_TYPE = {
    USER: GENERIC_USER_ERROR,
    INTERNAL: GENERIC_INTERNAL_ERROR,
    EXTERNAL: REMOTE_TASK_ERROR,
    INSUFFICIENT_RESOURCES: EXCEEDED_MEMORY_LIMIT_CODE,
}


def lookup_code(name: Optional[str],
                error_type: Optional[str] = None) -> ErrorCode:
    """Wire form -> ErrorCode: by name when registered, else the type's
    generic code (unknown wire values degrade to INTERNAL, retryable —
    never to a silent USER fail-fast)."""
    if name and name in _CODES:
        return _CODES[name]
    return _FALLBACK_BY_TYPE.get(error_type, GENERIC_INTERNAL_ERROR)


class TrinoError(RuntimeError):
    """An exception that knows its ErrorCode; ``remote_host`` names the
    worker implicated in an EXTERNAL/remote failure so the coordinator's
    query-retry loop can blacklist it for the re-run."""

    def __init__(self, code: ErrorCode, message: str,
                 remote_host: Optional[str] = None):
        super().__init__(f"{code.name}: {message}")
        self.code = code
        self.remote_host = remote_host

    @property
    def error_type(self) -> str:
        return self.code.error_type

    def is_retryable(self) -> bool:
        return self.code.is_retryable()


# exception classes from upper layers, matched by NAME so the SPI does not
# import the analyzer/executor packages it underpins
_USER_ERROR_CLASS_NAMES = frozenset({
    "AnalysisError",     # sql/analyzer.py (ValueError subclass)
    "ParseError",        # sql/parser.py
    "QueryError",        # ops/expr.py deferred lane errors (DIVISION_BY_ZERO)
    "PatternSyntaxError",  # exec/row_pattern.py MATCH_RECOGNIZE pattern text
})
_NETWORK_ERROR_TYPES = (ConnectionError, TimeoutError)
# what torch and the kernel library (ops/gpu_kernels.py) raise for a fault
# of the card or of the library, matched by class name and message so the
# SPI does not import torch
_DEVICE_ERROR_CLASS_NAMES = frozenset({"AcceleratorError", "OutOfMemoryError"})
_DEVICE_ERROR_TEXT = ("CUDA error", "CUDA driver error", "CUDA out of memory",
                      "device-side assert", "the kernel library",
                      "libtrino_kernels", "nvcc")


def is_device_fault(exc: BaseException) -> bool:
    """A CUDA error, or a kernel library that did not build (the failed
    nvcc command is in the message), bind or launch."""
    if isinstance(exc, TrinoError):
        return exc.code is DEVICE_FAULT
    if type(exc).__name__ in _DEVICE_ERROR_CLASS_NAMES:
        return True
    text = str(exc)
    return any(t in text for t in _DEVICE_ERROR_TEXT)


def classify(exc: BaseException) -> TrinoError:
    """Wrap an arbitrary exception as a classified TrinoError (identity on
    an already-classified one).  The mapping mirrors the reference's
    ``toFailure``/StandardErrorCode defaults: known user-facing classes →
    USER, memory pressure → INSUFFICIENT_RESOURCES, network trouble →
    EXTERNAL, everything unrecognized → GENERIC_INTERNAL_ERROR."""
    if isinstance(exc, TrinoError):
        return exc
    from .memory import ExceededMemoryLimitError

    msg = f"{type(exc).__name__}: {exc}"
    if is_device_fault(exc):
        return TrinoError(DEVICE_FAULT, msg)
    if isinstance(exc, ExceededMemoryLimitError):
        return TrinoError(EXCEEDED_MEMORY_LIMIT_CODE, msg)
    name = type(exc).__name__
    if name in _USER_ERROR_CLASS_NAMES:
        if "DIVISION_BY_ZERO" in str(exc):
            return TrinoError(DIVISION_BY_ZERO, msg)
        return TrinoError(GENERIC_USER_ERROR, msg)
    import urllib.error

    if isinstance(exc, (urllib.error.URLError, *_NETWORK_ERROR_TYPES)):
        return TrinoError(PAGE_TRANSPORT_ERROR, msg)
    return TrinoError(GENERIC_INTERNAL_ERROR, msg)


class Backoff:
    """Deterministic exponential backoff with a failure-duration budget
    (reference: the airlift Backoff inside HttpPageBufferClient — min/max
    delay doubling, ``maxFailureDuration`` deciding when a flaky peer is
    declared failed).

    No jitter on purpose: delays are a pure function of the failure count,
    so fault drills on the CPU mesh are reproducible.  ``clock`` is
    injectable for tests."""

    def __init__(self, min_delay_s: float = 0.05, max_delay_s: float = 2.0,
                 max_failure_duration_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        self.min_delay_s = float(min_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.max_failure_duration_s = float(max_failure_duration_s)
        self._clock = clock
        self.failure_count = 0
        self._first_failure: Optional[float] = None
        self._ready_at: float = 0.0

    @property
    def delay_s(self) -> float:
        """Current delay: min_delay * 2^(failures-1), capped at max_delay."""
        if self.failure_count == 0:
            return 0.0
        return min(self.max_delay_s,
                   self.min_delay_s * (2.0 ** (self.failure_count - 1)))

    def failure(self) -> bool:
        """Record one failure; returns True once failures have persisted
        past ``max_failure_duration_s`` (measured from the FIRST failure of
        the current streak, requiring at least two observations — one
        transient blip never trips the budget)."""
        now = self._clock()
        if self._first_failure is None:
            self._first_failure = now
        self.failure_count += 1
        self._ready_at = now + self.delay_s
        return (self.failure_count > 1
                and now - self._first_failure >= self.max_failure_duration_s)

    def success(self) -> None:
        self.failure_count = 0
        self._first_failure = None
        self._ready_at = 0.0

    def ready(self) -> bool:
        """False while the current delay gate is still closed."""
        return self._clock() >= self._ready_at

    @property
    def failure_duration_s(self) -> float:
        if self._first_failure is None:
            return 0.0
        return self._clock() - self._first_failure
