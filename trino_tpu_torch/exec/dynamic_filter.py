"""Dynamic filtering: build-side join keys prune probe-side scans.

The port of the reference ``exec/dynamic_filter.py`` (server/
DynamicFilterService.java:105, operator/DynamicFilterSourceOperator.java:44):
when a hash-join build side finishes, its key domain (min / max, and the
exact distinct set when it is small) becomes an extra predicate on the
probe-side table scan.  Pipelines run in dependency order (builds first),
so the filter is complete before the probe scan starts.

Only INNER and RIGHT joins attach filters: their unmatched probe rows are
dropped anyway, so pruning them cannot change results.  LEFT / FULL /
SINGLE joins and semi-join marks must see every probe row.

The probe side works on host numpy (the scan masks each host batch before
it is copied to the device).  A large build on the card derives its domain
with torch ops there (exec/kernels.py ``_device_domain``); the host reads
the result at the first probe, not at fill time.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

__all__ = ["DynamicFilterHolder", "MAX_DISTINCT_SET"]

MAX_DISTINCT_SET = 1 << 16  # keep an exact value set up to this many keys


class DynamicFilterHolder:
    """One build-side key column's domain, filled at JoinBuildSink.finish."""

    def __init__(self):
        self.ready = False
        self.empty = False  # the build had no rows: nothing can match
        self.vmin = None
        self.vmax = None
        self.values: Optional[np.ndarray] = None  # sorted exact set (or None)
        self.dict_values: Optional[set] = None  # for dictionary columns
        self.has_nan = False  # the build had NaN keys (NaN joins NaN here)
        self.rows_pruned = 0  # probe rows this filter dropped
        # the parallel scan shards of one probe share the holder
        self._lock = threading.Lock()
        # a device domain not read yet (exec/kernels.DeviceDomain): a
        # blocking read at fill time would stall the build pipeline for a
        # result the probe needs only later
        self._pending_device = None
        # the last probe dictionary and its per-code mask (probe batches of
        # one table share their dictionary object)
        self._code_ok: Optional[tuple] = None

    def fill_device(self, data, valid, live, dictionary) -> None:
        """Build keys as tensors (``valid`` / ``live`` None = all).  A build
        of at most MAX_DISTINCT_SET rows without a dictionary is read to
        the host in one fetch and keeps :meth:`fill`'s exact set; a larger
        build, or a dictionary column, derives its domain on its device
        (range, plus presence per dictionary code)."""
        from . import syncguard as SG
        from .kernels import _device_domain

        n = int(data.shape[0])
        if n <= MAX_DISTINCT_SET and dictionary is None:
            data, valid, keep = SG.fetch([data, valid, live], "df.build-keys")
            if keep is not None:
                data = data[keep]
                valid = None if valid is None else valid[keep]
            self.fill(data, valid, None)
            return
        dict_len = len(dictionary) if dictionary is not None else 0
        self._pending_device = (_device_domain(data, valid, live, dict_len),
                                dictionary)
        self.ready = True

    def _materialize(self) -> None:
        """Read the device-computed domain (first probe_mask use)."""
        domain, dictionary = self._pending_device
        self._pending_device = None
        cnt, cnt_nonnan, vmin, vmax, presence = domain.result()
        if cnt == 0:
            self.empty = True
            return
        if dictionary is not None:
            self.dict_values = set(str(v) for v in dictionary[presence])
        else:
            self.has_nan = cnt_nonnan < cnt
            if cnt_nonnan > 0:
                self.vmin = vmin
                self.vmax = vmax

    def fill(self, data: np.ndarray, valid: Optional[np.ndarray],
             dictionary: Optional[np.ndarray]) -> None:
        """Host build keys: the exact sorted set (up to MAX_DISTINCT_SET
        values, else the range), or a dictionary column's VALUES (codes
        are per-batch namespaces)."""
        data = np.asarray(data)
        if valid is not None:
            data = data[np.asarray(valid)]
        if data.size == 0:
            self.empty = True
            self.ready = True
            return
        if dictionary is not None:
            self.dict_values = set(str(v) for v in dictionary[np.unique(data)])
        else:
            uniq = np.unique(data)
            if np.issubdtype(uniq.dtype, np.floating):
                # NaN would poison the range (x <= NaN is False); the join
                # treats NaN = NaN as a match, so remember it apart
                self.has_nan = bool(np.count_nonzero(np.isnan(uniq)))
                uniq = uniq[~np.isnan(uniq)]
                if uniq.size == 0:
                    if not self.has_nan:
                        self.empty = True
                    self.ready = True
                    return
            self.vmin = uniq[0]
            self.vmax = uniq[-1]
            if uniq.size <= MAX_DISTINCT_SET:
                self.values = uniq
        self.ready = True

    def add_pruned(self, rows: int) -> None:
        with self._lock:
            self.rows_pruned += rows

    def _dictionary_mask(self, dictionary: np.ndarray) -> np.ndarray:
        if self._code_ok is None or self._code_ok[0] is not dictionary:
            self._code_ok = (dictionary, np.array(
                [str(v) in self.dict_values for v in dictionary], bool))
        return self._code_ok[1]

    def probe_mask(self, data: np.ndarray, valid: Optional[np.ndarray],
                   dictionary: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """Row mask of the probe rows that may match (None = keep all).
        NULL keys never match an equi-join, so they are dropped too."""
        if not self.ready:
            return None
        if self._pending_device is not None:
            with self._lock:
                if self._pending_device is not None:
                    self._materialize()
        data = np.asarray(data)
        if self.empty:
            return np.zeros(data.shape[0], bool)
        if dictionary is not None:
            if self.dict_values is None:
                return None
            code_ok = self._dictionary_mask(dictionary)
            mask = (code_ok[data] if len(code_ok)
                    else np.zeros(data.shape[0], bool))
        elif self.values is not None:
            pos = np.searchsorted(self.values, data)
            clipped = np.minimum(pos, self.values.size - 1)
            mask = self.values[clipped] == data
        elif self.vmin is not None:
            mask = (data >= self.vmin) & (data <= self.vmax)
        else:
            return None
        if self.has_nan and np.issubdtype(data.dtype, np.floating):
            mask = mask | np.isnan(data)
        if valid is not None:
            mask = mask & np.asarray(valid)
        return mask
