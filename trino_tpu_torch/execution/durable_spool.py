"""Durable on-disk FTE spool: stage outputs survive task AND process death.

The port of the reference ``execution/durable_spool.py``, the engine's
FileSystemExchangeManager miniature (plugin/trino-exchange-filesystem/.../
FileSystemExchangeManager.java:40, FileSystemExchangeSink):

- a task attempt writes its output as per-partition serde page files under
  ``<spool_root>/f<fragment>_t<task>/attempt-<n>.tmp/part-<p>.bin``;
- ``commit()`` atomically renames ``attempt-<n>.tmp`` -> ``attempt-<n>`` —
  only committed attempts are ever read, so a torn write from a dying
  process is invisible (the reference's exactly-once sink contract);
- readers stream frames from the committed directory; a worker-process
  death after commit loses nothing because the pages live on shared disk.

Part files carry the serde v2 CRC-checked stream framing (TTS2 header +
per-frame CRC32) so post-commit corruption — a bit flip or a torn sector —
surfaces as a retryable :class:`~.serde.SpoolCorruptionError` instead of
silently deserializing garbage; pre-CRC part files remain readable.

Part files are the reference's bytes for the same pages (execution/serde.py
writes the reference's wire format), so each package reads the other's
committed directories.  A device batch is serialized on the host when it
is spooled; a reader decodes each frame on the host and moves the batch to
its ``device`` (the consuming task's), so a task that reads the spool runs
its operators where a streaming task would.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Iterator, Optional

from ..spi import knobs
from ..spi.batch import ColumnBatch
from .serde import (deserialize_batch, iter_frames, serialize_batch,
                    write_frame_crc, write_stream_header)

__all__ = ["DurableSpoolWriter", "DurableSpoolClient", "make_spool_root"]


def make_spool_root(base: Optional[str] = None) -> str:
    """New per-query spool root under ``base``, the TRINO_TPU_SPOOL_DIR
    knob, or the system tempdir (first one set wins).  Callers register
    the root with :mod:`.spool_gc` so retention and the boot-time leak
    sweep know about it."""
    if base is None:
        base = knobs.get_str("TRINO_TPU_SPOOL_DIR") or None
        if base:
            os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="trino-tpu-spool-", dir=base)


class DurableSpoolWriter:
    """Duck-types the OutputBuffer surface PartitionedOutputSink uses
    (enqueue / set_finished) but lands every page on disk."""

    def __init__(self, task_dir: str, attempt: int, num_partitions: int):
        self.num_partitions = num_partitions
        self._final = os.path.join(task_dir, f"attempt-{attempt}")
        self._tmp = self._final + ".tmp"
        if os.path.exists(self._tmp):  # leftovers from a crashed twin
            shutil.rmtree(self._tmp)
        os.makedirs(self._tmp)
        self._files = [
            open(os.path.join(self._tmp, f"part-{p}.bin"), "wb")
            for p in range(num_partitions)
        ]
        for f in self._files:
            write_stream_header(f)
        self.committed: Optional[str] = None

    def enqueue(self, partition: int, page) -> None:
        raw = page.data if hasattr(page, "data") else serialize_batch(page)
        write_frame_crc(self._files[partition], raw)

    def set_finished(self) -> None:
        if self.committed is not None:  # idempotent (sink + runner both call)
            return
        for f in self._files:
            f.flush()
            os.fsync(f.fileno())
            f.close()
        # atomic commit: a crash before this rename leaves only a .tmp that
        # no reader will ever open
        if os.path.exists(self._final):
            shutil.rmtree(self._tmp)
        else:
            os.rename(self._tmp, self._final)
        self.committed = self._final

    def abort(self) -> None:
        for f in self._files:
            try:
                f.close()
            except Exception:  # best effort: rmtree below removes the spool
                pass
        shutil.rmtree(self._tmp, ignore_errors=True)


def _iter_partition(attempt_dir: str, partition: int,
                    device=None) -> Iterator[ColumnBatch]:
    path = os.path.join(attempt_dir, f"part-{partition}.bin")
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        for frame in iter_frames(f, path):
            batch = deserialize_batch(frame)
            yield batch if device is None else batch.to(device)


class DurableSpoolClient:
    """Duck-types ExchangeClient (poll / is_finished) over the committed
    spools of every producer task of one fragment; pages come back as
    batches on ``device`` (host batches when it is None)."""

    def __init__(self, attempt_dirs: list[str], partition: int,
                 on_read=None, device=None):
        self._dirs = list(attempt_dirs)
        self.device = device
        self.partition = partition
        self._iter = None
        self._pushback = None  # one-slot peek buffer (is_finished look-ahead)
        self._on_read = on_read  # failure-injection hook

    def _pages(self):
        for d in self._dirs:
            if self._on_read is not None:
                self._on_read(d)
            yield from _iter_partition(d, self.partition, self.device)

    def poll(self, timeout: float = 0.0):
        if self._pushback is not None:
            page, self._pushback = self._pushback, None
            return page
        if self._iter is None:
            self._iter = self._pages()
        return next(self._iter, None)

    def is_finished(self) -> bool:
        if self._pushback is not None:
            return False
        if self._iter is None:
            self._iter = self._pages()
        self._pushback = next(self._iter, None)
        return self._pushback is None
