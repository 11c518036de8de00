"""The disk spill tier: serialized pages in an anonymous temp file.

The port of the reference ``exec/spill.py`` (FileSingleStreamSpiller.java:57
+ GenericSpillerFactory): the tier below the device -> host revocation of
exec/revoking.py.  When an operator's buffered bytes exceed the session's
``spill_to_disk_bytes``, its batches are written as compressed v1 pages
(execution/serde.py) in v1 frames to a file of its own, unlinked as soon
as it is opened, and read back at finish.  ``write_s`` / ``read_s`` are
the seconds spent writing and reading back (serialization and IO).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Iterator, Optional

from ..execution.serde import (deserialize_batch, iter_frames,
                               serialize_batch, write_frame)
from ..spi.batch import ColumnBatch

__all__ = ["Spiller"]


class Spiller:
    """Append-only page spill file of one operator."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._dir = spill_dir
        self._file = None
        self.pages_spilled = 0
        self.bytes_spilled = 0
        self.write_s = 0.0
        self.read_s = 0.0

    def spill(self, batch: ColumnBatch) -> None:
        t0 = time.perf_counter()
        if self._file is None:
            fd, path = tempfile.mkstemp(prefix="trino-tpu-spill-",
                                        suffix=".bin", dir=self._dir)
            self._file = os.fdopen(fd, "w+b")
            os.unlink(path)  # anonymous: gone with the descriptor
        page = serialize_batch(batch)
        write_frame(self._file, page)
        self.pages_spilled += 1
        self.bytes_spilled += len(page)
        self.write_s += time.perf_counter() - t0

    def read_back(self) -> Iterator[ColumnBatch]:
        """The spilled batches in the order they were written, as host
        batches."""
        if self._file is None:
            return
        self._file.seek(0)
        frames = iter_frames(self._file)
        while True:
            t0 = time.perf_counter()
            frame = next(frames, None)
            if frame is None:
                return
            batch = deserialize_batch(frame)
            self.read_s += time.perf_counter() - t0
            yield batch

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
