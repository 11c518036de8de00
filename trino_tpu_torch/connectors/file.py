"""File connector: durable columnar tables on local disk.

The port of the reference ``connectors/file.py`` (the role plugin/trino-hive
plays for warehouse files): a table is a directory holding ``schema.json``
and one page file per written fragment.  Pages are the engine's v1 serde
pages in v1 frames (execution/serde.py), byte for byte the reference's, so
either package reads the other's tables.  Splits map 1:1 to page files.

Reads go through the port's native library (``native/pagefile.cpp`` via
trino_tpu_torch/native.py, built at first use; there is no pure-Python
read path): ``ttp_scan_frames`` finds a file's frames when its page source
opens, and ``ttp_read_frame`` reads one frame per batch.  A page decodes
only the columns the scan asked for.  The batches are host batches, so the
scan takes the asynchronous ingest path (exec/prefetch.py) like the tpch
connector's.  :attr:`FileConnector.read_stats` counts the frames, the bytes
read and inflated, and the seconds of reading, inflating and decoding.

Not ported: the result-cache invalidation on every write (the port has no
result cache yet).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from .. import native
from ..caching import result_cache
from ..execution.serde import (decode_page, inflate_page, serialize_batch,
                               write_frame)
from ..spi.batch import ColumnBatch
from ..spi.connector import (
    ColumnSchema,
    Connector,
    ConnectorPageSink,
    ConnectorPageSource,
    Split,
    TableSchema,
    TableStatistics,
)
from ..spi.types import parse_type

__all__ = ["FileConnector", "FileReadStats", "page_frames"]


@dataclass
class FileReadStats:
    """What the connector's page sources read (all sources together)."""

    frames: int = 0
    bytes_read: int = 0      # frame bytes read from disk
    bytes_inflated: int = 0  # page payload bytes after zlib
    read_s: float = 0.0      # native frame reads
    inflate_s: float = 0.0   # zlib
    decode_s: float = 0.0    # page bytes -> columns


def page_frames(path: str) -> list:
    """(offset, length) of every frame of a page file (``ttp_scan_frames``)."""
    lib = native.load()
    cap = 4096
    while True:
        out = (ctypes.c_int64 * (2 * cap))()
        n = lib.ttp_scan_frames(path.encode(), out, cap)
        if n < 0:
            raise IOError(f"corrupt page file: {path}")
        if n <= cap:
            return [(out[2 * i], out[2 * i + 1]) for i in range(n)]
        cap = n


class _FilePageSource(ConnectorPageSource):
    def __init__(self, conn: "FileConnector", path: str,
                 columns: Sequence[str]):
        self._lib = native.load()
        self._conn = conn
        self._path = path
        self._frames = page_frames(path)
        self._columns = list(columns)
        self._i = 0

    def get_next_batch(self) -> Optional[ColumnBatch]:
        if self._i >= len(self._frames):
            return None
        offset, length = self._frames[self._i]
        self._i += 1
        t0 = time.perf_counter()
        buf = bytearray(length)
        dst = (ctypes.c_uint8 * length).from_buffer(buf)
        if self._lib.ttp_read_frame(self._path.encode(), offset, length,
                                    dst) != length:
            raise IOError(f"short read: {self._path}")
        del dst  # release the buffer export
        t1 = time.perf_counter()
        magic, payload = inflate_page(buf)
        t2 = time.perf_counter()
        batch = decode_page(magic, payload, self._columns)
        t3 = time.perf_counter()
        self._conn._count_read(length, len(payload), t1 - t0, t2 - t1,
                               t3 - t2)
        return batch

    def is_finished(self) -> bool:
        return self._i >= len(self._frames)


class _FilePageSink(ConnectorPageSink):
    def __init__(self, path: str):
        self._path = path
        self._file = open(path, "wb")
        self.rows = 0

    def append(self, batch: ColumnBatch) -> bool:
        batch = batch.compact()  # on its device
        if batch.num_rows == 0:
            return True
        write_frame(self._file, serialize_batch(batch))
        self.rows += batch.num_rows
        return True

    def finish(self) -> list[Any]:
        self._file.close()
        return [(self._path, self.rows)]


class FileConnector(Connector):
    name = "file"

    def __init__(self, root: Optional[str] = None):
        # root=None: a temp directory made at first use, so idle catalogs
        # leave nothing behind
        self._root = root
        # metadata paths read self.root under it; page sources count reads
        self._lock = threading.RLock()
        self._sink_seq = 0
        self.read_stats = FileReadStats()

    @property
    def root(self) -> str:
        with self._lock:
            if self._root is None:
                self._root = tempfile.mkdtemp(prefix="trino-tpu-file-")
            os.makedirs(self._root, exist_ok=True)
            return self._root

    def _count_read(self, nbytes: int, inflated: int, read_s: float,
                    inflate_s: float, decode_s: float) -> None:
        with self._lock:
            st = self.read_stats
            st.frames += 1
            st.bytes_read += nbytes
            st.bytes_inflated += inflated
            st.read_s += read_s
            st.inflate_s += inflate_s
            st.decode_s += decode_s

    # ---- metadata -------------------------------------------------------
    def _dir(self, table: str) -> str:
        return os.path.join(self.root, table)

    def _meta_path(self, table: str) -> str:
        return os.path.join(self._dir(table), "schema.json")

    def _meta(self, table: str) -> dict:
        try:
            with open(self._meta_path(table)) as f:
                return json.load(f)
        except FileNotFoundError:
            raise KeyError(f"file: no such table {table!r}") from None

    def list_tables(self) -> list[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.exists(self._meta_path(d)))

    def get_table_schema(self, table: str) -> TableSchema:
        meta = self._meta(table)
        return TableSchema(table, tuple(
            ColumnSchema(c["name"], parse_type(c["type"]))
            for c in meta["columns"]))

    def get_table_statistics(self, table: str) -> TableStatistics:
        analyzed = getattr(self, "_analyzed_stats", {}).get(table)
        if analyzed is not None:
            return analyzed
        try:
            meta = self._meta(table)
        except KeyError:
            return TableStatistics()
        return TableStatistics(row_count=float(meta.get("rows", 0)))

    def row_count(self, table: str) -> int:
        """Rows held, from ``schema.json``."""
        return int(self._meta(table).get("rows", 0))

    def data_version(self, table: str):
        """The on-disk content signature: the page-file list (names are
        never reused) and the row count."""
        meta = self._meta(table)
        return f"{meta.get('rows', 0)}:{','.join(meta.get('pages', []))}"

    def create_table(self, schema: TableSchema) -> None:
        if os.path.exists(self._meta_path(schema.name)):
            raise ValueError(f"file: table {schema.name!r} already exists")
        os.makedirs(self._dir(schema.name), exist_ok=True)
        with open(self._meta_path(schema.name), "w") as f:
            json.dump({
                "columns": [{"name": c.name, "type": str(c.type)}
                            for c in schema.columns],
                "rows": 0,
                "pages": [],
            }, f)
        self._invalidate(schema.name)

    def drop_table(self, table: str) -> None:
        shutil.rmtree(self._dir(table), ignore_errors=True)
        getattr(self, "_analyzed_stats", {}).pop(table, None)
        self._invalidate(table)

    def _invalidate(self, table: str) -> None:
        """Drop the result cache's entries that read ``table`` (its
        content signature changed, so they could never be served)."""
        result_cache.invalidate_table(self.name, table)

    # ---- scan -----------------------------------------------------------
    def get_splits(self, table: str, splits_per_node: int,
                   node_count: int) -> list[Split]:
        meta = self._meta(table)
        return [Split("file", table, os.path.join(self._dir(table), p))
                for p in meta["pages"]]

    def create_page_source(self, split: Split, columns: Sequence[str],
                           constraint=None) -> ConnectorPageSource:
        return _FilePageSource(self, split.info, columns)

    # ---- write ----------------------------------------------------------
    def create_page_sink(self, table: str) -> ConnectorPageSink:
        self.get_table_schema(table)  # existence check
        with self._lock:
            self._sink_seq += 1
            # unique across processes, catalogs and packages sharing a root
            name = (f"part-{os.getpid()}-{self._sink_seq}-"
                    f"{uuid.uuid4().hex[:12]}.bin")
        return _FilePageSink(os.path.join(self._dir(table), name))

    def finish_insert(self, table: str, fragments: list[Any]) -> None:
        with self._lock:
            meta = self._meta(table)
            for frag in fragments:
                path, rows = frag[0] if isinstance(frag, list) else frag
                if rows == 0:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                meta["pages"].append(os.path.basename(path))
                meta["rows"] += rows
            with open(self._meta_path(table), "w") as f:
                json.dump(meta, f)
        self._invalidate(table)
