"""ctypes bindings of the port's native page-file library.

The port of the reference ``native.py``: ``native/pagefile.cpp`` (zlib
page framing, validity bitmaps, page-file scans) is compiled with the host
C++ compiler at first use into ``build/native/libpagefile.so`` under the
repository root (to a per-process temp file, then renamed into place) and
bound through ctypes.  Nothing is compiled at import and nothing is
written next to the source.  Unlike the reference there is no pure-Python
fallback: :func:`load` raises with the compiler's output when the build
fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "lib_path", "source_path"]

_SRC = Path(__file__).resolve().parent / "native" / "pagefile.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
_SO = _BUILD_DIR / "libpagefile.so"
_COMPILERS = ("c++", "g++")

_lock = threading.Lock()
_lib = None


def lib_path() -> str:
    return str(_SO)


def source_path() -> str:
    return str(_SRC)


def _build() -> None:
    """Compile the source into the library path; raise with every
    compiler's output when none succeeds."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for cc in _COMPILERS:
        try:
            proc = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC),
                 "-lz"], capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, _SO)
            return
        errors.append(f"{cc} (exit {proc.returncode}):\n{proc.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"building {_SO} from {_SRC} failed:\n"
                       + "\n".join(errors))


def load():
    """The loaded library with typed signatures, built first when it is
    missing or older than its source."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.ttp_deflate.argtypes = [u8p, i64, u8p, i64, ctypes.c_int]
        lib.ttp_deflate.restype = i64
        lib.ttp_deflate_bound.argtypes = [i64]
        lib.ttp_deflate_bound.restype = i64
        lib.ttp_inflate.argtypes = [u8p, i64, u8p, i64]
        lib.ttp_inflate.restype = i64
        lib.ttp_pack_bits.argtypes = [u8p, i64, u8p]
        lib.ttp_pack_bits.restype = None
        lib.ttp_unpack_bits.argtypes = [u8p, i64, u8p]
        lib.ttp_unpack_bits.restype = None
        lib.ttp_scan_frames.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(i64), i64]
        lib.ttp_scan_frames.restype = i64
        lib.ttp_read_frame.argtypes = [ctypes.c_char_p, i64, i64, u8p]
        lib.ttp_read_frame.restype = i64
        _lib = lib
        return _lib
