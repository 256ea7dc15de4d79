"""Build and load the native packing plane (``csrc/dataplane.cpp``).

The host C++ compiler (``c++``, else ``g++``) builds the source into
``build/native/libdataplane.so`` at the repository root (listed in
``.gitignore``) at first use, never at import, and rebuilds it when the
source is newer; ``ctypes`` loads it.  The compiler writes a temporary file
that is renamed into place, so processes that build at once do not
collide.  A failed build or load raises with the compiler's log: nothing
falls back to the Python packing by itself (``pack_examples(...,
use_native=False)`` is the caller's choice of it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dataplane.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def lib_path() -> Path:
    return BUILD_DIR / "libdataplane.so"


def _compiler() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the native "
                       f"packing plane ({SOURCE.name}) cannot be built")


def _stale() -> bool:
    lib = lib_path()
    return not lib.exists() or lib.stat().st_mtime < SOURCE.stat().st_mtime


def start_build():
    """Start the compiler if the library is missing or older than its
    source; returns what ``finish_build`` waits for (None when fresh)."""
    if not _stale():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = lib_path()
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    log = tmp.with_suffix(".log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            stdout=out, stderr=subprocess.STDOUT)
    return proc, tmp, log


def finish_build(started) -> None:
    """Wait for ``start_build``'s compiler; raises with its log if it
    failed."""
    if started is None:
        return
    proc, tmp, log = started
    rc = proc.wait()
    text = log.read_text()
    log.unlink()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit {rc}):\n"
                           + text)
    os.replace(tmp, lib_path())


def build() -> float:
    """Build the library if it is stale; returns the wall seconds."""
    t0 = time.perf_counter()
    finish_build(start_build())
    return time.perf_counter() - t0


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.greedy_knapsack.restype = ctypes.c_int64
    lib.greedy_knapsack.argtypes = [i64, ctypes.c_int64, ctypes.c_int64,
                                    i64, i64]
    lib.pack_rows.restype = None
    lib.pack_rows.argtypes = [
        i32, i32, i64, i64, i64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, i32, i32, i32, i32]
    return lib


def load() -> ctypes.CDLL:
    """The library, built first if needed; raises if it cannot be built
    or loaded."""
    with _lock:
        key = str(lib_path())
        if key not in _libs:
            build()
            try:
                _libs[key] = _configure(ctypes.CDLL(key))
            except OSError as err:
                raise RuntimeError(f"loading {key} failed: {err}") from None
        return _libs[key]


def as_i64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def as_i32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
