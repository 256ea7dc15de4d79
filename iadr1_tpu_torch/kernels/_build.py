"""Build and load the hand-written CUDA kernels (no JAX counterpart).

Each source under ``iadr1_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes``.  Libraries go to ``build/kernels/`` at the repository root
(listed in ``.gitignore``) and are rebuilt when their source, or any shared
header ``csrc/*.cuh``, is newer.
``build_all`` starts one ``nvcc`` per source, all at once.  Nothing is
built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(source: str) -> Path:
    return BUILD_DIR / (Path(source).stem + ".so")


def _stale(source: str) -> bool:
    lib = _lib_path(source)
    if not lib.exists():
        return True
    inputs = [CSRC / source, *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_all(sources) -> float:
    """Compile every stale source, one ``nvcc`` each, all started at once;
    returns the wall seconds.  The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``<stem>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for source in dict.fromkeys(sources):     # one nvcc per distinct source
        if not _stale(source):
            continue
        lib = _lib_path(source)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=log, stderr=subprocess.STDOUT)
        started.append((source, proc, tmp, lib))
    failures = []
    for source, proc, tmp, lib in started:
        if proc.wait() != 0:
            failures.append(f"nvcc failed on {source}:\n"
                            + lib.with_suffix(".log").read_text())
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


class CudaKernel:
    """One C entry point of one source, with its launch count.

    ``launch`` adds one to ``launches`` and raises if the C function
    returns a non-zero ``cudaGetLastError()``."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            build_all([self.source])
            lib = ctypes.CDLL(str(_lib_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed (cudaError {rc})")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
