"""Profiling: wall-time spans + device traces (the port's own copy of
iadr1_tpu/core/profiling.py).

The wall-time spans are trl's ``profiling_decorator``/context
(trl/extras/profiling.py), drained into the metrics sink under the same
keys as the JAX package's.  The device trace is a ``torch.profiler`` run
over the host and, where a card is present, its CUDA kernels, written as
a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Callable

# span name -> list of durations (seconds); drained by the metrics logger
_SPANS: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def profiling_context(name: str):
    """Record the wall time of a block under ``profiling/<name>``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        _SPANS[name].append(time.perf_counter() - start)


def profiling_decorator(fn: Callable) -> Callable:
    """Wall-time every call under the function's qualified name."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with profiling_context(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


def drain_profiling_metrics() -> dict[str, float]:
    """Mean duration per span since the last drain (wandb-style keys)."""
    out = {
        f"profiling/Time taken: {name}": sum(vals) / len(vals)
        for name, vals in _SPANS.items()
        if vals
    }
    _SPANS.clear()
    return out


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler``: host ops, and the CUDA
    kernels where a card is present; the Chrome trace is written to
    ``<log_dir>/trace.json`` when the block ends.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace (a ``record_function`` range)."""
    import torch

    return torch.profiler.record_function(name)
