"""Profiling helpers: a device trace of a block of code, and a timer.

Port of solver_in_the_loop_tpu/utils/profiling.py on torch.profiler: `trace`
records the host's operators and, where a CUDA card is present, its kernels,
and writes a Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, which
TensorBoard's profiler plugin and chrome://tracing read) into `out_dir`.
`timeit` waits for the card after every call, as the JAX one blocks on its
result.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def trace(out_dir: str):
    """Trace the enclosed block into a Chrome trace file in `out_dir`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(out_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def trace_files(out_dir: str) -> list:
    """The trace files `trace` wrote into `out_dir`, sorted."""
    return sorted(glob.glob(os.path.join(out_dir, "*.pt.trace.json")))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, warmup: int = 2, iters: int = 10, **kwargs) -> float:
    """Median wall-clock seconds per call, each call waited for on the card."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
