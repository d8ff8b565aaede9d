"""Profiling: a device trace of a block of code, and the program's own spans
and counters.

`trace` is the port of solver_in_the_loop_tpu/utils/profiling.py on
torch.profiler (the CLIs' --profile): it records the host's operators and,
where a CUDA card is present, its kernels, and writes a Chrome trace
(`<host>_<pid>.<ms>.pt.trace.json`, which TensorBoard's profiler plugin and
chrome://tracing read) into `out_dir`.

`span(name)` brackets a phase of the program and `count(name, value)` notes
a number the program made. Both act only where someone looks:

* off, the default (no torch.profiler active, no recording open): `span`
  returns one shared null context and `count` returns at once. Nothing is
  allocated, launched or read from the device.
* under torch.profiler: `span` also enters `torch.profiler.record_function`,
  so the span lies on the trace's host timeline, on the kernels' clock.
* inside `recording()`: `span` appends (name, start_ns, end_ns, parent,
  thread) to the recording, on `time.perf_counter_ns`. `parent` is the
  index of the innermost span open on the same thread; a thread with no
  open span takes the innermost span open on any other thread (the autograd
  engine runs a CUDA backward on a thread of its own while the caller waits
  inside `loss.backward()`). `count` appends its value as it is, a 0-d
  device tensor included; `Recording.read` waits for the device and turns
  the values into numbers, so a counter adds no host read.

The names are fixed:

  silt.train.forward      train/trainer.py, each train step's unrolled loss
  silt.train.backward     train/trainer.py `_backward`: loss.backward(), with
                          the remat's recomputes and the adjoint solves in it
  silt.train.recompute    one unrolled step re-run by the remat (utils/remat.py)
  silt.train.optimizer    `GuardedAdam.step`, the whole guarded update
  silt.train.guard        its child: the finite flag's host read
  silt.solver             one solver step (physics/karman.py, physics/burgers.py)
  silt.net                features -> net -> staggered correction, added
  silt.rollout.step       one step of a rollout (train/rollout.py)
  silt.pressure           one forward pressure solve (ops/poisson.py
                          `pressure_cg_solve`), on every route
  silt.pressure.adjoint   one cold adjoint solve in the backward
  silt.pressure.vcycle    one multigrid preconditioner apply (ops/multigrid.py
                          `v_cycle` from its top level, or a graph's replay)
  silt.pre.frame          one frame of the PRE generator (apps/karman_pre_gen.py
                          `PreFrame`): both steps, the projection, the correction
  silt.pre.lsq            the correction solve (pre/lsq.py `solve_correction`)
  silt.pre.lsq.project    its child: one projection's inner CG
  silt.kernels.load       kernels/build.py: a kernel library's first load
  silt.kernels.nvcc       its child where nvcc builds the library

  pressure.iters          a forward solve's iterations (0-d int32 tensor)
  pressure.adjoint_iters  an adjoint solve's iterations
  pressure.host_reads     1 for each stop test of a plain (P)CG loop, a host
                          read of the residuals (kernels/cg.py)
  multigrid.vcycles       the V-cycles one multigrid solve ran
  multigrid.kernel_cycles those of them the CUDA kernels ran (kernels/vcycle.py;
                          all of them on the card, 0 on the CPU)
  multigrid.graph_replays those of them replayed from a CUDA graph
                          (ops/multigrid.py `GraphedCycle`; 0 on the CPU)
  multigrid.graph_captures
                          the V-cycle graphs the solve captured (0 or 1)
  pre.lsq_outer_iters     a correction solve's outer (projected CG) iterations
  pre.lsq_inner_iters     its projections' inner CG iterations, summed
  pre.lsq_host_reads      1 for each host read of a stop flag in pre/lsq.py `_loop`
  pre.lsq_kernel_projections
                          1 for each projection whose inner CG the fused kernel
                          ran (csrc/cg.cu through kernels/cg.py `cg_solve`, on
                          the card; the CPU runs `tree_cg` and counts none)
  kernels.nvcc_builds     the libraries one nvcc run built
  remat.taped             the sites one remat step taped in its forward
  remat.replayed          the sites its recompute replayed
"""

from __future__ import annotations

import contextlib
import glob
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
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


class Recording:
    """What the program did while a `recording()` was open.

    `spans`: (name, start_ns, end_ns, parent, thread) in the order the spans
    opened; `end_ns` is None while a span is open, `parent` the index of
    its parent span or None. `counters`: name -> values in the order
    counted, device tensors as they were handed over."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._open: dict = {}  # thread -> indices of its open spans, innermost last
        self._lock = threading.Lock()

    def _parent(self, thread: int) -> Optional[int]:
        stack = self._open.get(thread)
        if stack:
            return stack[-1]
        tops = [s[-1] for s in self._open.values() if s]
        return max(tops, key=lambda i: self.spans[i][1]) if tops else None

    def _enter(self, name: str) -> int:
        thread = threading.get_ident()
        with self._lock:
            index = len(self.spans)
            self.spans.append((name, time.perf_counter_ns(), None, self._parent(thread), thread))
            self._open.setdefault(thread, []).append(index)
        return index

    def _exit(self, index: int) -> None:
        end = time.perf_counter_ns()
        with self._lock:
            name, start, _, parent, thread = self.spans[index]
            self.spans[index] = (name, start, end, parent, thread)
            self._open[thread].remove(index)

    def read(self) -> dict:
        """{"spans": the spans, "counters": name -> numbers}, after waiting
        for the card, so that every counted tensor holds its value."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        counters = {name: [v.item() if torch.is_tensor(v) else v for v in values]
                    for name, values in self.counters.items()}
        return {"spans": list(self.spans), "counters": counters}


_NULL = contextlib.nullcontext()
_recording: Optional[Recording] = None


class _Span:
    __slots__ = ("name", "recording", "index", "annotation")

    def __init__(self, name: str, rec: Optional[Recording]):
        self.name, self.recording, self.index, self.annotation = name, rec, None, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.recording is not None:
            self.index = self.recording._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            self.recording._exit(self.index)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """A context that brackets one phase of the program as `name`: the
    shared null context unless a torch.profiler is active or a recording
    is open."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, _recording)


def count(name: str, value) -> None:
    """Append `value` (a number or a device tensor, kept as it is) to the
    open recording's counter `name`; nothing without a recording."""
    rec = _recording
    if rec is not None:
        rec.counters.setdefault(name, []).append(value)


@contextlib.contextmanager
def recording():
    """Record every span and counter of the program while open (one at a
    time); yields the Recording."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    _recording = rec = Recording()
    try:
        yield rec
    finally:
        _recording = None
