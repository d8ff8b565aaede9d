"""Build and load the hand-written CUDA kernels of `solver_in_the_loop_torch/csrc`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, which is loaded with `ctypes`: this builds in
seconds, where an extension that includes PyTorch's headers takes minutes.
Libraries go to `build/kernels/` at the root of the checkout (ignored by git),
named by a hash of the flags, the source and the headers of csrc/ it includes,
so a changed source or header is rebuilt and a stale library is never
loaded. Nothing is built when this module is imported: the first kernel
launch builds its library, and `build_all` builds every source at once, one
`nvcc` per source, all started together. A library's first load in a
process is a `silt.kernels.load` span, an nvcc run a `silt.kernels.nvcc`
span with the libraries it built counted as `kernels.nvcc_builds`
(utils/profiling.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict

from solver_in_the_loop_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# per-source extra flags; the tap-sum and the V-cycle keep multiply and add
# separate so they match their plain PyTorch twins bit for bit (see
# csrc/advect.cu, csrc/vcycle.cu)
SOURCES: Dict[str, list] = {
    "advect": ["--fmad=false"],
    "vcycle": ["--fmad=false"],
    "pcg": [],
    "cg": [],
    "cg_cluster": [],
    "conv": [],
    "conv_bf16": [],
}
COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, Callable] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> list:
    """csrc/<name>.cu and every header of csrc/ it includes, directly or
    through another header (`#include "..."`), in the order first reached."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / m for m in _INCLUDE.findall(path.read_text())]
    return found


def _lib_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of the flags, the source
    and every header it includes, so an edit to any of them builds anew."""
    flags = COMMON_FLAGS + SOURCES[name]
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in _inputs(name))
                          + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(names) -> Dict[str, dict]:
    """Run one nvcc per source, all started together; returns, per source, the
    seconds until its library was in place and the register, shared-memory
    and spill report of ptxas."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    started = {}
    with profiling.span("silt.kernels.nvcc"):
        for name in names:
            out = _lib_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *COMMON_FLAGS, *SOURCES[name], "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), tmp, out)
        report = {}
        for name, (proc, tmp, out) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            report[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": [ln.strip() for ln in log.splitlines()
                                      if "ptxas info" in ln or "spill" in ln]}
    profiling.count("kernels.nvcc_builds", len(names))
    return report


def build_all(force: bool = False) -> Dict[str, dict]:
    """Compile every kernel source (only the missing ones unless `force`)."""
    return _compile([n for n in SOURCES if force or not _lib_path(n).exists()])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        with profiling.span("silt.kernels.load"):
            if not _lib_path(name).exists():
                _compile([name])
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]


def function(name: str, symbol: str, argtypes) -> Callable:
    """The C entry point `symbol` of csrc/<name>.cu with its argument types
    declared (pointers and the stream as c_void_p) and an int result, the
    cudaError_t of the launch. Configured once per process."""
    key = (name, symbol)
    if key not in _functions:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
