"""Readings that the `karman_pre.gen` cell's limits are set from, on the
card, as silt_bench/control_gen.py reads the generator's: for each seed
the numbers of the program and of the control (the reference with each
operator's output rounded to TF32, put in the program's place), and on the
first `--fault-seeds` seeds those of each planted fault. The faults are
faults.py's apply faults (stale, altered) and a correction solve stopped at
a relative residual of 1e-2 (`loose_lsq`: the program's `solve_correction`
called with tol `LOOSE_TOL` while the run lasts). One JSON line each:

    python3 -m silt_bench.control_pre --seeds 1 2 3 4 5 6 --fault-seeds 3

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from unittest import mock

import torch

from silt_bench import harness
from silt_bench.faults import FAULTS

CELL = "karman_pre.gen"
LOOSE_TOL = 1e-2


@contextlib.contextmanager
def loose_lsq():
    """The program's correction solve stopped at LOOSE_TOL while open."""
    from solver_in_the_loop_torch.apps import karman_pre_gen
    from solver_in_the_loop_torch.pre.lsq import solve_correction

    with mock.patch.object(karman_pre_gen, "solve_correction",
                           functools.partial(solve_correction, tol=LOOSE_TOL)):
        yield


def readings(seed: int, device, seconds: float = 0.0, fault=None, control=False,
             overrides=None) -> dict:
    """The numbers compared in one run of the cell, beside its `correct`."""
    line, diag = harness.run_cell(CELL, seed, seconds, False, device, time.perf_counter(), {},
                                  overrides=overrides, fault=fault, control=control)
    return {"correct": line["correct"], "attempted": line["attempted"],
            "numbers": {k: c["value"] for k, c in line["checks"].items()},
            "check_s": diag["check_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.control_pre")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("silt_bench.control_pre: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        runs = [("program", {}, contextlib.nullcontext), ("control", {"control": True},
                                                          contextlib.nullcontext)]
        if i < args.fault_seeds:
            runs += [(f"fault {name}", {"fault": plant}, contextlib.nullcontext)
                     for name, plant in FAULTS["apply"].items()]
            runs.append(("fault loose_lsq", {}, loose_lsq))
        for what, kwargs, context in runs:
            with context():
                got = readings(seed, device, **kwargs)
            print(json.dumps({"workload": CELL, "seed": seed, "run": what, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
