"""Readings that the `karman_gen.hires_b6` cell's limit is set from, on the
card, as silt_bench/control.py reads the other cells': for each seed the
numbers of the program and of the control (the reference with every field
rounded to TF32 after each operator, put in the program's place), and on
the first `--fault-seeds` seeds those of each planted fault. The faults
are faults.py's apply faults (stale, altered) and a solve stopped at a
relative residual of 1e-3 (`LOOSE`: the program's configuration
overridden, the reference's left as it is). One JSON line each:

    python3 -m silt_bench.control_gen --seeds 1 2 3 4 5 6 --fault-seeds 6

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from silt_bench import harness
from silt_bench.faults import FAULTS

CELL = "karman_gen.hires_b6"
LOOSE = {"config": {"pressure": {"tol": 1e-3, "max_iter": 1000, "precon": "fd"}}}


def readings(seed: int, device, seconds: float = 0.0, fault=None, control=False,
             overrides=None) -> dict:
    """The numbers compared in one run of the cell, beside its `correct`."""
    line, diag = harness.run_cell(CELL, seed, seconds, False, device, time.perf_counter(), {},
                                  overrides=overrides, fault=fault, control=control)
    return {"correct": line["correct"], "attempted": line["attempted"],
            "numbers": {k: c["value"] for k, c in line["checks"].items()},
            "check_s": diag["check_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.control_gen")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("silt_bench.control_gen: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        runs = [("program", {}), ("control", {"control": True})]
        if i < args.fault_seeds:
            runs += [(f"fault {name}", {"fault": plant}) for name, plant in FAULTS["apply"].items()]
            runs.append(("fault loose_solve", {"overrides": LOOSE}))
        for what, kwargs in runs:
            got = readings(seed, device, **kwargs)
            print(json.dumps({"workload": CELL, "seed": seed, "run": what, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
