"""Readings that the check's limits are set from, for one cell, on the card:
for each seed the numbers of the program and of the control (the
reference in TF32 operands, the precision below the configuration's
float32, put in the program's place), each from a whole run of the cell
(`harness.run_cell`) with a short window, judged as a run judges them;
on the first `--fault-seeds` seeds also the numbers of each planted fault
of faults.py. One JSON line each:

    python3 -m silt_bench.control --workload karman_sol32.train --seeds 1 2 3 --fault-seeds 3

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


def readings(name: str, seed: int, seconds: float, device, fault=None,
             control=False) -> dict:
    """The numbers compared in one run of cell `name` (the program's, with
    `fault` planted, or the control's), beside the run's `correct`."""
    line, diag = harness.run_cell(name, seed, seconds, False, device, time.perf_counter(),
                                  {}, fault=fault, control=control)
    return {"correct": line["correct"], "attempted": line["attempted"],
            "numbers": {k: c["value"] for k, c in line["checks"].items()},
            "check_s": diag["check_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="window: a run holds at least the cell's checked iterations or "
                        "rollouts however short it is")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control on the first N seeds (default: all)")
    p.add_argument("--fault-seeds", type=int, default=0,
                   help="read each planted fault on the first N seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("silt_bench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = harness.cell(args.workload)[1]["kind"]
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        runs = [("program", None, False)] + ([("control", None, True)] if i < n_control else [])
        if i < args.fault_seeds:
            runs += [(f"fault {name}", plant, False) for name, plant in FAULTS[kind].items()]
        for what, plant, control in runs:
            got = readings(args.workload, seed, args.seconds, device, plant, control)
            print(json.dumps({"workload": args.workload, "seed": seed, "run": what, **got}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
