"""The program's phases in one cell, from its own spans and counters
(solver_in_the_loop_torch/utils/profiling.py), printed as one JSON line:

    python3 -m silt_bench.phases --workload karman_sol32.train --seed 7 --seconds 20

It runs a cell as a `--trace 1` run of silt_bench.run does, without the
check: set-up (recorded), the window (tracing off: its wall time per unit),
the recorded stretch (`profile_units` iterations or `profile_rollouts`
rollouts with a recording open and the profiler off), then the profiled
stretch (as many more under torch.profiler, a recording open beside it for
the counters). The line holds the eight metrics of spans.METRICS; every
`silt.*` span's milliseconds per unit over the recorded stretch; the share
of the recorded stretch's wall time per unit that the train step's phases
(forward, backward, optimizer) or a rollout step's solver and net cover;
the recorded stretch's wall time per unit against the window's, which is
what recording costs; the profiled stretch's launches per unit and its
`spans` table (spans.spans_table). `--out FILE` writes the line there too.
Without a CUDA card it prints nothing and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

COVER = {"train": ("silt.train.forward", "silt.train.backward", "silt.train.optimizer"),
         "apply": ("silt.solver", "silt.net")}


def _stretch(kind, state):
    """kind.profile(state): (its counters, its wall seconds)."""
    t = time.perf_counter()
    counters = kind.profile(state)
    return counters, time.perf_counter() - t


def measure(name: str, seed: int, seconds: float, device, t0: float, overrides=None) -> dict:
    """The line of cell `name` on `device`; `t0` is the perf_counter
    reading that set-up is timed from, `overrides` harness.cell's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from silt_bench import harness, spans, trace
    from solver_in_the_loop_torch.utils import profiling

    config, workload = harness.cell(name, overrides)
    system = harness.load_module("systems", config["system"])
    kind = harness.load_module("kinds", workload["kind"])
    with profiling.recording() as setup_rec:
        state = kind.setup(system, config, workload, seed, device)
    setup_s = time.perf_counter() - t0
    record = kind.window(state, seconds)
    unit_wall_s = record["wall_s"] / max(record["units"], 1)
    with profiling.recording() as rec:
        counters, recorded_wall_s = _stretch(kind, state)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    with profiling.recording() as prof_rec, profile(activities=acts) as prof:
        prof_counters, profiled_wall_s = _stretch(kind, state)
    kind.free(state)
    summary = trace.summarize(prof)
    units, recording = counters["units"], rec.read()
    ctx = {"cell": name, "kind": workload["kind"], "config": config, "workload": workload,
           "unit_wall_s": unit_wall_s, "profiled_units": prof_counters["units"],
           "trace": summary, "counters": prof_counters, "spans": {}, "recording": recording,
           "recorded_units": units, "setup_recording": setup_rec.read(),
           "profiled_counters": prof_rec.read()["counters"]}
    metrics = {metric: entry[3](ctx) for metric, entry in spans.METRICS.items()}
    per_span = {span: spans.span_ms_per_unit(recording, span, units)
                for span in sorted({s[0] for s in recording["spans"]})}
    recorded_unit_ms = 1e3 * recorded_wall_s / units
    return {"cell": name, "seed": seed, "torch": torch.__version__, "setup_s": setup_s,
            "metrics": {k: v for k, v in metrics.items() if v is not None},
            "span_ms_per_unit": per_span,
            "covered": sum(per_span.get(n) or 0.0 for n in COVER[workload["kind"]])
            / recorded_unit_ms,
            "window_unit_ms": 1e3 * unit_wall_s, "recorded_unit_ms": recorded_unit_ms,
            "profiled_unit_ms": 1e3 * profiled_wall_s / prof_counters["units"],
            "window_units": record["units"], "recorded_units": units,
            "launches_per_unit": summary["launches"] / prof_counters["units"],
            "counters_per_unit": {k: sum(v) / units for k, v in recording["counters"].items()},
            "spans_table": spans.spans_table(prof),
            "idle_gaps": summary["breakdown"]["idle_gaps"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.phases")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"

    import torch

    if not torch.cuda.is_available():
        print("silt_bench.phases: needs a CUDA card", file=sys.stderr)
        return 2
    from silt_bench.run import _card_line

    device = torch.device("cuda", 0)
    import solver_in_the_loop_torch.train.rollout  # noqa: F401
    import solver_in_the_loop_torch.train.trainer  # noqa: F401

    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    line = measure(args.workload, args.seed, args.seconds, device, T0)
    line["card"] = _card_line(device)
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
