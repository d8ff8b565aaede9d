"""Run one cell of the benchmark of `solver_in_the_loop_torch` on the CUDA
card(s) of this machine, and print its result as the last line of
standard output:

    python3 -m silt_bench.run --workload karman_sol32.train --seed 7 --seconds 30 --trace 0

`--trace 0` measures the cell's end-to-end metrics; `--trace 1` its
per-layer metrics, from a torch.profiler trace of a stretch run after the
window. Every run checks what its timed path produced against the plain
reference in silt_bench/reference/ and prints each number compared beside
its limit as its last lines on standard error. Without a CUDA card, or
with fewer than the cell asks for, it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _card_line(device) -> str:
    """The card's name and power limit (nvidia-smi), or its name alone."""
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return smi.stdout.strip().splitlines()[torch.device(device).index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"

    from silt_bench import harness

    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"silt_bench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"silt_bench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    import solver_in_the_loop_torch.train.rollout  # noqa: F401
    import solver_in_the_loop_torch.train.trainer  # noqa: F401

    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    spans = {"setup_import_s": time.perf_counter() - T0}

    line, diag = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  device, T0, spans, bench=bench)
    line["device"]["count"] = entry["chips"]
    print(f"silt_bench: card {_card_line(device)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    print(f"silt_bench: {json.dumps(dict(diag, **spans))}", file=sys.stderr)
    print(f"silt_bench: memory peak {line['device']['memory_peak_bytes']} bytes; "
          f"{line['attempted']} attempted, {line['failed']} failed", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"silt_bench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
