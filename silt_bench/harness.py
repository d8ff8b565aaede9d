"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything particular is found by name: the cell's traffic in
`workloads/<cell>.json`, its configuration in `configs/<config>.json`,
the system that drives the program in `systems/<system>.py`, the kind of
loop in `kinds/<kind>.py`, each end-to-end metric's reader in
`end_to_end/<metric>.py` and each per-layer metric's in
`metrics/<metric>.py`; `BENCHMARK.json` says which metrics a cell reports.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import resource
import statistics
import sys
import time
from pathlib import Path

import torch

from silt_bench import trace as trace_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "solver_in_the_loop_tpu")


def load_module(folder: str, name: str):
    """silt_bench/<folder>/<name>.py (a name may hold dots)."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path.name}")
    key = f"silt_bench.{folder}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, overrides=None):
    """(config, workload) of a cell, each updated from `overrides`'
    "config" and "workload" entries (the tests' small sizes)."""
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{workload['config']}.json").read_text())
    for key, spec in (("config", config), ("workload", workload)):
        for k, v in (overrides or {}).get(key, {}).items():
            spec[k] = v
    return config, workload


def reported(entries, name: str, e2e_names=None):
    """The entries of `entries` that cell `name` reports: those listing it
    under "workloads", and those without the key (per-layer ones only
    where the cell reports the end-to-end metric they move)."""
    out = []
    for entry in entries:
        if "workloads" in entry:
            if name in entry["workloads"]:
                out.append(entry)
        elif e2e_names is None or entry["moves"] in e2e_names:
            out.append(entry)
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _host_counters(cuda: bool, device) -> dict:
    """What a window's host did: garbage collections by generation, this
    process's CPU seconds, and the caching allocator's device allocations,
    frees and retries."""
    out = {f"gc{g}": c["collections"] for g, c in enumerate(gc.get_stats())}
    use = resource.getrusage(resource.RUSAGE_SELF)
    out.update(cpu_user_s=use.ru_utime, cpu_sys_s=use.ru_stime)
    if cuda:
        stats = torch.cuda.memory_stats(device)
        for key in ("num_device_alloc", "num_device_free", "num_alloc_retries"):
            out[key] = stats.get(key, 0)
    return out


def _value(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             spans: dict, overrides=None, fault=None, bench=None, control=False):
    """Run cell `name`; return its result line (a dict) and what the run
    saw besides (set-up spans, the check's seconds). `t0` is the
    perf_counter reading at the process's start; `spans` holds set-up spans
    already taken (setup_import_s). `fault` plants a fault in the program;
    `control` judges the control, the reference in TF32 operands put in
    the program's place, instead of the program (both for the readings
    the limits are set from)."""
    bench = bench or benchmark()
    config, workload = cell(name, overrides)
    system = load_module("systems", config["system"])
    kind = load_module("kinds", workload["kind"])
    cuda = torch.device(device).type == "cuda"

    state = kind.setup(system, config, workload, seed, device, fault)
    spans = dict(spans, setup_warmup_s=state["spans"]["warmup_s"])
    setup_s = time.perf_counter() - t0
    before = _host_counters(cuda, device)
    record = kind.window(state, seconds)
    after = _host_counters(cuda, device)

    extra = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            t_prof = time.perf_counter()
            counters = kind.profile(state)
            window_s = time.perf_counter() - t_prof
        summary = trace_mod.summarize(prof)
        extra = {"summary": summary, "counters": counters, "window_s": window_s}
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    kind.free(state)
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = (kind.control if control else kind.check)(state, device)
    check_s = time.perf_counter() - t_check
    limits = workload["limits"]
    checks = {k: {"value": _value(numbers.get(k)), "limit": limits[k]} for k in limits}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())

    e2e = reported(bench["end_to_end"], name)
    metrics = {}
    if not trace:
        for entry in e2e:
            value = load_module("end_to_end", entry["name"]).read(record, setup_s)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        ctx = {"cell": name, "kind": workload["kind"], "config": config, "workload": workload,
               "unit_wall_s": record["wall_s"] / max(record["units"], 1),
               "profiled_units": extra["counters"]["units"], "trace": extra["summary"],
               "counters": extra["counters"], "spans": spans}
        for entry in reported(bench["per_layer"], name, {e["name"] for e in e2e}):
            value = load_module("metrics", entry["name"]).read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    line = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = extra["summary"]["busy_s"]
        dev["window_s"] = extra["window_s"]
        line["breakdown"] = extra["summary"]["breakdown"]
    line["checks"] = checks
    diag = {"setup": state["spans"], "check_s": check_s,
            "window_counters": {k: after[k] - before[k] for k in after}}
    for key in ("unit_s", "rollout_s"):
        if len(record.get(key, [])) >= 2:
            q = statistics.quantiles(record[key], n=4, method="inclusive")
            diag[f"{key}_quartiles"] = [min(record[key]), *q, max(record[key])]
    if trace:
        diag["device_kinds"] = extra["summary"]["device_kinds"]
    return line, diag
