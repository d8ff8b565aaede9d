"""What the per-layer metric readers (metrics/<name>.py) share: a traced
run's numbers per unit of its cell (a training iteration or a rollout
step).

A reader's `ctx` holds: `kind` ("train" or "apply"); `config` and
`workload`; `unit_wall_s`, the window's wall seconds per unit (the
unprofiled stretch); `profiled_units`; `trace` (trace.summarize over the
profiled stretch); `counters` (what the profiled stretch reported, such as
the solves' `cg_iters`); `spans` (the benchmark's set-up spans).
"""

from __future__ import annotations

from typing import Optional


def group_per_unit(ctx, group: str) -> Optional[dict]:
    """Device seconds and launches of a kernel group per unit, or None
    where the trace holds none of its kernels."""
    g = ctx["trace"]["groups"].get(group)
    if not g or not g["launches"]:
        return None
    n = ctx["profiled_units"]
    return {"s": g["s"] / n, "launches": g["launches"] / n}


def idle_pct(ctx) -> float:
    """The device's idle share of the unprofiled wall time per unit: busy
    seconds per unit from the profiled stretch, which the profiler slows on
    the host and not on the device."""
    busy = ctx["trace"]["busy_s"] / ctx["profiled_units"]
    return 100.0 * (1.0 - busy / ctx["unit_wall_s"])
