"""Reading a torch.profiler trace of the traced stretch: device time (the
union of kernel and copy intervals), launches, device time by kernel group,
and the breakdown the result line carries (the device operations that took
most time, and the device's idle time by what the host was doing).

A kernel's group follows from its own name (the port's kernels) or from
the name of the host operation that launched it (the profiler links the
two): cuDNN's convolutions, whatever algorithm it picks (implicit GEMM,
FFT, their layout copies), are the launches of a convolution op.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict

# group: (parts of kernel names, parts of launching op names)
GROUPS = {
    "conv": (("conv_fwd_kernel", "conv_wgrad_kernel", "conv_fwd_bf16_kernel",
              "conv_wgrad_bf16_kernel"), ("convolution", "conv2d", "silt::conv")),
    "pressure": (("pcg_kernel", "cg_kernel"), ("pcg_solve", "cg_solve")),
    "tap_sum": (("tap_sum_fwd_kernel", "tap_sum_bwd_kernel"), ("tap_sum",)),
}
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = re.compile(r"cuda|cu[A-Z]")
TOP = 10
NAME_CHARS = 120


def group_of(name: str, op: str) -> str:
    for group, (kernels, ops) in GROUPS.items():
        if any(k in name for k in kernels) or any(o in op for o in ops):
            return group
    return "other"


def _events(prof):
    """(device events as (start_ns, end_ns, name, launching op), host
    operations as (start_ns, end_ns, name, thread), counts of the device
    events kept and left out).

    A device event is a kernel, copy or memset; the profiler also puts each
    host annotation (record_function) on the device's timeline, under the
    annotation's own name. Where the profiler names activity kinds (newer
    torch), those are kept by kind; else a device event named as a host
    event is taken for an annotation. Host runtime calls (cuda*, cu*) are
    not host operations."""
    from torch.autograd import DeviceType

    raw, host, ops = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if e.device_type() == DeviceType.CUDA:
            raw.append((start, end, name, e.linked_correlation_id(), kind))
        elif not RUNTIME.match(name):
            host.append((start, end, name, e.start_thread_id()))
            ops[e.correlation_id()] = name
    host_names = {h[2] for h in host}
    device, counts = [], Counter()
    for start, end, name, corr, kind in raw:
        keep = kind in DEVICE_KINDS if kind is not None else name not in host_names
        counts["kept" if keep else "left_out"] += 1
        if keep:
            device.append((start, end, name, ops.get(corr, "")))
    return sorted(device), sorted(host), dict(counts)


def _union(device):
    """Merged busy intervals of the sorted device events."""
    busy = []
    for start, end, _, _ in device:
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    return busy


def _host_names(host, points):
    """The innermost host operation running at each point (the latest
    started among those still open, over every thread)."""
    names = [None] * len(points)
    stacks = defaultdict(list)
    i = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        t = points[k]
        while i < len(host) and host[i][0] <= t:
            start, end, name, tid = host[i]
            stack = stacks[tid]
            while stack and stack[-1][1] < start:
                stack.pop()
            stack.append((start, end, name))
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        names[k] = best[2] if best else "(no host operation)"
    return names


def summarize(prof) -> dict:
    """busy_s, launches, per-group seconds and launches, the device events'
    kinds, and the breakdown."""
    device, host, kinds = _events(prof)
    busy = _union(device)
    by_group = defaultdict(lambda: {"s": 0.0, "launches": 0})
    by_name = defaultdict(float)
    for start, end, name, op in device:
        g = by_group[group_of(name, op)]
        g["s"] += (end - start) * 1e-9
        g["launches"] += 1
        by_name[name[:NAME_CHARS]] += (end - start) * 1e-9
    first = min([e[0] for e in host[:1]] + [b[0] for b in busy[:1]], default=0)
    last = max([e[1] for e in host] + [b[1] for b in busy[-1:]], default=0)
    gaps = [(s, e) for s, e in zip([first] + [b[1] for b in busy], [b[0] for b in busy] + [last])
            if e > s]
    idle = defaultdict(float)
    for (s, e), name in zip(gaps, _host_names(host, [(s + e) // 2 for s, e in gaps])):
        idle[name[:NAME_CHARS]] += (e - s) * 1e-9
    return {"busy_s": sum(e - s for s, e in busy) * 1e-9, "launches": len(device),
            "groups": dict(by_group), "device_kinds": kinds,
            "breakdown": {"device_ops": sorted(([n, s] for n, s in by_name.items()),
                                               key=lambda x: -x[1])[:TOP],
                          "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                              key=lambda x: -x[1])[:TOP]}}
