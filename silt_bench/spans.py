"""The program's own spans and counters (solver_in_the_loop_torch/utils/
profiling.py) as the benchmark reads them: a span's milliseconds per unit
over a recorded stretch, the `spans` table over a profiled stretch (host,
device and idle seconds per `silt.*` span), and the readers of the eight
metrics that rest on them.

A recording is what the program's `Recording.read()` returns: {"spans":
[(name, start_ns, end_ns, parent, thread), ...], "counters": {name:
[numbers]}}. A reader's `ctx` holds what readers.py names and, besides:
`recording` and `recorded_units` (the recorded stretch: the profiler off),
`setup_recording` (set-up, recorded), and `profiled_counters` (the counters
of the profiled stretch, recorded alongside the profiler). A reader returns
None wherever these are missing or hold nothing of its span or counter,
as on a program without them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

from silt_bench import work
from silt_bench.readers import group_per_unit
from silt_bench.trace import DEVICE_KINDS, RUNTIME

PREFIX = "silt."


def outermost(spans, name: str) -> list:
    """(start_ns, end_ns) of every closed span named `name` that no span of
    the same name encloses (a name nested in itself counts once)."""
    out = []
    for i, (n, start, end, parent, _) in enumerate(spans):
        if n != name or end is None:
            continue
        p = parent
        while p is not None and spans[p][0] != name:
            p = spans[p][3]
        if p is None:
            out.append((start, end))
    return out


def span_ms_per_unit(rec: Optional[dict], name: str, units: int) -> Optional[float]:
    """Milliseconds of the outermost `name` spans per unit, or None where
    the recording holds none."""
    if not rec or not units:
        return None
    found = outermost(rec["spans"], name)
    if not found:
        return None
    return 1e-6 * sum(end - start for start, end in found) / units


def _innermost(spans, stacks, t, thread=None) -> Optional[int]:
    """Drop from the per-thread `stacks` the intervals closed before `t`;
    the innermost interval left on `thread`, else the latest started of
    those left on any thread (the program's own rule), or None."""
    for stack in stacks.values():
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
    mine = stacks.get(thread)
    if mine:
        return mine[-1]
    tops = [stack[-1] for stack in stacks.values() if stack]
    return max(tops, key=lambda i: spans[i][0]) if tops else None


class _Sweep:
    """The innermost of the `silt.*` intervals (start, end, name, thread),
    sorted by start and nested on each thread, open at increasing times."""

    def __init__(self, spans):
        self.spans, self.next, self.stacks = spans, 0, defaultdict(list)

    def at(self, t, thread=None) -> Optional[int]:
        while self.next < len(self.spans) and self.spans[self.next][0] <= t:
            self.stacks[self.spans[self.next][3]].append(self.next)
            self.next += 1
        return _innermost(self.spans, self.stacks, t, thread)


def _parents(spans) -> list:
    """Each interval's parent by the program's rule, or None."""
    stacks, out = defaultdict(list), []
    for i, (start, _, _, thread) in enumerate(spans):
        out.append(_innermost(spans, stacks, start, thread))
        stacks[thread].append(i)
    return out


def table_from_events(host, device) -> dict:
    """The `spans` table. host: (start_ns, end_ns, name, thread, corr) of
    every host operation and annotation; device: (start_ns, end_ns, corr of
    the launching operation) of every kernel and copy. Per `silt.*` name:
    `host_s`, the seconds of its outermost intervals; `device_s`, the
    seconds of the device events whose launching operation started inside
    an interval of that name (the operation's innermost span and every span
    it hangs from); `idle_s`, the seconds of the device's idle gaps whose
    midpoint falls in an interval of that name as the innermost `silt.*`
    span open then, on any thread."""
    host = sorted(host)
    # an interval before those it encloses, where two start together
    spans = sorted(((h[0], h[1], h[2], h[3]) for h in host if h[2].startswith(PREFIX)),
                   key=lambda x: (x[0], -x[1]))
    parents = _parents(spans)

    def chain(i):
        names = set()
        while i is not None:
            names.add(spans[i][2])
            i = parents[i]
        return names

    table = defaultdict(lambda: {"host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
    for i, (start, end, name, _) in enumerate(spans):
        if name not in chain(parents[i]):
            table[name]["host_s"] += (end - start) * 1e-9
    ops = {h[4]: (h[0], h[3]) for h in host if not h[2].startswith(PREFIX)}
    launched = sorted((ops[corr], end - start) for start, end, corr in device if corr in ops)
    sweep = _Sweep(spans)
    for (t, thread), seconds in launched:
        for name in chain(sweep.at(t, thread)):
            table[name]["device_s"] += seconds * 1e-9
    busy = []
    for start, end, _ in sorted(device):
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    first = min([h[0] for h in host[:1]] + [b[0] for b in busy[:1]], default=0)
    last = max([h[1] for h in host] + [b[1] for b in busy[-1:]], default=0)
    sweep = _Sweep(spans)
    for s, e in zip([first] + [b[1] for b in busy], [b[0] for b in busy] + [last]):
        i = sweep.at((s + e) // 2) if e > s else None
        if i is not None:
            table[spans[i][2]]["idle_s"] += (e - s) * 1e-9
    return dict(table)


def events(prof):
    """(host, device) of a torch.profiler run as `table_from_events` takes
    them; device events are kernels, copies and memsets (trace.py's kinds;
    where the profiler names no kinds, a device event named as a host one
    is an annotation and left out)."""
    from torch.autograd import DeviceType

    host, raw = [], []
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if e.device_type() == DeviceType.CUDA:
            raw.append((start, end, name, e.linked_correlation_id(), kind))
        elif not RUNTIME.match(name):
            host.append((start, end, name, e.start_thread_id(), e.correlation_id()))
    names = {h[2] for h in host}
    device = [(s, e, corr) for s, e, name, corr, kind in raw
              if (kind in DEVICE_KINDS if kind is not None else name not in names)]
    return host, device


def spans_table(prof) -> dict:
    """`table_from_events` of a torch.profiler run."""
    return table_from_events(*events(prof))


def _span_ms(kind: str, name: str):
    """The reader of span `name`'s ms per unit of a `kind` cell."""
    def read(ctx):
        if ctx["kind"] != kind:
            return None
        return span_ms_per_unit(ctx.get("recording"), name, ctx.get("recorded_units"))
    return read


def setup_kernels_s(ctx):
    """Seconds of the kernel libraries' first loads (and builds) in set-up;
    0 where set-up was recorded and loaded none."""
    rec = ctx.get("setup_recording")
    if not rec:
        return None
    return 1e-9 * sum(end - start for start, end in outermost(rec["spans"], "silt.kernels.load"))


def pressure_roofline_pct_train(ctx):
    """`pcg_bound_ms` of every solve of the profiled stretch, forward and
    adjoint, each at its own iteration count, over the (P)CG kernels'
    device time."""
    solve = group_per_unit(ctx, "pressure")
    counters = ctx.get("profiled_counters") or {}
    iters = counters.get("pressure.iters", []) + counters.get("pressure.adjoint_iters", [])
    if ctx["kind"] != "train" or solve is None or not iters:
        return None
    shape = (ctx["config"]["sbatch"],) + work.grid(ctx["config"])
    bound = sum(work.pcg_bound_ms(shape, int(k)) for k in iters) / ctx["profiled_units"]
    return 100.0 * bound / (1e3 * solve["s"])


# name: (unit, layer, end-to-end metric it moves, reader)
TRAIN_STEP = "train step (train/trainer.py)"
METRICS = {
    "forward_ms.train": ("ms/iter", TRAIN_STEP, "train_iter_ms",
                         _span_ms("train", "silt.train.forward")),
    "backward_ms.train": ("ms/iter", TRAIN_STEP, "train_iter_ms",
                          _span_ms("train", "silt.train.backward")),
    "remat_recompute_ms.train": ("ms/iter", TRAIN_STEP, "train_iter_ms",
                                 _span_ms("train", "silt.train.recompute")),
    "optimizer_ms.train": ("ms/iter", TRAIN_STEP, "train_iter_ms",
                           _span_ms("train", "silt.train.optimizer")),
    "pressure_roofline_pct.train": ("%", "pressure solve (ops/poisson.py, kernels/cg.py)",
                                    "train_iter_ms", pressure_roofline_pct_train),
    "solver_ms.apply": ("ms/step", "solver step (physics/, ops/)", "rollout_step_ms",
                        _span_ms("apply", "silt.solver")),
    "net_ms.apply": ("ms/step", "correction net (models/networks.py)", "rollout_step_ms",
                     _span_ms("apply", "silt.net")),
    "setup_kernels_s": ("s", "start-up (apps/, kernels/build.py)", "setup_s", setup_kernels_s),
}
