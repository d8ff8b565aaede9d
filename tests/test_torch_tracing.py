"""The port's spans and counters (utils/profiling.py) on the CPU, at the small
shapes of tests/test_torch_train_step.py: karman_domain(8), msteps 3,
batch 2.

* Off (no recording, no profiler) `span` is one shared null context and a
  train step leaves no recording behind.
* A recorded karman train step: one forward, one backward and one optimizer
  span (with its guard), disjoint and in that order; one recompute span per
  unrolled step, each a child of the backward (none without remat); one
  `pressure.iters` per step and one `pressure.adjoint_iters` per step but
  the first, each the iteration count of a direct cold solve of its
  right-hand side.
* Recording and a torch.profiler around a remat step change no loss, step
  loss or updated parameter by a bit, and the profiler's host events carry
  the train step's span names.
* Each step of a karman and a Burgers rollout is one `silt.rollout.step`
  holding one `silt.solver` and one `silt.net`.
* A recording's parents across threads, its counters kept as tensors until
  read, one recording at a time, and a kernel library's first load (with
  its nvcc build) as spans.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.kernels import build, cg
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics import burgers as tb
from solver_in_the_loop_torch.physics import karman as tk
from solver_in_the_loop_torch.train import trainer
from solver_in_the_loop_torch.train.rollout import burgers_rollout, karman_rollout
from solver_in_the_loop_torch.utils import profiling

torch.set_num_threads(1)

RES, MSTEPS, BATCH = 8, 3, 2
TRAIN = ("silt.train.forward", "silt.train.backward", "silt.train.optimizer")


def _karman_data(seed=5):
    """BATCH sims of MSTEPS + 2 frames around the initial state and one
    iteration's (sim, frame0) rows."""
    rng = np.random.RandomState(seed)
    dom = tk.karman_domain(RES)
    d0, v0 = tk.initial_state(dom, 1)
    frames = MSTEPS + 2

    def around(a, scale, shape):
        return torch.from_numpy((a.numpy()[None] + scale * rng.randn(BATCH, frames, *shape))
                                .astype(np.float32))

    data = {"dens": around(d0.values, 0.1, (dom.ny, dom.nx)),
            "u": around(v0.u, 0.2, (dom.ny, dom.nx + 1)),
            "v": around(v0.v, 0.2, (dom.ny + 1, dom.nx)),
            "re": torch.tensor(160000.0 * 2.0 ** np.arange(BATCH), dtype=torch.float32)}
    idx = torch.from_numpy(np.stack([np.arange(BATCH), rng.randint(0, 2, BATCH)], axis=1))
    norm = Normalization.karman(float(data["v"].abs().std()), float(data["u"].abs().std()),
                                float(data["re"].std()))
    return data, idx.to(torch.int64), norm


def _karman_step(remat=True):
    """(train_step, model) of a reference-initialised MarsMoon."""
    flow = tk.KarmanFlow(tk.karman_domain(RES), advection="shift", max_shift=2)
    model = build_model("mars_moon", init="reference", generator=torch.Generator().manual_seed(3))
    cfg = trainer.SolTrainConfig(msteps=MSTEPS, lr=1e-4, clip_grad=True, remat=remat)
    opt = trainer.make_optimizer(model, cfg)
    return trainer.make_karman_train_step(flow, model, opt, cfg), model


def _recorded_step(remat=True):
    data, idx, norm = _karman_data()
    step, _ = _karman_step(remat)
    with profiling.recording() as rec:
        step(data, norm, idx)
    return rec.read()


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s[0] == name]


def _children(spans, parent):
    return [s[0] for s in spans if s[3] == parent]


def test_off_mode_is_one_null_context_and_leaves_no_recording():
    assert profiling.span("silt.solver") is profiling.span("silt.train.forward")
    with profiling.span("silt.solver") as inside:
        assert inside is None
    data, idx, norm = _karman_data()
    step, _ = _karman_step()
    step(data, norm, idx)
    assert profiling._recording is None


def test_recorded_train_step_has_its_phases_in_order():
    spans = _recorded_step()["spans"]
    top = [s for s in spans if s[3] is None]
    assert [s[0] for s in top] == list(TRAIN)
    for before, after in zip(top, top[1:]):
        assert before[1] <= before[2] <= after[1] <= after[2]
    (opt,) = _named(spans, "silt.train.optimizer")
    assert _children(spans, opt) == ["silt.train.guard"]
    (backward,) = _named(spans, "silt.train.backward")
    recomputes = _named(spans, "silt.train.recompute")
    assert len(recomputes) == MSTEPS
    assert all(spans[i][3] == backward for i in recomputes)
    # the recompute re-runs each step's solver and net, not its solve
    for i in recomputes:
        assert sorted(_children(spans, i)) == ["silt.net", "silt.solver"]


def test_train_step_without_remat_has_no_recompute_span():
    spans = _recorded_step(remat=False)["spans"]
    assert not _named(spans, "silt.train.recompute")
    assert [s[0] for s in spans if s[3] is None] == list(TRAIN)


def test_solve_counters_are_the_solves_iterations(monkeypatch):
    """MSTEPS forward solves and MSTEPS - 1 adjoints (step 0's input is
    data), as test_remat_policies_are_bit_equal_and_never_rerun_the_solve
    counts them; each adjoint's count is a direct cold solve's."""
    calls = []
    real = cg.pcg_solve

    def kept(b, x0, *rest):
        x, iters = real(b, x0, *rest)
        calls.append((b.clone(), rest, int(iters)))
        return x, iters

    monkeypatch.setattr(cg, "pcg_solve", kept)
    counters = _recorded_step()["counters"]
    assert len(calls) == 2 * MSTEPS - 1
    assert counters["pressure.iters"] == [c[2] for c in calls[:MSTEPS]]
    cold = [int(cg.pcg_solve_plain(b, torch.zeros_like(b), *rest)[1])
            for b, rest, _ in calls[MSTEPS:]]
    assert counters["pressure.adjoint_iters"] == cold and min(cold) > 0


@pytest.mark.parametrize("mode", ["recording", "profiler", "both"])
def test_spans_change_no_result(mode):
    """A remat step with its spans recorded, under a CPU torch.profiler, or
    both, against the same step with neither: bit-equal."""
    data, idx, norm = _karman_data()

    def run(record, profile):
        step, model = _karman_step()
        with (profiling.recording() if record else profiling._NULL), \
                (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
                 if profile else profiling._NULL) as prof:
            loss, step_losses, _, applied = step(data, norm, idx)
        assert applied
        return loss, step_losses, [p.detach().clone() for p in model.parameters()], prof

    want = run(False, False)
    got = run(mode != "profiler", mode != "recording")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    if mode != "recording":
        names = {e.key for e in got[3].key_averages()}
        assert {*TRAIN, "silt.train.recompute", "silt.train.guard", "silt.solver",
                "silt.net", "silt.pressure", "silt.pressure.adjoint"} <= names


def _karman_rollout(steps):
    dom = tk.karman_domain(RES)
    flow = tk.KarmanFlow(dom, advection="shift", max_shift=2)
    data, _, norm = _karman_data()
    model = build_model("mars_moon", init="reference").eval()
    out = karman_rollout(flow, CenteredGrid(data["dens"][:1, 0], dom),
                         StaggeredGrid(data["u"][:1, 0], data["v"][:1, 0], dom),
                         data["re"][:1], steps, model=model, norm=norm)
    return out["cg_iters"].tolist()


def _burgers_rollout(steps):
    dom = tb.burgers_domain(RES)
    rng = np.random.RandomState(2)
    u, v = (torch.from_numpy(rng.randn(steps + 1, 1, *shape).astype(np.float32))
            for shape in ((RES, RES + 1), (RES + 1, RES)))
    model = build_model("mars_moon", in_channels=4, init="reference").eval()
    norm = Normalization.burgers(1.0, 1.0, 0.1, 0.1)
    _, replay = burgers_rollout(tb.BurgersFlow(dom, advection="shift"), steps, model=model,
                                norm=norm)
    replay(StaggeredGrid(u[0], v[0], dom), 0.1 * u[1:], 0.1 * v[1:])
    return None


@pytest.mark.parametrize("rollout", [_karman_rollout, _burgers_rollout])
def test_rollout_steps_hold_one_solver_and_one_net(rollout):
    with profiling.recording() as rec:
        cg_iters = rollout(3)
    got = rec.read()
    spans = got["spans"]
    steps = _named(spans, "silt.rollout.step")
    assert len(steps) == 3 and all(spans[i][3] is None for i in steps)
    for i in steps:
        assert sorted(_children(spans, i)) == ["silt.net", "silt.solver"]
    if cg_iters is not None:  # karman: one solve a step, counted
        assert got["counters"]["pressure.iters"] == cg_iters
        for i in _named(spans, "silt.solver"):
            assert _children(spans, i) == ["silt.pressure"]
    else:
        assert "pressure.iters" not in got["counters"]


def test_a_span_on_another_thread_takes_the_innermost_open_span():
    with profiling.recording() as rec:
        with profiling.span("outer"), profiling.span("inner"):
            worker = threading.Thread(target=lambda: profiling.span("elsewhere").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
        assert not worker.is_alive()
        with profiling.span("after"):
            pass
    spans = rec.spans
    assert [s[0] for s in spans] == ["outer", "inner", "elsewhere", "after"]
    assert [s[3] for s in spans] == [None, 0, 1, None]
    assert spans[2][4] != spans[1][4] and all(s[2] is not None for s in spans)


def test_counters_keep_tensors_until_read():
    value = torch.tensor(7, dtype=torch.int32)
    profiling.count("pressure.iters", value)  # off: dropped
    with profiling.recording() as rec:
        profiling.count("pressure.iters", value)
        profiling.count("pressure.iters", 3)
    assert rec.counters["pressure.iters"][0] is value
    assert rec.read()["counters"] == {"pressure.iters": [7, 3]}


def test_one_recording_at_a_time():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert profiling._recording is None


def test_first_load_of_a_missing_library_records_its_build(monkeypatch, tmp_path):
    """nvcc and the loader stood in for: a missing library's first load is a
    `silt.kernels.load` span holding one `silt.kernels.nvcc`, one library
    built; a second load records nothing."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("library", path))
    monkeypatch.setattr(build, "_loaded", {})
    with profiling.recording() as rec:
        lib = build.load("advect")
        assert build.load("advect") is lib
    assert lib == ("library", str(build._lib_path("advect")))
    assert [(s[0], s[3]) for s in rec.spans] == [("silt.kernels.load", None),
                                                 ("silt.kernels.nvcc", 0)]
    assert rec.read()["counters"] == {"kernels.nvcc_builds": [1]}
