"""The remat of the unrolled train step (utils/remat.py) on the CPU, at small
shapes: karman_domain(8) and Burgers 16x16, MarsMoon 32x5, batch 2, msteps 3.

* No Python dispatch mode is active at any site inside a remat'ed step,
  forward or recompute, under every policy (a TorchDispatchMode would run
  Python for every aten op of the step).
* `remat.taped` and `remat.replayed` count each step's saved sites: the
  solve, the 12 convs and the tap-sums (karman 3 a step, Burgers 2) as the
  policy names them; none without remat.
* The Burgers step bit-equal under every policy and without remat, with
  either conv implementation, in float32 and bfloat16.
* A replay that meets its sites out of order, with another shape or dtype,
  or more or fewer of them than were taped, raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode

from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics import burgers as tb
from solver_in_the_loop_torch.physics import karman as tk
from solver_in_the_loop_torch.train import trainer
from solver_in_the_loop_torch.utils import profiling, remat

torch.set_num_threads(1)

MSTEPS, BATCH = 3, 2
POLICIES = ("pressure", "pressure+conv", "pressure+advect")
TAP_SUM = torch.ops.silt.tap_sum.default
CONVOLUTION = torch.ops.aten.convolution.default
# sites a step tapes: karman's solve, 3 tap-sums and 12 convs; Burgers' 2 tap-sums
# and 12 convs, no solve
PER_STEP = {("karman", "pressure"): 1, ("karman", "pressure+conv"): 13,
            ("karman", "pressure+advect"): 4, ("burgers", "pressure"): 0,
            ("burgers", "pressure+conv"): 12, ("burgers", "pressure+advect"): 2}


def _karman_loss(cfg, conv="library"):
    """A karman unroll's loss and its model (karman_domain(8), seeded data)."""
    rng = np.random.RandomState(5)
    dom = tk.karman_domain(8)
    d0, v0 = tk.initial_state(dom, 1)

    def around(a, scale, shape):
        return torch.from_numpy((a.numpy()[None] + scale * rng.randn(BATCH, MSTEPS + 2, *shape))
                                .astype(np.float32))

    data = {"dens": around(d0.values, 0.1, (dom.ny, dom.nx)),
            "u": around(v0.u, 0.2, (dom.ny, dom.nx + 1)),
            "v": around(v0.v, 0.2, (dom.ny + 1, dom.nx)),
            "re": torch.tensor([160000.0, 320000.0])}
    idx = torch.tensor([[0, 1], [1, 0]])
    norm = Normalization.karman(float(data["v"].abs().std()), float(data["u"].abs().std()),
                                float(data["re"].std()))
    model = build_model("mars_moon", init="reference", generator=torch.Generator().manual_seed(3),
                        conv=conv)
    flow = tk.KarmanFlow(dom, advection="shift", max_shift=2)
    return trainer.karman_loss(flow, model, norm, data, idx, cfg)[0], model


def _burgers_loss(cfg, conv="library", dtype=torch.float32):
    """A Burgers unroll's loss and its model (16x16, seeded data and forces)."""
    rng = np.random.RandomState(11)
    res, frames = 16, MSTEPS + 2
    shapes = {"u": (res, res + 1), "v": (res + 1, res), "fu": (res, res + 1), "fv": (res + 1, res)}
    data = {k: torch.from_numpy((0.5 * (0.15 if k[0] == "f" else 1.0)
                                 * rng.randn(BATCH, frames, *s)).astype(np.float32))
            for k, s in shapes.items()}
    model = build_model("mars_moon", in_channels=4, init="reference",
                        generator=torch.Generator().manual_seed(3), conv=conv, compute_dtype=dtype)
    flow = tb.BurgersFlow(tb.burgers_domain(res), advection="shift", max_shift=2)
    loss, _ = trainer.burgers_loss(flow, model, Normalization.burgers(0.4, 0.38, 0.16, 0.15),
                                   data, torch.tensor([[0, 1], [1, 0]]), cfg)
    return loss, model


LOSSES = {"karman": _karman_loss, "burgers": _burgers_loss}


class _PassThrough(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("system", ["karman", "burgers"])
def test_no_dispatch_mode_inside_a_remat_step(monkeypatch, system, policy):
    """Each tap-sum site, in the forward and in the recompute, runs with no
    Python dispatch mode active (the probe sees one where one is)."""
    seen = []
    real = remat.site

    def probe(op, *args):
        if op is TAP_SUM:
            tape = remat._local.tape
            seen.append((tape is not None and tape.replaying, _get_current_dispatch_mode()))
        return real(op, *args)

    monkeypatch.setattr(remat, "site", probe)
    with _PassThrough():
        probe(TAP_SUM, *(torch.zeros(1, 4, 4),) * 3, 1, False)
    assert seen.pop()[1] is not None
    loss, _ = LOSSES[system](trainer.SolTrainConfig(msteps=MSTEPS, remat_policy=policy))
    loss.backward()
    taps = {"karman": 3, "burgers": 2}[system] * MSTEPS
    assert [replaying for replaying, _ in seen] == [False] * taps + [True] * taps
    assert all(mode is None for _, mode in seen)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("system", ["karman", "burgers"])
def test_taped_and_replayed_sites_are_counted(system, policy):
    with profiling.recording() as rec:
        loss, _ = LOSSES[system](trainer.SolTrainConfig(msteps=MSTEPS, remat_policy=policy))
        loss.backward()
    counters = rec.read()["counters"]
    want = [PER_STEP[(system, policy)]] * MSTEPS
    assert counters["remat.taped"] == want and counters["remat.replayed"] == want


def test_remat_counts_the_fused_convs_and_nothing_without_remat():
    with profiling.recording() as rec:
        loss, _ = _karman_loss(trainer.SolTrainConfig(msteps=MSTEPS), conv="kernel")
        loss.backward()
        loss, _ = _karman_loss(trainer.SolTrainConfig(msteps=MSTEPS, remat=False))
        loss.backward()
    counters = rec.read()["counters"]
    assert counters["remat.taped"] == counters["remat.replayed"] == [13] * MSTEPS


@pytest.mark.parametrize("conv,dtype", [("library", torch.float32), ("kernel", torch.float32),
                                        ("library", torch.bfloat16), ("kernel", torch.bfloat16)])
def test_burgers_policies_are_bit_equal_to_no_remat(conv, dtype):
    def run(**kw):
        loss, model = _burgers_loss(trainer.SolTrainConfig(msteps=MSTEPS, **kw), conv, dtype)
        loss.backward()
        return loss, [p.grad for p in model.parameters()]

    want_loss, want_grads = run(remat=False)
    for policy in POLICIES:
        loss, grads = run(remat_policy=policy)
        assert torch.equal(loss, want_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, want_grads)), policy


def _conv_site(x, w, b):
    return remat.site(CONVOLUTION, x, w, b, (1, 1), (1, 1), (1, 1), False, (0, 0), 1)


def _tap_site(v):
    d = torch.full_like(v, 0.25)
    return remat.site(TAP_SUM, v.contiguous(), d, d, 1, False)


# the recompute's sites where it departs from the forward's conv -> tap-sum
FAULTS = {
    "order": lambda x, w, b: _conv_site(_tap_site(x[:, 0])[:, None], w, b),
    "shape": lambda x, w, b: _tap_site(_conv_site(x[..., :3], w, b)[:, 0]),
    "dtype": lambda x, w, b: _tap_site(_conv_site(x.double(), w.double(), b.double())[:, 0]),
    "unconsumed": lambda x, w, b: _conv_site(x, w, b)[:, 0],
    "extra": lambda x, w, b: _tap_site(_tap_site(_conv_site(x, w, b)[:, 0])),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_replay_off_its_tape_raises(fault):
    conv = torch.nn.Conv2d(1, 1, 3, padding=1)
    calls = []

    def step(x):
        calls.append(x)
        if len(calls) == 1:
            return (_tap_site(_conv_site(x, conv.weight, conv.bias)[:, 0]),)
        return (FAULTS[fault](x, conv.weight, conv.bias),)

    saves = frozenset({CONVOLUTION, TAP_SUM})
    (out,) = remat.checkpoint(step, saves, tuple(conv.parameters()), torch.randn(1, 1, 4, 4))
    with pytest.raises(RuntimeError, match="remat replay"):
        out.sum().backward()
    assert len(calls) == 2 and remat._local.tape is None
