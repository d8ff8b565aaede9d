"""The plain reference against the program at small sizes on the CPU (the
program runs its kernels' plain twins there): the karman and Burgers
steps, the shift sample and its derivatives, the net, the training
iterations, and the Burgers generator against `burgers-gen`'s path."""

import numpy as np
import pytest
import torch

from silt_bench import harness, inputs
from silt_bench.reference import fluid, net

torch.manual_seed(0)


def _karman_batch():
    d = inputs.karman_set()
    s, f = [0, 3, 5], [0, 17, 39]
    return [torch.from_numpy(np.ascontiguousarray(d[k][s, f])) for k in ("dens", "u", "v")] + [
        torch.from_numpy(d["re"][s])]


def test_karman_step_matches_program():
    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain

    d, u, v, re = _karman_batch()
    dom = karman_domain(32, 100.0)
    flow = KarmanFlow(dom, advection="shift", max_shift=2, pressure_tol=1e-5,
                      pressure_max_iter=1000, pressure_precon="fd")
    got = flow.step(CenteredGrid(d, dom), StaggeredGrid(u, v, dom), re)
    want = fluid.Karman(32, 100.0, 2, 1e-5, 1000, "cpu").step(d, u, v, re)
    for a, b in zip((got[0].values, got[1].u, got[1].v, got[2]), want[:4]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert int(got[3]) == want[4]


def test_burgers_step_matches_program():
    from solver_in_the_loop_torch.core.grids import StaggeredGrid
    from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain

    u, v = torch.randn(2, 32, 33), torch.randn(2, 33, 32)
    fu, fv = 0.1 * torch.randn(2, 32, 33), 0.1 * torch.randn(2, 33, 32)
    dom = burgers_domain(32, 32.0)
    got = BurgersFlow(dom, advection="shift", max_shift=2).step_with_f(
        StaggeredGrid(u, v, dom), StaggeredGrid(fu, fv, dom), dt=0.1)
    want = fluid.Burgers(32, 32.0, 2).step(u, v, fu, fv, 0.1)
    for a, b in zip((got.u, got.v), want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("periodic", [False, True])
def test_shift_sample_and_its_derivatives_match_the_tap_sum(periodic):
    from solver_in_the_loop_torch.ops.interp import shifted_stencil_sample

    g = torch.Generator().manual_seed(1)
    values = torch.randn(2, 12, 9, generator=g)
    off_y = 3.0 * torch.randn(2, 12, 9, generator=g)
    off_x = 3.0 * torch.randn(2, 12, 9, generator=g)
    off_y[:, ::3] = torch.round(off_y[:, ::3])  # integer offsets: the hat taps' ties
    off_x[:, :, ::2] = torch.round(off_x[:, :, ::2])
    cot = torch.randn(2, 12, 9, generator=g)
    outs = []
    for fn in (shifted_stencil_sample, fluid.shift_sample):
        args = [t.clone().requires_grad_(True) for t in (values, off_y, off_x)]
        out = fn(*args, 2, periodic)
        grads = torch.autograd.grad(out, args, cot)
        outs.append((out.detach(), *grads))
    for a, b in zip(*outs):
        assert torch.allclose(a, b, rtol=0, atol=2e-5)


def test_net_matches_program_on_the_frozen_weights():
    from solver_in_the_loop_torch.models.networks import build_model

    weights = inputs.checkpoint("karman_sol32", 5)
    model = build_model("mars_moon", in_channels=3, leaky_slope=0.3)
    model.load_state_dict(weights)
    x = torch.randn(2, 16, 8, 3)
    assert torch.allclose(model(x), net.mars_moon(x, weights, 5, 0.3), rtol=0, atol=1e-5)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0000001])
    got = net.tf32_round(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]


@pytest.mark.parametrize("cell", ["karman_sol32.train", "burgers_sol04.train"])
def test_training_iterations_match_program(cell):
    config, workload = harness.cell(cell, {"config": SMALL_CONFIG[cell]})
    system = harness.load_module("systems", config["system"])
    kind = harness.load_module("kinds", "train")
    state = kind.setup(system, config, workload, 123, torch.device("cpu"))
    assert kind.window(state, 0.0)["attempted"] == workload["checked_iterations"]
    kind.free(state)
    got = kind.check(state, torch.device("cpu"))
    assert got["loss_gap"] < 1e-4 and got["change_gap"] < 1e-3, got


def test_burgers_generator_matches_burgers_gen():
    """The benchmark's generator makes burgers-gen's frames for a seed."""
    from solver_in_the_loop_torch.core.random_fields import randfreq_staggered
    from solver_in_the_loop_torch.core.resample import downsample_staggered
    from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain, random_forces
    from solver_in_the_loop_torch.train.rollout import burgers_rollout

    cfg = {"len": 32.0, "dt": 0.1, "scale": 2, "generator": {"res": 16, "skip": 3, "forces": 20}}
    got = inputs.burgers_sims([7, 9], cfg, 4, torch.device("cpu"))
    dom = burgers_domain(16, 32.0)
    for i, seed in enumerate((7, 9)):
        rng = np.random.RandomState(seed)
        forces = random_forces(rng, 20)
        v0 = randfreq_staggered(rng, dom)
        analytic, _ = burgers_rollout(BurgersFlow(dom, advection="gather"), steps=3 + 4 - 1,
                                      dt=0.1)
        frames = analytic(v0, forces)
        for key, fkey in (("u", "v"), ("fu", "fv")):
            want = downsample_staggered(frames[key][2:, 0], frames[fkey][2:, 0], 2)
            assert torch.allclose(got[key][i], want[0], rtol=0, atol=1e-5)
            assert torch.allclose(got[fkey][i], want[1], rtol=0, atol=1e-5)


SMALL_CONFIG = {
    "karman_sol32.train": {"msteps": 2, "sbatch": 2},
    "burgers_sol04.train": {"msteps": 2, "simsteps": 6, "nsims": 4, "sbatch": 2,
                            "generator": {"res": 64, "skip": 3, "forces": 20}},
}
