"""The port's karman train step against the JAX package's on the CPU.

Same data (made with numpy), same weights (the JAX init carried across by
`params_from_jax`), same schedule of (sim, frame) windows: the port's
`karman_loss` + backward against `make_karman_train_step` at
`karman_domain(8)` (16x8), MarsMoon 32x5, msteps 2 and 4, batch 2 and 3:

* the loss and the per-step losses within 1e-5 relative;
* every parameter's gradient within 1e-4 of its leaf's max (the JAX side's
  gradients are read through an optimizer that stores them, and compared in
  the port's layout);
* the parameters after one clipped Adam step within 1e-3 of the learning
  rate (Adam's first step is lr * g / (|g| + eps) per element, which turns
  the gradient's relative error into an absolute one on that scale);
* the four remat policies and no remat bit-equal, and the pressure solve
  never re-run in the backward pass.

Both sides run float32 with the same formulas and differ in summation order
(XLA's vs PyTorch's reductions and convolutions). The pressure solves run at
CG tolerance 1e-7 here (PTOL): at the default 1e-5 each side's gradients
carry the truncation error of 62 CG solves, forward and adjoint, and the two
sides' iterates part by up to 1e-3 of a leaf's max at msteps 4 (measured
while writing this test), which would hide a real difference. At 1e-7 they
agree to ~1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.physics import karman as jk
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch.kernels import advect, cg
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics import karman as tk
from solver_in_the_loop_torch.train import trainer
from solver_in_the_loop_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

RES = 8
LR = 1e-4
PTOL = 1e-7


def make_data(batch, msteps, seed):
    """S = batch sims of msteps + 2 frames around the initial state, and
    the (sim, frame0) windows of one iteration."""
    rng = np.random.RandomState(seed)
    dom = jk.karman_domain(RES)
    d0, v0 = jk.initial_state(dom, 1)
    frames = msteps + 2
    dens = (np.asarray(d0.values)[None] + 0.1 * rng.rand(batch, frames, dom.ny, dom.nx))
    u = np.asarray(v0.u)[None] + 0.2 * rng.randn(batch, frames, dom.ny, dom.nx + 1)
    v = np.asarray(v0.v)[None] + 0.2 * rng.randn(batch, frames, dom.ny + 1, dom.nx)
    data = {"dens": dens.astype(np.float32), "u": u.astype(np.float32),
            "v": v.astype(np.float32),
            "re": (160000.0 * 2.0 ** np.arange(batch)).astype(np.float32)}
    idx = np.stack([np.arange(batch), rng.randint(0, 2, batch)], axis=1).astype(np.int32)
    stats = {"std.v": float(np.std(np.abs(data["v"]))), "std.u": float(np.std(np.abs(data["u"]))),
             "ext.std": float(np.std(data["re"]))}
    return data, idx, stats


def _capture_grads():
    """An optimizer whose state after `update` is the gradient itself."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def jax_step(data, idx, stats, msteps, optimizer=None, seed=0):
    """One JAX train step: (initial params, loss, step losses, grads or the
    params after the optimizer's update)."""
    dom = jk.karman_domain(RES)
    flow = jk.KarmanFlow(dom, advection="shift", max_shift=2, pressure_tol=PTOL)
    model = jax_build_model("mars_moon", init="reference", leaky_slope=0.3)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((idx.shape[0], dom.ny, dom.nx, 3)))
    init = jax.tree_util.tree_map(np.asarray, params)
    cfg = jtrainer.SolTrainConfig(msteps=msteps, lr=LR, batch_size=idx.shape[0], clip_grad=True)
    opt = optimizer or _capture_grads()
    step = jtrainer.make_karman_train_step(flow, model.apply, opt, cfg)
    norm = JNormalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    new_params, state, loss, step_losses = step(
        params, opt.init(params), {k: jnp.asarray(a) for k, a in data.items()}, norm,
        jnp.asarray(idx))
    out = state if optimizer is None else new_params
    return init, float(loss), np.asarray(step_losses), jax.tree_util.tree_map(np.asarray, out)


def port_model(jax_params):
    model = build_model("mars_moon", leaky_slope=0.3)
    model.load_state_dict(params_from_jax(jax_params["params"], "mars_moon", model))
    return model


def port_loss(model, data, idx, stats, msteps, precon="fd", **cfg_kw):
    dom = tk.karman_domain(RES)
    flow = tk.KarmanFlow(dom, advection="shift", max_shift=2, pressure_tol=PTOL,
                         pressure_precon=precon)
    cfg = trainer.SolTrainConfig(msteps=msteps, lr=LR, clip_grad=True, **cfg_kw)
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    tdata = {k: torch.from_numpy(a) for k, a in data.items()}
    model.zero_grad(set_to_none=True)
    loss, step_losses, iters = trainer.karman_loss(flow, model, norm, tdata,
                                                   torch.from_numpy(idx.astype(np.int64)), cfg)
    loss.backward()
    return loss.detach(), step_losses.detach(), iters, flow, cfg, norm, tdata


def _as_port(model, jax_tree):
    """A flax params tree (HWIO kernels) as the model's state_dict names and layout."""
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree["params"]), "mars_moon",
                           model)


def _check_against_jax(msteps, batch, precon="fd"):
    data, idx, stats = make_data(batch, msteps, seed=msteps)
    jparams, jloss, jstep, jgrads = jax_step(data, idx, stats, msteps)
    model = port_model(jparams)
    loss, step_losses, iters, *_ = port_loss(model, data, idx, stats, msteps, precon)
    assert iters.shape == (msteps,) and int(iters.min()) > 0
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(step_losses.numpy(), jstep, rtol=1e-5)
    want = _as_port(model, jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys() and len(got) == 24
    for name, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((got[name] - w).abs().max()) / scale
        assert err <= 1e-4, f"{name}: {err}"
    return iters, jparams


@pytest.mark.parametrize("msteps,batch", [(2, 2), (4, 3)])
def test_train_step_matches_jax(msteps, batch):
    _check_against_jax(msteps, batch)


def test_train_step_without_preconditioner_matches_jax():
    """--pressure-precon none: every solve, forward and adjoint, is plain CG
    (the "cg" route), against the JAX step's FD-PCG; at PTOL both converge
    to the same pressures, so the same tolerances hold. Plain CG takes more
    iterations for the same tolerance."""
    iters, jparams = _check_against_jax(4, 3, precon="none")
    data, idx, stats = make_data(3, 4, seed=4)
    fd_iters = port_loss(port_model(jparams), data, idx, stats, 4)[2]
    assert int(iters.sum()) > int(fd_iters.sum())


def test_params_after_one_update_match_jax():
    msteps, batch = 2, 2
    data, idx, stats = make_data(batch, msteps, seed=7)
    jcfg = jtrainer.SolTrainConfig(msteps=msteps, lr=LR, batch_size=batch, clip_grad=True)
    jparams, _, _, jnew = jax_step(data, idx, stats, msteps, jtrainer.make_optimizer(jcfg))
    model = port_model(jparams)
    cfg = trainer.SolTrainConfig(msteps=msteps, lr=LR, clip_grad=True)
    opt = trainer.make_optimizer(model, cfg)
    dom = tk.karman_domain(RES)
    flow = tk.KarmanFlow(dom, advection="shift", pressure_tol=PTOL)
    step = trainer.make_karman_train_step(flow, model, opt, cfg)
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    *_, applied = step({k: torch.from_numpy(a) for k, a in data.items()}, norm,
                       torch.from_numpy(idx.astype(np.int64)))
    assert applied
    want, before = _as_port(model, jnew), _as_port(model, jparams)
    for name, p in model.named_parameters():
        assert float((want[name] - before[name]).abs().max()) > 0.5 * LR  # the step moved it
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-3 * LR)


POLICIES = [("pressure", True), ("pressure+conv", True), ("pressure+advect", True),
            ("pressure+conv", False)]


def test_remat_policies_are_bit_equal_and_never_rerun_the_solve(monkeypatch):
    """Every policy gives the same loss and gradients to the bit; the PCG runs
    once per step forward and once per step in the backward pass (the adjoint,
    none for step 0, whose input is data), under every policy."""
    msteps, batch = 3, 2
    data, idx, stats = make_data(batch, msteps, seed=5)
    jparams = jax_build_model("mars_moon", init="reference").init(
        jax.random.PRNGKey(1), jnp.zeros((batch, 16, 8, 3)))
    calls = {"pcg": 0, "fwd": 0, "bwd": 0}
    real = (cg.pcg_solve, advect.tap_sum_fwd, advect.tap_sum_bwd)

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(cg, "pcg_solve", counted("pcg", real[0]))
    monkeypatch.setattr(advect, "tap_sum_fwd", counted("fwd", real[1]))
    monkeypatch.setattr(advect, "tap_sum_bwd", counted("bwd", real[2]))
    results = {}
    for policy, remat in POLICIES:
        for k in calls:
            calls[k] = 0
        model = port_model(jparams)
        loss, step_losses, *_ = port_loss(model, data, idx, stats, msteps, remat=remat,
                                          remat_policy=policy)
        grads = [p.grad.clone() for p in model.parameters()]
        results[(policy, remat)] = (loss, step_losses, grads, dict(calls))
    ref_loss, ref_steps, ref_grads, _ = results[("pressure+conv", False)]
    for key, (loss, steps, grads, count) in results.items():
        assert torch.equal(loss, ref_loss) and torch.equal(steps, ref_steps), key
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads)), key
        assert count["pcg"] == msteps + (msteps - 1), (key, count)
        # density's tap-sum has no gradient path to the loss: two backward
        # tap-sums per step (u and v), none for step 0
        assert count["bwd"] == 2 * (msteps - 1), (key, count)
        recomputed = {"pressure+advect": 0}.get(key[0], 3 * msteps) if key[1] else 0
        assert count["fwd"] == 3 * msteps + recomputed, (key, count)


def test_remat_never_reruns_the_unpreconditioned_solve(monkeypatch):
    """With --pressure-precon none the solve takes the "cg" route, which every
    policy saves as it saves the "pcg" route's: one forward solve per step
    and one adjoint per step but step 0, no PCG."""
    msteps, batch = 3, 2
    data, idx, stats = make_data(batch, msteps, seed=5)
    jparams = jax_build_model("mars_moon", init="reference").init(
        jax.random.PRNGKey(1), jnp.zeros((batch, 16, 8, 3)))
    calls = {"cg": 0, "pcg": 0}
    real = (cg.cg_solve, cg.pcg_solve)

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(cg, "cg_solve", counted("cg", real[0]))
    monkeypatch.setattr(cg, "pcg_solve", counted("pcg", real[1]))
    results = []
    for policy, remat in POLICIES:
        calls.update(cg=0, pcg=0)
        model = port_model(jparams)
        loss, *_ = port_loss(model, data, idx, stats, msteps, "none", remat=remat,
                             remat_policy=policy)
        results.append((loss, [p.grad.clone() for p in model.parameters()]))
        assert calls == {"cg": msteps + (msteps - 1), "pcg": 0}, (policy, remat, calls)
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))


def test_remat_policy_names():
    # the one solve op, whichever route runs it, is saved by every policy;
    # "conv" names both conv implementations: cuDNN's and the fused silt::conv
    solve = torch.ops.silt.pressure_cg_solve.default
    assert trainer.remat_policy_ops("pressure") == [solve]
    assert trainer.remat_policy_ops("pressure+conv") == [
        solve, torch.ops.aten.convolution.default, torch.ops.silt.conv.default]
    assert trainer.remat_policy_ops("pressure+advect") == [solve, torch.ops.silt.tap_sum.default]
    for unknown in ("everything", "none"):  # the CLI maps "none" to "pressure"
        with pytest.raises(KeyError):
            trainer.remat_policy_ops(unknown)
