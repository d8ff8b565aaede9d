"""The port's bfloat16 nets (`--bf16`) on the CPU against the JAX package's.

* The bf16 conv twins (`conv_fwd_plain`, `conv_wgrad_plain` and `silt::conv`'s
  backward on bf16 tensors, the plain versions of csrc/conv_bf16.cu) against
  the JAX Pallas conv `conv_fused` on bf16 inputs in interpret mode, as
  tests/test_torch_conv.py runs it: every bf16 output within CONV_BF16_ULPS
  bf16 ulp of its magnitude, beyond the fp32 sums' own tolerance
  (parity.bf16_errors), the weight gradient's fp32 sum before its rounding
  within CONV_WGRAD_BF16_REL_TOL of its max.
* One full-width SOL-04 train step with `--bf16` against the JAX package's:
  the kernel's twin against the golden made with the Pallas conv in
  interpret mode, the library route against XLA's bf16 conv run here;
  tolerances parity.TRAIN_PARITY_TOL_BF16.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.ops.pallas import conv_kernel as ck
from solver_in_the_loop_tpu.physics import burgers as jb
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.kernels import conv as kconv
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train.checkpoint import params_from_jax

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _inputs(b, h, w, cin, cout, k, with_skip, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (0.1 * rng.randn(k, k, cin, cout)).astype(np.float32)
    bias = (0.01 * rng.randn(cout)).astype(np.float32)
    skip = rng.randn(b, h, w, cout).astype(np.float32) if with_skip else None
    cot = rng.randn(b, h, w, cout).astype(np.float32)
    return x, wt, bias, skip, cot


def _to_bf16(a):
    """numpy float32 -> (jnp bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _jax_conv(args, cot, act):
    def f(*a):
        y = ck.conv_fused(a[0], a[1], a[2], a[3] if len(a) > 3 else None, act=act, slope=0.3)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    grads, y = jax.grad(f, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return y, grads


@pytest.mark.parametrize("shape,act,with_skip", [
    ((2, 8, 8, 4, 32, 5), "leaky_relu", False),   # MarsMoon stem
    ((2, 8, 8, 8, 8, 5), "leaky_relu", True),     # residual block's second conv
    ((2, 8, 8, 8, 8, 5), "leaky_relu", False),    # residual block's first conv
    ((2, 8, 8, 8, 2, 5), "none", False),          # head
    ((2, 8, 8, 8, 8, 5), "none", True),
    ((3, 16, 16, 8, 8, 5), "relu", False),        # M = 768 > 512: two TPU row tiles
    ((2, 8, 8, 8, 8, 3), "leaky_relu", True),     # 3x3
    ((2, 8, 8, 8, 8, 3), "relu", True),
    ((2, 8, 8, 8, 8, 3), "none", False),
])
def test_bf16_conv_matches_jax_pallas_conv(monkeypatch, shape, act, with_skip):
    monkeypatch.setattr(ck, "_INTERPRET", True)
    b, h, w, cin, cout, k = shape
    x, wt, bias, skip, cot = _inputs(b, h, w, cin, cout, k, with_skip)
    pairs = [_to_bf16(a) for a in (x, wt, bias) + ((skip,) if with_skip else ())]
    y_j, g_j = _jax_conv([p[0] for p in pairs], cot, act)
    leaves = [p[1] for p in pairs]
    leaves[1] = leaves[1].permute(3, 2, 0, 1).contiguous()  # the PyTorch parameter's layout
    for t in leaves:
        t.requires_grad_()
    y_t = kconv.conv(leaves[0], leaves[1], leaves[2], leaves[3] if with_skip else None, act, 0.3)
    (y_t.float() * torch.from_numpy(cot)).sum().backward()
    assert y_t.dtype == BF16 and all(t.grad.dtype == BF16 for t in leaves)

    def as_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    assert parity.bf16_errors(y_t.detach(), as_torch(y_j)) <= parity.CONV_BF16_ULPS
    got = [t.grad for t in leaves]
    got[1] = got[1].permute(2, 3, 1, 0)
    for name, a, e in zip(("dx", "dw", "db", "dskip"), got, g_j):
        assert parity.bf16_errors(a, as_torch(e)) <= parity.CONV_BF16_ULPS, name
    # the weight gradient's fp32 sum, before the VJP rounds it
    dz = jnp.asarray(cot, jnp.bfloat16)
    want = np.asarray(ck._conv_wgrad(pairs[0][0], dz, k))
    dw = kconv.conv_wgrad(pairs[0][1].detach(), _to_bf16(cot)[1], k)
    assert dw.dtype == torch.float32
    assert np.abs(dw.numpy() - want).max() <= parity.CONV_WGRAD_BF16_REL_TOL * np.abs(want).max()


def test_bf16_backward_slope_is_the_slope_in_bf16(monkeypatch):
    """JAX's VJP multiplies the gradient by jnp.asarray(slope, dy.dtype):
    0.30078125 for 0.3 in bf16 (the forward's epilogue uses fp32 0.3). The
    twin's backward does the same, and differs from a product with 0.3."""
    monkeypatch.setattr(ck, "_INTERPRET", True)
    y = torch.tensor([-1.0, -2.0, 0.5], dtype=BF16)
    g = torch.tensor([1.0, 3.0, 7.0], dtype=BF16)
    got = kconv.act_grad("leaky_relu", 0.3, y, g)
    assert got.dtype == BF16
    assert got.float().tolist() == [0.30078125, float(torch.tensor(3 * 0.30078125, dtype=BF16)),
                                    7.0]
    want = ck._act_grad("leaky_relu", 0.3, jnp.asarray(y.float().numpy(), jnp.bfloat16),
                        jnp.asarray(g.float().numpy(), jnp.bfloat16))
    assert np.array_equal(np.asarray(want.astype(jnp.float32)), got.float().numpy())
    assert float(got[1]) != float(torch.tensor(3.0 * 0.3, dtype=BF16))


def test_bf16_dispatch_and_launch_counts_on_cpu():
    """On CPU tensors the bf16 entry points run their twins (no launch) and
    the fp32 entry points hand bf16 tensors to them."""
    x, wt, bias, skip, cot = _inputs(1, 6, 5, 8, 4, 3, True, seed=3)
    xb, wb, bb, sb, cb = (_to_bf16(a)[1] for a in (x, wt, bias, skip, cot))
    before = (kconv.conv_fwd_bf16.launches, kconv.conv_wgrad_bf16.launches)
    y1 = kconv.conv_fwd(xb, wb, bb, sb, "leaky_relu", 0.3)
    y2 = kconv.conv_fwd_bf16(xb, wb, bb, sb, "leaky_relu", 0.3)
    assert y1.dtype == BF16 and torch.equal(y1, y2)
    assert torch.equal(kconv.conv_wgrad(xb, cb, 3), kconv.conv_wgrad_bf16(xb, cb, 3))
    assert (kconv.conv_fwd_bf16.launches, kconv.conv_wgrad_bf16.launches) == before


def test_xla_cpu_sums_a_bias_cotangent_in_bf16():
    """Why the library route's bias gradients are left out of the bf16 step
    comparison (parity.py): the transpose of a bf16 broadcast add is a
    reduce_sum in bf16, which XLA on the CPU accumulates in bf16, while
    jnp.sum accumulates in fp32 and torch does either way."""
    g = jnp.asarray(np.random.RandomState(0).randn(5, 32, 32, 32), jnp.bfloat16)
    exact = np.asarray(g.astype(jnp.float32), np.float64).sum((0, 1, 2))
    grad = jax.grad(lambda b: jnp.sum((jnp.zeros(g.shape, jnp.bfloat16) + b) * g)
                    .astype(jnp.float32))(jnp.zeros(32, jnp.bfloat16))
    xla = np.asarray(grad.astype(jnp.float32))
    port = torch.from_numpy(np.array(g.astype(jnp.float32))).to(BF16).sum((0, 1, 2)).float()
    scale = np.abs(exact).max()
    assert np.abs(xla - exact).max() > 0.05 * scale
    assert np.abs(port.numpy() - exact).max() < 0.01 * scale


def _jax_bf16_step():
    """The JAX package's SOL-04 parity step with --bf16 on XLA's conv, as
    parity.parity_summary lays out the port's."""
    data, idx, stats = parity.burgers_train_parity_inputs()
    dom = jb.burgers_domain(32)
    model = jax_build_model("mars_moon", leaky_slope=stats["leaky_alpha"],
                            compute_dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((len(idx), 32, 32, 4)))
    params, _ = jax_ckpt.load_checkpoint(os.path.join(parity.BURGERS_CKPT, "model.msgpack"),
                                         params)
    cfg = jtrainer.SolTrainConfig(msteps=parity.BURGERS_PARITY_MSTEPS, batch_size=len(idx),
                                  clip_grad=True, dt=parity.BURGERS_DT)
    capture = optax_capture()
    step = jtrainer.make_burgers_train_step(jb.BurgersFlow(dom, advection="shift", max_shift=2),
                                            model.apply, capture, cfg)
    norm = JNormalization.burgers(stats["std.v"], stats["std.u"], stats["std.fv"], stats["std.fu"])
    _, grads, loss, step_losses = step(params, capture.init(params),
                                       {k: jnp.asarray(a) for k, a in data.items()}, norm,
                                       jnp.asarray(idx, jnp.int32))
    grads = params_from_jax(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32),
                                                   grads["params"]), "mars_moon",
                            build_model("mars_moon", in_channels=4))
    return (float(loss), np.asarray(step_losses), {n: float(g.norm()) for n, g in grads.items()},
            grads["head.weight"].numpy())


def optax_capture():
    """An optimizer whose state after `update` is the gradient itself."""
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def test_bf16_kernel_train_step_matches_golden():
    """`--bf16 --conv kernel` (the bf16 kernels' twins) against the JAX step
    with the Pallas conv in interpret mode (burgers_train_step_sol04_bf16.npz)."""
    got = parity.parity_summary(parity.burgers_parity_step(torch.device("cpu"), "kernel",
                                                           compute_dtype=BF16))
    errors = parity.parity_errors(got, parity.train_golden_summary(
        parity.BURGERS_TRAIN_GOLDEN_BF16))
    for key, tol in parity.TRAIN_PARITY_TOL_BF16.items():
        assert errors[key] <= tol, (key, errors)


def test_bf16_library_train_step_matches_jax_xla_conv(monkeypatch):
    """`--bf16 --conv library` (torch's bf16 conv) against the JAX step on
    XLA's bf16 conv, the weights' gradient norms (the biases' are left out,
    see parity.py)."""
    monkeypatch.setattr(ck, "_INTERPRET", False)
    want = _jax_bf16_step()
    got = parity.parity_summary(parity.burgers_parity_step(torch.device("cpu"), "library",
                                                           compute_dtype=BF16))
    weights = [n for n in want[2] if n.endswith(".weight")]
    errors = parity.parity_errors(got, want, params=weights)
    for key, tol in parity.TRAIN_PARITY_TOL_BF16.items():
        assert errors[key] <= tol, (key, errors)


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_bf16_net_keeps_float32_parameters_and_output(conv):
    model = build_model("mars_moon", in_channels=4, init="reference", conv=conv,
                        compute_dtype=BF16)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32))
    y = model(x)
    y.square().sum().backward()
    assert y.dtype == torch.float32 and y.shape == (2, 8, 8, 2)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    ref = build_model("mars_moon", in_channels=4, conv=conv)
    ref.load_state_dict(model.state_dict())
    # bf16 keeps 8 bits: the outputs agree to a few bf16 roundings
    assert (y - ref(x)).abs().max() <= 0.05 * ref(x).abs().max()


def test_build_model_refuses_other_compute_dtypes():
    with pytest.raises(KeyError, match="compute dtype"):
        build_model("mars_moon", compute_dtype=torch.float16)
