"""The port's fused convolution (`silt::conv`, kernels/conv.py) on the CPU,
where it runs its plain twins, against the JAX package's Pallas conv
(`conv_kernel.conv_fused`) in interpret mode, as tests/test_pallas_conv.py
runs it; and the correction nets under both conv implementations.

Tolerances are those of tests/test_pallas_conv.py: 1e-5 (rtol and atol) for
the forward, 2e-4 for the gradients (sums over all B*H*W rows in another
order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.ops.pallas import conv_kernel as ck

from solver_in_the_loop_torch.kernels import conv as kconv
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.parity import CONV_FWD_REL_TOL, CONV_WGRAD_REL_TOL

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(ck, "_INTERPRET", True)


def _inputs(b, h, w, cin, cout, k, with_skip, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (0.1 * rng.randn(k, k, cin, cout)).astype(np.float32)
    bias = (0.01 * rng.randn(cout)).astype(np.float32)
    skip = rng.randn(b, h, w, cout).astype(np.float32) if with_skip else None
    cot = rng.randn(b, h, w, cout).astype(np.float32)
    return x, wt, bias, skip, cot


def _jax_conv(x, w, bias, skip, cot, act):
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(a) for a in (x, w, bias)] + ([jnp.asarray(skip)] if skip is not None else [])

    def f(*a):
        y = ck.conv_fused(a[0], a[1], a[2], a[3] if len(a) > 3 else None, act=act, slope=0.3)
        return jnp.sum(y * cot), y

    grads, y = jax.grad(f, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _port_conv(x, w, bias, skip, cot, act):
    """silt::conv with the PyTorch (Cout, Cin, K, K) weight; gradients in the
    JAX package's layouts."""
    leaves = [torch.tensor(x), torch.tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
              torch.tensor(bias)] + ([torch.tensor(skip)] if skip is not None else [])
    for t in leaves:
        t.requires_grad_()
    y = kconv.conv(leaves[0], leaves[1], leaves[2], leaves[3] if skip is not None else None,
                   act, 0.3)
    (y * torch.tensor(cot)).sum().backward()
    grads = [t.grad.numpy() for t in leaves]
    grads[1] = grads[1].transpose(2, 3, 1, 0)
    return y.detach().numpy(), grads


@pytest.mark.parametrize("shape,act,with_skip", [
    ((2, 8, 8, 4, 32, 5), "leaky_relu", False),   # MarsMoon stem
    ((2, 8, 8, 8, 8, 5), "leaky_relu", True),     # residual block's second conv
    ((3, 16, 16, 8, 8, 5), "relu", True),         # M = 768 > 512: two TPU row tiles
    ((2, 8, 8, 8, 2, 5), "none", False),          # head
    ((2, 8, 8, 8, 8, 3), "leaky_relu", True),     # 3x3
    ((2, 8, 8, 8, 8, 3), "relu", False),
])
def test_conv_matches_jax_pallas_conv(shape, act, with_skip):
    b, h, w, cin, cout, k = shape
    x, wt, bias, skip, cot = _inputs(b, h, w, cin, cout, k, with_skip)
    y_j, g_j = _jax_conv(x, wt, bias, skip, cot, act)
    y_t, g_t = _port_conv(x, wt, bias, skip, cot, act)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)
    for name, a, e in zip(("dx", "dw", "db", "dskip"), g_t, g_j):
        np.testing.assert_allclose(a, e, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_gradient_at_zero_preactivation_matches_jax(act):
    """Every pre-activation exactly 0 (zero input and bias): the bias
    gradient is the cotangent's sum times JAX's act'(0), 0 for ReLU and 1
    for LeakyReLU (conv_kernel.py `_act_grad`)."""
    x, wt, bias, _, cot = _inputs(1, 4, 4, 3, 4, 3, False, seed=1)
    x[:] = 0.0
    bias[:] = 0.0
    _, g_j = _jax_conv(x, wt, bias, None, cot, act)
    _, g_t = _port_conv(x, wt, bias, None, cot, act)
    np.testing.assert_allclose(g_t[2], g_j[2], rtol=1e-6, atol=1e-6)
    want = 0.0 if act == "relu" else cot.sum((0, 1, 2))
    np.testing.assert_allclose(g_t[2], want, rtol=1e-6, atol=1e-6)


def test_flipped_transposed_forward_is_the_input_gradient():
    """conv_fwd on dz with the flipped, channel-transposed kernel view gives
    autograd's input gradient of the plain forward: the identity the
    backward uses, on strided weights."""
    x, wt, bias, _, cot = _inputs(2, 6, 7, 3, 5, 5, False, seed=2)
    xt = torch.tensor(x, requires_grad=True)
    w = torch.tensor(wt)
    (kconv.conv_fwd_plain(xt, w, torch.tensor(bias)) * torch.tensor(cot)).sum().backward()
    got = kconv.conv_fwd(torch.tensor(cot), w.transpose(2, 3), flip=True)
    np.testing.assert_allclose(got.numpy(), xt.grad.numpy(), rtol=1e-5, atol=1e-5)
    dw = kconv.conv_wgrad(torch.tensor(x), torch.tensor(cot), 5)
    assert dw.shape == (5, 5, 3, 5) and dw.permute(3, 2, 0, 1).is_contiguous()


def test_input_gradient_skipped_where_not_needed(monkeypatch):
    """The data-fed stem needs no dX: the backward then runs no flipped conv."""
    calls = []
    monkeypatch.setattr(kconv, "conv_fwd", lambda *a, **kw: calls.append(kw.get("flip", False))
                        or kconv.conv_fwd_plain(*a, **kw))
    x, wt, bias, _, _ = _inputs(1, 4, 4, 2, 3, 3, False)
    w = torch.tensor(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)), requires_grad=True)
    kconv.conv(torch.tensor(x), w, torch.tensor(bias), None, "relu", 0.0).sum().backward()
    assert calls == [False] and w.grad is not None


def test_wrappers_take_the_twins_on_the_cpu():
    x, wt, bias, skip, _ = _inputs(1, 4, 4, 2, 3, 3, True)
    launches = (kconv.conv_fwd.launches, kconv.conv_wgrad.launches)
    y = kconv.conv_fwd(torch.tensor(x), torch.tensor(wt), torch.tensor(bias), torch.tensor(skip),
                       "leaky_relu", 0.3)
    want = kconv.conv_fwd_plain(torch.tensor(x), torch.tensor(wt), torch.tensor(bias),
                                torch.tensor(skip), "leaky_relu", 0.3)
    assert torch.equal(y, want)
    kconv.conv_wgrad(torch.tensor(x), y, 3)
    assert (kconv.conv_fwd.launches, kconv.conv_wgrad.launches) == launches
    with pytest.raises(ValueError, match="unknown activation"):
        kconv.conv_fwd(torch.tensor(x), torch.tensor(wt), act="tanh")


@pytest.mark.parametrize("arch", ["mars_moon", "mercury"])
def test_nets_agree_under_both_conv_implementations(arch):
    """The same weights through cuDNN-style NCHW modules ("library") and the
    fused NHWC op ("kernel"): outputs and every parameter's gradient."""
    gen = torch.Generator().manual_seed(0)
    lib = build_model(arch, in_channels=4, init="reference", generator=gen)
    ker = build_model(arch, in_channels=4, conv="kernel")
    ker.load_state_dict(lib.state_dict())
    x = torch.randn(2, 8, 8, 4, generator=gen)
    outs = []
    for model in (lib, ker):
        y = model(x)
        (y * y).sum().backward()
        outs.append((y.detach(), {n: p.grad for n, p in model.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    for name, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][name], g, rtol=1e-4, atol=1e-4, msg=name)
    with pytest.raises(KeyError, match="conv implementation"):
        build_model(arch, conv="cudnn")


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, on the bits: as csrc/conv.cu `split_tf32` rounds."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with TF32 operands and fp32 sums: one product (terms=1), or
    3xTF32 (terms=3), big*big + (big*small + small*big) with
    a = big + small, as the conv kernels accumulate on the tensor cores."""
    a_big, b_big = _tf32(a), _tf32(b)
    if terms == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_big @ b_big + (a_big @ b_small + a_small @ b_big)


@pytest.mark.parametrize("what", ["forward", "weight_gradient"])
def test_three_tf32_products_meet_the_conv_tolerances_and_one_does_not(what):
    """Why the conv kernels pay for three tensor-core products: at the
    Burgers block shape (5, 32, 32, 32 -> 32, K=5), per-tap products in
    3xTF32 stay within the kernels' tolerances of a float64 reference, and
    in one TF32 product they do not."""
    b, h, w, cin, cout, k = 5, 32, 32, 32, 32, 5
    x, wt, _, _, dz = _inputs(b, h, w, cin, cout, k, False, seed=3)
    xp = np.pad(x, ((0, 0), (k // 2, k // 2), (k // 2, k // 2), (0, 0)))
    taps = [np.ascontiguousarray(xp[:, ky:ky + h, kx:kx + w, :].reshape(-1, cin))
            for ky in range(k) for kx in range(k)]
    rows = dz.reshape(-1, cout)
    if what == "forward":
        ref = sum(t.astype(np.float64) @ wt[i // k, i % k].astype(np.float64)
                  for i, t in enumerate(taps))
        tol = CONV_FWD_REL_TOL

        def emulate(terms):
            return sum(_tf32_product(torch.tensor(t), torch.tensor(wt[i // k, i % k]), terms)
                       for i, t in enumerate(taps)).numpy()
    else:
        ref = np.stack([t.T.astype(np.float64) @ rows.astype(np.float64) for t in taps])
        tol = CONV_WGRAD_REL_TOL

        def emulate(terms):
            return np.stack([_tf32_product(torch.tensor(t.T.copy()), torch.tensor(rows), terms)
                             .numpy() for t in taps])

    errors = {terms: float(np.abs(emulate(terms) - ref).max() / np.abs(ref).max())
              for terms in (3, 1)}
    assert errors[3] <= tol, errors
    assert errors[1] > tol, errors
