"""The karman-apply slice of the PyTorch port against the JAX package (CPU).

* `karman_rollout` of the port vs the JAX rollout with the trained SOL-32
  checkpoint (artifacts/a3_k_sol32) for a few steps at small resolutions;
* the port's CLI end to end with `--device cpu`, from the built-in initial
  state and from hi-res npz frames (`--initdH/--initvH`);
* the CLI without `--device cpu` refuses to run when CUDA is missing;
* the golden frames that chip_smoke.py compares the card's rollout with
  still equal a fresh JAX CPU run. Regenerate them with
  `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_apply.py`.
* an AST scan: the port and chip_smoke.py import nothing of JAX.

Tolerances: both sides run float32 with the same formulas; they differ only
in summation order (XLA's vs PyTorch's reductions, convs and matmuls), about
1e-7 relative per step. CG stops at tol 1e-5 and its iterate depends on
those bits, so after a few steps fields agree to ~1e-6 of their max; 1e-4
leaves room for the flow's amplification.
"""

from __future__ import annotations

import ast
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.io import scene as jax_scene
from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.physics import karman as jk
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt
from solver_in_the_loop_tpu.train.rollout import karman_rollout as jax_karman_rollout

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics import karman as tk
from solver_in_the_loop_torch.train import checkpoint as tckpt
from solver_in_the_loop_torch.train.rollout import karman_rollout

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "artifacts" / "a3_k_sol32"
GOLDEN = REPO / "tests" / "data" / "torch_port" / "karman_apply_sol32_r32.npz"
GOLDEN_STEPS = (1, 5, 20)
GOLDEN_RE = 240000.0
ROLLOUT_RTOL = 1e-4


def _stats():
    with open(CKPT / "dataStats.json") as f:
        return json.load(f)


def jax_apply_frames(res: int, steps: int, re_list):
    """The JAX package's karman-apply rollout (shift advection, SOL-32
    checkpoint) on the CPU from the built-in initial state: dict of (T, B, ...)."""
    stats = _stats()
    dom = jk.karman_domain(res, 100.0)
    flow = jk.KarmanFlow(dom, advection="shift", max_shift=2)
    d0, v0 = jk.initial_state(dom, len(re_list))
    norm = JNormalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    model = jax_build_model("mars_moon", leaky_slope=stats["leaky_alpha"])
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((len(re_list), dom.ny, dom.nx, 3)))
    params, _ = jax_ckpt.load_checkpoint(str(CKPT / "model.msgpack"), params)
    rollout = jax_karman_rollout(flow, steps=steps, model_apply=model.apply, norm=norm)
    frames = rollout(params, d0, v0, jnp.asarray(re_list, jnp.float32))
    return {k: np.asarray(v) for k, v in frames.items()}


def port_apply_frames(res: int, steps: int, re_list):
    stats = _stats()
    dom = tk.karman_domain(res, 100.0)
    flow = tk.KarmanFlow(dom, advection="shift", max_shift=2)
    d0, v0 = tk.initial_state(dom, len(re_list))
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    model = build_model("mars_moon", leaky_slope=stats["leaky_alpha"])
    tckpt.load_model_weights(model, str(CKPT / "model.msgpack"), "mars_moon")
    frames = karman_rollout(flow, d0, v0, torch.tensor(re_list), steps, model=model.eval(),
                            norm=norm)
    return {k: v.numpy() for k, v in frames.items()}


def make_golden_frames():
    """Density, u and v at GOLDEN_STEPS of the JAX CPU rollout at res 32,
    batch 1, Re 240000: what chip_smoke.py holds the card's rollout to."""
    frames = jax_apply_frames(32, max(GOLDEN_STEPS), [GOLDEN_RE])
    return {f"{k}_{s}": frames[k][s - 1] for k in ("dens", "u", "v") for s in GOLDEN_STEPS}


def _assert_rel_close(got, want, rtol):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


@pytest.mark.parametrize("res,steps,re_list", [(8, 6, [240000.0]), (16, 6, [240000.0, 960000.0])])
def test_rollout_matches_jax(res, steps, re_list):
    want = jax_apply_frames(res, steps, re_list)
    got = port_apply_frames(res, steps, re_list)
    assert got["cg_iters"].shape == (steps,)
    for key in ("dens", "u", "v", "corr_u", "corr_v"):
        assert got[key].shape == want[key].shape
        _assert_rel_close(got[key], want[key], ROLLOUT_RTOL)


def test_golden_frames_match_fresh_jax_run():
    """The committed golden file is what the JAX package computes today (up to
    last-bit differences between CPUs' float32 kernels)."""
    fresh = make_golden_frames()
    with np.load(GOLDEN) as golden:
        assert sorted(golden.files) == sorted(fresh)
        for key, arr in fresh.items():
            assert golden[key].shape == arr.shape
            _assert_rel_close(golden[key], arr, 1e-5)


def _cli_args(out, *extra):
    return ["karman-apply", "-o", str(out), "--model", str(CKPT / "model.msgpack"),
            "--stats", str(CKPT / "dataStats.json"), "-r", "8", "-t", "4", *extra]


def test_cli_cpu_end_to_end_matches_jax(tmp_path):
    frames = torch_cli.main(_cli_args(tmp_path / "out", "--re", "240000", "480000",
                                      "--device", "cpu"))
    want = jax_apply_frames(8, 3, [240000.0, 480000.0])
    for b in range(2):
        sc = torch_scene.Scene(str(tmp_path / "out" / f"sim_{b:06d}"))
        u, v = sc.read_staggered("velTf", 3)
        np.testing.assert_array_equal(u, frames["u"][2, b:b + 1].numpy())
        _assert_rel_close(u, want["u"][2, b:b + 1], ROLLOUT_RTOL)
        _assert_rel_close(v, want["v"][2, b:b + 1], ROLLOUT_RTOL)
        _assert_rel_close(sc.read_centered("denTf", 3), want["dens"][2, b:b + 1], ROLLOUT_RTOL)
        assert os.path.isfile(sc.frame_path("corTf", 0))
        with open(os.path.join(sc.path, "params.json")) as f:
            assert json.load(f)["re"] == [240000.0, 480000.0][b]


def test_cli_cpu_from_hires_frames(tmp_path):
    """--initdH/--initvH: legacy hi-res npz frames, 4x downsampled, then the
    rollout; the JAX CLI on the same files gives the same frames."""
    from solver_in_the_loop_tpu.apps import karman_apply as jax_apply

    rng = np.random.RandomState(3)
    dom_hi = jk.karman_domain(32)  # 4x the res-8 rollout
    d_hi = rng.rand(1, dom_hi.ny, dom_hi.nx).astype(np.float32)
    u_hi = (0.3 * rng.randn(1, dom_hi.ny, dom_hi.nx + 1)).astype(np.float32)
    v_hi = (1.0 + 0.3 * rng.randn(1, dom_hi.ny + 1, dom_hi.nx)).astype(np.float32)
    np.savez_compressed(tmp_path / "dens.npz", jax_scene.centered_to_legacy(d_hi))
    np.savez_compressed(tmp_path / "velo.npz", jax_scene.staggered_to_legacy(u_hi, v_hi))
    init = ["--initdH", str(tmp_path / "dens.npz"), "--initvH", str(tmp_path / "velo.npz"),
            "-d", "4", "--re", "240000"]
    torch_cli.main(_cli_args(tmp_path / "port", *init, "--device", "cpu"))
    jax_apply.main(_cli_args(tmp_path / "jax", *init)[1:])
    port, ref = (torch_scene.Scene(str(tmp_path / d / "sim_000000")) for d in ("port", "jax"))
    for frame in (0, 3):
        np.testing.assert_allclose(port.read_centered("denTf", frame),
                                   ref.read_centered("denTf", frame), rtol=0, atol=1e-6)
        for a, b in zip(port.read_staggered("velTf", frame), ref.read_staggered("velTf", frame)):
            _assert_rel_close(a, b, ROLLOUT_RTOL)


def test_cli_without_device_cpu_refuses_to_run_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(_cli_args(tmp_path / "out", "--re", "240000"))
    assert not (tmp_path / "out").exists()


BANNED = ("jax", "jaxlib", "flax", "optax", "solver_in_the_loop_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "solver_in_the_loop_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the training slice's modules are among those scanned
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {f"solver_in_the_loop_torch/{m}" for m in (
        "apps/karman_train.py", "train/trainer.py", "train/dataset.py",
        "utils/metrics.py", "utils/stats.py")} <= scanned
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_roots(f) if m in BANNED]
    assert not bad, f"the port imports JAX-side modules: {bad}"


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **make_golden_frames())
    print(f"wrote {GOLDEN}", file=sys.stderr)
