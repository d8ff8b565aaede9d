"""The port's karman-gen CLI against the JAX package's on the CPU.

* res 64 (128x64), two Re batched, `-t 6 -s 2`: the pressure solve takes
  multigrid on both sides (the size where the JAX package takes it off the
  TPU); frames 3..5 of both scenes;
* res 8 (16x8) with `-s 0` from hi-res frames (`--initdH/--initvH`, 4x
  downsampled), the Makefile's lo-res source runs at a small size, with the
  FD preconditioner and without it (the JAX side solves with its XLA FD-PCG
  either way): frames 0..4;
* the rollout's `collect_from`, the refusals (one init file, unstable
  diffusion); `--thumb` is held to the JAX app in tests/test_torch_npz_thumbs.py.

Tolerances. Diffusion, advection and downsampling are the same float32
formulas; the pressure solves stop at the CG tolerance 1e-5 of ||b||, an
iteration apart at most, and a few steps carry that on: 1e-4 of each field's
max.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import karman_gen as jax_gen
from solver_in_the_loop_tpu.io import scene as jax_scene
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.physics import karman as tk
from solver_in_the_loop_torch.train.rollout import karman_rollout

torch.set_num_threads(1)

RTOL = 1e-4


def _rel_close(got, want, rtol=RTOL):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _compare_scenes(port_dir, jax_dir, sims, frames):
    for sim in range(sims):
        port = torch_scene.Scene(os.path.join(port_dir, f"sim_{sim:06d}"))
        ref = jax_scene.Scene(os.path.join(jax_dir, f"sim_{sim:06d}"))
        assert port.frames("dens") == port.frames("velo") == list(frames)
        assert sorted(f for f in os.listdir(ref.path) if f.endswith(".npz")) == \
            sorted(f for f in os.listdir(port.path) if f.endswith(".npz"))
        with open(os.path.join(port.path, "params.json")) as f, \
                open(os.path.join(ref.path, "params.json")) as g:
            assert json.load(f)["re"] == json.load(g)["re"]
        for t in frames:
            _rel_close(port.read_centered("dens", t), ref.read_centered("dens", t))
            for a, b in zip(port.read_staggered("velo", t), ref.read_staggered("velo", t)):
                _rel_close(a, b)


def test_gen_cli_multigrid_matches_jax(tmp_path):
    argv = ["-r", "64", "-t", "6", "-s", "2", "--re", "160000", "640000"]
    frames = torch_cli.main(["karman-gen", "-o", str(tmp_path / "port"), *argv,
                             "--device", "cpu"])
    jax_gen.main(["-o", str(tmp_path / "jax"), *argv])
    assert frames["route"] == "multigrid"
    assert frames["dens"].shape == (3, 2, 128, 64) and frames["cg_iters"].shape == (3,)
    assert int(frames["cg_iters"].min()) > 0
    _compare_scenes(str(tmp_path / "port"), str(tmp_path / "jax"), 2, range(3, 6))


@pytest.mark.parametrize("precon,route", [("fd", "pcg"), ("none", "cg")])
def test_gen_cli_lores_from_hires_frames_matches_jax(tmp_path, precon, route):
    rng = np.random.RandomState(3)
    dom_hi = jk.karman_domain(32)
    d_hi = rng.rand(1, dom_hi.ny, dom_hi.nx).astype(np.float32)
    u_hi = (0.3 * rng.randn(1, dom_hi.ny, dom_hi.nx + 1)).astype(np.float32)
    v_hi = (1.0 + 0.3 * rng.randn(1, dom_hi.ny + 1, dom_hi.nx)).astype(np.float32)
    np.savez_compressed(tmp_path / "dens.npz", jax_scene.centered_to_legacy(d_hi))
    np.savez_compressed(tmp_path / "velo.npz", jax_scene.staggered_to_legacy(u_hi, v_hi))
    argv = ["-r", "8", "-s", "0", "-t", "5", "-d", "4", "--re", "160000",
            "--initdH", str(tmp_path / "dens.npz"), "--initvH", str(tmp_path / "velo.npz")]
    frames = torch_cli.main(["karman-gen", "-o", str(tmp_path / "port"), *argv,
                             "--pressure-precon", precon, "--device", "cpu"])
    jax_gen.main(["-o", str(tmp_path / "jax"), *argv])
    assert frames["route"] == route
    _compare_scenes(str(tmp_path / "port"), str(tmp_path / "jax"), 1, range(5))


def test_rollout_collect_from_keeps_the_warm_start_history():
    """Skipped steps stack nothing but run (and warm-start) as kept ones:
    the kept frames equal the tail of the full rollout to the bit."""
    dom = tk.karman_domain(8)
    flow = tk.KarmanFlow(dom, advection="gather", max_shift=4)
    d0, v0 = tk.initial_state(dom, 2)
    re = torch.tensor([160000.0, 320000.0])
    full = karman_rollout(flow, d0, v0, re, 7)
    tail = karman_rollout(flow, d0, v0, re, 7, collect_from=4)
    assert sorted(tail) == ["cg_iters", "dens", "u", "v"]  # no zero corrections
    for key, val in tail.items():
        assert val.shape[0] == 3 and torch.equal(val, full[key][4:]), key


def test_gen_refuses_one_init_file(tmp_path):
    with pytest.raises(ValueError, match="both"):
        torch_cli.main(["karman-gen", "-o", str(tmp_path), "--initdH", "x.npz",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="diffusion"):
        torch_cli.main(["karman-gen", "-o", str(tmp_path), "-r", "128", "--re", "10000",
                        "--device", "cpu"])
    assert not os.listdir(tmp_path)
