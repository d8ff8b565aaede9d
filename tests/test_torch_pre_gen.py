"""The port's PRE generators (`karman-pre-gen`, `burgers-pre-gen`) against
the JAX package's CLIs on the CPU, a few frames at a small resolution: the
same files, frames within FRAME_REL_TOL of each field's max, and the
thumbnails."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_gen as jax_bgen
from solver_in_the_loop_tpu.apps import burgers_pre_gen as jax_bpg
from solver_in_the_loop_tpu.apps import karman_pre_gen as jax_kpg

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.io.thumbs import png_pixels, thumb_pixels

torch.set_num_threads(2)

# a handful of lockstep frames: the solves' float32 sums in other orders
# (measured: at most 2e-6 of a field's max, the correction's too)
FRAME_REL_TOL = 1e-4
KARMAN_NAMES = ("densH", "veloH", "densC", "veloC", "dens", "velo", "corr")
BURGERS_NAMES = ("veloH", "veloC", "velo", "corr", "forcH", "forc")


def _files(root: str):
    return sorted(f for f in os.listdir(root) if f.endswith(".npz"))


def _compare(jsim: str, tsim: str):
    files = _files(jsim)
    assert files == _files(tsim)
    errors = {}
    for f in files:
        a = torch_scene.read_array(os.path.join(jsim, f))
        b = torch_scene.read_array(os.path.join(tsim, f))
        assert a.shape == b.shape, f
        errors[f] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    return errors


@pytest.mark.parametrize("beta", ["1.0", "0"])
def test_karman_pre_gen_matches_jax(tmp_path, beta):
    """-r 8 (16x8 lo-res, 64x32 hi-res), 12 frames with 4 skipped."""
    argv = ["-r", "8", "-l", "100", "--re", "160000", "-t", "12", "-s", "4", "--beta", beta]
    jax_kpg.main(["-o", str(tmp_path / "jax"), *argv])
    res = torch_cli.main(["karman-pre-gen", "-o", str(tmp_path / "port"), *argv, "--thumb",
                          "--device", "cpu"])
    assert res["frames"] == list(range(5, 12))
    errors = _compare(str(tmp_path / "jax" / "sim_000000"), res["scene"])
    assert len(errors) == len(KARMAN_NAMES) * 7
    assert max(errors.values()) <= FRAME_REL_TOL, errors
    assert len(res["lsq_outer"]) == 11 and (res["lsq_outer"] > 0).all()
    assert (res["lsq_inner"] > 0).all()
    assert set(res["seconds"]) >= {"hires_step", "lores_step", "projection", "lsq", "rollout",
                                   "write"}
    thumbs = tmp_path / "port" / "thumb" / "sim_000000"
    assert len(os.listdir(thumbs)) == 5 * 7
    corr_u = torch_scene.read_array(os.path.join(res["scene"], "corr_000011.npz"))[0, :-1, :, 0]
    np.testing.assert_array_equal(png_pixels(str(thumbs / "corUC_000011.png")),
                                  thumb_pixels(corr_u, 10000.0))


def test_burgers_pre_gen_matches_jax(tmp_path):
    """-r 16 from a JAX burgers-gen sim at 64x64: 10 frames."""
    jax_bgen.main(["-o", str(tmp_path / "hi"), "-r", "64", "-l", "32", "--dt", "0.1", "-s", "5",
                   "-t", "12", "--seed", "3"])
    sim = tmp_path / "hi" / "sim_000000"
    argv = ["-r", "16", "-l", "32", "--dt", "0.1", "-t", "10",
            "--initvH", str(sim / "velo_000000.npz"), "--loadfH", str(sim / "forc_0*.npz")]
    jax_bpg.main(["-o", str(tmp_path / "jax"), *argv])
    res = torch_cli.main(["burgers-pre-gen", "-o", str(tmp_path / "port"), *argv, "--thumb",
                          "--device", "cpu"])
    errors = _compare(str(tmp_path / "jax" / "sim_000000"), res["scene"])
    assert len(errors) == len(BURGERS_NAMES) * 9
    assert max(errors.values()) <= FRAME_REL_TOL, errors
    assert len(os.listdir(tmp_path / "port" / "thumb" / "sim_000000")) == 4 * 9


def test_burgers_pre_gen_random_start_matches_jax(tmp_path):
    """Without --initvH both draw the start from RandomState(seed)."""
    jax_bgen.main(["-o", str(tmp_path / "hi"), "-r", "32", "-l", "32", "--dt", "0.1", "-s", "0",
                   "-t", "6", "--seed", "1"])
    argv = ["-r", "8", "-l", "32", "--dt", "0.1", "-t", "5", "--seed", "7",
            "--loadfH", str(tmp_path / "hi" / "sim_000000" / "forc_0*.npz")]
    jax_bpg.main(["-o", str(tmp_path / "jax"), *argv])
    res = torch_cli.main(["burgers-pre-gen", "-o", str(tmp_path / "port"), *argv,
                          "--device", "cpu"])
    errors = _compare(str(tmp_path / "jax" / "sim_000000"), res["scene"])
    assert max(errors.values()) <= FRAME_REL_TOL, errors


def test_burgers_pre_gen_refuses_too_few_forces(tmp_path):
    jax_bgen.main(["-o", str(tmp_path / "hi"), "-r", "32", "-l", "32", "--dt", "0.1", "-s", "0",
                   "-t", "3", "--seed", "1"])
    with pytest.raises(ValueError, match="force frames"):
        torch_cli.main(["burgers-pre-gen", "-o", str(tmp_path / "port"), "-r", "8", "-t", "5",
                        "--loadfH", str(tmp_path / "hi" / "sim_000000" / "forc_0*.npz"),
                        "--device", "cpu"])
