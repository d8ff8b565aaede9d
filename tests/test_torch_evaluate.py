"""The port's `evaluate` CLI against the JAX package's on the CPU.

On a small pair of scenes written by the JAX package's Scene (a hi-res
reference at 4x the resolution of the rollout), both CLIs print one JSON
line: `steps` equal, the MAEs within 1e-6 relative (the same float32 means
in another summation order). Also the clamp to the longest run of rollout
frames from 1 and the exit status 2 of a run without frame 1.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import evaluate as jax_evaluate
from solver_in_the_loop_tpu.io.scene import Scene as JaxScene

from solver_in_the_loop_torch import __main__ as torch_cli

torch.set_num_threads(1)

REL_TOL = 1e-6


def _scenes(root, run_frames, ref_frames=range(0, 15), seed=0):
    """A reference scene at 64x32 (velo frames `ref_frames`) and a rollout at
    16x8 (velTf frames `run_frames`), both written by the JAX package."""
    rng = np.random.RandomState(seed)
    ref, run = JaxScene(str(root / "ref")), JaxScene(str(root / "run"))
    for t in ref_frames:
        ref.write_staggered("velo", t, rng.randn(1, 64, 33).astype(np.float32),
                            rng.randn(1, 65, 32).astype(np.float32))
    for t in run_frames:
        run.write_staggered("velTf", t, 0.1 * rng.randn(1, 16, 9).astype(np.float32),
                            0.1 * rng.randn(1, 17, 8).astype(np.float32))
    return ref.path, run.path


def _both(capsys, argv):
    want = jax_evaluate.main(argv)
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = torch_cli.main(["evaluate", *argv, "--device", "cpu"])
    got_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == got_line and want == want_line
    return got, want


def _assert_close(got, want):
    assert set(got) == set(want) == {"steps", "mae_mean", "mae_final", "mae_per_step_head"}
    assert got["steps"] == want["steps"]
    assert len(got["mae_per_step_head"]) == len(want["mae_per_step_head"])
    for a, b in zip([got["mae_mean"], got["mae_final"], *got["mae_per_step_head"]],
                    [want["mae_mean"], want["mae_final"], *want["mae_per_step_head"]]):
        assert abs(a - b) <= REL_TOL * abs(b), (a, b)


@pytest.mark.parametrize("steps,offset", [(12, 2), (5, 0)])
def test_evaluate_prints_the_jax_json(tmp_path, capsys, steps, offset):
    ref, run = _scenes(tmp_path, range(0, 13))
    got, want = _both(capsys, ["--run", run, "--ref", ref, "--ref-offset", str(offset),
                               "--scale", "4", "--steps", str(steps)])
    _assert_close(got, want)
    assert got["steps"] == steps


def test_evaluate_clamps_at_a_gap(tmp_path, capsys):
    """Frames 1..4 and 6..8: both clamp --steps 8 to the 4 frames before the gap."""
    ref, run = _scenes(tmp_path, [1, 2, 3, 4, 6, 7, 8])
    got, want = _both(capsys, ["--run", run, "--ref", ref, "--steps", "8"])
    _assert_close(got, want)
    assert got["steps"] == 4 and len(got["mae_per_step_head"]) == 4


def test_evaluate_exits_2_without_frame_1(tmp_path):
    ref, run = _scenes(tmp_path, [0, 2, 3])
    argv = ["--run", run, "--ref", ref, "--steps", "3"]
    with pytest.raises(SystemExit) as jax_exit:
        jax_evaluate.main(argv)
    with pytest.raises(SystemExit) as port_exit:
        torch_cli.main(["evaluate", *argv, "--device", "cpu"])
    assert port_exit.value.code == jax_exit.value.code == 2


def test_evaluate_refuses_cpu_without_device_flag(tmp_path, monkeypatch):
    ref, run = _scenes(tmp_path, [1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["evaluate", "--run", run, "--ref", ref])
