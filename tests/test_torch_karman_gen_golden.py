"""The JAX golden of chip_smoke.py's karman_gen phase, and the port's CPU run
held to it.

`karman_gen_hires_r128.npz`: frames KARMAN_GEN_STEPS (1, 5, 20) of sims
KARMAN_GEN_SIMS (0 and 5) of the JAX package's `karman-gen` with the
Makefile's hi-res training-set command (`karman-fdt-hires-set`: `-r 128 -l 100
--seed 0`, the 6 Re batched at 256x128, the pressure solved with multigrid),
cut to `-t 21 -s 0`: dens (2, 3, 256, 128), u (2, 3, 256, 129) and v (2, 3,
257, 128), as the scenes hold them. Regenerate with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_karman_gen_golden.py

(~10 s). The port is held to it within ROLLOUT_REL_TOL of each field's max
(solver_in_the_loop_torch/parity.py), as chip_smoke.py holds the card.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from solver_in_the_loop_tpu.apps import karman_gen as jax_gen
from solver_in_the_loop_tpu.io import scene as jax_scene

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity

STEPS = parity.KARMAN_GEN_STEPS
SIMS = parity.KARMAN_GEN_SIMS


def jax_frames(parent: str, simsteps: int, steps) -> dict:
    """The JAX package's karman-gen of the hi-res set cut to `simsteps`
    frames: dens, u, v at `steps` of SIMS, each (sims, steps, ...)."""
    jax_gen.main(["-o", parent, *parity.KARMAN_HIRES_ARGV, "-t", str(simsteps), "-s", "0"])
    out = {"dens": [], "u": [], "v": []}
    for sim in SIMS:
        sc = jax_scene.Scene(os.path.join(parent, f"sim_{sim:06d}"))
        rows = [(sc.read_centered("dens", t)[0], *(a[0] for a in sc.read_staggered("velo", t)))
                for t in steps]
        for key, arrs in zip(out, zip(*rows)):
            out[key].append(np.stack(arrs))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


def make_golden() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        frames = jax_frames(tmp, max(STEPS) + 1, STEPS)
    return {**frames, "sims": np.asarray(SIMS), "steps": np.asarray(STEPS)}


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_golden_matches_fresh_jax_run(tmp_path):
    """The committed step 1 is what the JAX package generates today (up to
    last-bit differences between CPUs' float32 kernels)."""
    fresh = jax_frames(str(tmp_path), 2, [1])
    with np.load(parity.KARMAN_GEN_GOLDEN) as g:
        assert g["dens"].shape == (len(SIMS), len(STEPS), 256, 128)
        assert g["u"].shape == (len(SIMS), len(STEPS), 256, 129)
        assert list(g["steps"]) == list(STEPS) and list(g["sims"]) == list(SIMS)
        for key in ("dens", "u", "v"):
            assert _rel(g[key][:, :1], fresh[key]) <= 1e-5, key


def test_port_cpu_gen_matches_golden(tmp_path):
    """The port's karman-gen of the same command on the CPU (multigrid, as
    the JAX package off the TPU): steps 1, 5 and 20 within ROLLOUT_REL_TOL."""
    frames = torch_cli.main(["karman-gen", "-o", str(tmp_path), *parity.KARMAN_HIRES_ARGV,
                             "-t", str(max(STEPS) + 1), "-s", "0", "--device", "cpu"])
    assert frames["route"] == "multigrid"
    with np.load(parity.KARMAN_GEN_GOLDEN) as g:
        for key in ("dens", "u", "v"):
            for i, sim in enumerate(SIMS):
                for j, step in enumerate(STEPS):
                    got = frames[key][step - 1, sim].numpy()
                    assert _rel(got, g[key][i, j]) <= parity.ROLLOUT_REL_TOL, (key, sim, step)


if __name__ == "__main__":
    os.makedirs(parity.DATA, exist_ok=True)
    np.savez_compressed(parity.KARMAN_GEN_GOLDEN, **make_golden())
    print(f"wrote {parity.KARMAN_GEN_GOLDEN}", file=sys.stderr)
