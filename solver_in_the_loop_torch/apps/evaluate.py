"""Rollout accuracy: the velocity MAE of a run_test scene against the
downsampled hi-res reference trajectory.

Port of solver_in_the_loop_tpu/apps/evaluate.py with the same flags plus
`--device {cuda,cpu}` (default cuda: the downsampling and the MAE run on the
card, which must be present). It prints the same JSON line, the repo's
accuracy metric (BASELINE.md):

    python -m solver_in_the_loop_torch evaluate \
        --run karman-fdt-sol32/run_test/sim_000000 \
        --ref karman-fdt-hires-testset/sim_000000 --ref-offset 1000 --scale 4 \
        --steps 100

Rollout frames 1..N are compared with reference frames ref_offset+1 ..
ref_offset+N, N being --steps clamped to the longest run of rollout frames
from 1 without a gap; a run without frame 1 exits with status 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np
import torch

from solver_in_the_loop_torch.apps.karman_apply import resolve_device
from solver_in_the_loop_torch.core.resample import downsample_staggered
from solver_in_the_loop_torch.io.scene import Scene, legacy_to_staggered

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("evaluate")
    p.add_argument("--run", required=True, help="rollout scene dir (velTf frames)")
    p.add_argument("--ref", required=True, help="hi-res reference scene dir (velo frames)")
    p.add_argument("--ref-offset", type=int, default=0,
                   help="reference frame number matching rollout frame 0")
    p.add_argument("--scale", type=int, default=4, help="reference downsampling factor")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--field", default="velTf")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to downsample and compare (default: the CUDA card)")
    return p


def run(args):
    """Print and return {"steps", "mae_mean", "mae_final", "mae_per_step_head"}."""
    device = resolve_device(args.device)
    run_sc, ref_sc = Scene(args.run), Scene(args.ref)
    have = set(run_sc.frames(args.field))
    n_contig = 0
    while (n_contig + 1) in have:
        n_contig += 1
    if n_contig <= 0:
        log.error("no contiguous rollout frames starting at 1 in %s (have: %s)",
                  args.run, sorted(have)[:5])
        sys.exit(2)
    if args.steps > n_contig:
        log.warning("only %d contiguous rollout frames available; clamping --steps %d",
                    n_contig, args.steps)
        args.steps = n_contig
    steps = range(1, args.steps + 1)
    ur, vr = (torch.from_numpy(a).to(device)
              for a in legacy_to_staggered(run_sc.read_batch(args.field, steps)))
    uh, vh = (torch.from_numpy(a).to(device) for a in legacy_to_staggered(
        ref_sc.read_batch("velo", [args.ref_offset + t for t in steps])))
    u_g, v_g = downsample_staggered(uh, vh, args.scale)
    du = torch.mean(torch.abs(ur - u_g), dim=(1, 2))
    dv = torch.mean(torch.abs(vr - v_g), dim=(1, 2))
    maes = [float(x) for x in (0.5 * (du + dv)).cpu().numpy()]
    out = {"steps": args.steps, "mae_mean": float(np.mean(maes)), "mae_final": maes[-1],
           "mae_per_step_head": maes[:10]}
    print(json.dumps(out))
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
