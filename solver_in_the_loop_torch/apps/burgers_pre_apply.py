"""Burgers PRE rollout CLI: burgers-apply with a PRE net's normalisation,
the test sim's forces replayed.

Port of solver_in_the_loop_tpu/apps/burgers_pre_apply.py with the same flags
plus `--conv {library,kernel}` and `--device {cuda,cpu}` (default cuda), as
burgers-apply's; `--arch` takes `jupiter_moon`. The features [v, u, fv, fu]
are standardised by the net's stats.json (in.std, and in.mean under
nozerocen), its output scaled by out.std (plus out.mean). The Makefile's
`burgers-fdt-pre/run_test` for one test sim:

    python -m solver_in_the_loop_torch burgers-pre-apply -o OUT \
        --stats burgers-fdt-pre/tf/stats.json --model burgers-fdt-pre/tf/model.msgpack \
        --initvH burgers-fdt-hires-testset/sim_000000/velo_000000.npz \
        --loadfH "burgers-fdt-hires-testset/sim_000000/forc_0*.npz" \
        -d 4 -r 32 -l 32 --dt 0.1 -t 200

It writes velTf frames, as burgers-apply.
"""

from __future__ import annotations

import argparse
import logging

from solver_in_the_loop_torch.apps import burgers_apply
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, MODELS


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("burgers-pre-apply")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--stats", required=True, help="stats.json from PRE training")
    p.add_argument("--leaky-alpha", type=float, default=None,
                   help="override the LeakyReLU slope (default: the value recorded in the "
                        "stats json; 0.01 if absent)")
    p.add_argument("--arch", default="mars_moon", choices=sorted(MODELS))
    p.add_argument("-t", "--simsteps", type=int, default=200)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("-l", "--len", type=float, default=32.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--initvH", required=True)
    p.add_argument("--loadfH", required=True)
    p.add_argument("-d", "--scale", type=int, default=4)
    p.add_argument("--advect", choices=["gather", "shift"], default="shift")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's CUDA kernels "
                        "('kernel')")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    # what burgers-apply's run reads and this CLI does not offer: always
    # forced, always with the net
    p.set_defaults(noforce=False, no_model=False)
    return p


def run(args):
    """burgers-apply's run with the PRE normalisation; returns its frames."""
    return burgers_apply.run(args, normalization=lambda stats, device, use_force:
                             Normalization.pre(stats, device))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
