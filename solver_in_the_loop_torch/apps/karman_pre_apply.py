"""Karman PRE rollout CLI: karman-apply with a PRE net's normalisation.

Port of solver_in_the_loop_tpu/apps/karman_pre_apply.py with the same flags
plus `--conv {library,kernel}`, `--pressure-precon {fd,none}` and `--device
{cuda,cpu}` (default cuda), as karman-apply's. The net's features are
standardised by its stats.json (in.std, and in.mean under nozerocen), its
output scaled by out.std (plus out.mean); the net is rebuilt at the stats'
LeakyReLU slope unless `--leaky-alpha` is given. The Makefile's
`karman-fdt-pre/run_test` for one test Re:

    python -m solver_in_the_loop_torch karman-pre-apply -o OUT \
        --stats karman-fdt-pre/tf/stats.json --model karman-fdt-pre/tf/model.msgpack \
        --initdH karman-fdt-hires-testset/sim_000000/dens_001000.npz \
        --initvH karman-fdt-hires-testset/sim_000000/velo_001000.npz \
        -d 4 -r 32 -l 100 --re 240000 -t 500

It writes denTf, velTf and corTf frames, one scene per Re, as karman-apply.
"""

from __future__ import annotations

import argparse
import logging

from solver_in_the_loop_torch.apps import karman_apply
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, MODELS


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("karman-pre-apply")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--stats", required=True, help="stats.json from PRE training")
    p.add_argument("--leaky-alpha", type=float, default=None,
                   help="override the LeakyReLU slope (default: the value recorded in the "
                        "stats json; 0.01 if absent)")
    p.add_argument("--arch", default="mars_moon", choices=sorted(MODELS))
    p.add_argument("-t", "--simsteps", type=int, default=500)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("--re", type=float, nargs="+", default=[1e6])
    p.add_argument("--initdH", default=None)
    p.add_argument("--initvH", default=None)
    p.add_argument("-d", "-s", "--scale", type=int, default=4, dest="scale")
    p.add_argument("-l", "--len", type=float, default=100.0)
    p.add_argument("--advect", choices=["gather", "shift"], default="shift")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's CUDA kernels "
                        "('kernel')")
    karman_apply.add_pressure_precon(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    # what karman-apply's run reads and this CLI does not offer: the JAX
    # CLI's solver defaults, always with the net
    p.set_defaults(no_model=False, ptol=1e-5, pmaxiter=1000)
    return p


def run(args):
    """karman-apply's run with the PRE normalisation; returns its frames."""
    return karman_apply.run(args, normalization=lambda stats, device: Normalization.pre(
        stats, device))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
