"""Forced periodic Burgers: its inputs, the program's train step and
rollout, and the reference's side of each check.

The program is driven through the calls its CLIs make: `burgers-train`'s
(`make_burgers_train_step`, fed by `local_batch` as `run_training` feeds
it) and `burgers-apply`'s (`burgers_rollout`'s `rollout_replay`). Its
modules are imported inside the functions.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from silt_bench import inputs as bench_inputs
from silt_bench.reference.sol import BurgersSol


def make_inputs(config: dict, kind: str, seed: int, device) -> dict:
    """The sims made from the seed (`nsims` training sims of `simsteps`
    frames, or `test_sims` test sims of apply_steps + 1), and the frozen
    checkpoint."""
    if kind == "train":
        seeds, frames = bench_inputs.sub_seeds(seed, config["nsims"]), config["simsteps"]
    else:
        seeds, frames = bench_inputs.sub_seeds(seed + 1, config["test_sims"]), \
            config["apply_steps"] + 1
    return {"data": bench_inputs.burgers_sims(seeds, config, frames, device),
            "weights": bench_inputs.checkpoint(config["checkpoint"], config["net"]["blocks"]),
            "stats": bench_inputs.stats(config["checkpoint"])}


def rows(config: dict, seed: int) -> Iterator[np.ndarray]:
    return bench_inputs.epoch_rows(config["nsims"], config["simsteps"], config["sbatch"],
                                   config["msteps"], seed)


def jobs(config: dict, workload: dict, inp: dict, seed: int) -> Iterator[dict]:
    """Rollouts of `batch` test sims (every one in turn, in a seeded order):
    frame 0's velocity and the forces of the steps after it."""
    data, batch, steps = inp["data"], workload["batch"], workload["steps"]
    sims = bench_inputs.cycled(data["u"].shape[0], seed)
    while True:
        pick = [next(sims) for _ in range(batch)]
        yield {"u": data["u"][pick, 0], "v": data["v"][pick, 0],
               "fu": data["fu"][pick, :steps].transpose(0, 1).contiguous(),
               "fv": data["fv"][pick, :steps].transpose(0, 1).contiguous()}


class Program:
    """The port's Burgers net, flow, optimizer and train step, built as
    `burgers-train` and `burgers-apply` build them."""

    def __init__(self, config: dict, inp: dict, device):
        from solver_in_the_loop_torch.models.features import Normalization
        from solver_in_the_loop_torch.models.networks import build_model
        from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain
        from solver_in_the_loop_torch.train import trainer

        self.trainer = trainer
        net, st = config["net"], inp["stats"]
        self.model = build_model(net["arch"], in_channels=net["in_channels"],
                                 leaky_slope=net["leaky_slope"], conv="library")
        self.model.load_state_dict(inp["weights"], strict=True)
        self.model.to(device)
        self.domain = burgers_domain(config["res"], config["len"])
        self.flow = BurgersFlow(self.domain, advection=config["advect"],
                                max_shift=config["max_shift"])
        self.norm = Normalization.burgers(st["std.v"], st["std.u"], st["std.fv"], st["std.fu"],
                                          device)
        self.dt = config["dt"]
        self.cfg = trainer.SolTrainConfig(msteps=config["msteps"], lr=config["lr"], epochs=1,
                                          clip_grad=True, remat=True,
                                          remat_policy=config["remat_policy"])
        self.optimizer = trainer.make_optimizer(self.model, self.cfg)
        self.step = trainer.make_burgers_train_step(self.flow, self.model, self.optimizer,
                                                    self.cfg, dt=self.dt, use_force=True)
        self.data, self.device = inp["data"], device

    def train_step(self, batch_rows: np.ndarray, wgt=None):
        idx, _ = self.trainer.local_batch(batch_rows, None, None, self.device)
        return self.step(self.data, self.norm, idx, wgt)

    def rollout(self, job: dict, steps: int) -> Dict[str, torch.Tensor]:
        from solver_in_the_loop_torch.core.grids import StaggeredGrid
        from solver_in_the_loop_torch.train.rollout import burgers_rollout

        _, replay = burgers_rollout(self.flow, steps=steps, model=self.model, norm=self.norm,
                                    dt=self.dt)
        return replay(StaggeredGrid(job["u"], job["v"], self.domain), job["fu"][:steps],
                      job["fv"][:steps])


def reference(config: dict, inp: dict, device, tf32: bool = False) -> BurgersSol:
    return BurgersSol(config, inp["stats"], device, tf32)


def reference_rollout(sol: BurgersSol, params, job: dict, steps: int):
    return sol.rollout(params, job["u"], job["v"], job["fu"][:steps], job["fv"][:steps])


@torch.no_grad()
def judge_rollout(sol: BurgersSol, params, job: dict, frames: Dict[str, torch.Tensor]) -> dict:
    """Every step recomputed by the reference from the frame before it, all
    steps as one batch: the widest gap of the frames over the reference's
    largest velocity, and over its largest correction."""
    steps, batch = frames["u"].shape[:2]

    def before(key):
        return torch.cat([job[key][None], frames[key][:-1]]).reshape(
            (steps * batch,) + job[key].shape[1:])

    fu, fv = (job[k][:steps].reshape((steps * batch,) + job[k].shape[2:]) for k in ("fu", "fv"))
    u, v, (du, dv) = sol.corrected(before("u"), before("v"), fu, fv, params)
    gap = max(float((frames["u"].reshape(u.shape) - u).abs().max()),
              float((frames["v"].reshape(v.shape) - v).abs().max()))
    scale = max(float(u.abs().max()), float(v.abs().max()))
    corr = max(float(du.abs().max()), float(dv.abs().max()))
    return {"frame_gap": gap / max(scale, 1e-30), "corr_gap": gap / max(corr, 1e-30)}


def rollout_failed(frames: Dict[str, torch.Tensor], config: dict) -> torch.Tensor:
    """A frame not finite: a flag on the device, read without a synchronise."""
    return ~torch.stack([torch.isfinite(frames[k]).all() for k in ("u", "v")]).all()
