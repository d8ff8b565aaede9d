"""The karman wake: its inputs, the program's train step and rollout, and
the reference's side of each check.

The program is driven through the calls its CLIs make: `karman-train`'s
(`make_karman_train_step`, fed by `local_batch` as `run_training` feeds
it) and `karman-apply`'s (`karman_rollout`). Its modules are imported
inside the functions, so that importing this file loads nothing of it.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from silt_bench import inputs as bench_inputs
from silt_bench.reference.sol import KarmanSol


def make_inputs(config: dict, kind: str, seed: int, device) -> dict:
    """The frozen set and checkpoint on `device` (the same for every seed);
    the seed orders what a run visits."""
    data = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in bench_inputs.karman_set().items()}
    return {"data": data, "weights": bench_inputs.checkpoint(config["checkpoint"],
                                                             config["net"]["blocks"]),
            "stats": bench_inputs.stats(config["checkpoint"])}


def rows(config: dict, seed: int) -> Iterator[np.ndarray]:
    return bench_inputs.epoch_rows(config["nsims"], config["simsteps"], config["sbatch"],
                                   config["msteps"], seed)


def jobs(config: dict, workload: dict, inp: dict, seed: int) -> Iterator[dict]:
    """Rollouts of `batch` elements: each a test Re (every one in turn, in a
    seeded order) from a developed-wake frame of the frozen set."""
    data, batch = inp["data"], workload["batch"]
    res = iter(bench_inputs.cycled(len(config["test_re"]), seed))
    rng = np.random.default_rng(bench_inputs.sub_seeds(seed, 2)[1])
    n_sims, n_frames = data["u"].shape[:2]
    while True:
        sims = rng.integers(n_sims, size=batch)
        frames = rng.integers(n_frames, size=batch)
        re = [float(config["test_re"][next(res)]) for _ in range(batch)]
        yield {"d": data["dens"][sims, frames], "u": data["u"][sims, frames],
               "v": data["v"][sims, frames], "re": torch.tensor(re, device=data["u"].device)}


class Program:
    """The port's karman net, flow, optimizer and train step, built as
    `karman-train` and `karman-apply` build them."""

    def __init__(self, config: dict, inp: dict, device):
        from solver_in_the_loop_torch.models.features import Normalization
        from solver_in_the_loop_torch.models.networks import build_model
        from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
        from solver_in_the_loop_torch.train import trainer

        self.trainer = trainer
        net, p, st = config["net"], config["pressure"], inp["stats"]
        self.model = build_model(net["arch"], in_channels=net["in_channels"],
                                 leaky_slope=net["leaky_slope"], conv="library")
        self.model.load_state_dict(inp["weights"], strict=True)
        self.model.to(device)
        self.domain = karman_domain(config["res"], config["len"])
        self.flow = KarmanFlow(self.domain, advection=config["advect"],
                               max_shift=config["max_shift"], pressure_tol=p["tol"],
                               pressure_max_iter=p["max_iter"], pressure_precon=p["precon"],
                               device=device)
        self.norm = Normalization.karman(st["std.v"], st["std.u"], st["ext.std"], device)
        self.cfg = trainer.SolTrainConfig(msteps=config["msteps"], lr=config["lr"], epochs=1,
                                          clip_grad=True, remat=True,
                                          remat_policy=config["remat_policy"])
        self.optimizer = trainer.make_optimizer(self.model, self.cfg)
        self.step = trainer.make_karman_train_step(self.flow, self.model, self.optimizer,
                                                   self.cfg)
        self.data, self.device = inp["data"], device

    def train_step(self, batch_rows: np.ndarray, wgt=None):
        """One iteration as `run_training` makes it: (loss, step losses, the
        forward solves' iterations, whether the update applied)."""
        idx, _ = self.trainer.local_batch(batch_rows, None, None, self.device)
        return self.step(self.data, self.norm, idx, wgt)

    def rollout(self, job: dict, steps: int) -> Dict[str, torch.Tensor]:
        from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
        from solver_in_the_loop_torch.train.rollout import karman_rollout

        return karman_rollout(self.flow, CenteredGrid(job["d"], self.domain),
                              StaggeredGrid(job["u"], job["v"], self.domain), job["re"],
                              steps=steps, model=self.model, norm=self.norm)


def reference(config: dict, inp: dict, device, tf32: bool = False) -> KarmanSol:
    return KarmanSol(config, inp["stats"], device, tf32)


def reference_rollout(sol: KarmanSol, params, job: dict, steps: int):
    return sol.rollout(params, job["d"], job["u"], job["v"], job["re"], steps)


@torch.no_grad()
def judge_rollout(sol: KarmanSol, params, job: dict, frames: Dict[str, torch.Tensor]) -> dict:
    """Every step of a rollout recomputed by the reference from the frame
    before it (the first from the job's start), all steps as one batch:
    the widest gap of the frames (density, u, v) and of the corrections,
    each over the reference's largest value of that field."""
    steps, batch = frames["u"].shape[:2]

    def before(key, start):
        return torch.cat([start[None], frames[key][:-1]]).reshape((steps * batch,)
                                                                  + start.shape[1:])

    d, u, v = before("dens", job["d"]), before("u", job["u"]), before("v", job["v"])
    re = job["re"].repeat(steps)
    d, u, v, _, _, (du, dv) = sol.corrected(d, u, v, re, params)
    ref = {"dens": d, "u": u, "v": v, "corr_u": du, "corr_v": dv}
    gaps = {k: float((frames[k].reshape(r.shape) - r).abs().max() / r.abs().max().clamp_min(1e-30))
            for k, r in ref.items()}
    return {"frame_gap": max(gaps["dens"], gaps["u"], gaps["v"]),
            "corr_gap": max(gaps["corr_u"], gaps["corr_v"])}


def rollout_failed(frames: Dict[str, torch.Tensor], config: dict) -> torch.Tensor:
    """A frame not finite, or a solve stopped at its iteration limit: a
    flag on the device, read without a synchronise."""
    bad = ~torch.stack([torch.isfinite(frames[k]).all() for k in ("dens", "u", "v")]).all()
    at_limit = frames["cg_iters"].max().to(bad.device) >= config["pressure"]["max_iter"]
    return bad | at_limit
