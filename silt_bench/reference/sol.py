"""Plain reference of what the benchmark's cells run: the corrected solver
step (solver, features, net, correction), the unrolled training loss, the
per-tensor gradient clip and Adam, and rollouts.

`KarmanSol` and `BurgersSol` share one interface:

* `corrected(state, params)` -> (next state, correction), one step of a
  batch of states; a karman state is (d, u, v, re, pressure history), a
  Burgers state (u, v, fu, fv);
* `unroll_loss(params, data, idx, msteps)` -> (loss, step losses), the
  loss of one training batch (idx (B, 2) rows of (sim, frame0));
* `rollout(params, start, steps, forces)` -> frames, sequentially.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from silt_bench.reference.fluid import Burgers, Karman, warm_start
from silt_bench.reference.net import collocated, correction, mars_moon

# optax's float32 b1, b2, eps, as the program's Adam is given them
ADAM_B1, ADAM_B2, ADAM_EPS = 0.8999999761581421, 0.9990000128746033, 9.99999993922529e-09


def l2_rows(diff):
    """0.5 sum(x^2) over each batch row."""
    return 0.5 * torch.sum(diff * diff, dim=(1, 2))


class KarmanSol:
    def __init__(self, config: dict, stats: dict, device, tf32: bool = False):
        net = config["net"]
        self.blocks, self.slope, self.tf32 = net["blocks"], net["leaky_slope"], tf32
        p = config["pressure"]
        self.flow = Karman(config["res"], config["len"], config["max_shift"], p["tol"],
                           p["max_iter"], device, tf32)
        self.in_scales = torch.tensor([stats["std.v"], stats["std.u"], stats["ext.std"]],
                                      device=device)
        self.out_scales = torch.tensor([stats["std.v"], stats["std.u"]], device=device)

    def net(self, u, v, re, params):
        vu = collocated(u, v)
        re_c = re.reshape(-1, 1, 1, 1).expand(vu.shape[:3] + (1,))
        feat = torch.cat([vu, re_c], dim=-1) / self.in_scales
        return correction(mars_moon(feat, params, self.blocks, self.slope, self.tf32),
                          self.out_scales)

    def corrected(self, d, u, v, re, params, x0=None):
        """(d, u, v, p, iterations, (du, dv)) of one corrected step."""
        d, u, v, p, it = self.flow.step(d, u, v, re, x0)
        du, dv = self.net(u, v, re, params)
        return d, u + du, v + dv, p, it, (du, dv)

    def unroll_loss(self, params, data, idx, msteps: int):
        sim, frame0 = idx[:, 0], idx[:, 1]
        d, u, v = data["dens"][sim, frame0], data["u"][sim, frame0], data["v"][sim, frame0]
        re = data["re"][sim]
        history, losses = [], []
        std_v, std_u = self.out_scales[0], self.out_scales[1]
        for k in range(msteps):
            d, u, v, p, _, _ = self.corrected(d, u, v, re, params, warm_start(history))
            history = (history + [p.detach()])[-3:]
            gt_u, gt_v = data["u"][sim, frame0 + k + 1], data["v"][sim, frame0 + k + 1]
            losses.append(torch.sum(l2_rows((gt_v - v) / std_v) + l2_rows((gt_u - u) / std_u)))
        losses = torch.stack(losses)
        return losses.sum() / msteps, losses

    @torch.no_grad()
    def rollout(self, params, d, u, v, re, steps: int):
        """Frames 1..steps of a corrected rollout: dens, u, v, corr_u,
        corr_v and the solves' iterations, stacked (T, B, ...)."""
        out = {k: [] for k in ("dens", "u", "v", "corr_u", "corr_v")}
        history, iters = [], []
        for _ in range(steps):
            d, u, v, p, it, (du, dv) = self.corrected(d, u, v, re, params, warm_start(history))
            history = (history + [p])[-3:]
            iters.append(it)
            for key, val in zip(out, (d, u, v, du, dv)):
                out[key].append(val)
        frames = {k: torch.stack(vals) for k, vals in out.items()}
        frames["cg_iters"] = torch.tensor(iters)
        return frames


class BurgersSol:
    def __init__(self, config: dict, stats: dict, device, tf32: bool = False):
        net = config["net"]
        self.blocks, self.slope, self.tf32 = net["blocks"], net["leaky_slope"], tf32
        self.flow = Burgers(config["res"], config["len"], config["max_shift"])
        self.dt = config["dt"]
        self.in_scales = torch.tensor([stats["std.v"], stats["std.u"], stats["std.fv"],
                                       stats["std.fu"]], device=device)
        self.out_scales = torch.tensor([stats["std.v"], stats["std.u"]], device=device)

    def corrected(self, u, v, fu, fv, params):
        """(u, v, (du, dv)) of one corrected step under the force (fu, fv)."""
        u, v = self.flow.step(u, v, fu, fv, self.dt)
        feat = torch.cat([collocated(u, v), collocated(fu, fv)], dim=-1) / self.in_scales
        du, dv = correction(mars_moon(feat, params, self.blocks, self.slope, self.tf32),
                            self.out_scales)
        return u + du, v + dv, (du, dv)

    def unroll_loss(self, params, data, idx, msteps: int):
        sim, frame0 = idx[:, 0], idx[:, 1]
        u, v = data["u"][sim, frame0], data["v"][sim, frame0]
        losses = []
        std_v, std_u = self.out_scales[0], self.out_scales[1]
        for k in range(msteps):
            u, v, _ = self.corrected(u, v, data["fu"][sim, frame0 + k],
                                     data["fv"][sim, frame0 + k], params)
            gt_u, gt_v = data["u"][sim, frame0 + k + 1], data["v"][sim, frame0 + k + 1]
            losses.append(torch.sum(l2_rows((gt_v - v) / std_v) + l2_rows((gt_u - u) / std_u)))
        losses = torch.stack(losses)
        return losses.sum() / msteps, losses

    @torch.no_grad()
    def rollout(self, params, u, v, fu, fv):
        """Frames 1..T of a corrected rollout under the forces fu (T, B, ...)."""
        us, vs = [], []
        for t in range(fu.shape[0]):
            u, v, _ = self.corrected(u, v, fu[t], fv[t], params)
            us.append(u)
            vs.append(v)
        return {"u": torch.stack(us), "v": torch.stack(vs)}


def train_iterations(sol, params0: Dict[str, torch.Tensor], data, batches: List[torch.Tensor],
                     msteps: int, lr: float, clip_norm: float):
    """Training iterations from params0, one per batch: the unrolled loss,
    its gradient, the per-tensor clip to `clip_norm`, and Adam, skipped
    where a gradient is not finite. Returns the losses, the step losses,
    the first iteration's gradients as Adam gets them (clipped) and as
    the loss gives them, and the parameters after the last iteration."""
    params = {k: t.detach().clone().requires_grad_(True) for k, t in params0.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    s = {k: torch.zeros_like(t) for k, t in params.items()}
    count, losses, step_losses, first, first_raw = 0, [], [], None, None
    for batch in batches:
        loss, steps = sol.unroll_loss(params, data, batch, msteps)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        step_losses.append(steps.detach())
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            continue
        raw = grads
        grads = {k: g * min(1.0, clip_norm / max(float(g.norm()), 1e-20))
                 for k, g in grads.items()}
        if first is None:
            first, first_raw = grads, raw
        count += 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = ADAM_B1 * m[k] + (1 - ADAM_B1) * g
                s[k] = ADAM_B2 * s[k] + (1 - ADAM_B2) * g * g
                m_hat = m[k] / (1 - ADAM_B1 ** count)
                s_hat = s[k] / (1 - ADAM_B2 ** count)
                params[k] -= lr * m_hat / (torch.sqrt(s_hat) + ADAM_EPS)
    return {"losses": losses, "step_losses": step_losses, "first_grads": first,
            "first_raw_grads": first_raw, "params": {k: t.detach() for k, t in params.items()}}


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each leaf's gap of norms, | |a| - |b| |, over the reference's norm of
    that leaf or of the median leaf, whichever is larger; for the leaves
    `keep` names (inf where a norm is not finite)."""
    ref_norms = {k: float(t.norm()) for k, t in reference.items()}
    median = sorted(ref_norms.values())[len(ref_norms) // 2]
    out = {}
    for k in keep:
        gap = abs(float(program[k].norm()) - ref_norms[k])
        out[k] = gap / max(ref_norms[k], median, 1e-30) if math.isfinite(gap) else math.inf
    return out


def leaf_gap(program, reference, keep) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(program, reference, keep).values(), default=0.0)


def moving_leaves(first_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: a leaf below that (a bias under softmax) moves by round-off."""
    norms = {k: float(g.norm()) for k, g in first_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
