"""Rank functions of the port's multi-process tests, and the launcher that
runs them as a process group on the CPU.

`spawn(fn, world, *args)` starts `world` processes, sets in each the
environment that `python -m torch.distributed.run` sets (WORLD_SIZE, RANK,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a port free at the time), runs
`fn(*args)` in each and returns the ranks' results in rank order. The ranks
join the group over gloo through parallel/mesh.py `data_parallel_mesh`.

This module imports no JAX and nothing of the JAX package: a spawned rank
imports the module that defines its target, and the ranks run the port
alone. The JAX side of a comparison runs in the test's own process.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

# a rank that has not finished by then is stopped and the test fails
DEADLINE_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, out_dir, fn, args, env):
    torch.set_num_threads(1)
    os.environ.update(env)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    result = fn(*args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, *args, env=None):
    """Run `fn(*args)` on `world` ranks; returns their results by rank.
    `env` adds environment variables to every rank."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_entry, args=(world, free_port(), out_dir, fn, args, env or {}),
                       nprocs=world, join=False)
        deadline = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__} on {world} ranks ran past {DEADLINE_S} s")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def cli_rank(argv):
    """One rank of a `python -m solver_in_the_loop_torch` train command: its
    TrainResult's losses and the files this rank wrote, by kind."""
    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.apps import karman_train
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    writes = []

    def recorded(kind, fn):
        def call(*a, **kw):
            writes.append(kind)
            return fn(*a, **kw)
        return call

    class Writer(karman_train.MetricsWriter):
        def __init__(self, *a, **kw):
            writes.append("metrics")
            super().__init__(*a, tensorboard=False)

    ckpt.save_checkpoint = recorded("checkpoint", ckpt.save_checkpoint)
    ckpt.save_stats = recorded("stats", ckpt.save_stats)
    karman_train.MetricsWriter = Writer
    result = cli.main(argv)
    logs = [h.baseFilename for h in logging.getLogger().handlers
            if isinstance(h, logging.FileHandler)]
    return {"losses": result.losses, "notfinite": result.notfinite, "writes": writes,
            "log_files": logs}


def _flow_and_step(case, model, optimizer, cfg, device):
    from solver_in_the_loop_torch.physics import burgers, karman
    from solver_in_the_loop_torch.train import trainer

    if case["family"] == "karman":
        flow = karman.KarmanFlow(karman.karman_domain(case["res"]), advection="shift",
                                 max_shift=case["max_shift"], pressure_tol=case["ptol"],
                                 pressure_max_iter=case["pmaxiter"], device=device)
        return trainer.make_karman_train_step(flow, model, optimizer, cfg)
    flow = burgers.BurgersFlow(burgers.burgers_domain(case["res"]), advection="shift",
                               max_shift=case["max_shift"])
    return trainer.make_burgers_train_step(flow, model, optimizer, cfg, dt=case["dt"])


def dp_train_step_rank(case, device="cpu"):
    """One data-parallel train step of the port on this rank's rows of
    `case`'s batch (padded to case["pad_to"]), as `run_training` takes it,
    twice from the same parameters: without the clip, for the gradient
    summed over the ranks (what the optimizer was given), and with it, for
    the parameters after the update. Returns numpy results, and this rank's
    kernel launches (on the card; the CPU runs the kernels' twins)."""
    from solver_in_the_loop_torch.kernels import advect, cg
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.models.networks import build_model
    from solver_in_the_loop_torch.parallel import mesh as pmesh
    from solver_in_the_loop_torch.train import trainer
    from solver_in_the_loop_torch.train.checkpoint import params_from_jax

    mesh = pmesh.data_parallel_mesh(device)
    try:
        dev = mesh.device
        data = {k: torch.from_numpy(a).to(dev) for k, a in case["data"].items()}
        norm = Normalization(torch.tensor(case["norm"][0], device=dev),
                             torch.tensor(case["norm"][1], device=dev))
        out = {}
        for clip in (False, True):
            model = build_model("mars_moon", in_channels=case["in_channels"], leaky_slope=0.3)
            model.load_state_dict(params_from_jax(case["params"], "mars_moon", model))
            model.to(dev)
            cfg = trainer.SolTrainConfig(msteps=case["msteps"], lr=case["lr"], clip_grad=clip)
            optimizer = trainer.make_optimizer(model, cfg, mesh)
            step = _flow_and_step(case, model, optimizer, cfg, dev)
            idx, wgt = trainer.local_batch(case["idx"], mesh, case["pad_to"], dev)
            loss, step_losses, _, applied = step(data, norm, idx, wgt)
            loss, step_losses = pmesh.all_reduce_sum([loss, step_losses], mesh)
            tensors = {n: (p.detach() if clip else p.grad) for n, p in model.named_parameters()}
            out["update" if clip else "grad"] = {n: t.cpu().numpy().copy()
                                                 for n, t in tensors.items()}
            out["loss"], out["step_losses"] = float(loss), step_losses.cpu().numpy().copy()
            out["applied"] = applied
        out["rows"] = idx.cpu().numpy().copy()
        out["weights"] = None if wgt is None else wgt.cpu().numpy().copy()
        out["launches"] = {"tap_sum_fwd": advect.tap_sum_fwd.launches,
                           "tap_sum_bwd": advect.tap_sum_bwd.launches,
                           "pcg_solve": cg.pcg_solve.launches}
        return out
    finally:
        mesh.close()


def move_rows_rank(have, want, width):
    """Rows of a field of sum(have) rows, each rank's block of value
    1000*rank + row, moved to `want`; the gradient of sum(out * (row + 1))."""
    from solver_in_the_loop_torch.parallel import mesh as pmesh

    mesh = pmesh.data_parallel_mesh("cpu")
    try:
        lo, hi = have[mesh.rank]
        block = (1000.0 * mesh.rank + torch.arange(lo, hi, dtype=torch.float32))
        x = block[None, :, None].expand(2, hi - lo, width).contiguous().requires_grad_()
        out = pmesh.move_rows(x, have, want, mesh)
        w = torch.arange(want[mesh.rank][0], want[mesh.rank][1], dtype=torch.float32) + 1.0
        (out * w[None, :, None]).sum().backward()
        return out.detach().numpy(), x.grad.numpy()
    finally:
        mesh.close()


def numpy_tree(tree):
    """A nested dict of arrays as plain numpy (picklable without JAX)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def spatial_rank(cases, device="cpu"):
    """The y-sharded karman step (parallel/spatial.py) on this rank, for
    each case: {"kind": "project" | "step" | "grad" | "vcycle", "res",
    "advection", "ptol", "pmaxiter", "backend" (the JAX pressure_backend),
    "fields": (dens, u, v) numpy, "weights" for "grad", "rhs" for "vcycle"}.
    Returns per case the whole fields gathered from every rank (numpy), the
    largest |value| of this rank's padding rows of v, the solve's route,
    and, for "grad", the gradients of sum(w * outputs) in the inputs; for
    "vcycle" the sharded V-cycle of "rhs" gathered, and each sharded level's
    rows a rank. With `device` "cuda" every rank runs on cuda:0 and the
    tap-sum launches of each case are counted."""
    from solver_in_the_loop_torch.kernels import advect
    from solver_in_the_loop_torch.parallel import spatial
    from solver_in_the_loop_torch.physics import karman

    mesh = spatial.spatial_mesh(device)
    out = []
    try:
        for case in cases:
            dom = karman.karman_domain(case["res"])
            flow = karman.KarmanFlow(dom, advection=case["advection"], max_shift=2,
                                     pressure_tol=case["ptol"],
                                     pressure_max_iter=case["pmaxiter"], device=mesh.device)
            shard = spatial.YShardedKarman(flow, mesh, case["backend"])
            ny = dom.ny
            res = {"route": shard.pressure_route}
            if case["kind"] == "vcycle":
                b = torch.from_numpy(case["rhs"]).to(mesh.device)
                x = shard.v_cycle(b[:, spatial.y_sharding(mesh, ny)].contiguous())
                res["x"] = spatial.gather_y(mesh, x, ny)
                res["level_rows"] = [lv.blocks[0][1] for lv in shard.mg_levels]
                out.append({k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                            for k, v in res.items()})
                continue
            full = [torch.from_numpy(a).to(mesh.device) for a in case["fields"]]
            dens, u, v_pad = spatial.shard_staggered_y(mesh, *full)
            advect.tap_sum_fwd.launches = advect.tap_sum_bwd.launches = 0
            if case["kind"] == "project":
                u, v_pad, p, iters = shard.project(u, v_pad)
                res["p"] = spatial.gather_y(mesh, p, ny)
                res["iters"] = int(iters)
            else:
                if case["kind"] == "grad":
                    for t in (dens, u, v_pad):
                        t.requires_grad_()
                ins = (dens, u, v_pad)
                dens, u, v_pad = shard.step(*ins, torch.tensor([1.6e5], device=mesh.device))
                if case["kind"] == "grad":
                    w = [torch.from_numpy(a).to(mesh.device) for a in case["weights"]]
                    w_d, w_u, w_v = spatial.shard_staggered_y(mesh, *w)
                    loss = (w_d * dens).sum() + (w_u * u).sum() + (w_v * v_pad).sum()
                    loss.backward()
                    res["grads"] = [spatial.gather_y(mesh, t.grad, n).cpu().numpy()
                                    for t, n in zip(ins, (ny, ny, ny + 1))]
                res["dens"] = spatial.gather_y(mesh, dens.detach(), ny)
            res["u"] = spatial.gather_y(mesh, u.detach(), ny)
            res["v"] = spatial.gather_y(mesh, v_pad.detach(), ny + 1)
            lo, hi = shard.padded[mesh.rank]
            tail = v_pad.detach()[:, hi - lo:]
            res["padding_max"] = float(tail.abs().max()) if tail.numel() else 0.0
            res["v_rows"] = int(v_pad.shape[1])
            res["tap_sum_launches"] = (advect.tap_sum_fwd.launches, advect.tap_sum_bwd.launches)
            out.append({k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                        for k, v in res.items()})
        return out
    finally:
        mesh.close()
