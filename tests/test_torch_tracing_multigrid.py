"""The pressure solve's host reads and the multigrid V-cycles as the port's
spans and counters (utils/profiling.py), beside tests/test_torch_tracing.py.

* A recorded multigrid solve (ops/poisson.py's route at 128x64 on the CPU)
  counts one `pressure.host_reads` per stop test, its iterations plus one
  (its iterations where it stops at max_iter), and `multigrid.vcycles`
  equal to its preconditioner applies, each a `silt.pressure.vcycle` span
  inside the solve's `silt.pressure`.
* Off (no recording, no profiler) nothing is counted and the solve is the
  same to the bit.
* On the CPU the V-cycle runs eagerly: a recorded solve and its adjoint
  count no graph replay and no capture, and the hierarchy holds no graph
  (on the card every V-cycle is a replay: tests/test_torch_cuda.py); they
  run the plain `_v_cycle` and count no V-cycle of the kernels
  (`multigrid.kernel_cycles` 0; on the card all of them).
* On the card the fused routes (csrc/pcg.cu, csrc/cg.cu and the cluster
  layout) count no host read and no V-cycle; this file imports nothing of
  JAX, so the card runs it with `--noconftest`.
"""

from __future__ import annotations

import pytest
import torch

from solver_in_the_loop_torch.kernels import vcycle
from solver_in_the_loop_torch.ops import multigrid
from solver_in_the_loop_torch.ops.poisson import pressure_route, solve_pressure
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.utils import profiling

torch.set_num_threads(1)

RES, BATCH = 64, 2


def _problem(res=RES, batch=BATCH, device="cpu", seed=4):
    flow = KarmanFlow(karman_domain(res), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch,) + flow.domain.resolution
    div = torch.randn(shape, generator=g, device=device) * flow.masks.fluid
    return div, flow.masks


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s[0] == name]


@pytest.mark.parametrize("max_iter", [1000, 3])
def test_a_recorded_multigrid_solve_counts_its_reads_and_vcycles(monkeypatch, max_iter):
    div, masks = _problem()
    assert pressure_route(div.shape, div.device) == "multigrid"
    applies = []
    real = multigrid.v_cycle

    def counted(h, b, level=0):
        applies.append(level)
        return real(h, b, level)

    monkeypatch.setattr(multigrid, "v_cycle", counted)
    with profiling.recording() as rec:
        _, iters = solve_pressure(div, masks, max_iter=max_iter)
    got = rec.read()
    iters = int(iters)
    stopped = iters == max_iter
    assert 0 < iters <= max_iter and stopped == (max_iter == 3)
    counters = got["counters"]
    assert counters["pressure.iters"] == [iters]
    assert counters["pressure.host_reads"] == [1] * (iters if stopped else iters + 1)
    assert counters["multigrid.vcycles"] == [len(applies)] == [iters + 1]
    spans = got["spans"]
    (solve,) = _named(spans, "silt.pressure")
    cycles = _named(spans, "silt.pressure.vcycle")
    assert len(cycles) == len(applies) and all(spans[i][3] == solve for i in cycles)


def test_nothing_is_counted_without_a_recording():
    div, masks = _problem()
    assert profiling.span("silt.pressure.vcycle") is profiling.span("silt.solver")
    off = solve_pressure(div, masks)
    assert profiling._recording is None
    with profiling.recording() as rec:
        on = solve_pressure(div, masks)
    assert torch.equal(off[0], on[0]) and int(off[1]) == int(on[1])
    assert len(rec.read()["counters"]["pressure.host_reads"]) == int(on[1]) + 1


def test_a_recorded_cpu_solve_replays_no_graph():
    div, masks = _problem(seed=5)
    div.requires_grad_()
    with profiling.recording() as rec:
        p, iters = solve_pressure(div, masks)
        p.sum().backward()
    counters = rec.read()["counters"]
    vcycles = counters["multigrid.vcycles"]
    assert len(vcycles) == 2 and vcycles[0] == int(iters) + 1 and vcycles[1] > 0
    assert counters["multigrid.graph_replays"] == counters["multigrid.graph_captures"] == [0, 0]
    h = multigrid.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)
    assert h.graphs == {} and multigrid.graphed_cycle(h, div) == (None, 0)


def test_a_cpu_solve_runs_the_plain_cycle_and_no_kernel(monkeypatch):
    div, masks = _problem(seed=6)
    div.requires_grad_()

    def refuse(h, b):
        raise AssertionError("the V-cycle kernels ran on the CPU")

    plain = []
    real = multigrid._v_cycle

    def counted(h, b, level):
        plain.append(level)
        return real(h, b, level)

    monkeypatch.setattr(vcycle, "v_cycle", refuse)
    monkeypatch.setattr(multigrid, "_v_cycle", counted)
    with profiling.recording() as rec:
        p, _ = solve_pressure(div, masks)
        p.sum().backward()
    counters = rec.read()["counters"]
    assert counters["multigrid.kernel_cycles"] == [0, 0]
    assert sum(counters["multigrid.vcycles"]) == plain.count(0) > 0
    assert torch.isfinite(div.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("res,batch,precon", [(32, 1, "fd"), (32, 3, "none"), (128, 1, "fd"),
                                              (128, 3, "none")])
def test_the_fused_routes_count_no_host_read(res, batch, precon):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused (P)CG kernels have no CPU mode")
    device = torch.device("cuda", 0)
    div, masks = _problem(res, batch, device)
    assert pressure_route(div.shape, device, precon=precon) == ("pcg" if precon == "fd" else "cg")
    with profiling.recording() as rec:
        solve_pressure(div, masks, precon=precon)
    counters = rec.read()["counters"]
    assert counters["pressure.iters"][0] > 0
    assert "pressure.host_reads" not in counters and "multigrid.vcycles" not in counters
