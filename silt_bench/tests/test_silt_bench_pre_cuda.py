"""On the card: the `karman_pre.gen` cell at small overrides (5-frame
rollouts, a 5 s window) through the harness comes out correct with its
metrics, and a PRE frame at (1, 256, 128) runs the route PERF.md names:
the fused FD-PCG kernel in its cluster layout for the hi-res step and the
projection, the fast layout for the 64x32 step. Skips without a card."""

import time

import pytest

from silt_bench import harness

CELL = "karman_pre.gen"
SMALL = {"workload": {"steps": 5}}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_at_small_overrides_is_correct_on_the_card(cuda_device, trace):
    line, _ = harness.run_cell(CELL, 2**31 + 25, 5.0, trace, cuda_device, time.perf_counter(),
                               {"setup_import_s": 0.0}, overrides=SMALL)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["device"]["platform"] == "gpu"
    got = {k: m["value"] for k, m in line["metrics"].items()}
    if not trace:
        assert {"rollout_step_ms", "setup_s"} <= set(got)
        return
    assert got["lsq_inner_iters_per_step.pre"] > 0 and got["lsq_ms_per_step.pre"] > 0
    assert got["lsq_host_reads_per_step.pre"] > got["lsq_inner_iters_per_step.pre"] / 8
    assert 0 < got["mfu.pre"] < 100


@pytest.mark.cuda
def test_a_frame_at_256x128_runs_the_cluster_layout(cuda_device):
    import torch

    from solver_in_the_loop_torch.kernels import cg

    config, workload = harness.cell(CELL)
    system = harness.load_module("systems", config["system"])
    inp = system.make_inputs(config, "pre", 3, cuda_device)
    program = system.Program(config, inp, cuda_device)
    assert program.pre.flow_hi.pressure_route(1) == "pcg"
    assert program.pre.flow_lo.pressure_route(1) == "pcg"
    job = next(system.jobs(config, workload, inp, 3))
    program.rollout(job, 1)
    before = (cg.pcg_cluster_solve.launches, cg.pcg_solve.launches)
    frames = program.rollout(job, 2)
    torch.cuda.synchronize(cuda_device)
    after = (cg.pcg_cluster_solve.launches, cg.pcg_solve.launches)
    # a frame: the hi-res step and the projection in the cluster layout, the
    # lo-res step in the fast one
    assert (after[0] - before[0], after[1] - before[1]) == (4, 2)
    assert int(frames["lsq_inner"].min()) > 0
