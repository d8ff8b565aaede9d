"""On the card: the `karman_gen.hires_b6` cell at small overrides (10-step
rollouts, a 5 s window) through the harness comes out correct with its
metrics, and a traced rollout of its program runs the multigrid route:
`silt.pressure.vcycle` spans and no fused (P)CG launch. Skips without a
card."""

import time

import pytest

from silt_bench import harness

CELL = "karman_gen.hires_b6"
SMALL = {"workload": {"steps": 10}}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_at_small_overrides_is_correct_on_the_card(cuda_device, trace):
    line, _ = harness.run_cell(CELL, 2**31 + 21, 5.0, trace, cuda_device, time.perf_counter(),
                               {"setup_import_s": 0.0}, overrides=SMALL)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["device"]["platform"] == "gpu"
    got = {k: m["value"] for k, m in line["metrics"].items()}
    if not trace:
        assert {"rollout_step_ms", "setup_s"} <= set(got)
        return
    assert got["host_reads_per_step.gen"] == got["pressure_iters_per_step.gen"] + 1
    assert 0 < got["mfu.gen"] < 100


@pytest.mark.cuda
def test_a_traced_rollout_runs_the_multigrid_route(cuda_device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    config, workload = harness.cell(CELL)
    system = harness.load_module("systems", config["system"])
    inp = system.make_inputs(config, "gen", 3, cuda_device)
    program = system.Program(config, inp, cuda_device)
    job = next(system.jobs(config, workload, inp, 3))
    assert program.flow.pressure_route(workload["batch"]) == "multigrid"
    program.rollout(job, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        program.rollout(job, 2)
        torch.cuda.synchronize(cuda_device)
    names = [e.key for e in prof.key_averages()]
    assert "silt.pressure.vcycle" in names
    assert not [n for n in names if "pcg_kernel" in n or "cg_kernel" in n]
