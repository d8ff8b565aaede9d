"""The `karman_gen` configuration on the CPU: the program's generator
rollout against the plain reference (reference/gen.py) at 128x64, where
`pressure_route` also takes multigrid; the check's control and faults
failing it; the cell's files; `mfu.gen`'s counts; the new readers on a
program without the new counters; and whole runs of the cell through the
harness at that size, from start frames made here in place of the frozen
256x128 ones."""

import json
import time

import numpy as np
import pytest
import torch

from silt_bench import harness
from silt_bench.faults import FAULTS
from silt_bench.reference import gen as ref_gen
from silt_bench.reference.net import tf32_round

CELL = "karman_gen.hires_b6"
CONFIG, WORKLOAD = harness.cell(CELL)
SYSTEM = harness.load_module("systems", "karman_gen")
RES, BATCH, STEPS = 64, 2, 5
CPU = torch.device("cpu")
NEW = ("host_reads_per_step.gen", "pressure_iters_per_step.gen", "mfu.gen")
# The program's solve stops at a relative residual of 1e-5 by its multigrid
# V-cycle, the reference's at 1e-7 by the FD preconditioner: the frames then
# part by the program's stopping error, 1.2e-5 of u's largest value at this
# size (5 steps, 2 Re); 5e-5 leaves four times that. Rounding every field to
# TF32 parts them by 4.5e-4 and a solve stopped at 1e-3 by 7e-4.
FRAME_TOL = 5e-5


def _start(seed: int, batch: int):
    """A seeded random perturbation of `initial_state` at 128x64."""
    from solver_in_the_loop_torch.physics.karman import initial_state, karman_domain

    g = torch.Generator().manual_seed(seed)
    d0, v0 = initial_state(karman_domain(RES), batch)
    return (d0.values + 0.1 * torch.rand(d0.values.shape, generator=g),
            v0.u + 0.2 * torch.randn(v0.u.shape, generator=g),
            v0.v + 0.2 * torch.randn(v0.v.shape, generator=g))


def _config(tol=1e-5):
    return dict(CONFIG, res=RES, pressure=dict(CONFIG["pressure"], tol=tol))


def _program_frames(tol=1e-5):
    d, u, v = _start(3, BATCH)
    job = {"d": d, "u": u, "v": v, "re": torch.tensor([160000.0, 5120000.0])}
    program = SYSTEM.Program(_config(tol), {}, CPU)
    assert program.flow.pressure_route(BATCH) == "multigrid"
    return job, program.rollout(job, STEPS)


def _gap(job, frames):
    ref = SYSTEM.reference(_config(), {}, CPU)
    return SYSTEM.judge_rollout(ref, {}, job, frames)["frame_gap"]


def test_program_rollout_matches_the_reference_at_128x64():
    job, frames = _program_frames()
    assert frames["cg_iters"].shape == (STEPS,) and int(frames["cg_iters"].min()) > 0
    assert _gap(job, frames) <= FRAME_TOL


def test_reference_rounded_to_tf32_fails_the_tolerance():
    job, _ = _program_frames()
    control = SYSTEM.reference(_config(), {}, CPU, tf32=True)
    frames = SYSTEM.reference_rollout(control, {}, job, STEPS)
    assert torch.equal(frames["u"], tf32_round(frames["u"]))
    assert _gap(job, frames) > 5 * FRAME_TOL


def test_a_loose_solve_fails_the_tolerance():
    job, frames = _program_frames(tol=1e-3)
    assert _gap(job, frames) > 5 * FRAME_TOL


def test_clamped_sample_takes_the_edge_value_outside():
    values = torch.arange(12.0).reshape(1, 3, 4)
    y = torch.tensor([[[-1.0, 2.0, 5.0, 1.5]]])
    x = torch.tensor([[[0.5, 3.0, -2.0, 9.0]]])
    got = ref_gen.clamped_sample(values, y, x)
    assert got.tolist() == [[[0.5, 11.0, 8.0, 9.0]]]


def test_the_frozen_start_frames_decode():
    frames = SYSTEM.start_frames()
    assert list(frames["frames"]) == [1000, 1250]
    assert list(frames["re"]) == [float(r) for r in CONFIG["re"]]
    shapes = {"dens": (256, 128), "u": (256, 129), "v": (257, 128)}
    for name, shape in shapes.items():
        assert frames[name].shape == (6, 2) + shape and np.isfinite(frames[name]).all()
    meta = json.loads((SYSTEM.DATA / f"{SYSTEM.START}.json").read_text())
    assert meta["route"] == "multigrid" and "karman-gen" in meta["command"]


def test_encode_decode_round_trip():
    import hashlib

    field = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(np.float32)
    field[0, 0, 0, 0] = -0.0
    digest = hashlib.sha256(field.tobytes()).hexdigest()
    back = SYSTEM.decode(SYSTEM.encode(field), field.shape, digest)
    assert back.tobytes() == field.tobytes()
    with pytest.raises(ValueError):
        SYSTEM.decode(SYSTEM.encode(field + 1), field.shape, digest)


def test_the_cell_files_parse_and_name_existing_readers():
    bench = harness.benchmark()
    (entry,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("karman_gen", "hires_b6", 1)
    (cfg,) = [c for c in bench["configs"] if c["name"] == "karman_gen"]
    assert json.loads((harness.ROOT / cfg["file"]).read_text())["reduced"] == cfg["reduced"]
    assert CONFIG["source_values"] == {"simsteps": 1500, "skipsteps": 999}
    assert (CONFIG["res"], CONFIG["batch"], len(CONFIG["re"])) == (128, 6, 6)
    assert WORKLOAD["kind"] == "gen" and WORKLOAD["batch"] == CONFIG["batch"]
    e2e = {e["name"] for e in harness.reported(bench["end_to_end"], CELL)}
    assert e2e == {"rollout_step_ms", "setup_s"}
    layer = {e["name"] for e in harness.reported(bench["per_layer"], CELL, e2e)}
    assert layer == set(NEW) | {"setup_import_s", "setup_warmup_s"}
    for name in layer:
        assert callable(harness.load_module("metrics", name).read)
    kind = harness.load_module("kinds", "gen")
    assert all(callable(getattr(kind, f)) for f in kind.__all__)


def test_mfu_counts_depend_on_the_configuration_alone():
    work = harness.load_module("metrics", "mfu.gen").step_work
    full = work(CONFIG, WORKLOAD)
    assert full == work(json.loads(json.dumps(CONFIG)), dict(WORKLOAD, steps=7, limits={}))
    assert full["bytes"] > 0 and full["bound_ms"] == pytest.approx(1e3 * full["bytes"] / 3.35e12)
    assert work(dict(CONFIG, res=64), WORKLOAD)["bytes"] < full["bytes"] / 3
    ctx = {"kind": "gen", "config": CONFIG, "workload": WORKLOAD, "unit_wall_s": 0.09,
           "counters": {}, "trace": {}}
    mfu = harness.load_module("metrics", "mfu.gen")
    assert mfu.read(ctx) == mfu.read(dict(ctx, counters={"pressure.iters": 50.0}))
    assert 0 < mfu.read(ctx) < 100


@pytest.mark.parametrize("name", NEW[:2])
def test_new_readers_return_none_without_the_new_counters(name):
    reader = harness.load_module("metrics", name)
    ctx = {"kind": "gen", "config": CONFIG, "workload": WORKLOAD, "unit_wall_s": 0.09,
           "profiled_units": 100, "counters": {"units": 100, "cg_iters": [12] * 100},
           "trace": {"busy_s": 1.0, "launches": 10, "groups": {}}}
    assert reader.read(ctx) is None
    assert reader.read(dict(ctx, kind="apply", counters={"pressure.iters": 3.0,
                                                        "pressure.host_reads": 4.0})) is None


# ------------------------------------------------ whole runs through the harness

SMALL = {"config": {"res": RES},
         "workload": {"steps": 3, "warmup_steps": 2, "checked_rollouts": 2}}


@pytest.fixture
def small_frames(monkeypatch):
    """Two start frames of the six Re at 128x64 in place of the frozen ones."""
    frames = [_start(seed, len(CONFIG["re"])) for seed in (5, 6)]
    made = {k: np.stack([f[i].numpy() for f in frames], axis=1)
            for i, k in enumerate(("dens", "u", "v"))}
    made.update(re=np.asarray(CONFIG["re"], np.float32), frames=np.asarray([1000, 1250]))
    monkeypatch.setattr(SYSTEM, "start_frames", lambda: made)


def _run(trace=False, **kwargs):
    overrides = kwargs.pop("overrides", SMALL)
    return harness.run_cell(CELL, 2**31 + 5, 0.3, trace, CPU, time.perf_counter(),
                            {"setup_import_s": 0.0}, overrides=overrides, **kwargs)[0]


def test_a_sound_traced_run_is_correct_and_reports_its_metrics(small_frames):
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    got = {k: m["value"] for k, m in line["metrics"].items()}
    assert set(got) == set(NEW) | {"setup_import_s", "setup_warmup_s"}
    # a host read a stop test: one more than the iterations, none at max_iter
    assert got["host_reads_per_step.gen"] == got["pressure_iters_per_step.gen"] + 1
    assert 0 < got["mfu.gen"] < 100


def test_an_untraced_run_reports_the_rollout_step(small_frames):
    line = _run()
    assert line["correct"] and set(line["metrics"]) == {"rollout_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["stale", "altered", "loose_solve"])
def test_a_planted_fault_is_not_correct(small_frames, fault):
    if fault == "loose_solve":
        from silt_bench.control_gen import LOOSE

        over = {"config": dict(SMALL["config"], **LOOSE["config"]),
                "workload": SMALL["workload"]}
        line = _run(overrides=over)
    else:
        line = _run(fault=FAULTS["apply"][fault])
    assert not line["correct"], line["checks"]


def test_the_control_is_not_correct(small_frames):
    line = _run(control=True)
    assert not line["correct"], line["checks"]
