"""The `karman_pre` configuration on the CPU at -r 8 (lo-res 16x8, hi-res
64x32): the plain reference's geometry, upsample and interpolation against
the program's; the program's correction solve against the reference's
direct float64 solve of its KKT system; program frames against the
reference; the cell's files and readers; and whole runs of the cell
through the harness at that size, from starts made here in place of the
frozen 64x32 / 256x128 ones, with the check's control and faults
failing it."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from silt_bench import harness
from silt_bench.faults import FAULTS
from silt_bench.reference import pre as ref_pre
from silt_bench.reference.net import tf32_round

from solver_in_the_loop_torch.core.resample import (
    downsample_centered,
    downsample_staggered,
    upsample_staggered,
)
from solver_in_the_loop_torch.physics.karman import initial_state, karman_domain
from solver_in_the_loop_torch.pre import lsq

torch.set_num_threads(2)

CELL = "karman_pre.gen"
CONFIG, WORKLOAD = harness.cell(CELL)
SYSTEM = harness.load_module("systems", "karman_pre")
RES, SCALE = 8, 4
CPU = torch.device("cpu")
NEW = ("lsq_ms_per_step.pre", "lsq_inner_iters_per_step.pre", "lsq_host_reads_per_step.pre",
       "mfu.pre")
# single operators, a float32 rounding or two apart
OP_TOL = 1e-6
# The program's correction stops its projected CG at r.z below 1e-8 of the
# cold r.z (tol 1e-4) with projections exact to their inner CG's 1e-4; on
# smooth seeded fields at this size it lies 3.6e-4 to 6.6e-4 of the largest
# value off the direct solve (beta 1 and 0, seeds 0-2; on random fields the
# JAX package's solve lies up to 1.8e-3 off, tests/test_torch_pre_lsq.py):
# 1.5e-3 leaves more than twice that.
KKT_TOL = 1.5e-3
# Frames recomputed by the reference from the program's frame before: the
# steps' solves stop at 1e-5 (the program) and 1e-7 (the reference), the
# correction as above. Measured at this size over 1 and 3 frames of three
# starts: frame_gap 5.7e-5 to 8.3e-5, corr_gap 1.0e-4 to 1.4e-4; the
# tolerances leave twice that. The reference rounded to TF32 reads 5.9e-4
# to 8.7e-4 and 7.3e-4 to 9.7e-4.
FRAME_TOL, CORR_TOL = 2e-4, 3e-4


def _geometries():
    return lsq.build_pre_geometry(karman_domain(RES), karman_domain(RES * SCALE), SCALE, bnd=2)


def _smooth(shape, g):
    """A seeded smooth field: a coarse random field upsampled 4x."""
    coarse = torch.randn((1, shape[1] // 4 + 2, shape[2] // 4 + 2), generator=g,
                         dtype=torch.float64)
    fine = torch.nn.functional.interpolate(coarse[None], scale_factor=4, mode="bilinear",
                                           align_corners=False)[0]
    return fine[:, :shape[1], :shape[2]].float().contiguous()


def test_the_reference_geometry_is_the_programs():
    geom = _geometries()
    fu, fv, cells = ref_pre.face_masks(2 * RES, RES, ref_pre.BND)
    hfu, hfv, _ = ref_pre.face_masks(2 * RES * SCALE, RES * SCALE, ref_pre.BND * SCALE)
    for got, want in ((fu, geom.lo_fu), (fv, geom.lo_fv), (cells, geom.lo_cells),
                      (hfu, geom.hi_fu), (hfv, geom.hi_fv)):
        np.testing.assert_array_equal(got, want[0])


def test_the_reference_upsample_is_the_programs():
    g = torch.Generator().manual_seed(0)
    u, v = torch.randn(2, 2 * RES, RES + 1, generator=g), torch.randn(2, 2 * RES + 1, RES,
                                                                         generator=g)
    for got, want in zip(ref_pre.upsample_staggered(u, v, SCALE), upsample_staggered(u, v, SCALE)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= OP_TOL * float(want.abs().max())


def test_the_reference_interpolation_transpose_is_the_programs():
    geom = _geometries()
    masks, _, wt, _, _ = lsq._operators(geom, CPU)
    ref = ref_pre.correction(RES, SCALE, 1.0, CPU)
    g = torch.Generator().manual_seed(1)
    hu, hv = torch.randn(geom.hi_fu.shape, generator=g), torch.randn(geom.hi_fv.shape, generator=g)
    with torch.no_grad():
        want = wt({"u": hu * masks["hi_fu"], "v": hv * masks["hi_fv"]})
    want = torch.cat([want["u"].reshape(1, -1), want["v"].reshape(1, -1)], 1)[:, ref.lo_valid]
    got = ref.apply_wt(torch.cat([hu.reshape(1, -1), hv.reshape(1, -1)], 1).double())
    assert float((got - want.double()).abs().max()) <= OP_TOL * float(want.abs().max())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_solve_correction_matches_the_direct_kkt_solve(seed, beta):
    """The program's correction at its defaults against the reference's
    direct float64 solve (see KKT_TOL), warm-started from a previous
    correction; the direct solve meets its constraint to float64 rounding."""
    geom = _geometries()
    g = torch.Generator().manual_seed(seed)
    hu, hv = _smooth(geom.hi_fu.shape, g), _smooth(geom.hi_fv.shape, g)
    pu, pv = 0.3 * _smooth(geom.lo_fu.shape, g), 0.3 * _smooth(geom.lo_fv.shape, g)
    with torch.no_grad():
        cu, cv, its = lsq.solve_correction(geom, hu, hv, pu, pv, beta=beta)
    ref = ref_pre.correction(RES, SCALE, beta, CPU)
    ku, kv = ref.solve(hu, hv, pu, pv)
    scale = max(float(ku.abs().max()), float(kv.abs().max()))
    assert scale > 1e-3 and int(its["outer"]) > 0 and int(its["inner"]) > 0
    gap = max(float((cu - ku).abs().max()), float((cv - kv).abs().max())) / scale
    assert gap <= KKT_TOL
    div = lsq.make_apply_gt(geom)({"u": ku, "v": kv}) * torch.as_tensor(geom.lo_cells)
    assert float(div.abs().max()) <= 1e-6 * scale


# ------------------------------------------------------------ program frames

def _start(seed: int) -> dict:
    """A seeded perturbation of `initial_state` at the hi resolution, the
    lo-res state its 4x downsample, the correction zero; (1, ...) each."""
    g = torch.Generator().manual_seed(seed)
    d, v = initial_state(karman_domain(RES * SCALE), 1)
    dh = d.values + 0.1 * torch.rand(d.values.shape, generator=g)
    uh = v.u + 0.2 * torch.randn(v.u.shape, generator=g)
    vh = v.v + 0.2 * torch.randn(v.v.shape, generator=g)
    lu, lv = downsample_staggered(uh, vh, SCALE)
    return {"dens_hi": dh, "u_hi": uh, "v_hi": vh, "dens": downsample_centered(dh, SCALE),
            "u": lu, "v": lv, "corr_u": torch.zeros_like(lu), "corr_v": torch.zeros_like(lv)}


def _config():
    return dict(CONFIG, res=RES)


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("seed", [5, 6])
def test_program_frames_match_the_reference(seed, frames):
    job = dict(_start(seed), re=1280000.0)
    frames_out = SYSTEM.Program(_config(), {}, CPU).rollout(job, frames)
    assert frames_out["u"].shape == (frames, 1, 2 * RES, RES + 1)
    assert frames_out["lsq_outer"].shape == (frames,) and int(frames_out["lsq_inner"].min()) > 0
    ref = SYSTEM.reference(_config(), {}, CPU)
    got = SYSTEM.judge_rollout(ref, {}, job, frames_out)
    assert got["frame_gap"] <= FRAME_TOL and got["corr_gap"] <= CORR_TOL, got
    assert not bool(SYSTEM.rollout_failed(frames_out, _config()))


def test_the_reference_rounded_to_tf32_fails_the_tolerances():
    job = dict(_start(5), re=1280000.0)
    control = SYSTEM.reference(_config(), {}, CPU, tf32=True)
    frames = SYSTEM.reference_rollout(control, {}, job, 3)
    assert torch.equal(frames["corr_u"], tf32_round(frames["corr_u"]))
    got = SYSTEM.judge_rollout(SYSTEM.reference(_config(), {}, CPU), {}, job, frames)
    assert got["frame_gap"] > 2 * FRAME_TOL or got["corr_gap"] > 2 * CORR_TOL, got


# ------------------------------------------------------------ the cell's files

def test_the_cell_files_parse_and_name_existing_readers():
    bench = harness.benchmark()
    (entry,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("karman_pre", "gen", 1)
    assert len(entry["why"]) <= 200
    (cfg,) = [c for c in bench["configs"] if c["name"] == "karman_pre"]
    assert json.loads((harness.ROOT / cfg["file"]).read_text())["reduced"] == cfg["reduced"]
    assert CONFIG["source_values"] == {"simsteps": 1500, "skipsteps": 999}
    assert (CONFIG["res"], CONFIG["scale"], CONFIG["beta"], CONFIG["batch"]) == (32, 4, 1.0, 1)
    assert CONFIG["re"] == [160000 * 2 ** i for i in range(6)]
    assert (CONFIG["lsq"]["tol"], CONFIG["pressure"]["tol"]) == (1e-4, 1e-5)
    assert WORKLOAD["kind"] == "pre" and WORKLOAD["batch"] == CONFIG["batch"]
    assert (WORKLOAD["steps"], WORKLOAD["warmup_steps"], WORKLOAD["profile_rollouts"],
            WORKLOAD["checked_rollouts"]) == (25, 2, 1, 2)
    e2e = {e["name"] for e in harness.reported(bench["end_to_end"], CELL)}
    assert e2e == {"rollout_step_ms", "setup_s"}
    layer = {e["name"] for e in harness.reported(bench["per_layer"], CELL, e2e)}
    assert layer == set(NEW) | {"setup_import_s", "setup_warmup_s"}
    for name in layer:
        assert callable(harness.load_module("metrics", name).read)
    kind = harness.load_module("kinds", "pre")
    assert all(callable(getattr(kind, f)) for f in kind.__all__)


def test_the_frozen_starts_decode():
    frames = SYSTEM.start_frames()
    meta = json.loads((SYSTEM.DATA / f"{SYSTEM.START}.json").read_text())
    n = len(meta["re"])
    assert n == 12 and sorted(set(meta["frames"])) == [1000, 1250]
    assert sorted(set(frames["re"].tolist())) == [float(r) for r in CONFIG["re"]]
    shapes = {"dens_hi": (256, 128), "u_hi": (256, 129), "v_hi": (257, 128), "dens": (64, 32),
              "u": (64, 33), "v": (65, 32), "corr_u": (64, 33), "corr_v": (65, 32)}
    for name, shape in shapes.items():
        assert frames[name].shape == (n, 1) + shape and np.isfinite(frames[name]).all()
    assert meta["routes"]["hi"] == "pcg" and "pre_start" in meta["command"]
    assert all(s["frames_run"] <= 100 for s in meta["starts"])


def test_mfu_counts_depend_on_the_configuration_alone():
    mfu = harness.load_module("metrics", "mfu.pre")
    full = mfu.frame_work(CONFIG, WORKLOAD)
    assert full == mfu.frame_work(json.loads(json.dumps(CONFIG)), dict(WORKLOAD, steps=7))
    gen = harness.load_module("metrics", "mfu.gen").step_work
    hi = gen(dict(CONFIG, res=128), WORKLOAD)
    assert hi["bytes"] < full["bytes"] < 3 * hi["bytes"]
    assert full["bound_ms"] == pytest.approx(1e3 * full["bytes"] / 3.35e12)
    ctx = {"kind": "pre", "config": CONFIG, "workload": WORKLOAD, "unit_wall_s": 0.45,
           "counters": {}, "trace": {}}
    assert mfu.read(ctx) == mfu.read(dict(ctx, counters={"pre.lsq_inner_iters": 400.0}))
    assert 0 < mfu.read(ctx) < 0.01


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_return_none_on_other_kinds_and_without_their_numbers(name):
    reader = harness.load_module("metrics", name)
    counters = {"units": 25, "pre.lsq_ms": 400.0, "pre.lsq_inner_iters": 400.0,
                "pre.lsq_host_reads": 60.0}
    ctx = {"kind": "gen", "config": CONFIG, "workload": WORKLOAD, "unit_wall_s": 0.45,
           "profiled_units": 25, "counters": counters,
           "trace": {"busy_s": 1.0, "launches": 10, "groups": {}}}
    for kind in ("gen", "apply", "train"):
        assert reader.read(dict(ctx, kind=kind)) is None
    if name != "mfu.pre":
        assert reader.read(dict(ctx, kind="pre", counters={"units": 25})) is None
        assert reader.read(dict(ctx, kind="pre")) > 0


# ------------------------------------------------ whole runs through the harness

# the cell at -r 8 from perturbed starts, held to this size's tolerances
SMALL = {"config": {"res": RES},
         "workload": {"steps": 3, "warmup_steps": 2, "checked_rollouts": 2,
                      "limits": {"frame_gap": FRAME_TOL, "corr_gap": CORR_TOL}}}


@pytest.fixture
def small_starts(monkeypatch):
    """Three starts at -r 8 in place of the frozen ones."""
    starts = [_start(seed) for seed in (5, 6, 7)]
    made = {k: np.stack([s[k].numpy() for s in starts]) for k in SYSTEM.FIELDS}
    made.update(re=np.asarray([160000.0, 1280000.0, 5120000.0], np.float32),
                frames=np.asarray([1000, 1250, 1000]))
    monkeypatch.setattr(SYSTEM, "start_frames", lambda: made)


def _run(trace=False, **kwargs):
    return harness.run_cell(CELL, 2**31 + 5, 0.3, trace, CPU, time.perf_counter(),
                            {"setup_import_s": 0.0}, overrides=SMALL, **kwargs)[0]


def test_a_sound_traced_run_is_correct_and_reports_its_metrics(small_starts):
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    got = {k: m["value"] for k, m in line["metrics"].items()}
    assert set(got) == set(NEW) | {"setup_import_s", "setup_warmup_s"}
    # a read a PPCG iteration and one to leave it, and one every CHECK_EVERY
    # iterations of each inner solve
    assert got["lsq_host_reads_per_step.pre"] > got["lsq_inner_iters_per_step.pre"] / 8
    assert got["lsq_ms_per_step.pre"] > 0 and 0 < got["mfu.pre"] < 100


def test_an_untraced_run_reports_the_rollout_step(small_starts):
    line = _run()
    assert line["correct"] and set(line["metrics"]) == {"rollout_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["stale", "altered", "loose_lsq"])
def test_a_planted_fault_is_not_correct(small_starts, fault):
    if fault == "loose_lsq":
        from silt_bench.control_pre import loose_lsq

        with loose_lsq():
            line = _run()
    else:
        line = _run(fault=FAULTS["apply"][fault])
    assert not line["correct"], line["checks"]


def test_the_control_is_not_correct(small_starts):
    line = _run(control=True)
    assert not line["correct"], line["checks"]
