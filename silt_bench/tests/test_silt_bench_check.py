"""The check that decides `correct`, driven through a whole run of each cell
at a small size on the CPU (the look for a card skipped): a sound run
comes out correct; each fault a cell can have, planted under the timed
path, comes out not correct; and so does the control, the reference in
TF32 operands put in the program's place."""

import time

import pytest
import torch

from silt_bench import harness
from silt_bench.faults import FAULTS

GEN = {"res": 64, "skip": 3, "forces": 20, "advect": "gather"}
SMALL = {
    "karman_sol32.train": {"config": {"msteps": 2, "sbatch": 2},
                           "workload": {"profile_units": 1}},
    "burgers_sol04.train": {"config": {"msteps": 2, "simsteps": 6, "nsims": 4, "sbatch": 2,
                                       "generator": GEN},
                            "workload": {"profile_units": 1}},
    "karman_sol32.apply_b1": {"workload": {"steps": 6, "warmup_steps": 2,
                                           "checked_rollouts": 2}},
    "burgers_sol04.apply_b1": {"config": {"apply_steps": 6, "test_sims": 2, "generator": GEN},
                               "workload": {"steps": 6, "warmup_steps": 2,
                                            "checked_rollouts": 2}},
}
CPU = torch.device("cpu")


def _run(cell, fault=None, trace=False, seed=2**31 + 7, control=False):
    return harness.run_cell(cell, seed, 0.5, trace, CPU, time.perf_counter(),
                            {"setup_import_s": 0.0}, overrides=SMALL[cell], fault=fault,
                            control=control)[0]


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    line = _run(cell, trace=cell.endswith("train"))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SMALL
                                        for f in FAULTS[harness.cell(c)[1]["kind"]]])
def test_a_planted_fault_is_not_correct(cell, fault):
    kind = harness.cell(cell)[1]["kind"]
    line = _run(cell, fault=FAULTS[kind][fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_is_not_correct(cell):
    line = _run(cell, seed=11, control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", [c for c in SMALL if c.endswith("train")])
def test_a_fault_in_the_window_alone_is_not_correct(cell):
    """The optimizer step leaves the state unchanged from the window's first
    iteration on, after sound warm-up iterations: the check judges
    iterations the window ran."""
    warmup = harness.cell(cell)[1]["warmup_iterations"]

    def stale_after_warmup(program):
        step, calls = program.optimizer.step, []

        def maybe():
            calls.append(1)
            return step() if len(calls) <= warmup else True

        program.optimizer.step = maybe

    assert not _run(cell, fault=stale_after_warmup)["correct"]
