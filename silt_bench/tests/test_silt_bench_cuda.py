"""On the card: a short run of each cell, traced, through the harness;
each comes out correct and reports its per-layer metrics, rooflines and
shares within 0-100 %. Skips without a card."""

import time

import pytest

from silt_bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card(cell, cuda_device):
    line, _ = harness.run_cell(cell, 2**31 + 99, 2.0, True, cuda_device, time.perf_counter(),
                               {"setup_import_s": 0.0})
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name, metric in line["metrics"].items():
        if metric["unit"] == "%":
            assert 0 < metric["value"] <= 100, (name, metric)
