"""The work counts and bounds, pinned at the cells' shapes."""

import pytest

from silt_bench import harness, work


def _unit(cell):
    config, workload = harness.cell(cell)
    return work.unit_work(config, workload)


@pytest.mark.parametrize("cell,flops", [
    # 32 steps x (forward + weight gradient + input gradient) of 2 x 6,144
    # cells x 25 x (3x32 + 10x32x32 + 32x2) = 3.195e9, less step 0's stem
    # input gradient (2 x 6,144 x 25 x 96)
    ("karman_sol32.train", 32 * 3 * 2 * 6144 * 25 * 10400 - 2 * 6144 * 25 * 96),
    ("burgers_sol04.train", 4 * 3 * 2 * 5120 * 25 * 10432 - 2 * 5120 * 25 * 128),
    ("karman_sol32.apply_b1", 2 * 2048 * 25 * 10400),
    ("burgers_sol04.apply_b1", 2 * 1024 * 25 * 10432),
])
def test_net_operations_per_unit(cell, flops):
    assert _unit(cell)["flops"] == flops


def test_operations_bound_the_convs_at_the_cells_shapes():
    # a 32->32 5x5 conv at (3, 64, 32): 3 x 2 x 6,144 x 25,600 operations at
    # 495 TFLOP/s outweigh its 2.4 MB at 3.35 TB/s
    assert work.conv_bound_ms((3, 64, 32, 32, 32, 5), True) == pytest.approx(
        1e3 * 3 * 2 * 6144 * 25 * 32 * 32 / 495e12)
    assert _unit("karman_sol32.train")["bound_ms"] == pytest.approx(1.8790377, rel=1e-6)
    assert _unit("karman_sol32.apply_b1")["bound_ms"] == pytest.approx(0.0065285535, rel=1e-6)


def test_pcg_bound():
    # (1, 64, 32) at 13 iterations: 14 passes of 3 x 4 x 2,048 x 96 TF32
    # operations and 28 x 2,048 fp32 ones; the bytes take less
    want = 14 * (3 * 4 * 2048 * 96 / 495e12 + 28 * 2048 / 67e12) * 1e3
    assert work.pcg_bound_ms((1, 64, 32), 13) == pytest.approx(want)
    assert work.FP32_ACCURATE_FLOPS == 165e12
