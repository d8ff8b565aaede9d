"""The readers of the program's spans and counters (spans.py) on synthetic
recordings and traces, and phases.py through a small run of a training
and a rollout cell on the CPU."""

import math
import time

import pytest
import torch

from silt_bench import harness, phases, spans, work
from silt_bench.tests.test_silt_bench_check import SMALL

MS = 1_000_000  # ns


def _rec(*spans_):
    return {"spans": list(spans_), "counters": {}}


def test_a_name_nested_in_itself_counts_once():
    rec = _rec(("silt.solver", 0, 10 * MS, None, 1),       # step_with_f around step
               ("silt.solver", 2 * MS, 8 * MS, 0, 1),
               ("silt.net", 10 * MS, 14 * MS, None, 1),
               ("silt.solver", 20 * MS, 25 * MS, 2, 1),    # under another name: counts
               ("silt.solver", 30 * MS, None, None, 1))    # still open: left out
    assert spans.span_ms_per_unit(rec, "silt.solver", 3) == pytest.approx(15 / 3)
    assert spans.span_ms_per_unit(rec, "silt.net", 1) == pytest.approx(4)
    assert spans.span_ms_per_unit(rec, "silt.pressure", 1) is None
    assert spans.span_ms_per_unit(None, "silt.net", 1) is None


def _host(start, end, name, thread, corr=0):
    return (start * MS, end * MS, name, thread, corr)


def test_the_table_puts_each_gap_in_the_innermost_span_on_any_thread():
    """The caller waits in the backward on thread 1; the autograd thread 2
    runs a recompute and launches a kernel in it, then one outside it; a
    gap goes to the latest started of the spans open at its midpoint."""
    host = [_host(0, 20, "silt.train.backward", 1),
            _host(2, 10, "silt.train.recompute", 2),
            _host(3, 4, "aten::mul", 2, corr=7),
            _host(12, 13, "aten::add", 2, corr=8),
            _host(21, 25, "aten::sum", 1, corr=9)]
    device = [(4 * MS, 6 * MS, 7), (13 * MS, 14 * MS, 8), (24 * MS, 24 * MS + MS // 2, 9)]
    table = spans.table_from_events(host, device)
    back, rec = table["silt.train.backward"], table["silt.train.recompute"]
    # gaps: 0-4 (mid 2: recompute opens at 2), 6-13 (mid 9.5: recompute),
    # 14-24 (mid 19: backward), 24.5-25 (mid 24.75: none)
    assert rec["idle_s"] == pytest.approx((4 + 7) * 1e-3)
    assert back["idle_s"] == pytest.approx(10e-3)
    # the kernel launched in the recompute counts for it and the backward
    # it hangs from; the one launched at 12 ms for the backward alone; the
    # one launched outside every span for none
    assert rec["device_s"] == pytest.approx(2e-3)
    assert back["device_s"] == pytest.approx(3e-3)
    assert back["host_s"] == pytest.approx(20e-3) and rec["host_s"] == pytest.approx(8e-3)
    assert set(table) == {"silt.train.backward", "silt.train.recompute"}


def test_the_table_counts_a_nested_name_once_and_an_outer_span_first():
    host = [_host(0, 10, "silt.solver", 1), _host(0, 6, "silt.solver", 1),
            _host(1, 2, "aten::mul", 1, corr=3)]
    table = spans.table_from_events(host, [(2 * MS, 3 * MS, 3)])
    assert table["silt.solver"]["host_s"] == pytest.approx(10e-3)
    assert table["silt.solver"]["device_s"] == pytest.approx(1e-3)


def _train_ctx(**kw):
    config, workload = harness.cell("karman_sol32.train")
    ctx = {"kind": "train", "config": config, "workload": workload, "profiled_units": 2,
           "trace": {"groups": {"pressure": {"s": 0.012, "launches": 126}}}}
    ctx.update(kw)
    return ctx


def test_pressure_roofline_counts_every_solve_at_its_own_iterations():
    fwd, adj = [13] * 64, [23] * 62
    ctx = _train_ctx(profiled_counters={"pressure.iters": fwd, "pressure.adjoint_iters": adj})
    shape = (3, 64, 32)
    want = 100.0 * (64 * work.pcg_bound_ms(shape, 13) + 62 * work.pcg_bound_ms(shape, 23)) \
        / 2 / 6.0
    got = spans.pressure_roofline_pct_train(ctx)
    assert got == pytest.approx(want) and 0 < got < 100
    # the adjoints' share is in it: without them it reads less
    assert spans.pressure_roofline_pct_train(
        _train_ctx(profiled_counters={"pressure.iters": fwd})) < got


def test_every_reader_is_silent_on_a_program_without_spans():
    for kind in ("train", "apply"):
        ctx = _train_ctx(kind=kind, recording={"spans": [], "counters": {}}, recorded_units=2,
                         setup_recording={"spans": [], "counters": {}})
        ctx["trace"] = {"groups": {}}
        for name, (unit, layer, moves, read) in spans.METRICS.items():
            got = read(ctx)
            assert got is None or (name == "setup_kernels_s" and got == 0.0), name
        bare = _train_ctx(kind=kind)
        assert all(entry[3](bare) is None for entry in spans.METRICS.values())


def test_the_metrics_name_their_layers_as_the_benchmark_does():
    bench = harness.benchmark()
    layers = {e["layer"] for e in bench["per_layer"]}
    e2e = {e["name"] for e in bench["end_to_end"]}
    assert len(spans.METRICS) == 8
    for name, (unit, layer, moves, _) in spans.METRICS.items():
        assert moves in e2e and name not in {e["name"] for e in bench["per_layer"]}
        assert layer in layers or layer == "solver step (physics/, ops/)", name


@pytest.mark.parametrize("cell", ["karman_sol32.train", "burgers_sol04.apply_b1"])
def test_phases_reads_a_small_run(cell):
    line = phases.measure(cell, 2**31 + 7, 0.2, torch.device("cpu"), time.perf_counter(),
                          SMALL[cell])
    kind = harness.cell(cell)[1]["kind"]
    want = {n for n in spans.METRICS if n.endswith("." + kind)} | {"setup_kernels_s"}
    # no device trace on the CPU: the (P)CG group holds no launch to read
    want.discard("pressure_roofline_pct.train")
    assert set(line["metrics"]) == want
    assert all(math.isfinite(v) and v >= 0 for v in line["metrics"].values())
    assert 0.9 <= line["covered"] <= 1.0
    if kind == "train":
        counts = line["counters_per_unit"]
        assert counts["pressure.iters"] > 0 and counts["pressure.adjoint_iters"] > 0
        assert line["span_ms_per_unit"]["silt.train.recompute"] > 0
        assert set(line["spans_table"]) >= {"silt.train.forward", "silt.train.backward"}
