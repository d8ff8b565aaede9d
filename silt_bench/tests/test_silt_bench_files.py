"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric reader found by name and valid, within the contract's limits;
the frozen inputs decode; and a cell or a metric is added by adding files
alone."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from silt_bench import harness, inputs

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|expan|feature|kernel|"
                   r"channel|width)", re.I)
E2E = {e["name"] for e in BENCH["end_to_end"]}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_run_seconds_fits_a_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_configs_are_files_of_their_own_and_reduce_no_width():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in spec and not WIDTH.search(key), key
        assert spec["dtype"] == "float32" and spec["tf32"] is False


def test_workloads_are_found_by_name():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        config, workload = harness.cell(w["name"])
        assert workload["config"] == w["config"] == config["name"]
        harness.load_module("kinds", workload["kind"])
        harness.load_module("systems", config["system"])
        assert workload["limits"] and all(v > 0 for v in workload["limits"].values())


def test_metrics_are_found_by_name_and_agree():
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        mod = harness.load_module("end_to_end", e["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (e["unit"], e["better"], e["source"])
    assert "setup_s" in E2E
    layers = {}
    for e in BENCH["per_layer"]:
        assert e["moves"] in E2E and _line(e["layer"])
        mod = harness.load_module("metrics", e["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["better"], e["source"], e["moves"], e["layer"])
        assert mod.WORKLOADS == e.get("workloads")
        layers.setdefault(e["layer"], e["layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {e["name"] for e in harness.reported(BENCH["end_to_end"], w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.reported(BENCH["per_layer"], w["name"], e2e)
        assert layer and all(e["moves"] in e2e for e in layer)


def test_frozen_inputs_decode():
    data = inputs.karman_set()
    assert data["dens"].shape == (6, 40, 64, 32) and data["re"].shape == (6,)
    for name in ("karman_sol32", "burgers_sol04"):
        weights = inputs.checkpoint(name, 5)
        assert len(weights) == 24 and weights["stem.weight"].shape[0] == 32


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark with one more traffic file, one more metric
    reader and their entries in BENCHMARK.json (no file of the copy edited)
    runs the new cell and reports the new metric."""
    shutil.copytree(ROOT / "silt_bench", tmp_path / "silt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "karman_sol32.apply_b2", "config": "karman_sol32",
                               "traffic": "apply_b2", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][2]["workloads"].append("karman_sol32.apply_b2")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "rollout_step_ms",
                               "workloads": ["karman_sol32.apply_b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = json.loads((ROOT / "silt_bench/workloads/karman_sol32.apply_b1.json").read_text())
    workload.update(batch=2, steps=3, warmup_steps=2, checked_rollouts=1)
    (tmp_path / "silt_bench/workloads/karman_sol32.apply_b2.json").write_text(json.dumps(workload))
    (tmp_path / "silt_bench/metrics/steps_seen.py").write_text(
        'def read(ctx):\n    return ctx["profiled_units"]\n')
    script = textwrap.dedent("""
        import json, time, torch
        from silt_bench import harness
        line = harness.run_cell("karman_sol32.apply_b2", 5, 0.3, True, torch.device("cpu"),
                                time.perf_counter(), {"setup_import_s": 0.0})[0]
        print(json.dumps(line))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["steps_seen"]["value"] == 3
    for path in (ROOT / "silt_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and "tests" not in path.parts:
            copy = tmp_path / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


@pytest.mark.parametrize("folder", ["configs", "workloads", "metrics", "end_to_end"])
def test_every_file_is_named_in_the_benchmark(folder):
    names = {"configs": {c["name"] for c in BENCH["configs"]},
             "workloads": {w["name"] for w in BENCH["workloads"]},
             "metrics": {e["name"] for e in BENCH["per_layer"]},
             "end_to_end": E2E}[folder]
    found = {p.name[:-len(p.suffix)] for p in (ROOT / "silt_bench" / folder).iterdir()
             if p.suffix in (".json", ".py") and p.name != "__init__.py"}
    assert found == names
