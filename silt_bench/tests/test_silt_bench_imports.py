"""What the benchmark may load, read by the modules' syntax trees: nothing
of JAX or of the JAX package anywhere under silt_bench/, nothing of the
program in the reference, and nothing of the JAX package's benchmark
files. Names are compared by their whole top-level part."""

import ast
from pathlib import Path

import pytest

from silt_bench import harness

BENCH = harness.BENCH
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    top = set(_imports(path))
    assert "solver_in_the_loop_torch" not in top and top <= {
        "__future__", "functools", "math", "typing", "numpy", "torch", "silt_bench"}


def test_nothing_reads_the_jax_packages_benchmark():
    for path in MODULES:
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "BENCH_r", "BENCH.md", "MULTICHIP_", "VERDICT"):
            assert name not in text, (path, name)


def test_the_harness_loads_nothing_forbidden():
    """Importing the harness and the cells' modules loads no forbidden module
    (a run itself checks sys.modules after its window)."""
    import subprocess
    import sys

    script = ("import sys; from silt_bench import harness, control\n"
              "for f, n in [('systems', 'karman'), ('systems', 'burgers'), ('kinds', 'train'),"
              " ('kinds', 'apply')]: harness.load_module(f, n)\n"
              "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", script], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
