"""The port's kernel build (kernels/build.py) with a stand-in for nvcc.

The real compiler exists only on the card's machine; here a shell script in
its place checks what the build does around it: one compiler per source,
libraries named by a hash of source and flags, only missing ones rebuilt,
and a compiler failure raised with the compiler's output.
"""

from __future__ import annotations

import os
import stat

import pytest

from solver_in_the_loop_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  case "$1" in *.cu) src="$1";; esac
  shift
done
echo "ptxas info    : Used 8 registers for $src"
%s
touch "$out"
"""


def _fake_cuda(tmp_path, monkeypatch, extra=""):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC % extra)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")


def test_build_all_compiles_each_source_once(tmp_path, monkeypatch):
    _fake_cuda(tmp_path, monkeypatch)
    report = build.build_all()
    assert sorted(report) == sorted(build.SOURCES)
    for name, info in report.items():
        assert build._lib_path(name).exists()
        assert build._lib_path(name).parent == tmp_path / "kernels"
        assert info["ptxas"] == [f"ptxas info    : Used 8 registers for {build.CSRC}/{name}.cu"]
    assert build.build_all() == {}  # nothing missing, nothing rebuilt
    assert sorted(build.build_all(force=True)) == sorted(build.SOURCES)
    assert not [p for p in os.listdir(tmp_path / "kernels") if p.endswith(".tmp")]


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    _fake_cuda(tmp_path, monkeypatch, extra='echo "error: bad kernel"; exit 2')
    with pytest.raises(RuntimeError, match="error: bad kernel"):
        build.build_all()
    assert not build._lib_path("advect").exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_library_name_follows_flags(monkeypatch):
    before = build._lib_path("advect")
    monkeypatch.setitem(build.SOURCES, "advect", [])
    assert build._lib_path("advect") != before


def test_launch_error_is_raised():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="tap_sum_fwd: CUDA error 9"):
        build.check(9, "tap_sum_fwd")


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edit to a header of csrc/ alone builds every source that includes
    it anew, and no other."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build._inputs("pcg")] == ["pcg.cu", "cg_common.cuh", "tf32.cuh"]
    assert [p.name for p in build._inputs("conv")] == ["conv.cu", "tf32.cuh"]
    assert [p.name for p in build._inputs("cg_cluster")] == ["cg_cluster.cu", "cg_common.cuh",
                                                             "tf32.cuh"]
    for header, users in (("cg_common.cuh", {"pcg", "cg", "cg_cluster"}),
                          ("tf32.cuh", {"pcg", "conv", "cg_cluster"})):
        before = {name: build._lib_path(name) for name in build.SOURCES}
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        changed = {name for name in build.SOURCES if build._lib_path(name) != before[name]}
        assert changed == users, header
