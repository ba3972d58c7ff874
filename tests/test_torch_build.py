"""The kernel build cache (``dl_esm_inf_tpu_torch/ops/cuda_build.py``).

nvcc is replaced by a stand-in that writes the library file and prints
a ptxas report, and ``ctypes.CDLL`` by a stub, so that what the cache
keeps beside a library is checked without a CUDA toolkit: a library
loaded from the cache reports the registers and spills of its build,
one cached without its report is built again, and a failed build
leaves nothing behind.
"""
import subprocess
from pathlib import Path

import pytest

from dl_esm_inf_tpu_torch.ops import cuda_build as cb

REPORT = ("ptxas info    : Function properties for _Z12sweep_kernelv\n"
          "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
          "loads\nptxas info    : Used 40 registers\n")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Calls of the stand-in nvcc, with its exit code settable."""
    calls = {"n": 0, "rc": 0}

    def run(cmd, capture_output, text):
        calls["n"] += 1
        if calls["rc"] == 0:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, calls["rc"], REPORT, "")

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cb, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cb.subprocess, "run", run)
    monkeypatch.setattr(cb.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(cb, "_loaded", {})
    return calls


def test_cached_library_keeps_its_ptxas_report(fake_nvcc):
    first = cb.load_library("probe", ("stencil_sweep.cuh",))
    assert fake_nvcc["n"] == 1 and first.log == REPORT
    assert first.path.with_suffix(".log").read_text() == REPORT
    cb._loaded.clear()                    # a new process, a warm cache
    again = cb.load_library("probe", ("stencil_sweep.cuh",))
    assert fake_nvcc["n"] == 1 and again.seconds == 0.0
    assert again.path == first.path and again.log == REPORT
    assert "Used 40 registers" in again.log


def test_cached_library_without_its_report_is_rebuilt(fake_nvcc):
    first = cb.load_library("probe", ("stencil_sweep.cuh",))
    first.path.with_suffix(".log").unlink()
    cb._loaded.clear()
    again = cb.load_library("probe", ("stencil_sweep.cuh",))
    assert fake_nvcc["n"] == 2 and again.log == REPORT
    assert again.path.with_suffix(".log").read_text() == REPORT


def test_failed_build_raises_and_leaves_nothing(fake_nvcc):
    fake_nvcc["rc"] = 2
    with pytest.raises(RuntimeError, match="nvcc exit 2"):
        cb.load_library("probe", ("stencil_sweep.cuh",))
    assert not list(cb.BUILD_DIR.iterdir())
