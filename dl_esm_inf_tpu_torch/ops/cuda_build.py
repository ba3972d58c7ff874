"""Build and load the package's hand-written CUDA kernels.

Each library is compiled by ``nvcc`` from the sources under
``dl_esm_inf_tpu_torch/csrc/`` into a shared object with a plain C
interface, loaded with ``ctypes``.  Libraries are built at first use into
``build/torch_kernels/`` at the root of the checkout, under a name keyed
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads in milliseconds.  A failed build raises: nothing
falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: sm_90a (Hopper); no FMA contraction, so the kernels round exactly
#: where their plain PyTorch versions do; -Xptxas -v reports registers,
#: shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float        # compile time; 0.0 when loaded from the cache
    log: str              # nvcc's diagnostics (the ptxas report)


_loaded: dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of dl_esm_inf_tpu_torch cannot be built")


def load_library(name: str, sources: tuple[str, ...]) -> BuiltLibrary:
    """Build (if needed) and load ``lib<name>`` from ``csrc/<sources>``."""
    if name in _loaded:
        return _loaded[name]
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(paths) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(p) for p in paths)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building lib{name} failed (nvcc exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
    _loaded[name] = built
    return built
