"""Build and load the package's hand-written CUDA kernels.

Each library is compiled by ``nvcc`` from the sources under
``dl_esm_inf_tpu_torch/csrc/``, or from a generated source (the sweep
kernels generated from kernel schedules, :mod:`.schedule_sweep`), into a
shared object with a plain C interface, loaded with ``ctypes``.
Libraries are built at first use into ``build/torch_kernels/`` at the
root of the checkout, under a name keyed by a hash of the sources, the
shared headers and the flags, so a changed source rebuilds and an
unchanged one loads in milliseconds.  nvcc's log (the ptxas report of
registers and spills) is kept beside the library and read back with it,
so a library loaded from the cache reports what its build did.  A
generated source is written there too, beside its library.  A library that calls the CUDA driver
API (the stream memory operations of the exchange between ranks) links
``libcuda`` through the toolkit's stub.  A failed build raises: nothing
falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
    log: str              # nvcc's diagnostics (the ptxas report), kept
                          # beside the library
    source: Path | None = None   # the generated source, if any


_loaded: dict[str, BuiltLibrary] = {}
_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


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


def load_library(name: str, sources: tuple[str, ...] = (), *,
                 generated: str | None = None,
                 driver: bool = False) -> BuiltLibrary:
    """Build (if needed) and load ``lib<name>`` from ``csrc/<sources>``,
    or from the source text ``generated`` (which may include the headers
    under ``csrc/`` only); ``driver``: link the CUDA driver API
    (``-lcuda``).  Safe to call from several threads."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            _loaded[name] = _build(name, sources, generated, driver)
    return _loaded[name]


def _driver_link(nvcc: str) -> list[str]:
    """``-lcuda``, with the toolkit's stub directories on the link path
    (the driver's own ``libcuda.so.1`` is loaded at run time)."""
    root = Path(nvcc).resolve().parent.parent
    stubs = [d for d in (root / "lib64" / "stubs",
                         root / "targets" / "x86_64-linux" / "lib" / "stubs")
             if d.is_dir()]
    return [f"-L{d}" for d in stubs] + ["-lcuda"]


def _build(name: str, sources, generated, driver) -> BuiltLibrary:
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode()
                       + (b" -lcuda" if driver else b""))
    if generated is not None:
        h.update(b"generated:" + generated.encode())
    for p in sorted(paths) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    src = BUILD_DIR / f"{name}-{digest}.cu" if generated is not None else None
    seconds = 0.0
    if out.exists() and log_path.exists():
        log = log_path.read_text()
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        include = []
        if src is not None:
            tmp_src = src.with_name(f"{src.name}.{os.getpid()}.tmp")
            tmp_src.write_text(generated)
            os.replace(tmp_src, src)
            paths, include = [src], ["-I", str(CSRC)]
        nvcc = find_nvcc()
        cmd = [nvcc, *NVCC_FLAGS, *include, "-o", str(tmp),
               *(str(p) for p in paths),
               *(_driver_link(nvcc) if driver else [])]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building lib{name} failed (nvcc exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)   # the log first: a cached library
        os.replace(tmp, out)            # always has its report
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log, src)
