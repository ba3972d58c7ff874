"""Profiling, tracing and comms observability.

Counterpart of ``dl_esm_inf_tpu/utils/profiling.py``.  The reference has
no tracing — only compile-time DEBUG/DEBUG_COMMS printf gates
(parallel_comms_mod.f90:41-43) and decomposition statistics
(parallel_mod.f90:319-330).  Here:

* :class:`StepTimer` — host-clock step timing, fenced by
  ``torch.cuda.synchronize`` on a CUDA device (PyTorch returns before
  the card finishes);
* :func:`slope_time` — the slope method (two chain lengths) that
  cancels fixed per-chain costs, timed with CUDA events on the card
  (the JAX package's ``scripts/kbench.py:40-50``);
* :func:`trace` — ``torch.profiler`` around a block, written as a Chrome
  trace (Perfetto, ``chrome://tracing``);
* :func:`comms_schedule` — the DEBUG_COMMS analogue: the static
  neighbour schedule a halo spec executes (direction, tile pairs, strip
  shapes), readable without running anything;
* :func:`decomposition_report` — go_decompose's load-imbalance banner.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from ..core.decomposition import Decomposition
from ..parallel.halo import HaloSpec


class StepTimer:
    """Accumulates per-call wall times around device work; on a CUDA
    ``device`` each measurement starts and ends with
    ``torch.cuda.synchronize(device)``, so it times the work and not its
    enqueue."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.times: list[float] = []

    def _fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def measure(self):
        self._fence()
        t0 = time.perf_counter()
        yield
        self._fence()
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def summary(self) -> dict:
        return {"n": len(self.times), "best_s": self.best,
                "mean_s": self.mean}


def slope_time(fn, n_lo: int = 50, n_hi: int = 250, reps: int = 4,
               device=None) -> float:
    """Seconds per iteration from two chain lengths: ``fn(n)`` returns a
    callable that runs a chain of ``n`` iterations; the best of ``reps``
    timings of each chain (after one warm-up call each) differ by
    ``n_hi - n_lo`` iterations, which cancels every fixed per-chain cost.
    On a CUDA ``device`` each chain is timed with CUDA events, else with
    the host clock."""
    dev = None if device is None else torch.device(device)
    cuda = dev is not None and dev.type == "cuda"
    lo, hi = fn(n_lo), fn(n_hi)
    lo()
    hi()

    def once(f) -> float:
        if not cuda:
            t0 = time.perf_counter()
            f()
            return time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        f()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) * 1e-3

    def best(f) -> float:
        return min(once(f) for _ in range(reps))
    return (best(hi) - best(lo)) / (n_hi - n_lo)


@contextlib.contextmanager
def trace(logdir: str):
    """Device trace of the block through ``torch.profiler`` (CPU and,
    where there is one, CUDA activity), written as a Chrome trace
    ``trace.json`` into ``logdir``; the profile is yielded for
    ``key_averages()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _perms(n: int, wrap: bool) -> tuple[list, list]:
    """(forward, backward) neighbour pairs along an axis of n tiles."""
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    if wrap and n > 1:
        fwd.append((n - 1, 0))
        bwd.append((0, n - 1))
    return fwd, bwd


def comms_schedule(spec: HaloSpec, depth: int = 1) -> list[dict]:
    """The static message schedule one exchange executes.

    Each entry is one phase: axis, direction, the (src, dst) tile pairs,
    the strip shape in elements and the source and destination columns
    (x) or rows (y) of the strip in a tile's local block.  On one card
    every pair is a strip move within the stacked tensor; the entries are
    the JAX package's, whose pairs become collective messages between
    devices.  The analogue of the reference's per-message DEBUG_COMMS
    logs (parallel_comms_mod.f90:1613-1661), available statically."""
    if depth < 1 or depth > spec.halo:
        raise ValueError(
            f"halo-exchange depth {depth} outside [1, halo={spec.halo}] "
            "— this schedule could never be executed")
    sched = []
    h, d = spec.halo, depth
    if spec.nprocx > 1 or spec.wrap_x:
        fwd, bwd = _perms(spec.nprocx, spec.wrap_x)
        sched.append({"axis": "x", "direction": "east",
                      "pairs": fwd, "strip": (spec.local_ny, d),
                      "src_cols": (h + spec.tile_nx - d, h + spec.tile_nx),
                      "dst_cols": (h - d, h)})
        sched.append({"axis": "x", "direction": "west",
                      "pairs": bwd, "strip": (spec.local_ny, d),
                      "src_cols": (h, h + d),
                      "dst_cols": (h + spec.tile_nx, h + spec.tile_nx + d)})
    if spec.nprocy > 1 or spec.wrap_y:
        fwd, bwd = _perms(spec.nprocy, spec.wrap_y)
        sched.append({"axis": "y", "direction": "north",
                      "pairs": fwd, "strip": (d, spec.local_nx),
                      "src_rows": (h + spec.tile_ny - d, h + spec.tile_ny),
                      "dst_rows": (h - d, h)})
        sched.append({"axis": "y", "direction": "south",
                      "pairs": bwd, "strip": (d, spec.local_nx),
                      "src_rows": (h, h + d),
                      "dst_rows": (h + spec.tile_ny, h + spec.tile_ny + d)})
    return sched


def decomposition_report(decomp: Decomposition) -> str:
    """Human-readable decomposition + load-imbalance banner (reference
    parallel_mod.f90:292-330)."""
    st = decomp.imbalance_stats()
    lines = [
        f"go_decompose: using grid of {decomp.nprocx}x{decomp.nprocy}",
        f"Tile width = {decomp.tile_nx}, tile height = {decomp.tile_ny}",
    ]
    for r, s in enumerate(decomp.subdomains):
        g, i = s.global_, s.internal
        lines.append(
            f"subdomain[{r}] global ({g.xstart}:{g.xstop})"
            f"({g.ystart}:{g.ystop}), interior ({i.xstart}:{i.xstop})"
            f"({i.ystart}:{i.ystop})")
    lines += [
        f"Mean sub-domain size = {st['mean_pts']:.1f} pts",
        f"Min,max sub-domain size (pts) = {st['min_pts']},{st['max_pts']}",
        f"Domain load imbalance (%) = {st['imbalance_pct']:.2f}",
        f"Max sub-domain dims are {st['max_width']}x{st['max_height']}",
    ]
    return "\n".join(lines)
