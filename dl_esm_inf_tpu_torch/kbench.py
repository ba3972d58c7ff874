"""Kernel-variant microbench for the flagship sweep (slope method).

Counterpart of the JAX package's ``scripts/kbench.py``: it takes one
production sweep of the NEMOLite2D flagship apart into the time its
loads and stores take and the time its arithmetic takes::

    python -m dl_esm_inf_tpu_torch.kbench [--modes prod,dma,compute,compute_fast]
        [--ks 1,2,4] [--n 1024] [--device cuda]

Modes (:func:`~.ops.fused_step.make_variant`):

* ``prod`` — the production sweep kernel (``make_fused_step``);
* ``dma`` — the same loads and stores, with a copy for the compute: the
  memory floor of a sweep;
* ``compute`` — the K sub-steps on resident windows, no memory traffic
  per pass: the compute floor;
* ``compute_fast`` — the same with the approximate reciprocal (float32).

The TPU microbench's tile-row knob (``--tys``) has no counterpart: the
CUDA tile follows from the shared-memory budget for each dtype and K
(:func:`~.ops.fused_step.tile`).  The sweep depth K takes its place.  Each
(K, mode) prints its time per model step; each K then prints the split
of one production step into the memory floor, the compute floor and the
remainder.  Times come from :func:`~.utils.profiling.slope_time`: on the
card each chain is one CUDA graph of its launches, timed with CUDA
events, so a sweep shorter than the host's cost of a call still shows;
on the CPU the host clock times the modes' plain versions, and the
numbers say nothing of the card.
"""
from __future__ import annotations

import argparse

import torch

from .models import nemolite2d as nl
from .models.gravity_wave import gaussian_eta
from .ops.fused_step import make_variant
from .parallel import environment as env
from .utils.profiling import slope_time

MODES = ("prod", "dma", "compute", "compute_fast")
#: chain lengths of the slope on the card: sweeps for prod and dma,
#: passes for the compute modes.  The compute modes feed each pass back
#: into windows whose ring is never refreshed, so a long chain leaves the
#: physical range: the passes stay few and the timed outputs are
#: required finite.  On the CPU every chain is (1, 2).
CHAINS = {"prod": (10, 50), "dma": (10, 50), "compute": (2, 8),
          "compute_fast": (2, 8)}


def _model(n: int, device):
    if env.get_num_ranks() > 1:
        raise ValueError(
            "the kernel-variant microbench times one device: run it in one "
            f"process, not across {env.get_num_ranks()} ranks")
    m = nl.build(n, n, fused=True, steps_per_sweep=4, dtype=torch.float32,
                 device=device)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    return m


def measure(mode: str, K: int, m, reps: int = 4) -> float:
    """Seconds per model step of ``mode`` at sweep depth K on the state
    of model ``m`` (its whole stacked block)."""
    ly, lx = m.grid.array_shape
    var = make_variant(ly, lx, m.grid.dtype, m.p, m.grid.dx, m.grid.dy,
                       m._fcor, m.depth, K, mode)
    forcing = m.forcing_series(0, K)
    codes = m._mask_codes
    start = (m.sshn_t.data, m.un.data, m.vn.data)
    last = [start]
    passes = mode.startswith("compute")
    dev = m.grid.device

    def run(n):
        if passes:                   # one launch of n passes
            last[0] = var(*start, codes, forcing, reps=n)
        else:                        # n sweeps, the state fed forward
            s = start
            for _ in range(n):
                s = var(*s, codes, forcing)
            last[0] = s

    def chain(n):
        if dev.type != "cuda":
            return lambda: run(n)
        # on the card a chain is one CUDA graph of its launches, so the
        # slope is the kernels' time and not the host's cost of a call
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(n)
        return graph.replay

    run(1)                           # build, and set up the launches
    lo, hi = CHAINS[mode] if dev.type == "cuda" else (1, 2)
    t = slope_time(chain, lo, hi, reps=reps, device=dev)
    if not all(bool(torch.isfinite(a).all()) for a in last[0]):
        raise RuntimeError(f"{mode} K={K}: the timed outputs are not "
                           "finite")
    return t / K                     # an iteration is K steps


def main(argv=None) -> dict:
    """Run the microbench; returns ``{K: {mode: us_per_step}}``."""
    ap = argparse.ArgumentParser(
        prog="python -m dl_esm_inf_tpu_torch.kbench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES),
                    help=f"comma list of: {','.join(MODES)}")
    ap.add_argument("--ks", default="1,2,4",
                    help="comma list of sweep depths K (1..4)")
    ap.add_argument("--n", type=int, default=1024, help="global N x N")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    ks = [int(k) for k in args.ks.split(",")]
    m = _model(args.n, torch.device(args.device))
    ly, lx = m.grid.array_shape
    where = (torch.cuda.get_device_name(m.grid.device)
             if m.grid.device.type == "cuda" else "cpu (plain versions)")
    print(f"kbench: flagship {args.n}^2 float32, block {ly}x{lx}, "
          f"device {where}", flush=True)
    out: dict = {}
    for K in ks:
        out[K] = {}
        for mode in modes:
            us = measure(mode, K, m) * 1e6
            out[K][mode] = us
            print(f"K={K} {mode:12s} {us:9.3f} us/step", flush=True)
        r = out[K]
        if {"prod", "dma", "compute"} <= set(r):
            rest = r["prod"] - r["dma"] - r["compute"]
            print(f"K={K} split: prod {r['prod']:.3f} = dma {r['dma']:.3f} "
                  f"+ compute {r['compute']:.3f} + remainder {rest:.3f} "
                  f"us/step", flush=True)
    return out


if __name__ == "__main__":
    main()
