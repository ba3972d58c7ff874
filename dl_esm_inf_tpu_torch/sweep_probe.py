"""Times the flagship kernels' paths on the card and prints one JSON line.

    python dl_esm_inf_tpu_torch/sweep_probe.py [--root DIR] [--n 1024]
        [--ranks]

Run as a file, it imports the port from the checkout at ``--root``
(default: this file's checkout), so one command can time two trees in
turns, as a comparison of a change with its parent must (parent, change,
change, parent).  At
``n``² float32, flat depth unless stated, each a CUDA graph of its
launches timed with CUDA events (the best of 5 replays):

* ``run_K4_us_per_step``: ``build(n, n, fused=True, steps_per_sweep=4)``
  and ``run(400)``, host loop included (best of 3);
* one sweep at K = 1..4, at K = 4 also at float64, on rectangular cells
  (dx 1000, dy 1500), over a seeded depth plane (``ht``) and with the
  exchange inside on 2x2 tiles (``exch22``);
* the ``dma`` variant at K = 1 beside three ``torch.add`` over the state
  (its library yardstick), and the microbench split at K = 1, 2, 4:
  ``prod``, ``dma`` and the ``compute`` slope over 2 and 8 passes, per
  step.

``--ranks`` also runs ``chip_smoke.phase_ranks()`` of that checkout (the
rdma exchange and the fused transport across 2 and 4 ranks) and prints
its two kernel entries.  Needs one CUDA GPU; numbers from a CPU mean
nothing and the script refuses to run there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _graph_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / n)
    return best


def probe(n: int) -> dict:
    """The timings of the module docstring, in µs."""
    import numpy as np
    import torch

    from dl_esm_inf_tpu_torch.models import nemolite2d as nl
    from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
    from dl_esm_inf_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    m = nl.build(n, n, fused=True, steps_per_sweep=4, dtype=torch.float32,
                 device=dev)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    m.run(40)
    torch.cuda.synchronize()
    out = {"n": n}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        e0.record()
        m.run(400)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) * 1e3 / 400)
    out["run_K4_us_per_step"] = best
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    codes = m._mask_codes
    args = (*m.grid.array_shape, torch.float32, m.p, m.grid.dx, m.grid.dy,
            m._fcor, m.depth)

    def us(fn, launches=50):
        return 1e3 * _graph_ms(fn, launches)

    for K in (1, 2, 3, 4):
        f = m.forcing_series(0, K)
        fused = fs.make_fused_step(*args, steps_per_sweep=K)
        out[f"sweep_K{K}_us"] = us(lambda: fused(*state, codes, f))
    f4 = m.forcing_series(0, 4)
    s64 = tuple(t.double() for t in state)
    f64 = fs.make_fused_step(*args[:2], torch.float64, *args[3:],
                             steps_per_sweep=4)
    out["sweep_f64_K4_us"] = us(lambda: f64(*s64, codes, f4), 20)
    m2 = nl.build(n, n, ndomains=4, fused=True, steps_per_sweep=4,
                  dtype=torch.float32, device=dev)
    m2.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    m2.enable_fast_path(4, transport="fused")
    s2 = (m2.sshn_t.data, m2.un.data, m2.vn.data)
    fx = m2._make_fused(4)
    out["sweep_exch22_K4_us"] = us(lambda: fx(*s2, m2._mask_codes, f4))
    frect = fs.make_fused_step(*args[:4], 1000.0, 1500.0, *args[6:],
                               steps_per_sweep=4)
    out["sweep_rect_K4_us"] = us(lambda: frect(*state, codes, f4))
    depth = 50.0 + 100.0 * np.random.default_rng(3).random(
        m.grid.array_shape)
    ht = torch.tensor(depth, dtype=torch.float32, device=dev)
    fh = fs.make_fused_step(*args, steps_per_sweep=4, variable_bathy=True)
    out["sweep_ht_K4_us"] = us(lambda: fh(*state, codes, f4, ht=ht))
    f1 = m.forcing_series(0, 1)
    dma = fs.make_variant(*args, 1, "dma")
    out["dma_K1_us"] = us(lambda: dma(*state, codes, f1))
    out["add3_us"] = us(lambda: [torch.add(x, f1[0]) for x in state])
    for K in (1, 2, 4):
        fk = m.forcing_series(0, K)
        comp = fs.make_variant(*args, K, "compute")
        t2 = _graph_ms(lambda: comp(*state, codes, fk, reps=2), 5)
        t8 = _graph_ms(lambda: comp(*state, codes, fk, reps=8), 5)
        out[f"compute_K{K}_us_per_step"] = 1e3 * (t8 - t2) / (6 * K)
        d = fs.make_variant(*args, K, "dma")
        out[f"dma_K{K}_us_per_step"] = us(lambda: d(*state, codes,
                                                    fk)) / K
        fp = fs.make_fused_step(*args, steps_per_sweep=K)
        out[f"prod_K{K}_us_per_step"] = us(lambda: fp(*state, codes,
                                                     fk)) / K
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose port is timed")
    ap.add_argument("--n", type=int, default=1024, help="global N x N")
    ap.add_argument("--ranks", action="store_true",
                    help="also run that checkout's chip_smoke.phase_ranks()")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep_probe times the card: no CUDA GPU here")
    import dl_esm_inf_tpu_torch as port
    if not Path(port.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"the port was imported from {port.__file__}, not "
                         f"from {root}: run this file as a script")
    res = {"root": root, **probe(args.n)}
    print(json.dumps(res), flush=True)
    if args.ranks:
        from concurrent.futures import ThreadPoolExecutor
        os.chdir(root)
        import chip_smoke
        # the hand-written libraries first, as chip_smoke.py's phase 2
        # does: a rank compiling inside a gang keeps its peers waiting
        with ThreadPoolExecutor(len(chip_smoke.KERNELS)) as pool:
            list(pool.map(lambda k: k.build(), chip_smoke.KERNELS))
        print(json.dumps({"root": root, "ranks": chip_smoke.phase_ranks()}),
              flush=True)


if __name__ == "__main__":
    # run as a file, its own directory (the package's) must not shadow
    # top-level modules
    if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        del sys.path[0]
    main()
