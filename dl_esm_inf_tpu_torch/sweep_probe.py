"""Times the flagship kernels' paths on the card and prints one JSON line
(a second one with ``--skeleton``: the sweeps on the shared skeleton).

    python dl_esm_inf_tpu_torch/sweep_probe.py [--root DIR] [--n 1024]
        [--ranks] [--skeleton] [--nlayer-run] [--exchange] [--scratch]
        [--no-flagship]

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

``--skeleton`` also times every sweep on the shared skeleton
(``csrc/stencil_sweep.cuh``) at ``chip_smoke.py``'s configurations of
that checkout, each a CUDA graph of its launches (best of 5 replays),
and prints them as a second JSON line (``skeleton_*`` keys, µs per
sweep): gravity wave, shallow and two-layer at K=8, tracer van Leer at
K=4 and upwind at K=8, the Chebyshev sweep at K = 1, 2, 4, 8 (float32) and K=4 (float64),
lam 50, the N-layer sweep at L=3, K=8 and at ``NLAYER_KEYS`` (null where
that checkout's kernel refuses the layers; beside them one sweep's max
abs against its plain version on a 256^2 grid of spacings 0.7 x 1.3,
``nlayer_dx07_max_abs``), the PSy light sweep at repeats 1, 2 and 3
and the levels=N chain's light sweep at L=3 and L=8 (float32) and L=8
(float64); beside them the Helmholtz solve (K=4, float32) in ms on the
kernel and the plain path with its iterations, and each library's
registers and spilled bytes from its build log.

``--nlayer-run`` prints one more line: where the N-layer rows' ``run``
spends its time (:func:`probe_nlayer_run`).

``--exchange`` prints one more line: the standalone exchange
(``csrc/halo_exchange.cu``) at ``chip_smoke.py``'s configurations
(:func:`probe_exchange`): the functional form ``exchange_kernel`` and
``Field.halo_exchange(d, transport="remote_dma")`` (the ring form in
place, where that checkout has it), each the card's time as a CUDA graph
of 20 calls (best of 5 replays) beside one wrapper call's time, the
``aten::index`` gather of ``exchange_index`` and a ``torch.clone`` of
the block beside them, and each form's byte bound.

``--scratch`` prints one more line: the generated schedule sweep past
one CTA's shared memory (:func:`probe_scratch`), the levels=N chain at
float64 on 2x2 tiles at ``chip_smoke.py``'s fewest levels past one CTA
and at 75 levels, one light sweep as a CUDA graph beside its byte bound,
the form that checkout gives it (the cluster form; the scratch form
before it existed), its CTAs and its libraries' registers and spills;
one level fewer (the shared form); and the cluster form's settings.
``--no-flagship`` skips the first line (the flagship's timings).

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


def _build_report(names) -> dict:
    """Registers (min-max over the library's kernels) and spilled bytes
    of each loaded library whose name starts with one of ``names``,
    from its ptxas report."""
    import re

    from dl_esm_inf_tpu_torch.ops import cuda_build
    out = {}
    for key, b in cuda_build._loaded.items():
        if not key.startswith(names):
            continue
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", b.log)]
        spill = sum(int(a) + int(c) for a, c in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", b.log))
        out[key] = {"registers": [min(regs), max(regs)] if regs else None,
                    "spill_bytes": spill, "nvcc_s": round(b.seconds, 1)}
    return out


def probe_skeleton(n: int) -> dict:
    """The skeleton sweeps' device times of the module docstring, in µs,
    at ``chip_smoke.py``'s configurations (its helpers, of the same
    checkout)."""
    import functools
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from dl_esm_inf_tpu_torch.models import nlayer as nlm
    from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    from dl_esm_inf_tpu_torch.ops import solvers as so

    # the libraries first, in parallel (one nvcc each)
    tasks = [k.build for k in (
        cs.gw.gravity_wave_sweep, cs.sh.shallow_sweep, cs.tl.twolayer_sweep,
        cs.tr.tracer_sweep, so.helmholtz_cheb_sweep, nlm.nlayer_sweep)]
    tasks += [functools.partial(cs._psy_case, torch.float32, 1, r, "light",
                                False, n=64, steps=2 * r) for r in (1, 2, 3)]
    tasks += [functools.partial(cs._level_case, "chain", dt, lv, False,
                                n=64, ndom=1)
              for lv, dt in ((3, torch.float32), (8, torch.float32),
                             (8, torch.float64))]
    with ThreadPoolExecutor(len(tasks)) as pool:
        list(pool.map(lambda t: t(), tasks))

    def us(fn, launches=20):
        return 1e3 * _graph_ms(fn, launches)

    out = {}
    for c in cs.CLIENTS:
        m = c.mod.build(n, n, fused=True, steps_per_sweep=c.K,
                        device=cs.DEV, **c.main_kw(n))
        c.init(m, n)
        m.run(2 * c.K)
        state = tuple(getattr(m, f).data for f in m._fields)
        sweep, aux = m._make_sweep(c.K), m._sweep_aux
        out[f"skeleton_{c.name}_K{c.K}_us"] = us(lambda: sweep(state, aux))
    m = cs.tr.build(n, n, fused=True, steps_per_sweep=8, device=cs.DEV,
                    **cs._tracer_kw(n, "upwind"))
    m.set_initial_tracer(gaussian_eta(n, n, amp=1.0) + 0.01)
    m.run(16)
    state, aux = (m.c.data,), m._sweep_aux
    sweep = m._make_sweep(8)
    out["skeleton_tracer_upwind_K8_us"] = us(lambda: sweep(state, aux))
    lam = 50.0
    for K, dt in ((1, torch.float32), (2, torch.float32), (4, torch.float32),
                  (8, torch.float32), (4, torch.float64)):
        g, tmask = cs._solver_grid(n, 1, K, dt, island=False)
        b = cs._rhs(g, tmask, 0)
        s = so.HelmholtzSolver(g, lam, lam, method="chebyshev",
                               steps_per_exchange=K, fused=True)
        sweep = s._make_cheb_sweep(K)
        sc = so.chebyshev_scalars(*s._lam_bounds, s.niters())[:K]
        x = 0.5 * b
        state = (x, b - x, 0.01 * b)
        key = f"skeleton_cheb_K{K}_{str(dt)[6:]}_us"
        out[key] = us(lambda: sweep(*state, sc))
        if K == 4 and dt == torch.float32:
            sp = so.HelmholtzSolver(g, lam, lam, method="chebyshev",
                                    steps_per_exchange=K)
            out["solve_iterations"] = s.solve(b)[1]["iterations"]
            out["solve_plain_iterations"] = sp.solve(b)[1]["iterations"]
            out["solve_ms"] = cs._time_ms(lambda: s.solve(b), 10)
            out["solve_plain_ms"] = cs._time_ms(lambda: sp.solve(b), 3)
    m = nlm.build(n, n, layers=3, fused=True, steps_per_sweep=8,
                  device=cs.DEV)
    m.set_initial(cs._nlayer_eta0(n, 3))
    flat = _nlayer_state(m)
    sweep = m._make_sweep(8)
    out["skeleton_nlayer_L3_K8_us"] = us(lambda: sweep(flat,
                                                       m._sweep_aux))
    for L, dname, K in NLAYER_KEYS:
        key = f"skeleton_nlayer_L{L}_{dname}_K{K}_us"
        dt = getattr(torch, dname)
        try:
            m = nlm.build(n, n, layers=L, fused=True, steps_per_sweep=K,
                          dtype=dt, device=cs.DEV)
        except ValueError:      # more layers than that checkout's kernel
            out[key] = None
            continue
        m.set_initial(cs._nlayer_eta0(n, L))
        flat = _nlayer_state(m)
        sweep = m._make_sweep(K)
        out[key] = us(lambda: sweep(flat, m._sweep_aux))
    out["nlayer_dx07_max_abs"] = _nlayer_spacing_max_abs(cs, 256)
    m = NemoLite2DPsy(n, n, halo_width=8, device=cs.DEV)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    m.run(4, fused=True)
    for r in (1, 2, 3):
        key = "skeleton_psy_light_us" if r == 1 else \
            f"skeleton_psy_light_r{r}_us"
        out[key] = us(_light_sweep(m._sched, [tuple(
            float(v) for v in m._sched._user_scalar_vector(
                m._scalars_at(m._step + j))) for j in range(r)], r))
    for lv, dt in ((3, torch.float32), (8, torch.float32),
                   (8, torch.float64)):
        sched, _ = cs._level_main(lv, dt, (1, 1))
        sched.fused_program(4)()
        out[f"skeleton_levels{lv}_{str(dt)[6:]}_us"] = us(_light_sweep(
            sched, [tuple(float(v) for v in sched._user_scalar_vector(
                None))]))
    out["build"] = _build_report((
        "gravity_wave", "shallow", "twolayer", "tracer", "helmholtz",
        "nlayer", "schedule_sweep"))
    return out


#: the N-layer rows whose ``run`` chip_smoke.py times at float32:
#: (layers, K)
NLAYER_RUN = ((3, 8), (5, 8), (8, 8), (33, 8), (48, 4))


def probe_nlayer_run(n: int) -> dict:
    """Where ``run``'s time goes in the N-layer rows of ``chip_smoke.py``
    (float32, n^2), for each (L, K) of NLAYER_RUN (``nlayer_run_L*_K*``,
    µs per step unless named): ``run(20 K)`` as chip_smoke's
    ``_run_step_us`` times it (``run_us``: the mean of 3 runs in one
    CUDA-event window after a warm-up run; ``mallocs``: the segments the
    caching allocator took from cudaMalloc in that window) and each of 3
    more runs alone (``runs_us``); the same window again after the plain
    sweeps chip_smoke runs just before ``run`` (four timed, one counted:
    ``run_after_plain_us``, ``mallocs_after_plain``); the
    sweep's CUDA graph on the initial state and on the state the runs
    left (``graph_us``, ``graph_after_us``, per step);
    and one more run under torch.profiler: the sweep kernel's launches
    and their device µs per launch (``kernel_us``: mean, min, max), the
    device's busy µs per step (every kernel, memset and copy) and the
    span from the first one's start to the last one's end per step
    (``span_us``); null where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dl_esm_inf_tpu_torch.models import nlayer as nlm
    from dl_esm_inf_tpu_torch.ops.stencil_sweep import stencil_sweep_reference

    def mallocs():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def events_ms(fn, reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    out = {}
    for L, K in NLAYER_RUN:
        steps = 20 * K
        m = nlm.build(n, n, layers=L, fused=True, steps_per_sweep=K,
                      device=cs.DEV)
        m.set_initial(cs._nlayer_eta0(n, L))
        sweep = m._make_sweep(K)
        state = (m.eta.data, m.u.data, m.v.data)
        graph_us = 1e3 * _graph_ms(lambda: sweep(state, m._sweep_aux),
                                   20) / K
        m.run(steps)
        torch.cuda.synchronize()
        n0 = mallocs()
        row = {"run_us": 1e3 * events_ms(lambda: m.run(steps), 3) / steps,
               "mallocs": mallocs() - n0,
               "runs_us": [1e3 * events_ms(lambda: m.run(steps), 1) / steps
                           for _ in range(3)]}
        state = (m.eta.data, m.u.data, m.v.data)
        prep = m._prepare(m._sweep_aux)
        def plain():
            return stencil_sweep_reference(m._sweep_step, K, state, prep)
        for _ in range(4):
            plain()
        cs._count_ops(plain)
        m.run(steps)
        torch.cuda.synchronize()
        n0 = mallocs()
        row["run_after_plain_us"] = 1e3 * events_ms(lambda: m.run(steps),
                                                    3) / steps
        row["mallocs_after_plain"] = mallocs() - n0
        state = (m.eta.data, m.u.data, m.v.data)
        row["graph_us"] = graph_us
        row["graph_after_us"] = 1e3 * _graph_ms(
            lambda: sweep(state, m._sweep_aux), 20) / K
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.run(steps)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = [e.time_range.end - e.time_range.start for e in dev
                if "nlayer_kernel" in e.name]
        if dev:
            row["launches"] = len(kern)
            row["kernel_us"] = ([sum(kern) / len(kern), min(kern),
                                 max(kern)] if kern else None)
            row["busy_us"] = sum(e.time_range.end - e.time_range.start
                                 for e in dev) / steps
            row["span_us"] = (max(e.time_range.end for e in dev)
                              - min(e.time_range.start for e in dev)) / steps
        else:
            row.update(launches=None, kernel_us=None, busy_us=None,
                       span_us=None)
        out[f"nlayer_run_L{L}_K{K}"] = row
        del m, sweep, state
        torch.cuda.empty_cache()
    return out


#: the exchanges ``--exchange`` times at float32, halo 8: (tiles, doubly
#: periodic, depth, levels, global N as a multiple of ``--n``)
EXCHANGE_CASES = (((2, 2), False, 1, None, 1), ((2, 2), False, 8, None, 1),
                  ((4, 4), False, 8, None, 1), ((1, 1), True, 8, None, 1),
                  ((2, 2), False, 8, 3, 1), ((2, 2), False, 8, None, 4))


def probe_exchange(n: int) -> dict:
    """The exchange rows of the module docstring (``exchange_*`` keys, µs
    unless named), each checked bitwise against the gather first:
    ``kernel_us`` / ``kernel_call_us`` the functional form,
    ``field_us`` / ``field_call_us`` ``Field.halo_exchange(d,
    transport="remote_dma")``, ``gather_us`` the ``aten::index`` gather,
    ``clone_us`` a ``torch.clone`` of the block (the card's copy rate),
    ``bound_us`` two passes over the block, ``ring_bound_us`` two over
    its ring (the cells the exchange map moves), ``field_in_place``
    whether the field's tensor kept its storage."""
    import numpy as np
    import torch

    import dl_esm_inf_tpu_torch as tdl
    from dl_esm_inf_tpu_torch.parallel import halo as halo_mod
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk

    dev = torch.device("cuda")

    def call_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return 1e3 * t0.elapsed_time(t1) / reps

    out = {}
    for tiles, wrap, depth, levels, scale in EXCHANGE_CASES:
        N = n * scale
        bc = tdl.BC_PERIODIC if wrap else tdl.BC_EXTERNAL
        g = tdl.Grid(tdl.ARAKAWA_C, (bc, bc, tdl.BC_NONE), tdl.OFFSET_NE,
                     dtype=torch.float32, device=dev)
        g.decompose(N, N, ndomainx=tiles[0], ndomainy=tiles[1],
                    halo_width=8)
        tdl.grid_init(g, 1.0, 1.0)
        spec = g.halo_spec
        lead = () if levels is None else (levels,)
        shape = lead + spec.array_shape
        a = torch.from_numpy(np.random.default_rng(0).permutation(
            int(np.prod(shape))).reshape(shape)).to(dev, torch.float32)
        rows, cols = halo_mod.exchange_index(spec, depth, dev)
        rows = rows[:, None]
        want = a[..., rows, cols]
        if not torch.equal(hk.exchange_kernel(a, spec, depth), want):
            raise AssertionError(f"exchange {tiles} depth {depth} at {N}^2:"
                                 " kernel != gather")
        f = tdl.Field(g, tdl.T_POINTS, levels=levels)
        f.data = a.clone()
        ptr = f.data.data_ptr()
        f.halo_exchange(depth, transport="remote_dma")
        if not torch.equal(f.data, want):
            raise AssertionError(f"Field.halo_exchange {tiles} depth {depth}"
                                 f" at {N}^2 != gather")
        in_place = f.data.data_ptr() == ptr
        moved = ((rows[:, 0] != torch.arange(rows.shape[0], device=dev))[
            :, None] | (cols != torch.arange(cols.shape[0], device=dev)))
        ring_bytes = int(moved.sum()) * (levels or 1) * a.element_size()
        key = (f"exchange_{N}_{tiles[0]}x{tiles[1]}"
               f"{'_periodic' if wrap else ''}_d{depth}"
               f"{'_l%d' % levels if levels else ''}")
        out[key] = {
            "kernel_us": 1e3 * _graph_ms(
                lambda: hk.exchange_kernel(a, spec, depth), 20),
            "kernel_call_us": call_us(
                lambda: hk.exchange_kernel(a, spec, depth)),
            "field_us": 1e3 * _graph_ms(
                lambda: f.halo_exchange(depth, transport="remote_dma"), 20),
            "field_call_us": call_us(
                lambda: f.halo_exchange(depth, transport="remote_dma")),
            "gather_us": 1e3 * _graph_ms(lambda: a[..., rows, cols], 20),
            "clone_us": 1e3 * _graph_ms(a.clone, 20),
            "bound_us": 2 * a.numel() * a.element_size() / 3.35e12 * 1e6,
            "ring_bound_us": 2 * ring_bytes / 3.35e12 * 1e6,
            "field_in_place": in_place}
        del a, f, want
        torch.cuda.empty_cache()
    return out


#: the N-layer sweeps ``--skeleton`` also times: (layers, dtype, K)
NLAYER_KEYS = ((5, "float32", 8), (8, "float32", 8), (5, "float64", 8),
               (8, "float64", 8), (16, "float32", 8), (32, "float32", 8),
               (48, "float32", 4))


def _nlayer_state(m):
    """An N-layer model's sweep state: its three level blocks, or, in a
    checkout whose kernel takes single planes (``_to_planes``), those."""
    state = (m.eta.data, m.u.data, m.v.data)
    return m._to_planes(state) if hasattr(m, "_to_planes") else state


def _nlayer_spacing_max_abs(cs, n: int) -> float:
    """One N-layer sweep (3 layers, K=4, float32) on a grid of spacings
    0.7 x 1.3, kernel vs its plain version on the card: max abs on
    internal points (through the model's API, which both checkouts
    share)."""
    import torch

    import dl_esm_inf_tpu_torch as tdl
    from dl_esm_inf_tpu_torch.models import nlayer as nlm
    from dl_esm_inf_tpu_torch.ops.stencil_sweep import stencil_sweep_reference
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE,
                 dtype=torch.float32, device=cs.DEV)
    g.decompose(n, n, ndomains=1, halo_width=4)
    tdl.grid_init(g, 0.7, 1.3, nlm.default_tmask(n, n))
    m = nlm.NLayerModel(g, dt=0.01, layers=3)
    m.enable_fast_path(4)
    m.set_initial(cs._nlayer_eta0(n, 3))
    flat = _nlayer_state(m)
    ker = m._make_sweep(4)(flat, m._sweep_aux)
    ref = stencil_sweep_reference(m._sweep_step, 4, flat,
                                  m._prepare(m._sweep_aux))
    return cs._internal_max_abs(g, ker, ref)


#: what --scratch times: the levels chain past one CTA at float64 on 2x2
#: tiles, at the fewest levels past one CTA (chip_smoke.scratch_levels())
#: and at NEMO's 75; one level fewer as the shared form's record; and, in
#: a checkout with the cluster form, its threads a CTA at the fewest levels
SCRATCH_NEMO_LEVELS = 75
CLUSTER_THREADS = (256, 512)


def _chain_light(cs, L: int, n: int):
    """(one light sweep of the chain at L levels, float64, 2x2 tiles at
    n^2, its generated sweep, the bytes it must move)."""
    import torch
    cs.MAIN_SIZE = n
    sched, _ = cs._level_main(L, torch.float64, (2, 2))
    rows = [tuple(float(v) for v in sched._user_scalar_vector(None))]
    sweep, st_slots, x_slots = sched._fused_prog(4, 1)[3]["light"]
    ro_slots = sched._fused_prog(4, 1)[2]

    def planes(idx):
        return tuple(p for i in idx for p in (
            (sched._slots[i].data,) if sched._slots[i].data.dim() == 2
            else sched._slots[i].data.unbind(0)))
    state, ros, extra = planes(st_slots), planes(ro_slots), planes(x_slots)
    nbytes = sum(2 * t.numel() * t.element_size() for t in state) + sum(
        t.numel() * t.element_size()
        for t in (*ros, *extra, torch.stack(sched._fused_masks())))
    return (lambda: sweep(state, ros, extra, rows)), sweep.generated, nbytes


def probe_scratch(n: int) -> dict:
    """The levels chain past one CTA's shared memory (float64, 2x2 tiles
    at ``n``^2) in the form the checkout gives it (the scratch form
    before the cluster form existed): one light sweep as a CUDA graph of
    3 launches (best of 5 replays), at ``chip_smoke.scratch_levels()``
    levels and at SCRATCH_NEMO_LEVELS, beside its byte bound (inputs read
    once, outputs written once, at 3.35 TB/s), its form, cluster and
    CTAs; at one level fewer, the shared form (one CTA an SM).  In a
    checkout with the cluster form, also each of CLUSTER_THREADS at the
    fewest levels, with whether its result equals the default's bitwise
    on every cell.  Each generated library's registers and spilled bytes
    from its build log."""
    import torch
    import chip_smoke as cs
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    L = cs.scratch_levels()
    cluster = hasattr(ss, "CLUSTER_THREADS")
    saved = getattr(ss, "CLUSTER_THREADS", None)
    cases = [(L - 1, None), (L, None), (SCRATCH_NEMO_LEVELS, None)]
    if cluster:
        cases += [(L, nt) for nt in CLUSTER_THREADS if nt != saved]
    out, ref = {"scratch_levels": L}, {}
    try:
        for lv, nt in cases:
            if nt is not None:
                ss.CLUSTER_THREADS = nt
            key = f"L{lv}" + ("" if nt is None else f"_nt{nt}")
            fn, gen, nbytes = _chain_light(cs, lv, n)
            got = fn()
            ref.setdefault(lv, got)
            out[key + "_us"] = _graph_ms(fn, 3) * 1e3
            out[key + "_bound_us"] = nbytes / 3.35e12 * 1e6
            out[key + "_form"] = gen.form
            out[key + "_cluster"] = getattr(gen, "cluster", None)
            out[key + "_tile"] = list(gen.tile)
            out[key + "_equal"] = all(torch.equal(a, b)
                                      for a, b in zip(got, ref[lv]))
            lib = ss.schedule_sweep.build(gen).lib
            ly, lx = got[0].shape
            out[key + "_ctas"] = (
                lib.schedule_sweep_clusters(ly, lx) * gen.cluster
                if gen.form == "cluster" else lib.schedule_sweep_ctas(
                    ly, lx, ss.SCRATCH_BYTES) if gen.form == "scratch"
                else None)
            out[key + "_build"] = _build_report((gen.name,))
            del fn, got
            torch.cuda.empty_cache()
    finally:
        if cluster:
            ss.CLUSTER_THREADS = saved
    return out


def _light_sweep(sched, rows, repeats=1):
    """One launch of the light sweep of a schedule's 4-step program at
    ``repeats`` (one scalar row each) on its current slots, as
    ``chip_smoke.py``'s PSy and levels phases time it."""
    sweep, st_slots, x_slots = sched._fused_prog(4, repeats)[3]["light"]
    ro_slots = sched._fused_prog(4, repeats)[2]

    def planes(idx):
        return tuple(p for i in idx for p in (
            (sched._slots[i].data,) if sched._slots[i].data.dim() == 2
            else sched._slots[i].data.unbind(0)))
    state, ros, extra = planes(st_slots), planes(ro_slots), planes(x_slots)
    return lambda: sweep(state, ros, extra, rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose port is timed")
    ap.add_argument("--n", type=int, default=1024, help="global N x N")
    ap.add_argument("--skeleton", action="store_true",
                    help="also time the sweeps on the shared skeleton")
    ap.add_argument("--nlayer-run", action="store_true",
                    help="also split the N-layer rows' run into device "
                    "and host time")
    ap.add_argument("--exchange", action="store_true",
                    help="also time the standalone exchange's two forms")
    ap.add_argument("--scratch", action="store_true",
                    help="also time the schedule sweep past one CTA's "
                    "shared memory (the cluster form, or the scratch form "
                    "before it)")
    ap.add_argument("--no-flagship", action="store_true",
                    help="skip the flagship timings of the first line")
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
    if not args.no_flagship:
        print(json.dumps({"root": root, **probe(args.n)}), flush=True)
    if args.skeleton:
        print(json.dumps({"root": root, **probe_skeleton(args.n)}),
              flush=True)
    if args.nlayer_run:
        print(json.dumps({"root": root, **probe_nlayer_run(args.n)}),
              flush=True)
    if args.exchange:
        print(json.dumps({"root": root, **probe_exchange(args.n)}),
              flush=True)
    if args.scratch:
        os.chdir(root)
        print(json.dumps({"root": root, **probe_scratch(args.n)}),
              flush=True)
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
