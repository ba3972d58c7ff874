"""GPU smoke run of the PyTorch port's main paths: the NEMOLite2D
flagship and the four sweep-engine client models (gravity wave,
shallow, two-layer, tracer).

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the five hand-written kernels from
   dl_esm_inf_tpu_torch/csrc/ with nvcc, one process per source, all at
   once (build/torch_kernels/); prints each library's registers and
   spills;
3. flagship kernel vs plain, float64: the fused model on the kernel
   against the same model on the plain PyTorch path, 256^2 and 1024^2,
   K = 1..4, 1 and 4 tiles, 101 steps from a Gaussian bump;
4. flagship kernel vs the independent numpy golden
   (tests/nemolite2d_golden.py), float64, 10 and 1024 steps;
5. the flagship's main path, float32: build(1024, 1024, fused=True,
   steps_per_sweep=4, device="cuda"), run(n) with the launch counter
   reset just before; then the kernel against its plain version on the
   same inputs, and times on the card (CUDA events, after warm-up);
6. for each client model (the tracer with both schemes where stated):
   a. kernel vs plain, float64, 256^2, every K the kernel takes, 1 and
      4 tiles, 50 steps;
   b. kernel vs the model's numpy golden, float64, at the sizes and
      tolerances of the JAX package's tests, with the launch count;
   c. its main path, float32 1024^2, configured as the reference
      benchmark configures it (bench.py measure_client_models): run(n)
      with the model's launch counter reset just before, finiteness,
      kernel vs plain after the run and for one sweep, and times on the
      card.

The line before the last is the kernel report as JSON; the last line is
the result as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

from dl_esm_inf_tpu_torch.models import gravity_wave as gw  # noqa: E402
from dl_esm_inf_tpu_torch.models import nemolite2d as nl  # noqa: E402
from dl_esm_inf_tpu_torch.models import shallow as sh  # noqa: E402
from dl_esm_inf_tpu_torch.models import tracer as tr  # noqa: E402
from dl_esm_inf_tpu_torch.models import twolayer as tl  # noqa: E402
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta  # noqa: E402
from dl_esm_inf_tpu_torch.ops import fused_step as fs  # noqa: E402
from dl_esm_inf_tpu_torch.ops.stencil_sweep import (  # noqa: E402
    stencil_sweep_reference)
from nemolite2d_golden import golden_run  # noqa: E402

DEV = torch.device("cuda")
#: kernel vs plain, float64: max |diff| of internal points over the
#: field's max |value|.  Both round every operation once in the same
#: order (the kernel is built without FMA contraction).
TOL_F64 = 1e-12
#: kernel vs plain, float32, after the main path's n steps, relative to
#: the field's max |value|.  Measured bitwise equal on an H100; the
#: bound leaves room for ulp-level differences between torch builds.
TOL_F32 = 1e-6
MAIN_N = 402                     # n // 4 sweeps + n % 4 single steps
PARITY_SIZES = (256, 1024)
MAIN_SIZE = 1024


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return smi


KERNELS = (fs.nemolite2d_sweep, gw.gravity_wave_sweep, sh.shallow_sweep,
           tl.twolayer_sweep, tr.tracer_sweep)


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(lambda k: k.build(), KERNELS))
    wall = time.perf_counter() - t0
    for b in built:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", b.log)]
        spill = sum(int(a) + int(c) for a, c in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", b.log))
        reg_s = f"{min(regs)}-{max(regs)}" if regs else "?"
        print(f"build: {b.path.name} nvcc {b.seconds:.1f}s; ptxas: "
              f"{len(regs)} kernels, {reg_s} registers, {spill} bytes "
              f"spilled", flush=True)
    print(f"build: {len(built)} libraries in {wall:.1f}s (in parallel)",
          flush=True)


def _rel_diff(ga: dict, gb: dict) -> float:
    return max(float(np.abs(ga[k] - gb[k]).max() / np.abs(ga[k]).max())
               for k in ga)


def _pair(n, ndom, K, dtype, steps):
    """(kernel model, plain model) after ``steps`` from the same start."""
    out = []
    for fused in (True, False):
        m = nl.build(n, n, ndomains=ndom, fused=fused, steps_per_sweep=K,
                     halo_width=2 * K, dtype=dtype, device=DEV)
        m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
        m.run(steps)
        out.append(m)
    return out


def phase_parity_f64() -> float:
    worst = 0.0
    for n in PARITY_SIZES:
        for ndom in (1, 4):
            for K in (1, 2, 3, 4):
                mk, mp = _pair(n, ndom, K, torch.float64, 101)
                d = _rel_diff(mk.gather(), mp.gather())
                if not d <= TOL_F64:
                    raise AssertionError(
                        f"kernel vs plain f64 {n}^2 ndomains={ndom} K={K}: "
                        f"{d:.3e} > {TOL_F64}")
                worst = max(worst, d)
    print(f"parity f64: kernel vs plain, sizes {PARITY_SIZES}, K=1..4, "
          f"ndomains 1 and 4, 101 steps: max rel diff {worst:.3e} "
          f"(tol {TOL_F64})", flush=True)
    return worst


def phase_golden() -> None:
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    report = []
    for steps, ndom, rtol, atol in ((10, 1, 1e-11, 1e-13),
                                    (1024, 1, 1e-8, 1e-10),
                                    (1024, 4, 1e-8, 1e-10)):
        m = nl.build(gnx, gny, ndomains=ndom, fused=True, steps_per_sweep=4,
                     dtype=torch.float64, device=DEV)
        m.set_initial_ssh(ssh0)
        before = fs.nemolite2d_sweep.launches
        m.run(steps)
        if fs.nemolite2d_sweep.launches - before != steps // 4 + steps % 4:
            raise AssertionError("golden run did not go through the kernel")
        want = golden_run(nl.default_tmask(gnx, gny), ssh0, steps, m.p,
                          m.grid.dx, m.grid.dy, 100.0)
        got = m.gather()
        err = 0.0
        for k in ("sshn", "un", "vn"):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"{k} {steps} steps")
            err = max(err, float(np.abs(got[k] - want[k]).max()))
        report.append(f"{steps} steps ndomains={ndom} max abs {err:.2e} "
                      f"(rtol {rtol}, atol {atol})")
    print("golden f64 34x30 K=4: " + "; ".join(report), flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _run_step_us(m, nsteps: int, reps: int) -> float:
    return 1e3 * _time_ms(lambda: m.run(nsteps), reps) / nsteps


def phase_main() -> dict:
    N, K = MAIN_SIZE, 4
    m = nl.build(N, N, fused=True, steps_per_sweep=K, device=DEV)
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    torch.cuda.synchronize()
    fs.nemolite2d_sweep.launches = 0
    m.run(MAIN_N)
    torch.cuda.synchronize()
    launches = fs.nemolite2d_sweep.launches
    if launches != MAIN_N // K + MAIN_N % K:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times, expected {MAIN_N // K + MAIN_N % K}")
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    for t in state:
        if tuple(t.shape) != m.grid.array_shape or not torch.isfinite(t).all():
            raise AssertionError("main path state is not finite")
    cs = m.checksums()
    print(f"main f32 {N}^2 K={K}: run({MAIN_N}) launches={launches} "
          f"(= {MAIN_N}//{K} + {MAIN_N}%{K}); finite; checksums "
          + " ".join(f"{k}={v:.10E}" for k, v in cs.items()), flush=True)

    # the same run on the plain path
    mp = nl.build(N, N, fused=False, steps_per_sweep=K, device=DEV)
    mp.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    mp.run(MAIN_N)
    d_run = _rel_diff(m.gather(), mp.gather())
    if not d_run <= TOL_F32:
        raise AssertionError(f"kernel vs plain f32 after {MAIN_N} steps: "
                             f"{d_run:.3e} > {TOL_F32}")

    # one sweep of the kernel's wrapper against its plain version, on the
    # main path's state and shapes
    fused = m._make_fused(K)
    forcing = m.forcing_series(m._istep0, K)
    codes = m._mask_codes
    ker = fused(*state, codes, forcing)
    ref = fs.fused_step_reference(*state, codes, forcing, p=m.p,
                                  dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
                                  depth=m.depth)
    inner = m.sshn_t.internal_mask.bool()
    max_abs = max(float((a - b).abs()[inner].max())
                  for a, b in zip(ker, ref))
    scale = max(float(b.abs()[inner].max()) for b in ref)
    if not max_abs <= TOL_F32 * scale:
        raise AssertionError(f"one sweep kernel vs plain f32: {max_abs:.3e}")
    ms = _time_ms(lambda: fused(*state, codes, forcing), 200)
    plain_ms = _time_ms(lambda: fs.fused_step_reference(
        *state, codes, forcing, p=m.p, dx=m.grid.dx, dy=m.grid.dy,
        fcor=m._fcor, depth=m.depth), 20)

    # end-to-end step times of the model (host loop included)
    us_k = _run_step_us(m, 400, 5)
    us_p = _run_step_us(mp, 40, 3)
    print(f"timing f32 {N}^2 K={K}: kernel {us_k:.2f} us/step "
          f"({N * N / us_k:.0f} Mpt/s), plain {us_p:.2f} us/step "
          f"({N * N / us_p:.0f} Mpt/s); one sweep: kernel {ms * 1e3:.2f} us,"
          f" plain {plain_ms * 1e3:.2f} us; kernel vs plain after "
          f"{MAIN_N} steps rel {d_run:.3e}, one sweep max abs "
          f"{max_abs:.3e} (tol {TOL_F32} x max|field|)", flush=True)

    m64, p64 = (nl.build(N, N, fused=f, steps_per_sweep=K,
                         dtype=torch.float64, device=DEV)
                for f in (True, False))
    for mm in (m64, p64):
        mm.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    us_k64 = _run_step_us(m64, 400, 3)
    us_p64 = _run_step_us(p64, 40, 3)
    print(f"timing f64 {N}^2 K={K}: kernel {us_k64:.2f} us/step "
          f"({N * N / us_k64:.0f} Mpt/s), plain {us_p64:.2f} us/step "
          f"({N * N / us_p64:.0f} Mpt/s)", flush=True)
    return {"name": "nemolite2d_sweep", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/nemolite2d_sweep.cu",
            "replaces": "dl_esm_inf_tpu/ops/pallas_step.py:33",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms}


# --- the sweep-engine client models ---------------------------------------

PARITY_N, PARITY_STEPS = 256, 50


def _tracer_kw(n, scheme):
    """The reference benchmark's tracer configuration: velocities from a
    streamfunction Gaussian (bench.py measure_client_models)."""
    u, v = tr.streamfunction_velocities(gaussian_eta(n, n, amp=20.0,
                                                     width=0.2))
    return dict(dt=0.2, u=u, v=v, kappa=0.02, scheme=scheme)


@dataclass(frozen=True)
class Client:
    """A client model's smoke configuration."""
    name: str            # the kernel's name
    mod: object          # the model module
    main_kw: object      # n -> build kwargs of the main path
    init: object         # (model, n) -> None: the initial state
    K: int               # the main path's steps_per_sweep
    n_main: int          # the main path's steps: n // K sweeps + n % K
    parity: tuple        # ((n -> build kwargs, largest K), ...)
    replaces: str

    @property
    def kernel(self):
        return getattr(self.mod, self.name)


CLIENTS = (
    Client("gravity_wave_sweep", gw, lambda n: dict(dt=0.005),
           lambda m, n: m.set_initial_eta(gaussian_eta(n, n, amp=0.1)),
           8, 404, ((lambda n: dict(dt=0.005), 8),),
           "dl_esm_inf_tpu/models/gravity_wave.py:151"),
    Client("shallow_sweep", sh, lambda n: {},
           lambda m, n: m.set_initial_eta(gaussian_eta(n, n, amp=0.3)),
           8, 404, ((lambda n: {}, 8),),
           "dl_esm_inf_tpu/models/shallow.py:102"),
    # the benchmark leaves the two-layer state at rest; a bump on each
    # interface makes the run do work
    Client("twolayer_sweep", tl, lambda n: {},
           lambda m, n: m.set_initial(gaussian_eta(n, n, amp=0.5),
                                      -gaussian_eta(n, n, amp=2.0)),
           8, 404, ((lambda n: {}, 8),),
           "dl_esm_inf_tpu/models/twolayer.py:125"),
    Client("tracer_sweep", tr, lambda n: _tracer_kw(n, "vanleer"),
           lambda m, n: m.set_initial_tracer(gaussian_eta(n, n, amp=1.0)
                                             + 0.01),
           4, 402, ((lambda n: _tracer_kw(n, "upwind"), 8),
                    (lambda n: _tracer_kw(n, "vanleer"), 4)),
           "dl_esm_inf_tpu/models/tracer.py:191"),
)


def phase_client_parity(c: Client) -> None:
    n, steps = PARITY_N, PARITY_STEPS
    worst, cases = 0.0, 0
    for kw_of, kmax in c.parity:
        for ndom in (1, 4):
            for K in range(1, kmax + 1):
                ms = [c.mod.build(n, n, ndomains=ndom, fused=f,
                                  steps_per_sweep=K, dtype=torch.float64,
                                  device=DEV, **kw_of(n))
                      for f in (True, False)]
                for m in ms:
                    c.init(m, n)
                before = c.kernel.launches
                ms[0].run(steps)
                if c.kernel.launches - before != steps // K + steps % K:
                    raise AssertionError(f"{c.name} K={K}: the fused run "
                                         "did not go through the kernel")
                ms[1].run(steps)
                d = _rel_diff(ms[0].gather(), ms[1].gather())
                if not d <= TOL_F64:
                    raise AssertionError(
                        f"{c.name} kernel vs plain f64 {n}^2 ndomains="
                        f"{ndom} K={K}: {d:.3e} > {TOL_F64}")
                worst, cases = max(worst, d), cases + 1
    print(f"{c.name} parity f64: kernel vs plain {n}^2, {cases} cases "
          f"(every K, ndomains 1 and 4), {steps} steps: max rel diff "
          f"{worst:.3e} (tol {TOL_F64})", flush=True)


def _rotating(n):
    """tests/test_tracer.py's rotating velocities."""
    x = (np.arange(n) - n / 2 + 0.5) / n
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


def _golden_cases(c: Client):
    """(label, model, nsteps, golden fields, rtol, atol, points) at the
    sizes and tolerances of the JAX package's tests; each model is
    built on the fused path at the kernel's largest K."""
    f64 = dict(dtype=torch.float64, device=DEV, fused=True)
    if c.mod is gw:
        for (nx, ny), ndom, steps, tol in (((48, 40), 1, 100, 1e-12),
                                           ((48, 40), 4, 100, 1e-12),
                                           ((128, 96), 4, 1024, 1e-11)):
            eta0 = gaussian_eta(nx, ny)
            m = gw.build(nx, ny, ndomains=ndom, dt=0.05, depth=10.0,
                         steps_per_sweep=8, **f64)
            m.set_initial_eta(eta0)
            yield (f"{nx}x{ny} ndomains={ndom}", m, steps,
                   lambda s=steps, e=eta0, nx=nx, ny=ny:
                   gw.golden_reference(e, gw.default_tmask(nx, ny), 1.0, 1.0,
                                       0.05, s, depth=10.0), tol, tol, None)
    elif c.mod is sh:
        for ndom in (1, 4):
            eta0 = gaussian_eta(32, 32, amp=0.3)
            m = sh.build(32, 32, ndomains=ndom, dt=0.02, steps_per_sweep=8,
                         **f64)
            m.set_initial_eta(eta0)
            yield (f"32x32 ndomains={ndom}", m, 200,
                   lambda e=eta0: sh.golden_reference(e, 0.02, 200), 1e-11,
                   1e-12, None)
    elif c.mod is tl:
        e1 = gaussian_eta(48, 40, amp=0.5)
        e2 = -gaussian_eta(48, 40, amp=2.0)
        for ndom in (1, 4):
            m = tl.build(48, 40, ndomains=ndom, dt=0.01, steps_per_sweep=8,
                         **f64)
            m.set_initial(e1, e2)
            yield (f"48x40 ndomains={ndom}", m, 100,
                   lambda: tl.golden_reference(e1, e2, tl.default_tmask(
                       48, 40), 1.0, 1.0, 0.01, 100), 1e-12, 1e-12, None)
    else:
        N = 32
        u, v = _rotating(N)
        c0 = gaussian_eta(N, N, amp=1.0, width=0.08) + 0.01
        tmask = gw.default_tmask(N, N)
        tmask[12:15, 18:21] = 0          # an island
        for scheme, K in (("upwind", 8), ("vanleer", 4)):
            for ndom in (1, 8):
                m = tr.build(N, N, ndomains=ndom, dt=0.2, u=u, v=v,
                             kappa=0.02, scheme=scheme, tmask=tmask,
                             steps_per_sweep=K, **f64)
                m.set_initial_tracer(c0)
                yield (f"{scheme} 32x32 ndomains={ndom}", m, 40,
                       lambda s=scheme: {"c": tr.golden_reference(
                           c0, tmask, u, v, dt=0.2, nsteps=40, kappa=0.02,
                           scheme=s)}, 0.0, 1e-12, tmask == 1)


def phase_client_golden(c: Client) -> None:
    report = []
    for label, m, steps, golden, rtol, atol, pts in _golden_cases(c):
        K = m._sweep_K
        before = c.kernel.launches
        m.run(steps)
        if c.kernel.launches - before != steps // K + steps % K:
            raise AssertionError(f"{c.name} golden {label}: launched "
                                 f"{c.kernel.launches - before} times, "
                                 f"expected {steps // K + steps % K}")
        want, got = golden(), m.gather()
        err = 0.0
        for k in want:
            g, w = (got[k], want[k]) if pts is None else (got[k][pts],
                                                         want[k][pts])
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{c.name} {label} {k}")
            err = max(err, float(np.abs(g - w).max()))
        report.append(f"{label} K={K} {steps} steps max abs {err:.2e}")
    print(f"{c.name} golden f64: " + "; ".join(report) + " (rtol/atol of "
          "the JAX package's tests)", flush=True)


def phase_client_main(c: Client) -> dict:
    N, K, n = MAIN_SIZE, c.K, c.n_main
    kern = c.kernel
    m = c.mod.build(N, N, fused=True, steps_per_sweep=K, device=DEV,
                    **c.main_kw(N))
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    c.init(m, N)
    mass0 = m.mass() if c.mod is tr else None
    torch.cuda.synchronize()
    kern.launches = 0
    m.run(n)
    torch.cuda.synchronize()
    launches = kern.launches
    if launches != n // K + n % K:
        raise AssertionError(f"{c.name} main path launched the kernel "
                             f"{launches} times, expected {n // K + n % K}")
    state = tuple(getattr(m, f).data for f in m._fields)
    for t in state:
        if tuple(t.shape) != m.grid.array_shape or not torch.isfinite(t).all():
            raise AssertionError(f"{c.name} main path state is not finite")

    mp = c.mod.build(N, N, fused=False, steps_per_sweep=K, device=DEV,
                     **c.main_kw(N))
    c.init(mp, N)
    mp.run(n)
    d_run = _rel_diff(m.gather(), mp.gather())
    if not d_run <= TOL_F32:
        raise AssertionError(f"{c.name} kernel vs plain f32 after {n} "
                             f"steps: {d_run:.3e} > {TOL_F32}")
    extra = ""
    if c.mod is tr:
        cg = m.gather()["c"][m.grid.global_tmask() == 1]
        drift = abs(m.mass() - mass0) / abs(mass0)
        extra = (f"; mass drift {drift:.2e} (f32), range [{cg.min():.4e}, "
                 f"{cg.max():.4e}]")

    # one sweep of the wrapper against its plain version, on the main
    # path's state and shapes
    sweep = m._make_sweep(K)
    aux = m._sweep_aux
    prep = m._prepare(aux)
    ker = sweep(state, aux)
    ref = stencil_sweep_reference(m._step_math, K, state, prep)
    inner = getattr(m, m._fields[0]).internal_mask.bool()
    max_abs = max(float((a - b).abs()[inner].max()) for a, b in zip(ker, ref))
    scale = max(float(b.abs()[inner].max()) for b in ref)
    if not max_abs <= TOL_F32 * scale:
        raise AssertionError(f"{c.name} one sweep kernel vs plain f32: "
                             f"{max_abs:.3e}")
    ms = _time_ms(lambda: sweep(state, aux), 200)
    plain_ms = _time_ms(lambda: stencil_sweep_reference(
        m._step_math, K, state, prep), 20)
    us_k = _run_step_us(m, 50 * K, 5)
    us_p = _run_step_us(mp, 5 * K, 3)
    print(f"{c.name} main f32 {N}^2 K={K}: run({n}) launches={launches} "
          f"(= {n}//{K} + {n}%{K}); finite; kernel vs plain after {n} "
          f"steps rel {d_run:.3e}, one sweep max abs {max_abs:.3e}{extra}",
          flush=True)
    print(f"{c.name} timing f32 {N}^2 K={K}: run on the kernel path "
          f"{us_k:.2f} us/step ({N * N / us_k:.0f} Mpt/s), on the plain "
          f"path {us_p:.2f} us/step ({N * N / us_p:.0f} Mpt/s); one sweep: "
          f"kernel {ms * 1e3:.2f} us ({ms * 1e3 / K:.2f} us/step), plain "
          f"{plain_ms * 1e3:.2f} us", flush=True)
    return {"name": c.name, "route": "cuda",
            "source": f"dl_esm_inf_tpu_torch/csrc/{kern.source}",
            "replaces": c.replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def main() -> None:
    phase_device()
    phase_build()
    phase_parity_f64()
    phase_golden()
    kernels = [phase_main()]
    for c in CLIENTS:
        phase_client_parity(c)
        phase_client_golden(c)
        kernels.append(phase_client_main(c))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
