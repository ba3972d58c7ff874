"""GPU smoke run of the PyTorch port's main path (NEMOLite2D flagship).

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the hand-written kernel from
   dl_esm_inf_tpu_torch/csrc/ with nvcc (build/torch_kernels/);
3. kernel vs plain, float64: the fused model on the kernel against the
   same model on the plain PyTorch path, 256^2 and 1024^2, K = 1..4,
   1 and 4 tiles, 101 steps from a Gaussian bump;
4. kernel vs the independent numpy golden (tests/nemolite2d_golden.py),
   float64, 10 and 1024 steps;
5. the main path, float32: build(1024, 1024, fused=True,
   steps_per_sweep=4, device="cuda"), run(n) with the launch counter
   reset just before; then the kernel against its plain version on the
   same inputs, and times on the card (CUDA events, after warm-up).

The line before the last is the kernel report as JSON; the last line is
the result as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

from dl_esm_inf_tpu_torch.models import nemolite2d as nl  # noqa: E402
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta  # noqa: E402
from dl_esm_inf_tpu_torch.ops import fused_step as fs  # noqa: E402
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


def phase_build() -> None:
    t0 = time.perf_counter()
    built = fs.nemolite2d_sweep.build()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {built.path.name} nvcc {built.seconds:.1f}s "
          f"(load {wall:.1f}s); ptxas: {' | '.join(ptxas)}", flush=True)


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


def main() -> None:
    phase_device()
    phase_build()
    phase_parity_f64()
    phase_golden()
    kernel = phase_main()
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
