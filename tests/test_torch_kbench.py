"""The port's kernel-variant microbench against the JAX package's.

``dl_esm_inf_tpu_torch/ops/fused_step.py::make_variant`` and
``python -m dl_esm_inf_tpu_torch.kbench`` against
``scripts/kbench.py::make_variant``, loaded by path with its compile
cache switched off and its ``pallas_call`` run in TPU interpret mode.
On the CPU the variants run their plain versions: ``dma`` equals the
JAX ``dma`` mode exactly, ``prod`` the JAX ``full`` mode on internal
points, and ``compute`` a JAX reference built from the JAX package's
``step_math`` per window with the same update regions, at 1e-12
(float64).  The CUDA variant kernels are held against these plain
versions by tests/test_torch_gpu.py and ``chip_smoke.py`` on the card.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.utils import compilation_cache

from dl_esm_inf_tpu_torch import kbench
from dl_esm_inf_tpu_torch.models import nemolite2d as tnl
from dl_esm_inf_tpu_torch.ops import fused_step as tfs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-12, 1e-13
DX = 1000.0
#: compute_fast against compute: relative to the field's max |value| on
#: internal points, per pass of the K sub-steps (chip_smoke.TOL_FAST)
TOL_FAST = 1e-6


@pytest.fixture
def jax_kbench(monkeypatch):
    """scripts/kbench.py, loaded by path, with its compile cache switched
    off and every pallas_call in TPU interpret mode."""
    monkeypatch.setattr(compilation_cache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_kbench", REPO / "scripts" / "kbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    return mod


def _fcor(p):
    return float(2.0 * p.omega * np.sin(50.0 * p.d2r))


def _block(ly, lx, seed=0):
    """A seeded state on one block with the flagship's mask codes (walls,
    open north row) inside a dry rim."""
    rng = np.random.default_rng(seed)
    state = [a * rng.standard_normal((ly, lx)) for a in (0.2, 0.05, 0.05)]
    tm = np.zeros((ly, lx), np.int8)
    tm[2:-2, 2:-2] = tnl.default_tmask(lx - 4, ly - 4)
    codes = tnl.encode_masks(torch.from_numpy(tm))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jnl.encode_masks(jnp.asarray(tm))))
    return state, codes


def _port(state, codes, dtype, K, mode, forcing, reps=1):
    ly, lx = state[0].shape
    var = tfs.make_variant(ly, lx, dtype, tnl.Params(), DX, DX,
                           _fcor(tnl.Params()), 100.0, K, mode)
    return var(*(torch.from_numpy(a).to(dtype) for a in state), codes,
               forcing, reps=reps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dma_matches_jax_make_variant(jax_kbench, dtype):
    """Plain dma at K = 1 is the JAX dma mode, x + f, exactly."""
    state, codes = _block(64, 64)
    jdt = jnp.dtype(str(dtype).removeprefix("torch."))
    p = jnl.Params()
    var = jax_kbench.make_variant(64, 64, jdt, p, DX, DX, _fcor(p), 100.0,
                                  32, "dma")
    want = var(jnp.asarray([0.01], jdt), *(jnp.asarray(a, jdt) for a in
                                           state), jnp.asarray(codes.numpy()))
    got = _port(state, codes, dtype, 1, "dma", [0.01])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [64, 66])
def test_prod_matches_jax_full(jax_kbench, n):
    """Plain prod at K = 1 (the production sweep's plain version) is the
    JAX full mode on internal points (float64; each version's edge rows
    and columns hold its own wrap values)."""
    state, codes = _block(n, n, seed=1)
    p = jnl.Params()
    var = jax_kbench.make_variant(n, n, jnp.float64, p, DX, DX, _fcor(p),
                                  100.0, 32, "full")
    want = var(jnp.asarray([0.03]), *(jnp.asarray(a) for a in state),
               jnp.asarray(codes.numpy()))
    got = _port(state, codes, torch.float64, 1, "prod", [0.03])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[2:-2, 2:-2],
                                   np.asarray(w)[2:-2, 2:-2], rtol=RTOL,
                                   atol=ATOL)


def _jax_compute(state, codes, forcing, reps):
    """The compute variant from the JAX package's step_math and
    make_prep, applied per window (vmap) with the kernel's staging (the
    port's tile at float64 + 2K ring, reads clamped to the block), update
    regions (continuity 2k+1, momentum 2k+2 cells inside) and scratch
    planes (copies of the staged state, swapped with the state every
    sub-step)."""
    K = len(forcing)
    ly, lx = state[0].shape
    t = tfs.tile(torch.float64, K)
    R, wy, wx = 2 * K, t.ty + 4 * K, t.tx + 4 * K
    nty, ntx = -(-ly // t.ty), -(-lx // t.tx)
    ry = np.clip(np.arange(nty)[:, None] * t.ty - R + np.arange(wy), 0,
                 ly - 1)
    rx = np.clip(np.arange(ntx)[:, None] * t.tx - R + np.arange(wx), 0,
                 lx - 1)

    def windows(a):
        return jnp.asarray(a[ry[:, None, :, None], rx[None, :, None, :]]
                           .reshape(nty * ntx, wy, wx))
    iy, ix = np.arange(wy), np.arange(wx)
    inset = [jnp.asarray(((iy >= r) & (iy < wy - r))[:, None]
                         & ((ix >= r) & (ix < wx - r))[None, :])
             for r in range(2 * K + 1)]
    p = jnl.Params()

    def one(ssh, u, v, c):
        prep = jnl.make_prep(c, 100.0, p, jnp.float64, dx=DX, dy=DX)
        s_ssh, s_u, s_v = ssh, u, v
        for _ in range(reps):
            for k, f in enumerate(forcing):
                a, ua, va = jnl.step_math(ssh, u, v, c, p, DX, DX, _fcor(p),
                                          100.0, f, prep=prep)
                s_ssh = jnp.where(inset[2 * k + 1], a, s_ssh)
                s_u = jnp.where(inset[2 * k + 2], ua, s_u)
                s_v = jnp.where(inset[2 * k + 2], va, s_v)
                ssh, s_ssh = s_ssh, ssh
                u, s_u = s_u, u
                v, s_v = s_v, v
        return ssh, u, v

    out = jax.vmap(one)(*(windows(a) for a in state),
                        windows(codes.numpy()))
    return [np.asarray(o)[:, R:R + t.ty, R:R + t.tx]
            .reshape(nty, ntx, t.ty, t.tx).transpose(0, 2, 1, 3)
            .reshape(nty * t.ty, ntx * t.tx)[:ly, :lx] for o in out]


@pytest.mark.parametrize("K,reps", [(1, 1), (2, 3), (3, 1), (4, 2)])
def test_compute_matches_jax_step_math_per_window(K, reps):
    state, codes = _block(70, 66, seed=K)
    forcing = [0.01 * (k + 1) for k in range(K)]
    got = _port(state, codes, torch.float64, K, "compute", forcing, reps)
    want = _jax_compute(state, codes, forcing, reps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_compute_one_pass_is_the_production_sweep(K, dtype):
    """compute(reps=1) equals fused_step_reference on every cell 2K or
    more from the block edge (the kernels also agree on the rest)."""
    state, codes = _block(70, 66, seed=10 + K)
    forcing = [0.02 * (k + 1) for k in range(K)]
    got = _port(state, codes, dtype, K, "compute", forcing)
    p = tnl.Params()
    want = tfs.fused_step_reference(
        *(torch.from_numpy(a).to(dtype) for a in state), codes, forcing, p=p,
        dx=DX, dy=DX, fcor=_fcor(p), depth=100.0)
    r = 2 * K
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[r:-r, r:-r],
                                      w.numpy()[r:-r, r:-r])


@pytest.mark.parametrize("reps", [1, 3])
def test_compute_fast_within_tolerance(reps):
    """compute_fast (the Newton step on the reciprocal) stays within
    TOL_FAST per pass of compute, relative, on internal points."""
    state, codes = _block(70, 66, seed=7)
    forcing = [0.01, 0.02]
    fast = _port(state, codes, torch.float32, 2, "compute_fast", forcing,
                 reps)
    exact = _port(state, codes, torch.float32, 2, "compute", forcing, reps)
    for f, e in zip(fast, exact):
        assert torch.isfinite(f).all()
        rel = ((f - e)[4:-4, 4:-4].abs().max()
               / e[4:-4, 4:-4].abs().max())
        assert rel <= TOL_FAST * reps
    x = torch.tensor([0.5, 3.0, 97.25], dtype=torch.float64)
    assert torch.allclose(tnl._recip_fast(x), 1.0 / x, rtol=1e-15, atol=0)


def test_cli_runs_on_cpu(capsys):
    res = kbench.main(["--device", "cpu", "--n", "32", "--ks", "1,2"])
    out = capsys.readouterr().out
    assert sorted(res) == [1, 2]
    assert all(sorted(r) == sorted(kbench.MODES) for r in res.values())
    assert out.count("us/step") == 10 and out.count("split") == 2
    assert "cpu (plain versions)" in out


def test_guards():
    p, f = tnl.Params(), _fcor(tnl.Params())
    args = (40, 40, torch.float64, p, DX, DX, f, 100.0)
    with pytest.raises(ValueError, match="unknown mode"):
        tfs.make_variant(*args, 1, "carrier-pigeon")
    with pytest.raises(ValueError, match="Mosaic"):
        tfs.make_variant(*args, 1, "tight")
    with pytest.raises(ValueError, match="float32"):
        tfs.make_variant(*args, 1, "compute_fast")
    with pytest.raises(ValueError, match="steps_per_sweep"):
        tfs.make_variant(*args, 5, "dma")
    state, codes = _block(40, 40)
    s = [torch.from_numpy(a) for a in state]
    with pytest.raises(ValueError, match="reps"):
        tfs.make_variant(*args, 1, "dma")(*s, codes, [0.0], reps=2)
    with pytest.raises(ValueError, match="reps"):
        tfs.make_variant(*args, 1, "prod")(*s, codes, [0.0], reps=2)
    with pytest.raises(ValueError, match="forcing"):
        tfs.make_variant(*args, 2, "compute")(*s, codes, [0.0])


def test_variant_wrapper_never_falls_back():
    """A tensor that is not on the CPU goes to the variant kernel or
    raises; the plain version is never taken for it."""
    meta = [torch.empty((8, 8), dtype=torch.float32, device="meta")
            for _ in range(3)]
    codes = torch.empty((8, 8), dtype=torch.int8, device="meta")
    for mode, kern in tfs.VARIANT_KERNELS.items():
        var = tfs.make_variant(8, 8, torch.float32, tnl.Params(), DX, DX,
                               1e-4, 100.0, 1, mode)
        before = kern.launches
        with pytest.raises(ValueError, match="CUDA"):
            var(*meta, codes, [0.0])
        assert kern.launches == before


def test_sweep_probe_needs_the_card(monkeypatch):
    """The flagship probe times the card only: without one it exits
    before it builds or times anything."""
    import sys
    from dl_esm_inf_tpu_torch import sweep_probe
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        sweep_probe.main(["--n", "32"])
