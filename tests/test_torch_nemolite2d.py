"""The PyTorch port's NEMOLite2D flagship against the JAX package.

On the CPU the port's fused path runs the sweep kernel's plain version
(:func:`fused_step_reference`), so these tests pin the physics, the
K-step schedule and the exchange of the port to the JAX package at
float64 — against both its jnp path and its Pallas kernel in interpret
mode — and to the independent numpy golden.  The CUDA kernel itself is
held against the plain version by tests/test_torch_gpu.py (skipped
without a card) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta as j_gaussian
from dl_esm_inf_tpu.ops import stencils as jst
from dl_esm_inf_tpu.ops.pallas_step import make_fused_step as j_make_fused

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.interop import load_reference_state
from dl_esm_inf_tpu_torch.models import nemolite2d as tnl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.ops import fused_step as tfs
from dl_esm_inf_tpu_torch.parallel.mp_check import overlap_depth

from nemolite2d_golden import golden_run

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")

RTOL, ATOL = 1e-12, 1e-13       # as tests/test_pallas_step.py
GNX, GNY = 96, 64


def _assert_close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _block_inputs(ly, lx, seed=0):
    """A nontrivial state on one (ly, lx) block with the flagship's mask
    codes (walls, open north row), from seeded numpy."""
    rng = np.random.default_rng(seed)
    sshn = 0.2 * rng.normal(size=(ly, lx))
    un = 0.05 * rng.normal(size=(ly, lx))
    vn = 0.05 * rng.normal(size=(ly, lx))
    tm = np.zeros((ly, lx), np.int8)
    tm[2:-2, 2:-2] = tnl.default_tmask(lx - 4, ly - 4)
    codes_j = np.asarray(jnl.encode_masks(jnp.asarray(tm)))
    codes_t = tnl.encode_masks(torch.from_numpy(tm))
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    return sshn, un, vn, codes_j, codes_t


def _fcor(p):
    return float(2.0 * p.omega * np.sin(50.0 * p.d2r))


def test_step_math_matches_jax():
    sshn, un, vn, cj, ct = _block_inputs(24, 40)
    pj, pt = jnl.Params(), tnl.Params()
    want = jnl.step_math(sshn, un, vn, jnp.asarray(cj), pj, 1000.0, 1000.0,
                         _fcor(pj), 100.0, 0.03)
    got = tnl.step_math(*(torch.from_numpy(a) for a in (sshn, un, vn)), ct,
                        pt, 1000.0, 1000.0, _fcor(pt), 100.0, 0.03)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_fused_step_reference_matches_jax_sweeps(K):
    """fused_step_reference (the kernel's plain version) against JAX
    chained step_math on the whole block, and against the JAX Pallas
    sweep in interpret mode on the cells >= 2K from the block edge
    (edge cells hold each version's own wrap values)."""
    ly, lx = 32, 128
    sshn, un, vn, cj, ct = _block_inputs(ly, lx, seed=K)
    pj, pt = jnl.Params(), tnl.Params()
    forcing = [0.01 * (k + 1) for k in range(K)]
    got = tfs.fused_step_reference(
        *(torch.from_numpy(a) for a in (sshn, un, vn)), ct, forcing, p=pt,
        dx=1000.0, dy=1000.0, fcor=_fcor(pt), depth=100.0)
    s = (sshn, un, vn)
    prep = jnl.make_prep(jnp.asarray(cj), 100.0, pj, jnp.float64,
                         dx=1000.0, dy=1000.0)
    for f in forcing:
        s = jnl.step_math(*s, jnp.asarray(cj), pj, 1000.0, 1000.0,
                          _fcor(pj), 100.0, f, prep=prep)
    for w, g in zip(s, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    fused = j_make_fused(ly, lx, "float64", pj, 1000.0, 1000.0, _fcor(pj),
                         100.0, interpret=True, steps_per_sweep=K)
    pal = fused(*(jnp.asarray(a) for a in (sshn, un, vn)), jnp.asarray(cj),
                jnp.asarray(forcing))
    r = 2 * K
    for w, g in zip(pal, got):
        np.testing.assert_allclose(g.numpy()[r:-r, r:-r],
                                   np.asarray(w)[r:-r, r:-r], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("bathy", ["flat", "variable"])
@pytest.mark.parametrize("dx,dy", [(1000.0, 1500.0), (1500.0, 1000.0)])
def test_rectangular_cells_match_jax(dx, dy, bathy, K):
    """Rectangular cells: the port's fused plain path (the kernel's
    plain version) against the JAX chained jnp step and the JAX Pallas
    sweep in interpret mode (cells >= 2K from the block edge), float64,
    flat and variable depth."""
    ly, lx = 32, 128
    sshn, un, vn, cj, ct = _block_inputs(ly, lx, seed=K)
    pj, pt = jnl.Params(), tnl.Params()
    forcing = [0.01 * (k + 1) for k in range(K)]
    ht = None
    if bathy == "variable":
        ht = 60.0 + 40.0 * np.random.default_rng(K).random((ly, lx))
    got = tfs.fused_step_reference(
        *(torch.from_numpy(a) for a in (sshn, un, vn)), ct, forcing, p=pt,
        dx=dx, dy=dy, fcor=_fcor(pt), depth=100.0,
        ht=None if ht is None else torch.from_numpy(ht))
    if ht is None:
        dep = 100.0
    else:
        hj = jnp.asarray(ht)
        dep = (hj, jst.avg_x(hj), jst.avg_y(hj))
    prep = jnl.make_prep(jnp.asarray(cj), dep, pj, jnp.float64, dx=dx, dy=dy)
    s = (sshn, un, vn)
    for f in forcing:
        s = jnl.step_math(*s, jnp.asarray(cj), pj, dx, dy, _fcor(pj), dep, f,
                          prep=prep)
    for w, g in zip(s, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    fused = j_make_fused(ly, lx, "float64", pj, dx, dy, _fcor(pj), 100.0,
                         interpret=True, steps_per_sweep=K,
                         variable_bathy=ht is not None)
    pal = fused(*(jnp.asarray(a) for a in (sshn, un, vn)), jnp.asarray(cj),
                jnp.asarray(forcing),
                **({} if ht is None else {"ht": jnp.asarray(ht)}))
    r = 2 * K
    for w, g in zip(pal, got):
        np.testing.assert_allclose(g.numpy()[r:-r, r:-r],
                                   np.asarray(w)[r:-r, r:-r], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("ndom", [1, 4])
def test_rectangular_slice_matches_jax(ndom):
    """The whole slice on a rectangular-cell grid: port NemoLite2D on the
    fused plain path (K = 2, variable depth) against the JAX flagship on
    its jnp path, float64."""
    gnx, gny = 40, 30
    depth = 60.0 + 40.0 * np.random.default_rng(3).random((gny, gnx))
    jg = jdl.Grid(jdl.ARAKAWA_C, (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL,
                                  jdl.BC_NONE), jdl.OFFSET_NE)
    jg.decompose(gnx, gny, ndomains=ndom, halo_width=4)
    jdl.grid_init(jg, 1500.0, 1000.0, tnl.default_tmask(gnx, gny))
    mj = jnl.NemoLite2D(jg, depth=depth)
    mj.set_steps_per_exchange(2)
    tg = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                  tdl.BC_NONE), tdl.OFFSET_NE, **CPU)
    tg.decompose(gnx, gny, ndomains=ndom, halo_width=4)
    tdl.grid_init(tg, 1500.0, 1000.0, tnl.default_tmask(gnx, gny))
    mt = tnl.NemoLite2D(tg, depth=depth)
    mt.enable_fast_path(steps_per_sweep=2)
    for m in (mj, mt):
        m.set_initial_ssh(j_gaussian(gnx, gny, amp=0.5))
        m.run(7)
    _assert_close(mt.gather(), mj.gather())


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("ndom", [1, 4])
def test_slice_matches_jax(ndom, K, ref):
    """The whole slice: port build(fused=True) on the CPU at float64
    against the JAX flagship (Pallas sweep in interpret mode, or the jnp
    path); 7 steps leave a remainder after the K-step sweeps."""
    if ref == "pallas":
        mj = jnl.build(GNX, GNY, ndomains=ndom, pallas=True,
                       steps_per_sweep=K)
        mj.enable_pallas(interpret=True, steps_per_sweep=K)
    else:
        mj = jnl.build(GNX, GNY, ndomains=ndom)
    mt = tnl.build(GNX, GNY, ndomains=ndom, fused=True, steps_per_sweep=K,
                   **CPU)
    assert mt.grid.dtype == torch.float64 and mt.use_fused
    for m in (mj, mt):
        m.set_initial_ssh(j_gaussian(GNX, GNY, amp=0.5))
        m.run(7)
    _assert_close(mt.gather(), mj.gather())
    cj, ct = mj.checksums(), mt.checksums()
    for k in cj:
        assert ct[k] == pytest.approx(cj[k], rel=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_golden_short_horizon_tight(fused):
    """As tests/test_nemolite2d_golden.py: 10 steps, every term live."""
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = tnl.build(gnx, gny, fused=fused, steps_per_sweep=4 if fused else 1,
                  **CPU)
    m.set_initial_ssh(ssh0)
    m.run(10)
    want = golden_run(tnl.default_tmask(gnx, gny), ssh0, 10, m.p, m.grid.dx,
                      m.grid.dy, 100.0)
    _assert_close(m.gather(), want, rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("ndom", [1, 4])
def test_golden_40_steps(ndom):
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = tnl.build(gnx, gny, ndomains=ndom, fused=True, steps_per_sweep=3,
                  **CPU)
    m.set_initial_ssh(ssh0)
    m.run(40)
    want = golden_run(tnl.default_tmask(gnx, gny), ssh0, 40, m.p, m.grid.dx,
                      m.grid.dy, 100.0)
    _assert_close(m.gather(), want, rtol=1e-10, atol=1e-12)


def test_variable_bathymetry_plain_path_matches_jax():
    gnx, gny = 34, 30
    yy = np.linspace(0.0, 1.0, gny)[:, None]
    xx = np.linspace(0.0, 1.0, gnx)[None, :]
    depth = 60.0 + 50.0 * yy + 15.0 * np.sin(3.0 * np.pi * xx)
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    mj = jnl.build(gnx, gny, ndomains=4, depth=depth, halo_width=4,
                   steps_per_sweep=2)
    mt = tnl.build(gnx, gny, ndomains=4, depth=depth, halo_width=4,
                   fused=True, steps_per_sweep=2, **CPU)
    for m in (mj, mt):
        m.set_initial_ssh(ssh0)
        m.run(9)
    _assert_close(mt.gather(), mj.gather())
    want = golden_run(tnl.default_tmask(gnx, gny), ssh0, 9, mt.p, 1000.0,
                      1000.0, depth)
    _assert_close(mt.gather(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ndom", [1, 4])
def test_state_carried_from_jax(ndom):
    """JAX runs n1 steps, the port takes its state over, and both run n2
    more: the port continues the JAX trajectory."""
    n1, n2 = 5, 6
    mj = jnl.build(GNX, GNY, ndomains=ndom)
    mj.set_initial_ssh(j_gaussian(GNX, GNY, amp=0.5))
    mj.run(n1)
    mt = tnl.build(GNX, GNY, ndomains=ndom, fused=True, steps_per_sweep=2,
                   **CPU)
    state = dict(mj.gather(), tmask=tnl.default_tmask(GNX, GNY), depth=100.0)
    load_reference_state(mt, state, istep0=n1)
    _assert_close(mt.gather(), mj.gather(), rtol=0, atol=0)
    mj.run(n2)
    mt.run(n2)
    _assert_close(mt.gather(), mj.gather())
    bad = dict(state, tmask=np.zeros((GNY, GNX), np.int32))
    with pytest.raises(ValueError, match="tmask"):
        load_reference_state(mt, bad, istep0=n1)
    with pytest.raises(ValueError, match="depth"):
        load_reference_state(mt, dict(state, depth=50.0), istep0=n1)


def test_guards():
    with pytest.raises(ValueError, match="steps_per_sweep"):
        tnl.build(32, 32, fused=True, steps_per_sweep=5, **CPU)
    with pytest.raises(ValueError, match="halo_width >= 4"):
        m = tnl.build(32, 32, fused=True, **CPU)          # halo 2
        m.enable_fast_path(steps_per_sweep=2)
    m = tnl.build(32, 32, fused=True, steps_per_sweep=2, **CPU)
    with pytest.raises(ValueError, match="unknown transport"):
        m.enable_fast_path(steps_per_sweep=2, transport="carrier-pigeon")
    # the JAX package's guard (tests/test_pallas_step.py:133-136): one
    # step at a time, so no temporal blocking under overlap
    with pytest.raises(ValueError, match="overlap"):
        m.step_program(4, overlap=True)
    with pytest.raises(ValueError, match="remat"):     # no backward
        m.step_program(4, remat_chunk=2)
    fused = m._make_fused(2)
    with pytest.raises(ValueError, match="forcing"):
        fused(m.sshn_t.data, m.un.data, m.vn.data, m._mask_codes, [0.0])


# --- overlap mode (the JAX package's tests/test_nemolite2d.py:157-221) -------

#: tests/test_nemolite2d.py:187-214's extent, sloping bottom and bump;
#: across ranks (one tile per rank, 2x2) in tests/test_torch_multiprocess.py
OV_GNX, OV_GNY, OV_STEPS = 48, 40, 30


def _ov_runs(mod, depth, **kw):
    """{overlap: gathered fields after OV_STEPS of step_program} for one
    package's flagship (1 tile, halo 2, open north, from the bump)."""
    out = {}
    for ov in (False, True):
        m = mod.build(OV_GNX, OV_GNY, ndomains=1, halo_width=2,
                      open_north=True, depth=depth, **kw)
        m.set_initial_ssh(gaussian_eta(OV_GNX, OV_GNY, amp=0.5))
        bathy = (m._ht,) if m._ht is not None else ()
        istep0 = jnp.int32(0) if mod is jnl else 0
        state = m.step_program(OV_STEPS, overlap=ov)(
            istep0, (m.sshn_t.data, m.un.data, m.vn.data), m._mask_codes,
            *bathy)
        m.sshn_t.data, m.un.data, m.vn.data = state
        out[ov] = m.gather()
    return out


def _check_overlap(depth, fused):
    """Overlap equals the non-overlapped step bitwise at internal points
    (the port's invariant: each point's arithmetic is the same), and the
    JAX package's overlap run within RTOL / ATOL (its test's tolerance)."""
    got = _ov_runs(tnl, depth, fused=fused, **CPU)
    _assert_close(got[True], got[False], rtol=0, atol=0)
    want = _ov_runs(jnl, depth)[True]
    _assert_close(got[True], want)


@pytest.mark.parametrize("fused", [False, True])
def test_overlap_step_matches_plain(fused):
    """Twin of tests/test_nemolite2d.py::test_overlap_step_matches_plain
    on one tile (its 4-tile case is the 4-rank gang's overlap leg): the
    plain step and the fused K=1 sweep's plain version as the interior."""
    _check_overlap(100.0, fused)


@pytest.mark.parametrize("fused", [False, True])
def test_overlap_variable_bathymetry_matches_plain(fused):
    """Twin of tests/test_nemolite2d.py::
    test_overlap_variable_bathymetry_matches_plain on one tile."""
    _check_overlap(overlap_depth(OV_GNX, OV_GNY), fused)


def test_overlap_guards():
    """Twin of tests/test_nemolite2d.py::test_overlap_guards, with the
    rest of the JAX package's overlap guards (its models/nemolite2d.py:
    784-802): one tile per rank, not with the fused transport, halo >= 2,
    tiles >= 8x8, one step per exchange."""
    m = tnl.build(16, 16, ndomains=1, **CPU)                  # halo 1
    with pytest.raises(ValueError, match="halo_width"):
        m.step_program(1, overlap=True)
    m = tnl.build(32, 32, ndomains=4, halo_width=2, **CPU)
    with pytest.raises(NotImplementedError, match="one tile per rank"):
        m.step_program(1, overlap=True)
    m = tnl.build(12, 12, ndomains=1, halo_width=2, **CPU)
    m.step_program(1, overlap=True)
    m = tnl.build(7, 12, ndomains=1, halo_width=2, **CPU)
    with pytest.raises(ValueError, match="8x8"):
        m.step_program(1, overlap=True)
    m = tnl.build(32, 32, ndomains=1, halo_width=8, **CPU)
    m.enable_fast_path(2, transport="fused")
    with pytest.raises(ValueError, match="redundant"):
        m.step_program(2, overlap=True)


def test_overlap_remat_composes():
    """``remat_chunk`` composes with overlap as in the JAX package: the
    forward bitwise unchanged, and the gradient of the surface's energy
    after 6 steps with respect to the initial surface equal to the
    non-overlapped step's within 1e-12 relative."""
    m = tnl.build(OV_GNX, OV_GNY, ndomains=1, halo_width=2, open_north=True,
                  **CPU)
    m.set_initial_ssh(gaussian_eta(OV_GNX, OV_GNY, amp=0.5))
    rng = np.random.default_rng(5)
    bump = torch.from_numpy(0.01 * rng.standard_normal(m.sshn_t.data.shape))
    grads, fwd = [], []
    for ov, ck in ((False, None), (True, None), (True, 2)):
        x = (m.sshn_t.data + bump).requires_grad_(True)
        out = m.step_program(6, overlap=ov, remat_chunk=ck)(
            0, (x, m.un.data, m.vn.data), m._mask_codes)
        inner = m.sshn_t.internal_mask.bool()
        loss = (out[0][inner] ** 2).sum()
        (g,) = torch.autograd.grad(loss, x)
        fwd.append(out[0].detach()[inner])
        grads.append(g[inner])
    assert torch.equal(fwd[1], fwd[0]) and torch.equal(fwd[2], fwd[1])
    assert torch.equal(grads[2], grads[1])
    scale = float(grads[0].abs().max())
    assert scale > 0
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-12 * scale


def test_wrapper_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never taken for it."""
    ly, lx = 8, 8
    meta = [torch.empty((ly, lx), dtype=torch.float64, device="meta")
            for _ in range(3)]
    codes = torch.empty((ly, lx), dtype=torch.int8, device="meta")
    fused = tfs.make_fused_step(ly, lx, torch.float64, tnl.Params(), 1000.0,
                                1000.0, 1e-4, 100.0)
    before = tfs.nemolite2d_sweep.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused(*meta, codes, [0.0])
    assert tfs.nemolite2d_sweep.launches == before


def test_cli_runs_on_cpu(capsys):
    tnl.main(["24", "10", "cpu"])
    out = capsys.readouterr().out
    assert out.count("step ") == 5 and "fused=True" in out
