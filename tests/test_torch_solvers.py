"""The PyTorch port's elliptic-solver path against the JAX package.

``ops/solvers.py`` (PCG, Chebyshev, the fused Chebyshev sweep's plain
version, iterative refinement) and ``models/semi_implicit.py``, with the
same seeded numpy inputs through both packages, at float64 unless
stated.  On the CPU the fused solver runs its sweep kernel's plain
version (``cheb_step`` K times per pass); the CUDA kernel itself is held
against that plain version by tests/test_torch_gpu.py (skipped without
a card) and by ``chip_smoke.py``.

Tolerances, stated per test:
* port vs JAX, Chebyshev and the semi-implicit model: atol 1e-12 (the
  same operations in the same order; CG's dot products sum in another
  order, an ulp per iteration);
* port vs the dense numpy solve: 1e-10 on converged solves at tol
  1e-12, as tests/test_solvers.py;
* fused plain sweep vs the JAX Pallas sweep in interpret mode at f32:
  atol 5e-6, tests/test_solvers.py's bound for the fused vs plain
  iteration at f32.
"""
import numpy as np
import pytest
import torch

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.core import layout as jlayout
from dl_esm_inf_tpu.models import semi_implicit as jsi
from dl_esm_inf_tpu.ops import solvers as jso

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.core import layout as tlayout
from dl_esm_inf_tpu_torch.interop import load_reference_state
from dl_esm_inf_tpu_torch.models import semi_implicit as tsi
from dl_esm_inf_tpu_torch.ops import solvers as tso

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")


def dense_solve(act, lam_x, lam_y, b, wrap=False):
    """Independent dense construction of (I + lam*L) with no-flux walls
    (and optional periodic wrap), solved by numpy (a copy of
    tests/test_solvers.py's).  ``lam_x``/``lam_y`` are scalars or
    per-face arrays (NE convention: ``lam_x[j, i]`` is the face between
    cells (j, i) and (j, i+1))."""
    gny, gnx = act.shape
    n = gny * gnx
    A = np.eye(n)

    def idx(j, i):
        return j * gnx + i

    def face(lam, dj, di, j, i):
        if np.isscalar(lam):
            return lam
        if di == 1 or dj == 1:
            return lam[j, i]
        if di == -1:
            return lam[j, (i - 1) % gnx]
        return lam[(j - 1) % gny, i]

    for j in range(gny):
        for i in range(gnx):
            if not act[j, i]:
                continue
            for dj, di, lam in ((0, 1, lam_x), (0, -1, lam_x),
                                (1, 0, lam_y), (-1, 0, lam_y)):
                jj, ii = j + dj, i + di
                if wrap:
                    jj, ii = jj % gny, ii % gnx
                elif not (0 <= jj < gny and 0 <= ii < gnx):
                    continue
                if act[jj, ii]:
                    lv = face(lam, dj, di, j, i)
                    A[idx(j, i), idx(j, i)] += lv
                    A[idx(j, i), idx(jj, ii)] -= lv
    return np.linalg.solve(A, b.ravel()).reshape(gny, gnx)


def _island_tmask(gnx, gny, wrap=False):
    t = np.ones((gny, gnx), np.int32)
    if not wrap:
        t[0, :] = t[-1, :] = 0
        t[:, 0] = t[:, -1] = 0
    t[gny // 3: gny // 3 + 3, gnx // 3: gnx // 3 + 3] = 0   # an island
    return t


def _grids(gnx, gny, ndom, tmask, halo=1, wrap=False, dtype="float64"):
    """The same grid in both packages."""
    bc = (jdl.BC_PERIODIC if wrap else jdl.BC_EXTERNAL)
    gj = jdl.Grid(jdl.ARAKAWA_C, (bc, bc, jdl.BC_NONE), jdl.OFFSET_NE,
                  dtype=dtype)
    gj.decompose(gnx, gny, ndomains=ndom, halo_width=halo)
    jdl.grid_init(gj, 1.0, 1.0, tmask)
    tbc = (tdl.BC_PERIODIC if wrap else tdl.BC_EXTERNAL)
    gt = tdl.Grid(tdl.ARAKAWA_C, (tbc, tbc, tdl.BC_NONE), tdl.OFFSET_NE,
                  dtype=dtype, **CPU)
    gt.decompose(gnx, gny, ndomains=ndom, halo_width=halo)
    tdl.grid_init(gt, 1.0, 1.0, tmask)
    return gj, gt


def _solve_both(gj, gt, b, lam_x, lam_y, **kw):
    sj = jso.HelmholtzSolver(gj, lam_x, lam_y, **kw)
    st = tso.HelmholtzSolver(gt, lam_x, lam_y, **kw)
    xj, ij = sj.solve(jdl.Field(gj, jdl.T_POINTS, init_global_data=b))
    xt, it = st.solve(tdl.Field(gt, tdl.T_POINTS, init_global_data=b))
    return (jlayout.unstack_internal(gj.decomp, np.asarray(xj)), ij,
            tlayout.unstack_internal(gt.decomp, xt.numpy()), it)


CASES = [  # (method, K, ndom, wrap, per-face lam)
    ("cg", 1, 1, False, False),
    ("cg", 1, 4, False, False),
    ("cg", 1, 4, True, False),
    ("cg", 1, 4, False, True),
    ("chebyshev", 1, 1, False, False),
    ("chebyshev", 1, 4, True, False),
    ("chebyshev", 1, 4, False, True),
    ("chebyshev", 4, 4, False, False),
    ("chebyshev", 4, 1, True, False),
]


@pytest.mark.parametrize("method,K,ndom,wrap,face", CASES)
def test_helmholtz_matches_jax_and_dense(method, K, ndom, wrap, face):
    """Port vs JAX solver (atol 1e-12, equal iteration counts) and vs the
    dense numpy solve (1e-10), at 1 and 4 tiles, walled and periodic,
    scalar and per-face couplings."""
    gnx, gny = 20, 16
    tmask = _island_tmask(gnx, gny, wrap)
    act = tmask == 1
    rng = np.random.default_rng(K + 10 * ndom + 100 * wrap + 1000 * face)
    b = rng.standard_normal((gny, gnx)) * act
    if face:
        lam_x = rng.uniform(0.5, 8.0, (gny, gnx))
        lam_y = rng.uniform(0.5, 8.0, (gny, gnx))
    else:
        lam_x = lam_y = 3.0 if wrap else 7.3
    gj, gt = _grids(gnx, gny, ndom, tmask, halo=K, wrap=wrap)
    xj, ij, xt, it = _solve_both(gj, gt, b, lam_x, lam_y, tol=1e-12,
                                 method=method, steps_per_exchange=K)
    assert it["converged"] and ij["converged"], (it, ij)
    assert it["iterations"] == ij["iterations"]
    assert it["rel_res"] == pytest.approx(ij["rel_res"], rel=1e-3)
    np.testing.assert_allclose(xt * act, xj * act, rtol=0, atol=1e-12)
    xd = dense_solve(act, lam_x, lam_y, b, wrap=wrap)
    assert np.abs((xt - xd) * act).max() < 1e-10


@pytest.mark.parametrize("ndom,K", [(1, 4), (4, 2), (4, 8)])
def test_fused_plain_sweep_matches_plain_chebyshev(ndom, K):
    """The fused path's sweep on the CPU (the kernel's plain version)
    against the port's own plain Chebyshev iteration at an equal
    iteration count: 1e-12 at f64."""
    gnx, gny = 40, 32
    tmask = _island_tmask(gnx, gny)
    b = np.random.default_rng(ndom).standard_normal((gny, gnx)) * (tmask == 1)
    _, gt = _grids(gnx, gny, ndom, tmask, halo=K)
    xs = []
    for fused in (True, False):
        s = tso.HelmholtzSolver(gt, 6.0, 4.0, method="chebyshev",
                                steps_per_exchange=K, fused=fused,
                                maxiter=8 * K, tol=1e-30)
        x, info = s.solve(tdl.Field(gt, tdl.T_POINTS, init_global_data=b))
        assert info["iterations"] == 8 * K
        xs.append(tlayout.unstack_internal(gt.decomp, x.numpy()))
    np.testing.assert_allclose(xs[0], xs[1], rtol=0, atol=1e-12)


def test_fused_plain_sweep_matches_jax_pallas_interpret():
    """The port's fused solve (plain sweep on the CPU) against the JAX
    fused solve (its Pallas sweep in interpret mode) at float32, K=4:
    atol 5e-6, as tests/test_solvers.py holds the JAX fused iteration
    to its plain one."""
    N, K = 64, 4
    tmask = np.ones((N, N), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    tmask[20:30, 25:40] = 0
    b = (np.random.default_rng(5).standard_normal((N, N))
         * (tmask == 1)).astype(np.float32)
    gj = jdl.Grid(jdl.ARAKAWA_C, (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL,
                                  jdl.BC_NONE), jdl.OFFSET_NE,
                  dtype="float32")
    gj.decompose(N, N, ndomains=1, halo_width=K, align=128, align_y=8)
    jdl.grid_init(gj, 1.0, 1.0, tmask)
    sj = jso.HelmholtzSolver(gj, 6.0, 6.0, maxiter=32, tol=1e-30,
                             method="chebyshev", steps_per_exchange=K,
                             pallas=True, pallas_interpret=True)
    xj, ij = sj.solve(jdl.Field(gj, jdl.T_POINTS, init_global_data=b))
    _, gt = _grids(N, N, 1, tmask, halo=K, dtype="float32")
    st = tso.HelmholtzSolver(gt, 6.0, 6.0, maxiter=32, tol=1e-30,
                             method="chebyshev", steps_per_exchange=K,
                             fused=True)
    xt, it = st.solve(tdl.Field(gt, tdl.T_POINTS, init_global_data=b))
    assert it["iterations"] == ij["iterations"] == 32
    assert xt.dtype == torch.float32
    np.testing.assert_allclose(
        tlayout.unstack_internal(gt.decomp, xt.numpy()),
        jlayout.unstack_internal(gj.decomp, np.asarray(xj)), rtol=0,
        atol=5e-6)


def test_cheb_sweep_constants_and_scalars():
    """The per-sweep constants the kernel reads: lam_x, lam_y, then the
    sweep's c1 and c2 rows padded to RING; the scalars equal the JAX
    package's."""
    sc = tso.chebyshev_scalars(1.0, 25.0, 12)
    np.testing.assert_array_equal(sc, jso.chebyshev_scalars(1.0, 25.0, 12))
    c = tso.cheb_sweep_constants(6.0, 4.0, sc[4:7])
    assert len(c) == 2 + 2 * tso.RING
    assert c[:2] == [6.0, 4.0]
    assert c[2:5] == sc[4:7, 0].tolist() and c[5:10] == [0.0] * 5
    assert c[10:13] == sc[4:7, 1].tolist() and c[13:] == [0.0] * 5
    assert tso.chebyshev_iterations(1.0, 401.0, 5.96e-6) == \
        jso.chebyshev_iterations(1.0, 401.0, 5.96e-6)
    for dt in ("float32", "float64"):
        assert tso.default_tol(dt) == jso.default_tol(np.dtype(dt))


def test_coefficients_and_codes_match_jax():
    """helmholtz_coefficients (halo cells included) and the fused path's
    4-bit face code, periodic with 4 tiles and a deep halo."""
    tmask = _island_tmask(24, 16, wrap=True)
    gj, gt = _grids(24, 16, 4, tmask, halo=3, wrap=True)
    lam_x = np.random.default_rng(3).uniform(0.5, 4.0, (16, 24))
    cj = jso.helmholtz_coefficients(gj, lam_x, 2.5,
                                    diag_extra=np.full((16, 24), 0.25))
    ct = tso.helmholtz_coefficients(gt, lam_x, 2.5,
                                    diag_extra=np.full((16, 24), 0.25))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sj = jso.HelmholtzSolver(gj, 2.0, 3.0, method="chebyshev",
                             steps_per_exchange=3, pallas=True,
                             pallas_interpret=True)
    stt = tso.HelmholtzSolver(gt, 2.0, 3.0, method="chebyshev",
                              steps_per_exchange=3, fused=True)
    np.testing.assert_array_equal(stt._codes.numpy(), np.asarray(sj._codes))


def test_explicit_maxiter_is_a_hard_cap():
    """With steps_per_exchange, an explicit maxiter rounds DOWN to a K
    multiple (65 -> 64), on the plain and the fused path, as the JAX
    package does."""
    tmask = _island_tmask(24, 24)
    b = np.zeros((24, 24))
    b[5, 5] = 1.0
    gj, gt = _grids(24, 24, 4, tmask, halo=4)
    _, ij, _, it = _solve_both(gj, gt, b, 3.0, 3.0, tol=1e-13, maxiter=65,
                               method="chebyshev", steps_per_exchange=4)
    assert it["iterations"] == ij["iterations"] == 64
    s = tso.HelmholtzSolver(gt, 3.0, 3.0, tol=1e-13, maxiter=65,
                            method="chebyshev", steps_per_exchange=4,
                            fused=True)
    fb = tdl.Field(gt, tdl.T_POINTS, init_global_data=b)
    assert s.solve(fb)[1]["iterations"] == 64
    # the CG-sized default maxiter does not cap the Chebyshev count
    s = tso.HelmholtzSolver(gt, 300.0, 300.0, tol=1e-12, method="chebyshev")
    assert s.niters() > s.maxiter


def test_cg_zero_rhs_unpreconditioned_and_iteration_cap():
    tmask = _island_tmask(16, 16)
    act = tmask == 1
    b = np.random.default_rng(2).standard_normal((16, 16)) * act
    gj, gt = _grids(16, 16, 4, tmask)
    xj, ij, xt, it = _solve_both(gj, gt, b, 2.0, 2.0, tol=1e-12,
                                 precondition=False)
    assert it["iterations"] == ij["iterations"]
    np.testing.assert_allclose(xt * act, xj * act, rtol=0, atol=1e-12)
    s = tso.HelmholtzSolver(gt, 2.0, 2.0, tol=1e-12)
    z, zinfo = s.solve(np.zeros(gt.array_shape))
    assert zinfo["iterations"] == 0 and float(z.abs().max()) == 0.0
    capped = tso.HelmholtzSolver(gt, 2.0, 2.0, tol=1e-12, maxiter=3)
    _, cinfo = capped.solve(tdl.Field(gt, tdl.T_POINTS, init_global_data=b))
    assert cinfo["iterations"] == 3 and not cinfo["converged"]


def test_solver_guards():
    tmask = _island_tmask(16, 16)
    _, gt = _grids(16, 16, 4, tmask)
    with pytest.raises(ValueError, match="chebyshev"):
        tso.HelmholtzSolver(gt, 1.0, 1.0, steps_per_exchange=2)
    with pytest.raises(ValueError, match="halo_width"):
        tso.HelmholtzSolver(gt, 1.0, 1.0, method="chebyshev",
                            steps_per_exchange=2)
    with pytest.raises(ValueError, match="method"):
        tso.HelmholtzSolver(gt, 1.0, 1.0, method="sor")
    with pytest.raises(ValueError, match="chebyshev"):
        tso.HelmholtzSolver(gt, 1.0, 1.0, fused=True)
    with pytest.raises(NotImplementedError, match="SCALAR"):
        tso.HelmholtzSolver(gt, np.ones((16, 16)), 1.0, method="chebyshev",
                            fused=True)
    _, g9 = _grids(32, 32, 1, _island_tmask(32, 32), halo=9)
    with pytest.raises(ValueError, match="1..8"):
        tso.HelmholtzSolver(g9, 1.0, 1.0, method="chebyshev",
                            steps_per_exchange=9, fused=True)
    bare = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                    tdl.BC_NONE), tdl.OFFSET_NE, **CPU)
    with pytest.raises(ValueError, match="grid_init"):
        tso.HelmholtzSolver(bare, 1.0, 1.0)


def test_fused_sweep_has_no_fallback():
    """A tensor that is not on the CPU goes to the kernel or raises: the
    plain version is never taken for it, and nothing is counted."""
    _, gt = _grids(16, 16, 1, _island_tmask(16, 16), halo=2)
    s = tso.HelmholtzSolver(gt, 1.0, 1.0, method="chebyshev",
                            steps_per_exchange=2, fused=True)
    meta = [torch.empty((18, 18), dtype=torch.float64, device="meta")
            for _ in range(3)]
    kern = tso.helmholtz_cheb_sweep
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        s._make_cheb_sweep(2)(*meta, np.ones((2, 2)))
    with pytest.raises(ValueError, match="sub-steps"):
        kern(meta, (), torch.empty((18, 18), dtype=torch.int8,
                                   device="meta"),
             consts=[0.0] * 18, K=9)
    assert kern.launches == before


def test_solve_refined_reaches_f64_accuracy():
    """float32 correction solves + float64 residuals recover f64-level
    accuracy (tests/test_solvers.py's bounds), and match the JAX
    refinement's iteration count."""
    rng = np.random.default_rng(7)
    tmask = _island_tmask(20, 20)
    act = tmask == 1
    b = (rng.standard_normal((20, 20)) * act).astype(
        np.float32).astype(np.float64)
    xd = dense_solve(act, 5.0, 5.0, b)
    gj, gt = _grids(20, 20, 4, tmask, dtype="float32")
    s = tso.HelmholtzSolver(gt, 5.0, 5.0)
    fb = tdl.Field(gt, tdl.T_POINTS, init_global_data=b)
    x32, _ = s.solve(fb)
    err32 = np.abs((tlayout.unstack_internal(gt.decomp, x32.numpy()) - xd)
                   * act).max()
    x64, info = s.solve_refined(fb, refine=2)
    err64 = np.abs((tlayout.unstack_internal(gt.decomp, x64.numpy()) - xd)
                   * act).max()
    assert x64.dtype == torch.float64
    assert err64 < 1e-12
    assert err64 < 1e-5 * max(err32, 1e-12)
    assert info["refined_rel_res"] < 1e-13 and info["converged"]
    _, jinfo = jso.HelmholtzSolver(gj, 5.0, 5.0).solve_refined(
        jdl.Field(gj, jdl.T_POINTS, init_global_data=b), refine=2)
    assert abs(info["iterations"] - jinfo["iterations"]) <= 3
    _, g64 = _grids(16, 16, 4, _island_tmask(16, 16))
    with pytest.raises(ValueError, match="4-byte"):
        tso.HelmholtzSolver(g64, 1.0, 1.0).solve_refined(
            np.zeros(g64.array_shape))


# ---------------------------------------------------------------------
# the semi-implicit model

N_SI = 32


def _ridge(n):
    ht = np.full((n, n), 20.0)
    ht[:, n // 3: 2 * n // 3] = 2.0
    return ht


SI_CASES = {
    "cg": dict(),
    "chebyshev": dict(solver="chebyshev"),
    "cg_ridge": dict(depth=_ridge(N_SI)),
    "chebyshev_ridge": dict(solver="chebyshev", depth=_ridge(N_SI)),
    "open_north": dict(open_north=True, bc_amp=0.05, bc_omega=0.3),
}


@pytest.mark.parametrize("name", SI_CASES)
def test_semi_implicit_matches_jax(name):
    """20 implicit steps at 4 tiles from the same bump: the port equals
    the JAX model to atol 1e-12 (solver tol 1e-12), with the same
    solver iteration count and mass."""
    kw = SI_CASES[name]
    e0 = jsi.gaussian_eta(N_SI, N_SI, amp=0.6)
    mj = jsi.build(N_SI, N_SI, ndomains=4, dt=1.0, tol=1e-12, **kw)
    mt = tsi.build(N_SI, N_SI, ndomains=4, dt=1.0, tol=1e-12, **kw, **CPU)
    for m in (mj, mt):
        m.set_initial_eta(e0)
    ij, it = mj.run(20), mt.run(20)
    assert it == ij
    gj, gt = mj.gather(), mt.gather()
    for k in gj:
        assert np.all(np.isfinite(gt[k])), k
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    assert mt.mass() == pytest.approx(mj.mass(), rel=1e-12)
    for k, v in mj.checksums().items():
        assert mt.checksums()[k] == pytest.approx(v, rel=1e-12)


def test_semi_implicit_conserves_mass_beyond_cfl():
    """Wave CFL ~ 20: Crank-Nicolson stays bounded and conserves mass
    to solver tolerance (no-flux faces telescope), as
    tests/test_solvers.py pins for the JAX model."""
    N = 40
    m = tsi.build(N, N, ndomains=4, dt=2.0, depth=10.0, tol=1e-10, **CPU)
    m.set_initial_eta(tsi.gaussian_eta(N, N, amp=1.0))
    m.run(3)
    m0 = m.mass()
    m.run(40)
    g = m.gather()
    assert np.isfinite(g["eta"]).all() and np.abs(g["eta"]).max() < 2.0
    assert abs(m.mass() - m0) <= 1e-8 * max(abs(m0), 1.0)


def test_semi_implicit_state_carried_from_jax():
    """JAX runs 6 steps with a time-dependent open boundary; the port
    takes over eta/u/v, the depth and the clock, and both run 8 more."""
    kw = dict(ndomains=4, dt=1.0, tol=1e-12, open_north=True, bc_amp=0.05,
              bc_omega=0.3, depth=_ridge(N_SI))
    mj = jsi.build(N_SI, N_SI, **kw)
    mj.set_initial_eta(jsi.gaussian_eta(N_SI, N_SI, amp=0.6))
    mj.run(6)
    mt = tsi.build(N_SI, N_SI, **kw, **CPU)
    state = dict(mj.gather(), depth=_ridge(N_SI),
                 tmask=mt.grid.global_tmask())
    load_reference_state(mt, state, istep0=6)
    assert mt._istep0 == 6
    mj.run(8)
    mt.run(8)
    gj, gt = mj.gather(), mt.gather()
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    with pytest.raises(ValueError, match="depth"):
        load_reference_state(mt, dict(state, depth=10.0))


def test_semi_implicit_guards():
    with pytest.raises(ValueError, match="solver='cg'"):
        tsi.build(16, 16, solver="chebyshev", differentiable=True, **CPU)
    assert tsi.build(16, 16, differentiable=True, **CPU).differentiable
    with pytest.raises(ValueError, match="solver"):
        tsi.build(16, 16, solver="jacobi", **CPU)
    with pytest.raises(ValueError, match="theta"):
        tsi.build(16, 16, theta=0.4, **CPU)
    with pytest.raises(ValueError, match="positive"):
        tsi.build(16, 16, depth=np.zeros((16, 16)), **CPU)
    with pytest.raises(ValueError, match="gny"):
        tsi.build(16, 16, depth=np.ones((3, 3)), **CPU)
    m = tsi.build(16, 16, **CPU)
    m.set_initial_eta(np.ones((16, 16)))
    state = (m.eta.data, m.u.data, m.v.data)
    for a, b in zip(m.step_program(2)(0, *state),
                    m.step_program(2, remat_chunk=1)(0, *state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    grid = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_PERIODIC,
                                    tdl.BC_NONE), tdl.OFFSET_NE, **CPU)
    grid.decompose(16, 16)
    tdl.grid_init(grid, 1.0, 1.0)
    with pytest.raises(ValueError, match="periodic"):
        tsi.SemiImplicitModel(grid, dt=1.0, open_north=True)


def test_semi_implicit_cli_runs_on_cpu(capsys):
    tsi._main(["24", "3", "2.0", "chebyshev", "cpu"])
    out = capsys.readouterr().out
    assert "mass drift" in out and "device=cpu" in out
    assert "solver=chebyshev" in out


def test_scatter_exchanged_matches_jax():
    """Grid.scatter_exchanged: halo cells carry their source cell's
    value (periodic wrap and seams), both modes."""
    tmask = _island_tmask(24, 16, wrap=True)
    gj, gt = _grids(24, 16, 4, tmask, halo=2, wrap=True)
    a = np.random.default_rng(9).standard_normal((16, 24))
    for mode in ("edge", "zeros"):
        np.testing.assert_array_equal(
            gt.scatter_exchanged(a, mode=mode).numpy(),
            np.asarray(gj.scatter_exchanged(a, mode=mode)))
