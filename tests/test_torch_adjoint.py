"""Checkpointed adjoints and the adjoint CG in the PyTorch port.

``ops/adjoint.py::checkpointed_fori`` (``torch.utils.checkpoint``, per
step and two-level), the ``remat_chunk`` paths of every model's
``step_program`` and ``ops/solvers.py::pcg_solve`` (the implicit
backward of the CG solve), at float64 on the CPU: the twins of
tests/test_remat.py, the remat gradients against the JAX package, and
the saved-bytes measurement.

Tolerances: remat against plain bitwise (checkpointing changes what is
stored, never what is computed), the semi-implicit model at 1e-13 as
tests/test_remat.py (the recomputed forward solve and the adjoint solve
stop at a residual test); port against JAX 1e-10 relative.
"""
import numpy as np
import pytest
import torch

import jax

from dl_esm_inf_tpu.core import layout as jlayout
from dl_esm_inf_tpu.models import gravity_wave as jgw
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models.assimilation import make_cost_fn as jmake_cost

from dl_esm_inf_tpu_torch.core import layout as tlayout
from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import semi_implicit as si
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models.assimilation import make_cost_fn
from dl_esm_inf_tpu_torch.ops import solvers as so
from dl_esm_inf_tpu_torch.ops.adjoint import checkpointed_fori

torch.set_num_threads(1)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")


def _smooth(seed, N, amp):
    """A seeded smooth asymmetric field (low Fourier modes).  An
    asymmetric start keeps the flagship's upwind selections off exact
    ties, where the two packages' roundoff could pick different
    a.e.-valid subgradients."""
    rng = np.random.default_rng(seed)
    z = np.fft.rfft2(rng.standard_normal((N, N)))
    ky = np.abs(np.fft.fftfreq(N) * N)[:, None]
    kx = (np.fft.rfftfreq(N) * N)[None, :]
    f = np.fft.irfft2(np.where((ky <= 3) & (kx <= 3), z, 0), s=(N, N))
    return amp * f / np.abs(f).max()


def _flagship_obs(N, steps, seed=1):
    truth = nl.build(N, N, open_north=True, **CPU)
    truth.set_initial_ssh(gw.gaussian_eta(N, N, amp=0.2)
                          + _smooth(seed, N, 0.05))
    obs, done = {}, 0
    for t in sorted(steps):
        truth.run(t - done)
        done = t
        obs[t] = truth.gather()["sshn"]
    return obs


def _gw_obs(N, steps):
    truth = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    truth.set_initial_eta(gw.gaussian_eta(N, N, amp=0.5))
    truth.run(steps)
    return {steps: truth.gather()["eta"]}


def _coupled(N, **kw):
    fs = nl.build(N, N, open_north=True, halo_width=2, **CPU)
    fs.set_initial_ssh(gw.gaussian_eta(N, N, amp=0.2) + _smooth(3, N, 0.05))
    return tr.CoupledTracer(fs, kappa=0.01, **kw)


def _coupled_obs(N, steps):
    truth = _coupled(N)
    truth.set_initial_tracer(gw.gaussian_eta(N, N, amp=0.8, width=0.12))
    truth.run(steps)
    return {steps: truth.gather()["c"]}


def _tracer_obs(N, steps):
    truth = tr.build(N, N, dt=0.2, u=0.3, v=-0.2, kappa=0.02, **CPU)
    truth.set_initial_tracer(gw.gaussian_eta(N, N, amp=0.8))
    truth.run(steps)
    return {steps: truth.gather()["c"]}


#: (build, observations, observed state index, initial guess) per model:
#: step counts with a remainder at chunk 4 (14 = 3*4 + 2, 10 = 2*4 + 2)
REMAT_CASES = {
    "flagship": (lambda: nl.build(32, 32, open_north=True, **CPU),
                 lambda: _flagship_obs(32, [14]), 0,
                 lambda: _smooth(2, 32, 0.05)),
    "gravity_wave": (lambda: gw.build(24, 24, dt=0.05, depth=10.0, **CPU),
                     lambda: _gw_obs(24, 10), 0,
                     lambda: gw.gaussian_eta(24, 24, amp=0.1)),
    "tracer": (lambda: tr.build(24, 24, dt=0.2, u=0.3, v=-0.2, kappa=0.02,
                                **CPU),
               lambda: _tracer_obs(24, 10), 0,
               lambda: _smooth(4, 24, 0.3) + 0.3),
    "coupled": (lambda: _coupled(24), lambda: _coupled_obs(24, 10), 3,
                lambda: _smooth(5, 24, 0.3) + 0.3),
}


def _cost_grad(model, obs, index, x0, remat_chunk=None):
    cost, pack, _ = make_cost_fn(model, obs, remat_chunk=remat_chunk,
                                 obs_state_index=index)
    x = pack(x0).requires_grad_(True)
    c = cost(x)
    (g,) = torch.autograd.grad(c, x)
    return float(c.detach()), g


@pytest.mark.parametrize("name", sorted(REMAT_CASES))
def test_remat_gradients_match(name):
    """Per-step (chunk=1) and two-level (chunk=4, with a remainder)
    checkpointing reproduce the plain adjoint bitwise, the cost too:
    remat changes what is stored, never what is computed."""
    build, make_obs, index, guess = REMAT_CASES[name]
    obs, x0 = make_obs(), guess()
    c_plain, g_plain = _cost_grad(build(), obs, index, x0)
    assert np.isfinite(c_plain) and c_plain > 0
    assert float(g_plain.abs().max()) > 0
    for ck in (1, 4):
        c_r, g_r = _cost_grad(build(), obs, index, x0, remat_chunk=ck)
        assert c_r == c_plain
        assert torch.equal(g_r, g_plain), ck


def test_flagship_remat_gradients_match_jax():
    """The port's checkpointed flagship adjoint equals the JAX package's
    (plain and chunk 4 there) at 1e-10 relative, internal points."""
    N, steps = 32, [14]
    obs = _flagship_obs(N, steps)
    x0 = _smooth(2, N, 0.05)
    m = nl.build(N, N, open_north=True, **CPU)
    c_t, g_t = _cost_grad(m, obs, 0, x0, remat_chunk=4)
    g_t = tlayout.unstack_internal(m.grid.decomp, g_t).numpy()
    for ck in (None, 4):
        jm = jnl.build(N, N, open_north=True)
        cost, pack, _ = jmake_cost(jm, obs, remat_chunk=ck)
        x = pack(x0)
        c_j = float(cost(x))
        g_j = np.asarray(jlayout.unstack_internal(
            jm.grid.decomp, jax.jit(jax.grad(cost))(x)))
        assert abs(c_t - c_j) <= 1e-10 * abs(c_j)
        assert np.abs(g_t - g_j).max() <= 1e-10 * np.abs(g_j).max()


def _saved_bytes(fn):
    """Bytes of the distinct storages that the autograd graph of
    ``fn()`` keeps for the backward pass, counted by a
    ``saved_tensors_hooks`` around the forward.  A checkpoint's own hooks
    hide the saves inside it (they are dropped, and recomputed in the
    backward); what the backward keeps of a checkpoint are its tensor
    inputs, which it saves where the hook sees them."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_flagship_remat_reduces_saved_bytes():
    """The structural measurement (tests/test_remat.py's residual
    stacks): per-step checkpointing keeps at most a quarter of the plain
    adjoint's saved bytes, the two-level scheme fewer still."""
    N = 32
    obs = _flagship_obs(N, [16])
    sizes = {}
    for ck in (None, 1, 4):
        m = nl.build(N, N, open_north=True, **CPU)
        cost, pack, _ = make_cost_fn(m, obs, remat_chunk=ck)
        x = pack(np.zeros((N, N))).requires_grad_(True)
        sizes[ck] = _saved_bytes(lambda: cost(x))
    assert sizes[1] * 4 <= sizes[None], sizes
    assert sizes[4] < sizes[1], sizes


def test_implicit_remat_gradient_matches():
    """Checkpointing composes with implicit differentiation: the
    backward pass re-runs the chunk's forward solves, then pcg_solve's
    adjoint solve runs as usual.  Gradient equals the plain adjoint."""
    N = 20

    def build():
        return si.build(N, N, dt=1.0, depth=10.0, tol=1e-12,
                        differentiable=True, **CPU)

    truth = build()
    truth.set_initial_eta(gw.gaussian_eta(N, N, amp=0.5))
    truth.run(5)
    obs = {5: truth.gather()["eta"]}
    _c, g_plain = _cost_grad(build(), obs, 0, np.zeros((N, N)))
    _c, g_r = _cost_grad(build(), obs, 0, np.zeros((N, N)), remat_chunk=2)
    assert float((g_r - g_plain).abs().max()) <= 1e-13


@pytest.mark.parametrize("kind", ["flagship", "coupled", "semi_implicit"])
def test_remat_forward_run_unchanged(kind):
    """step_program(remat_chunk=...) is forward-bitwise the plain
    program."""
    N = 24
    if kind == "flagship":
        m = nl.build(N, N, open_north=True, **CPU)
        m.set_initial_ssh(gw.gaussian_eta(N, N, amp=0.2))
        state = (m.sshn_t.data, m.un.data, m.vn.data)

        def run(ck):
            return m.step_program(7, remat_chunk=ck)(0, state, m._mask_codes)
    elif kind == "coupled":
        m = _coupled(N)
        m.set_initial_tracer(gw.gaussian_eta(N, N, amp=0.8))
        fs = m.flagship
        state = (fs.sshn_t.data, fs.un.data, fs.vn.data, m.c.data)

        def run(ck):
            return m.step_program(7, remat_chunk=ck)(0, state)
    else:
        m = si.build(N, N, dt=1.0, depth=10.0, tol=1e-12,
                     differentiable=True, open_north=True, bc_amp=0.05,
                     bc_omega=0.3, **CPU)
        m.set_initial_eta(gw.gaussian_eta(N, N, amp=0.5))

        def run(ck):
            return m.step_program(7, remat_chunk=ck)(
                0, m.eta.data, m.u.data, m.v.data)[:3]
    plain = run(None)
    ck = run(3)
    for a, b in zip(plain, ck):
        assert torch.equal(a, b)


def test_checkpointed_fori_schedule():
    """The loop visits every absolute step index once and in order at
    any chunk (remainders included) and as the plain loop (``chunk=None``);
    n <= 0 returns the state."""
    for n in (0, 1, 5, 12, 14):
        for chunk in (None, 1, 3, 4, 20):
            seen = []

            def body(i, s):
                seen.append(i)
                return (s[0] + i, s[1] * 2)

            x = torch.ones(3, dtype=torch.float64, requires_grad=True)
            out = checkpointed_fori(n, body, (x, x * 1), chunk)
            assert seen == list(range(n))
            assert float(out[0][0].detach()) == 1 + n * (n - 1) / 2
            assert float(out[1][0].detach()) == 2 ** n
            if n:
                (g,) = torch.autograd.grad(out[1].sum(), x)
                assert torch.equal(g, torch.full((3,), 2.0 ** n,
                                                 dtype=torch.float64))


def test_remat_guards():
    """remat needs the plain differentiable path; the N-layer model's
    step_program takes no remat_chunk (as in the JAX package)."""
    from dl_esm_inf_tpu_torch.models import nlayer as nlr
    m = gw.build(16, 16, dt=0.05, halo_width=2, **CPU)
    m.set_steps_per_exchange(2)
    with pytest.raises(ValueError, match="remat"):
        m.step_program(4, remat_chunk=1)
    mf = gw.build(16, 16, dt=0.05, fused=True, **CPU)
    with pytest.raises(ValueError, match="remat"):
        mf.step_program(4, remat_chunk=1)
    mn = nl.build(32, 32, halo_width=4, **CPU)
    mn.set_steps_per_exchange(2)
    with pytest.raises(ValueError, match="remat"):
        mn.step_program(4, remat_chunk=2)
    mk = nl.build(32, 32, fused=True, **CPU)
    with pytest.raises(ValueError, match="remat"):
        mk.step_program(4, remat_chunk=2)
    with pytest.raises(TypeError, match="remat_chunk"):
        nlr.build(16, 16, layers=2, **CPU).step_program(4, remat_chunk=1)


def _helmholtz(N=20, seed=7):
    """A semi-implicit model's operator and a seeded right-hand side."""
    m = si.build(N, N, dt=1.0, depth=10.0, tol=1e-13, **CPU)
    e, w, n, s, diag = m._coeffs
    mv = so.make_helmholtz_matvec(m.grid.halo_spec, e, w, n, s, diag)
    rng = np.random.default_rng(seed)
    b = m.grid.block_tensor(tlayout.stack_global(
        m.grid.decomp, rng.standard_normal((N, N)), mode="zeros"))
    return m, mv, b


def test_pcg_solve_implicit_gradient():
    """pcg_solve solves the projected system and its backward is the
    adjoint solve: for J = <c, x(b)>, dJ/db = weight * A^-1 c (A
    symmetric), checked against a forward solve with c as right-hand
    side, and against central differences; the start carries no
    gradient."""
    m, mv, b = _helmholtz()
    wgt = m._weight
    kw = dict(tol=1e-13, maxiter=m.maxiter, inv_diag=m._inv_diag)
    rng = np.random.default_rng(8)
    c = m.grid.block_tensor(rng.standard_normal(b.shape)) * wgt
    bb = b.clone().requires_grad_(True)
    x0 = (0.1 * b).requires_grad_(True)
    x = so.pcg_solve(mv, bb, wgt, x0=x0, constants=m._coeffs, **kw)
    xd = x.detach()
    assert float((xd * (1 - wgt)).abs().max()) == 0.0   # canonical
    # the residual of the projected system on internal cells
    assert float((wgt * (b - mv(xd))).abs().max()) <= 1e-10
    J = (c * x).sum()
    gb, gx0 = torch.autograd.grad(J, (bb, x0), allow_unused=True)
    assert gx0 is None or float(gx0.abs().max()) == 0.0
    want = so.pcg_solve(mv, c, wgt, constants=m._coeffs, **kw)
    assert float((gb - want).abs().max()) <= 1e-10 * float(
        want.abs().max())
    h = 1e-6
    for idx in ((5, 7), (12, 9)):
        d = torch.zeros_like(b)
        d[idx] = h

        def J_at(bv):
            return float((c * so.pcg_solve(mv, bv, wgt, constants=m._coeffs,
                                           **kw)).sum())
        fd = (J_at(b + d) - J_at(b - d)) / (2 * h)
        assert abs(fd - float(gb[idx])) <= 1e-7 * max(abs(fd), 1e-3)


def test_pcg_solve_refuses_operator_gradients():
    """The operator is constant in every user path: a coefficient that
    requires a gradient raises instead of being silently ignored."""
    m, mv, b = _helmholtz()
    coeffs = list(m._coeffs)
    coeffs[4] = coeffs[4].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="right-hand side"):
        so.pcg_solve(mv, b, m._weight, tol=1e-10, maxiter=10,
                     constants=coeffs)
