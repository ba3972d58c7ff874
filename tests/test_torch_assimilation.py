"""The PyTorch port's 4D-Var against the JAX package.

``models/assimilation.py``: ``make_cost_fn`` (cost and autograd
gradient through every model's plain step), ``control_smoother``,
``hybrid_controls`` and ``assimilate`` with the port's Adam (optax's
update rule) and ``torch.optim.LBFGS``, at float64 on the CPU.  The
cost and gradient of every supported model equal the JAX package's on
the same seeded inputs, on 1 tile and on the JAX tests' 8; Adam's first
iterates equal optax's; the twins of tests/test_assimilation.py hold the
port to that file's own thresholds (L-BFGS's line search is PyTorch's
strong-Wolfe, not optax's zoom, so its iterates are not compared).

Tolerances: port vs JAX 1e-10 relative (cost; gradient against its
largest component; XLA:CPU may contract a multiply-add where PyTorch
rounds twice, and CG's dot products sum in another order); the rest as
tests/test_assimilation.py.  The flagship and tracer cases start from
asymmetric seeded fields: on an exactly symmetric state the upwind and
limiter selections sit on ties, where roundoff picks one of two
a.e.-valid subgradients (and ``d|x|/dx`` at 0 is 1 in JAX, 0 in
PyTorch).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dl_esm_inf_tpu.core import layout as jlayout
from dl_esm_inf_tpu.models import assimilation as jda
from dl_esm_inf_tpu.models import gravity_wave as jgw
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models import semi_implicit as jsi
from dl_esm_inf_tpu.models import shallow as jsh
from dl_esm_inf_tpu.models import tracer as jtr
from dl_esm_inf_tpu.models import twolayer as jtl

from dl_esm_inf_tpu_torch.core import layout
from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import semi_implicit as si
from dl_esm_inf_tpu_torch.models import shallow as sh
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models import twolayer as tl
from dl_esm_inf_tpu_torch.models.assimilation import (assimilate,
                                                      control_smoother,
                                                      hybrid_controls,
                                                      make_cost_fn)
from dl_esm_inf_tpu_torch.models.ensemble import Ensemble

torch.set_num_threads(1)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")
TOL_JAX = 1e-10


def _smooth_noise(rng, N, ncut=3):
    z = np.fft.rfft2(rng.standard_normal((N, N)))
    ky = np.abs(np.fft.fftfreq(N) * N)[:, None]
    kx = (np.fft.rfftfreq(N) * N)[None, :]
    f = np.fft.irfft2(np.where((ky <= ncut) & (kx <= ncut), z, 0),
                      s=(N, N))
    return f / np.abs(f).max()


def _rotating(N):
    x = (np.arange(N) - N / 2 + 0.5) / N
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


def _observe(m, steps, key, setter=None, x0=None):
    """Run a truth model and record ``key`` at the given steps."""
    if setter is not None:
        getattr(m, setter)(x0)
    obs, done = {}, 0
    for t in sorted(steps):
        m.run(t - done)
        done = t
        obs[t] = m.gather()[key]
    return obs


def _truth_obs(m, eta_true, steps):
    return _observe(m, steps, "eta", "set_initial_eta", eta_true)


# ----------------------------------------------------------------------
# the port against the JAX package: cost and gradient of every model

U24, V24 = _rotating(24)


def _coupled_pair(pkg, N, ndom):
    mods = (jnl, jtr) if pkg == "jax" else (nl, tr)
    kw = {} if pkg == "jax" else CPU
    fs = mods[0].build(N, N, ndomains=ndom, open_north=True, halo_width=2,
                       **kw)
    rng = np.random.default_rng(21)
    fs.set_initial_ssh(gw.gaussian_eta(N, N, amp=0.2)
                       + 0.05 * _smooth_noise(rng, N))
    return mods[1].CoupledTracer(fs, kappa=0.01)


#: name -> (build(pkg_module, ndomains, kwargs), the observed field and
#: steps, the truth's setter and initial field, the first guess, the
#: observed state index); the port's truth run makes the observations
#: both packages see
PARITY = {
    "gravity_wave": (
        lambda p, nd, kw: p.build(24, 24, ndomains=nd, dt=0.05, depth=10.0,
                                  **kw),
        ("eta", [6, 10]), ("set_initial_eta", gw.gaussian_eta(24, 24, 0.5)),
        lambda rng: 0.1 * _smooth_noise(rng, 24), 0),
    "shallow": (
        lambda p, nd, kw: p.build(16, 16, ndomains=nd, dt=0.02, **kw),
        ("eta", [6]), ("set_initial_eta", gw.gaussian_eta(16, 16, 0.4)),
        lambda rng: 0.1 * _smooth_noise(rng, 16), 0),
    "twolayer": (
        lambda p, nd, kw: p.build(16, 16, ndomains=nd, **kw),
        ("eta1", [5]), ("set_initial", gw.gaussian_eta(16, 16, 0.3)),
        lambda rng: 0.1 * _smooth_noise(rng, 16), 0),
    "semi_implicit": (
        lambda p, nd, kw: p.build(20, 20, ndomains=nd, dt=1.0, depth=10.0,
                                  tol=1e-12, differentiable=True, **kw),
        ("eta", [2, 4]), ("set_initial_eta", gw.gaussian_eta(20, 20, 0.5)),
        lambda rng: 0.1 * _smooth_noise(rng, 20), 0),
    "flagship": (
        lambda p, nd, kw: p.build(32, 32, ndomains=nd, open_north=True, **kw),
        ("sshn", [4, 8]),
        ("set_initial_ssh", gw.gaussian_eta(32, 32, 0.2)
         + 0.05 * _smooth_noise(np.random.default_rng(20), 32)),
        lambda rng: 0.05 * _smooth_noise(rng, 32), 0),
    "tracer": (
        lambda p, nd, kw: p.build(24, 24, ndomains=nd, dt=0.3, u=U24, v=V24,
                                  kappa=0.01, **kw),
        ("c", [5, 10]),
        ("set_initial_tracer", 0.8 * _smooth_noise(
            np.random.default_rng(22), 24) + 1.0),
        lambda rng: 0.5 * _smooth_noise(rng, 24) + 1.0, 0),
    "coupled": (
        lambda p, nd, kw: _coupled_pair("jax" if p is jtr else "torch", 32,
                                        nd),
        ("c", [5, 10]),
        ("set_initial_tracer", 0.8 * _smooth_noise(
            np.random.default_rng(23), 32) + 1.0),
        lambda rng: 0.5 * _smooth_noise(rng, 32) + 1.0, 3),
}

MODULES = {"gravity_wave": (jgw, gw), "shallow": (jsh, sh),
           "twolayer": (jtl, tl), "semi_implicit": (jsi, si),
           "flagship": (jnl, nl), "tracer": (jtr, tr),
           "coupled": (jtr, tr)}


@pytest.mark.parametrize("ndom", [1, 8])
@pytest.mark.parametrize("name", sorted(PARITY))
def test_cost_and_gradient_match_jax(name, ndom):
    """make_cost_fn's cost and its gradient (internal points) equal the
    JAX package's on the same observations and first guess."""
    build, (key, steps), (setter, x_true), guess, index = PARITY[name]
    jmod, tmod = MODULES[name]
    obs = _observe(build(tmod, ndom, CPU), steps, key, setter, x_true)
    x0 = guess(np.random.default_rng(30))

    tm = build(tmod, ndom, CPU)
    cost, pack, _ = make_cost_fn(tm, obs, obs_state_index=index)
    x = pack(x0).requires_grad_(True)
    c_t = cost(x)
    (g_t,) = torch.autograd.grad(c_t, x)
    g_t = layout.unstack_internal(tm.grid.decomp, g_t).numpy()

    jm = build(jmod, ndom, {})
    jcost, jpack, _ = jda.make_cost_fn(jm, obs, obs_state_index=index)
    xj = jpack(x0)
    c_j = float(jcost(xj))
    g_j = np.asarray(jlayout.unstack_internal(
        jm.grid.decomp, jax.jit(jax.grad(jcost))(xj)))
    assert c_j > 0 and np.abs(g_j).max() > 0
    assert abs(float(c_t.detach()) - c_j) <= TOL_JAX * c_j
    assert np.abs(g_t - g_j).max() <= TOL_JAX * np.abs(g_j).max()


def test_adam_iterates_match_jax():
    """The port's Adam is optax's update rule: the first 5 iterates (the
    cost history and the final field) equal the JAX package's."""
    N = 24
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU),
                     gw.gaussian_eta(N, N, amp=0.5), [6, 12])
    res_t = assimilate(gw.build(N, N, dt=0.05, depth=10.0, **CPU), obs,
                       iters=5, learning_rate=0.1)
    res_j = jda.assimilate(jgw.build(N, N, dt=0.05, depth=10.0), obs,
                           iters=5, learning_rate=0.1)
    np.testing.assert_allclose(res_t["cost_history"], res_j["cost_history"],
                               rtol=TOL_JAX, atol=0)
    scale = np.abs(res_j["eta0"]).max()
    assert scale > 0
    np.testing.assert_allclose(res_t["eta0"], res_j["eta0"], rtol=0,
                               atol=TOL_JAX * scale)
    assert abs(res_t["grad_norm"] - res_j["grad_norm"]) <= (
        TOL_JAX * res_j["grad_norm"])


def test_control_transforms_match_jax():
    """control_smoother and the hybrid transform (static part plus the
    ensemble-anomaly span) equal the JAX package's, as does the
    preconditioned penalty."""
    from dl_esm_inf_tpu.models.ensemble import Ensemble as JEnsemble
    N, M = 24, 4
    rng = np.random.default_rng(31)
    w = rng.standard_normal((N, N))
    a = rng.standard_normal(M)
    perts = np.stack([0.2 * _smooth_noise(rng, N) for _ in range(M)])

    tm = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    jm = jgw.build(N, N, dt=0.05, depth=10.0)
    _c, tpack, tunpack = make_cost_fn(tm, {1: np.zeros((N, N))})
    _c, jpack, junpack = jda.make_cost_fn(jm, {1: np.zeros((N, N))})
    sm_t = control_smoother(tm, 2.5)(tpack(w))
    sm_j = jda.control_smoother(jm, 2.5)(jpack(w))
    np.testing.assert_allclose(
        tunpack(sm_t), junpack(sm_j), rtol=0,
        atol=1e-12 * np.abs(junpack(sm_j)).max())

    et = Ensemble(gw.build(N, N, dt=0.05, depth=10.0, **CPU), M)
    ej = JEnsemble(jgw.build(N, N, dt=0.05, depth=10.0), M)
    for e in (et, ej):
        e.set_member_states(0, gw.gaussian_eta(N, N, 0.3) + perts)
    tt, pt, zt = hybrid_controls(tm, et, smooth_scale=2.0, beta=(0.7, 1.3))
    tj, pj, zj = jda.hybrid_controls(jm, ej, smooth_scale=2.0,
                                     beta=(0.7, 1.3))
    xt = {"w": tpack(w), "a": torch.as_tensor(a)}
    xj = {"w": jpack(w), "a": jnp.asarray(a)}
    want = junpack(tj(xj))
    np.testing.assert_allclose(tunpack(tt(xt)), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert abs(float(pt(xt)) - float(pj(xj))) <= 1e-12 * float(pj(xj))
    z = zt()
    assert float(z["w"].abs().max()) == 0 and z["a"].shape == (M,)


# ----------------------------------------------------------------------
# the twins of tests/test_assimilation.py, at its thresholds

def _fd_check(cost, x0, g, idxs, h, rel, floor=1e-3, skip_below=None):
    """Central differences at ``idxs`` (stacked indices) against the
    autograd gradient ``g``; returns the number of probes checked."""
    checked = 0
    with torch.no_grad():
        for idx in idxs:
            ep, em = x0.clone(), x0.clone()
            ep[idx] = h
            em[idx] = -h
            fd = float((cost(ep) - cost(em)) / (2 * h))
            if skip_below is not None and abs(fd) <= skip_below:
                continue              # degenerate (land/halo) probes
            assert abs(fd - float(g[idx])) <= rel * max(abs(fd), floor), idx
            checked += 1
    return checked


def _grad(cost, x):
    x = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(cost(x), x)
    return g


def _wet(m):
    return layout.unstack_internal(m.grid.decomp,
                                   m._t_upd.cpu().numpy()).astype(bool)


def test_adjoint_matches_finite_differences():
    """The autograd gradient through 10 steps (the exchange's slices and
    rolls included) equals central differences at several probes."""
    N = 24
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU),
                     gw.gaussian_eta(N, N, amp=0.5), [10])
    cost, pack, _ = make_cost_fn(m, obs)
    x0 = pack(np.zeros((N, N)))
    g = _grad(cost, x0)
    assert _fd_check(cost, x0, g, ((5, 7), (12, 12), (18, 4)), 1e-6,
                     1e-7) == 3


def test_twin_experiment_recovers_initial_state():
    """Observing eta at steps {6, 12, 18} recovers the initial bump from
    a zero first guess with Adam."""
    N = 24
    eta_true = gw.gaussian_eta(N, N, amp=0.5)
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU),
                     eta_true, [6, 12, 18])
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    res = assimilate(m, obs, iters=300, learning_rate=0.1)
    hist = res["cost_history"]
    assert hist[-1] < 1e-4 * hist[0]
    err = np.abs((res["eta0"] - eta_true) * _wet(m)).max()
    assert err < 0.02 * np.abs(eta_true).max()


def test_decomposition_invariant_gradient():
    """1-tile and 8-tile adjoints agree."""
    N = 16
    eta_true = gw.gaussian_eta(N, N, amp=0.4)
    grads = []
    for ndom in (1, 8):
        m = gw.build(N, N, ndomains=ndom, dt=0.05, depth=10.0, **CPU)
        obs = _truth_obs(gw.build(N, N, ndomains=ndom, dt=0.05, depth=10.0,
                                  **CPU), eta_true, [8])
        cost, pack, _ = make_cost_fn(m, obs)
        g = _grad(cost, pack(np.zeros((N, N))))
        grads.append(layout.unstack_internal(m.grid.decomp, g).numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-12)


def test_guards():
    N = 16
    m = gw.build(N, N, dt=0.05, **CPU)
    with pytest.raises(ValueError, match="observations"):
        make_cost_fn(m, {})
    with pytest.raises(ValueError, match=">= 1"):
        make_cost_fn(m, {0: np.zeros((N, N))})
    mp = gw.build(N, N, dt=0.05, halo_width=2, **CPU)
    mp.set_steps_per_exchange(2)
    with pytest.raises(ValueError, match="plain differentiable path"):
        make_cost_fn(mp, {4: np.zeros((N, N))})
    for fused in (gw.build(N, N, dt=0.05, fused=True, **CPU),
                  nl.build(32, 32, fused=True, **CPU),
                  tr.build(N, N, fused=True, **CPU)):
        with pytest.raises(ValueError, match="plain differentiable path"):
            make_cost_fn(fused, {4: np.zeros(fused.grid.global_tmask().shape)})
    with pytest.raises(ValueError, match="bathymetry"):
        make_cost_fn(nl.build(N, N, depth=np.full((N, N), 50.0), **CPU),
                     {4: np.zeros((N, N))})
    with pytest.raises(TypeError, match="GravityWaveModel"):
        make_cost_fn(object(), {4: np.zeros((N, N))})
    from dl_esm_inf_tpu_torch.models import nlayer as nlr
    with pytest.raises(TypeError, match="GravityWaveModel"):
        make_cost_fn(nlr.build(N, N, **CPU), {4: np.zeros((N, N))})
    with pytest.raises(ValueError, match="optimizer"):
        assimilate(m, {4: np.zeros((N, N))}, iters=1, optimizer="sgd")


def test_implicit_model_differentiable_mode_matches():
    """differentiable=True (pcg_solve) and the raw-CG mode produce the
    same trajectory."""
    N = 24
    eta0 = gw.gaussian_eta(N, N, amp=0.5)
    got = {}
    for diff in (False, True):
        m = si.build(N, N, dt=1.0, depth=10.0, tol=1e-12,
                     differentiable=diff, **CPU)
        m.set_initial_eta(eta0)
        info = m.run(6)
        assert (info["cg_iterations"] == 0) == diff
        got[diff] = m.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(got[True][k], got[False][k], rtol=0,
                                   atol=1e-10)


def test_implicit_model_adjoint_and_twin_experiment():
    """4D-Var through the implicit solver: the gradient of a 4-step
    implicit trajectory misfit matches finite differences (implicit
    differentiation: the CG loop is never recorded), and a twin
    experiment at dt 10x beyond the explicit CFL limit recovers the
    initial state."""
    N = 20
    eta_true = gw.gaussian_eta(N, N, amp=0.5)

    def build():
        return si.build(N, N, dt=1.0, depth=10.0, tol=1e-12,
                        differentiable=True, **CPU)

    obs = _observe(build(), (2, 4), "eta", "set_initial_eta", eta_true)
    m = build()
    cost, pack, _ = make_cost_fn(m, obs)
    x0 = pack(np.zeros((N, N)))
    g = _grad(cost, x0)
    assert _fd_check(cost, x0, g, ((6, 8), (11, 5)), 1e-6, 1e-6) == 2

    res = assimilate(m, obs, iters=250, learning_rate=0.1)
    assert res["cost_history"][-1] < 1e-3 * res["cost_history"][0]
    err = np.abs((res["eta0"] - eta_true) * _wet(m)).max()
    assert err < 0.05 * np.abs(eta_true).max()


def test_flagship_adjoint_and_twin_experiment():
    """4D-Var on the nonlinear flagship: gradient == finite differences;
    a short twin experiment from a zero first guess recovers most of the
    initial surface."""
    N = 32
    eta_true = gw.gaussian_eta(N, N, amp=0.2)
    obs = _observe(nl.build(N, N, open_north=True, **CPU), (4, 8), "sshn",
                   "set_initial_ssh", eta_true)
    m = nl.build(N, N, open_north=True, **CPU)
    cost, pack, _ = make_cost_fn(m, obs)
    x0 = pack(np.zeros((N, N)))
    g = _grad(cost, x0)
    assert _fd_check(cost, x0, g, ((8, 10), (16, 16), (24, 7)), 1e-6,
                     1e-5, skip_below=1e-8) >= 2

    res = assimilate(m, obs, iters=150, learning_rate=0.05)
    assert res["cost_history"][-1] < 1e-2 * res["cost_history"][0]


def test_open_boundary_implicit_4dvar():
    """4D-Var through the implicit solver with the radiative open
    boundary (the diagonal extra keeps the operator symmetric, so the
    adjoint reuses the same solve)."""
    N = 20
    eta_true = gw.gaussian_eta(N, N, amp=0.5)

    def build():
        return si.build(N, N, dt=0.5, depth=10.0, tol=1e-12,
                        differentiable=True, open_north=True, **CPU)

    obs = _observe(build(), (2, 4), "eta", "set_initial_eta", eta_true)
    m = build()
    cost, pack, _ = make_cost_fn(m, obs)
    x0 = pack(np.zeros((N, N)))
    g = _grad(cost, x0)
    assert _fd_check(cost, x0, g, ((8, 9),), 1e-6, 1e-6) == 1
    res = assimilate(m, obs, iters=200, learning_rate=0.1)
    assert res["cost_history"][-1] < 1e-2 * res["cost_history"][0]


def test_shallow_and_twolayer_adjoints():
    """The rotating periodic model (SW offset, no masks) and the
    two-layer model (6-field state, top interface observed, through the
    checkpointed loop): gradient == central differences."""
    N, h = 16, 1e-6
    truth = sh.build(N, N, dt=0.02, **CPU)
    truth.set_initial_eta(gw.gaussian_eta(N, N, amp=0.4))
    truth.run(6)
    m = sh.build(N, N, dt=0.02, **CPU)
    cost, pack, _ = make_cost_fn(m, {6: truth.gather()["eta"]})
    x0 = pack(np.zeros((N, N)))
    assert _fd_check(cost, x0, _grad(cost, x0), ((5, 7), (11, 3)), h,
                     1e-7) == 2

    t2 = tl.build(N, N, **CPU)
    t2.set_initial(eta1_global=gw.gaussian_eta(N, N, amp=0.3))
    t2.run(5)
    m2 = tl.build(N, N, **CPU)
    cost2, pack2, _ = make_cost_fn(m2, {5: t2.gather()["eta1"]},
                                   remat_chunk=2)
    x2 = pack2(np.zeros((N, N)))
    assert _fd_check(cost2, x2, _grad(cost2, x2), ((6, 8), (9, 5)), h,
                     1e-6, skip_below=1e-9) >= 1


def test_lbfgs_optimizer():
    """L-BFGS drives the quadratic misfit to ~machine precision in a few
    dozen iterations."""
    N = 24
    eta_true = gw.gaussian_eta(N, N, amp=0.5)
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU), eta_true,
                     [6, 12])
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    res = assimilate(m, obs, iters=40, optimizer="lbfgs")
    hist = res["cost_history"]
    assert hist[-1] < 1e-12 * hist[0]
    err = np.abs((res["eta0"] - eta_true) * _wet(m)).max()
    assert err < 1e-4 * np.abs(eta_true).max()


@pytest.mark.parametrize("hybrid", [False, True], ids=["field", "hybrid"])
def test_port_lbfgs_is_torch_lbfgs_on_one_rank(hybrid):
    """The port's LBFGS (whose reductions are all-reduced across ranks)
    is torch.optim.LBFGS at assimilate's settings on one rank: 12
    iterations give the same cost history and iterate, bitwise, on a
    field control and on the hybrid's two leaves (the ensemble weights
    first)."""
    from dl_esm_inf_tpu_torch.models.assimilation import LBFGS
    N = 16
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU),
                     gw.gaussian_eta(N, N, amp=0.5), [6])
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    if hybrid:
        ens = Ensemble(gw.build(N, N, dt=0.05, depth=10.0, **CPU), 3)
        rng = np.random.default_rng(3)
        ens.set_member_states(0, np.stack(
            [0.2 * _smooth_noise(rng, N) for _ in range(3)]))
        tf, pen, zero = hybrid_controls(m, ens)
        cost, _, _ = make_cost_fn(m, obs, control_transform=tf,
                                  control_penalty=pen,
                                  background_weight=1e-3)
        x0 = zero()
        keys = sorted(x0)
    else:
        cost, pack, _ = make_cost_fn(m, obs)
        x0, keys = {"x": pack(np.zeros((N, N)))}, ["x"]

    def run(port):
        leaves = [x0[k].clone().requires_grad_(True) for k in keys]

        def value(ls):
            d = dict(zip(keys, ls))
            return cost(d if hybrid else d["x"])
        hist = []
        if port:
            opt = LBFGS(leaves, [k == "a" for k in keys])

            def evaluate(ls):
                c = value(ls)
                return c.detach(), torch.autograd.grad(c, ls)
            for _ in range(12):
                hist.append(float(opt.step(evaluate)[0]))
        else:
            opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=26,
                                    history_size=10, tolerance_grad=0.0,
                                    tolerance_change=0.0,
                                    line_search_fn="strong_wolfe")

            def closure():
                opt.zero_grad()
                c = value(leaves)
                c.backward()
                return c
            for _ in range(12):
                hist.append(float(opt.step(closure).detach()))
        return hist, [t.detach() for t in leaves]
    (h_p, x_p), (h_t, x_t) = run(True), run(False)
    assert h_p == h_t and h_p[-1] < h_p[0]
    assert all(torch.equal(a, b) for a, b in zip(x_p, x_t))


def test_tracer_source_inversion_4dvar():
    """Observing the tracer at two later times recovers the initial
    release by L-BFGS through the checkpointed loop (the JAX package's
    tests/test_tracer.py thresholds)."""
    N = 24
    c_true = gw.gaussian_eta(N, N, amp=0.8, width=0.08) + 0.008
    obs = _observe(tr.build(N, N, dt=0.3, u=U24, v=V24, kappa=0.01, **CPU),
                   (5, 10), "c", "set_initial_tracer", c_true)
    m = tr.build(N, N, dt=0.3, u=U24, v=V24, kappa=0.01, **CPU)
    res = assimilate(m, obs, iters=60, optimizer="lbfgs", remat_chunk=2)
    hist = res["cost_history"]
    assert hist[-1] < 1e-8 * hist[0]
    err = np.abs((res["eta0"] - c_true) * _wet(m)).max()
    assert err < 1e-3 * np.abs(c_true).max()


def test_implicit_model_requires_differentiable_flag():
    m = si.build(16, 16, dt=1.0, **CPU)
    with pytest.raises(ValueError, match="differentiable"):
        make_cost_fn(m, {4: np.zeros((16, 16))})


def test_velocity_observations():
    """Drifter-style DA: observing only v (state index 2) constrains the
    initial elevation through the dynamics: gradient == finite
    differences, and L-BFGS drives the velocity misfit to near zero
    while recovering the bulk of the bump."""
    N = 24
    eta_true = gw.gaussian_eta(N, N, amp=0.5)
    truth = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    obs = _observe(truth, (6, 12), "v", "set_initial_eta", eta_true)
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    vw = layout.unstack_internal(m.grid.decomp, m._v_wet.numpy())
    cost, pack, _ = make_cost_fn(m, obs, obs_state_index=2, obs_weight=vw)
    x0 = pack(np.zeros((N, N)))
    assert _fd_check(cost, x0, _grad(cost, x0), ((7, 9), (14, 6)), 1e-6,
                     1e-6) == 2

    x = x0.clone().requires_grad_(True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1, max_eval=26,
                            history_size=10, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        c = cost(x)
        c.backward()
        return c

    c0 = float(cost(x0))
    for _ in range(60):
        opt.step(closure)
    cv = float(cost(x.detach()))
    assert cv < 1e-8 * c0
    wet = _wet(m)
    rec = layout.unstack_internal(m.grid.decomp, x.detach()).numpy()
    err = np.abs((rec - eta_true) * wet).max()
    assert err < 0.35 * np.abs(eta_true).max()
    cc = np.corrcoef(rec[wet].ravel(), eta_true[wet].ravel())[0, 1]
    assert cc > 0.8, cc


def test_control_variable_transform_sparse_obs():
    """The Weaver-Courtier change of variables: with observations at 1
    point in 16, minimising a control vector through the diffusion
    sqrt-B recovers the bump far better than raw 4D-Var."""
    N = 24
    eta_true = gw.gaussian_eta(N, N, amp=0.5, width=0.15)
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU), eta_true,
                     [6, 12])
    ow = np.zeros((N, N))
    ow[2::4, 2::4] = 1.0
    err = {}
    for scale in (None, 2.5):
        m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
        res = assimilate(m, obs, iters=60, optimizer="lbfgs", obs_weight=ow,
                         smooth_scale=scale)
        err[scale] = np.sqrt((((res["eta0"] - eta_true) * _wet(m)) ** 2
                              ).mean())
    assert err[2.5] < 0.5 * err[None], err


def test_hybrid_4denvar():
    """Hybrid 4D-EnVar: adding the forecast-ensemble anomaly directions
    (the port's Ensemble) to the static sqrt-B control recovers a truth
    whose error lies partly in the ensemble span far better than the
    static transform alone, with nonzero ensemble weights."""
    N, M = 24, 6
    rng = np.random.default_rng(13)
    base = gw.gaussian_eta(N, N, amp=0.3)
    perts = np.stack([0.2 * _smooth_noise(rng, N) for _ in range(M)])
    eta_true = (base + perts.mean(0) + 0.6 * (perts[1] - perts[3])
                + 0.05 * _smooth_noise(rng, N))
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU), eta_true,
                     [6, 12])
    ow = np.zeros((N, N))
    ow[2::4, 2::4] = 1.0

    ens = Ensemble(gw.build(N, N, dt=0.05, depth=10.0, **CPU), M)
    ens.set_member_states(0, base + perts)
    err = {}
    for mode in ("static", "hybrid"):
        m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
        res = assimilate(m, obs, iters=60, optimizer="lbfgs", obs_weight=ow,
                         smooth_scale=2.0, background_weight=1e-5,
                         ensemble=ens if mode == "hybrid" else None)
        err[mode] = np.sqrt((((res["eta0"] - eta_true) * _wet(m)) ** 2
                             ).mean())
    assert err["hybrid"] < 0.8 * err["static"], err
    assert np.abs(res["ensemble_weights"]).max() > 1e-3
    with pytest.raises(ValueError, match="first_guess"):
        assimilate(m, obs, iters=1, ensemble=ens, first_guess=base)


def test_control_transform_background_is_state_space():
    """With a control transform, a physical background compares in state
    space: a dominant background term pins the analysis to it."""
    N = 16
    truth = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    truth.set_initial_eta(gw.gaussian_eta(N, N, amp=0.4))
    truth.run(4)
    obs = {4: truth.gather()["eta"]}
    bgf = gw.gaussian_eta(N, N, amp=0.2, width=0.2)
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    res = assimilate(m, obs, iters=150, optimizer="lbfgs", smooth_scale=2.0,
                     background=bgf, background_weight=1e4)
    err = np.abs((res["eta0"] - bgf) * _wet(m)).max()
    assert err < 0.05 * np.abs(bgf).max()
    with pytest.raises(ValueError, match="first_guess"):
        assimilate(m, obs, iters=1, smooth_scale=2.0, first_guess=bgf)


def test_background_term_and_weights():
    """A background (prior) term with observations masked to half the
    domain gives a finite positive cost."""
    N = 16
    eta_true = gw.gaussian_eta(N, N, amp=0.5)
    obs = _truth_obs(gw.build(N, N, dt=0.05, depth=10.0, **CPU), eta_true,
                     [6])
    ow = np.zeros((N, N))
    ow[:, : N // 2] = 1.0
    m = gw.build(N, N, dt=0.05, depth=10.0, **CPU)
    cost, pack, _ = make_cost_fn(m, obs, obs_weight=ow,
                                 background=np.zeros((N, N)),
                                 background_weight=1e-3)
    c = float(cost(pack(np.zeros((N, N)))))
    assert np.isfinite(c) and c > 0
