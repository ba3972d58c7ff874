"""The PyTorch port's CoupledTracer against the JAX package.

``models/tracer.py::CoupledTracer``: the flagship flow and a passive
tracer advanced together with one 4-field depth-2 exchange a step, at
float64 on the CPU.  The twins of tests/test_tracer.py's coupled cases
(its ETKF case's twin is in tests/test_torch_enkf.py, with the port's
ETKF), the run against the JAX ``CoupledTracer`` on the same seeded
inputs, and the guards.

Tolerances: port vs JAX 1e-12 relative to each field's largest value
(the same operations in the same order); the coupled flow vs a plain
flagship run in the port bitwise (the same step on the same exchange);
mass 1e-12 relative; the rest as tests/test_tracer.py.
"""
import numpy as np
import pytest
import torch

from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models import tracer as jtr

from dl_esm_inf_tpu_torch.core import layout
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta

torch.set_num_threads(1)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")


def _blob(N, amp=1.0):
    x = (np.arange(N) - N / 2 + 0.5) / N
    return amp * np.exp(-((x[None, :] - 0.1) ** 2
                          + (x[:, None] + 0.05) ** 2) / 0.01)


def _ssh0(N, seed=0):
    """A seeded asymmetric initial surface."""
    rng = np.random.default_rng(seed)
    return (gaussian_eta(N, N, amp=0.2)
            + 0.01 * rng.standard_normal((N, N)))


def _coupled(N, ndom=None, **kw):
    fs = nl.build(N, N, ndomains=ndom, open_north=True, halo_width=2, **CPU)
    return tr.CoupledTracer(fs, **kw)


@pytest.mark.parametrize("ndom", [1, 8])
@pytest.mark.parametrize("scheme", ["upwind", "vanleer"])
def test_coupled_matches_jax(ndom, scheme):
    """Same seeded surface and tracer, 12 coupled steps in two runs (the
    tidal clock continues): flow and tracer equal the JAX package's."""
    N = 32
    ssh0, c0 = _ssh0(N), _blob(N) + 0.05
    jfs = jnl.build(N, N, ndomains=ndom, open_north=True, halo_width=2)
    jct = jtr.CoupledTracer(jfs, kappa=0.01, scheme=scheme)
    ct = _coupled(N, ndom, kappa=0.01, scheme=scheme)
    for m in (jct, ct):
        m.flagship.set_initial_ssh(ssh0)
        m.set_initial_tracer(c0)
        m.run(5)
        m.run(7)
    assert ct._istep0 == jct._istep0 == 12
    gj, gt = jct.gather(), ct.gather()
    assert set(gt) == set(gj) == {"sshn", "un", "vn", "c"}
    for k in gj:
        scale = np.abs(gj[k]).max()
        assert scale > 0
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=1e-12 * scale,
                                   err_msg=k)
    assert abs(ct.mass() - float(jct.mass())) <= 1e-12 * abs(ct.mass())


def test_coupled_flow_untouched_and_mass_conserved():
    """The coupled flagship trajectory equals a plain flagship run
    bitwise (the tracer is passive), and tracer mass is conserved
    through the evolving flow."""
    N = 32
    ssh0 = _ssh0(N, seed=1)
    plain = nl.build(N, N, open_north=True, halo_width=2, **CPU)
    plain.set_initial_ssh(ssh0)
    plain.run(12)

    ct = _coupled(N, kappa=0.01)
    ct.flagship.set_initial_ssh(ssh0)
    ct.set_initial_tracer(_blob(N))
    m0 = ct.mass()
    ct.run(12)
    assert abs(ct.mass() - m0) <= 1e-12 * abs(m0)
    g, gp = ct.gather(), plain.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_array_equal(g[k], gp[k], err_msg=k)
    # the face ssh is kept in sync, as the flagship's own run does
    for f in ("sshn_u", "sshn_v"):
        assert torch.equal(getattr(ct.flagship, f).data,
                           getattr(plain, f).data)


def test_coupled_quiescent_matches_standalone():
    """A quiescent closed basin: a diffusion-only coupled tracer matches
    the standalone model with u = v = 0 on a matching grid."""
    N = 24
    c0 = _blob(N)
    fs = nl.build(N, N, open_north=False, halo_width=2, **CPU)
    kappa = 1.0e4                       # dx = 1 km, dt 20 s -> 0.2/axis
    ct = tr.CoupledTracer(fs, kappa=kappa)
    ct.set_initial_tracer(c0)
    ct.run(6)

    msa = tr.build(N, N, dt=fs.p.rdt, u=0.0, v=0.0, kappa=kappa,
                   dx=1000.0, dy=1000.0, **CPU)
    msa.set_initial_tracer(c0)
    msa.run(6)
    np.testing.assert_allclose(ct.gather()["c"], msa.gather()["c"],
                               rtol=0, atol=1e-13)


def test_coupled_decomposition_invariant():
    """1 tile == 8 tiles for the coupled run."""
    N = 32
    got = {}
    for ndom in (1, 8):
        ct = _coupled(N, ndom=ndom, kappa=0.01)
        ct.flagship.set_initial_ssh(_ssh0(N))
        ct.set_initial_tracer(_blob(N))
        ct.run(10)
        got[ndom] = ct.gather()
    for k in got[1]:
        np.testing.assert_allclose(got[8][k], got[1][k], rtol=0, atol=1e-11)


def test_coupled_source_inversion_through_evolving_flow():
    """4D-Var drives the coupled model: observing the plume at two later
    times recovers the initial release while the tidal flow evolves
    underneath (the flow is a constant; the adjoint runs through
    advection by that flow), with the checkpointed loop and the
    obs_state_index selector.  tests/test_tracer.py's thresholds."""
    from dl_esm_inf_tpu_torch.models.assimilation import assimilate
    N = 32
    c_true = _blob(N, amp=0.8)
    ssh0 = gaussian_eta(N, N, amp=0.2)

    truth = _coupled(N, kappa=0.01)
    truth.flagship.set_initial_ssh(ssh0)
    truth.set_initial_tracer(c_true)
    obs, done = {}, 0
    for t in (5, 10):
        truth.run(t - done)
        done = t
        obs[t] = truth.gather()["c"]

    m = _coupled(N, kappa=0.01)
    m.flagship.set_initial_ssh(ssh0)
    res = assimilate(m, obs, iters=50, optimizer="lbfgs", remat_chunk=2,
                     obs_state_index=3)
    hist = res["cost_history"]
    assert hist[-1] < 1e-8 * hist[0]
    wet = layout.unstack_internal(m.grid.decomp,
                                  m._t_upd.numpy()).astype(bool)
    err = np.abs((res["eta0"] - c_true) * wet).max()
    assert err < 1e-3 * np.abs(c_true).max()


def test_coupled_guards():
    """The JAX package's guards: a NemoLite2D only, the plain path, a
    halo of at least 2 and the scheme's reach."""
    from dl_esm_inf_tpu_torch.models import gravity_wave as gw
    with pytest.raises(TypeError, match="NemoLite2D"):
        tr.CoupledTracer(gw.build(16, 16, **CPU))
    with pytest.raises(ValueError, match="plain path"):
        tr.CoupledTracer(nl.build(32, 32, fused=True, **CPU))
    k2 = nl.build(32, 32, halo_width=4, **CPU)
    k2.set_steps_per_exchange(2)
    with pytest.raises(ValueError, match="plain path"):
        tr.CoupledTracer(k2)
    with pytest.raises(ValueError, match="halo_width >= 2"):
        tr.CoupledTracer(nl.build(32, 32, **CPU))
    with pytest.raises(ValueError, match="scheme"):
        tr.CoupledTracer(nl.build(32, 32, halo_width=2, **CPU),
                         scheme="centred")
