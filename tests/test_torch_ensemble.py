"""The PyTorch port's Ensemble against the JAX package.

``models/ensemble.py``: M members as a leading axis of each state
tensor, stepped by the model's own plain step, at float64 on the CPU.
For every adapter the members equal their own sequential runs in the
port bitwise, and the whole ensemble equals the JAX package's
``Ensemble`` on the same seeded inputs; npz files cross between the
packages both ways; the twins of tests/test_ensemble.py.

Tolerances: members vs sequential runs bitwise (the same operations on
a broadcast axis); port vs JAX 1e-12 relative to each field's largest
value (the same operations in the same order; XLA:CPU may contract a
multiply-add where PyTorch rounds twice).
"""
import os

import numpy as np
import pytest
import torch

from dl_esm_inf_tpu.models import gravity_wave as jgw
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models import nlayer as jnlr
from dl_esm_inf_tpu.models import semi_implicit as jsi
from dl_esm_inf_tpu.models import shallow as jsh
from dl_esm_inf_tpu.models import tracer as jtr
from dl_esm_inf_tpu.models import twolayer as jtl
from dl_esm_inf_tpu.models.ensemble import Ensemble as JEnsemble

from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import nlayer as nlr
from dl_esm_inf_tpu_torch.models import semi_implicit as si
from dl_esm_inf_tpu_torch.models import shallow as sh
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models import twolayer as tl
from dl_esm_inf_tpu_torch.models.ensemble import Ensemble

torch.set_num_threads(1)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")

GN = 24
NDOM = 8            # the JAX tests' tile count (every CPU device)


def _etas(n, gn, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    base = gw.gaussian_eta(gn, gn, amp=amp)
    return np.stack([base * (1 + 0.2 * k)
                     + 0.01 * amp * rng.standard_normal((gn, gn))
                     for k in range(n)])


def _levels(n, gn, layers, seed=4):
    rng = np.random.default_rng(seed)
    base = gw.gaussian_eta(gn, gn, amp=0.3)
    return np.stack([np.stack([base * (1 + 0.1 * k + 0.05 * lvl)
                               + 0.01 * rng.standard_normal((gn, gn))
                               for lvl in range(layers)])
                     for k in range(n)])


def _gyre(gn):
    x = (np.arange(gn) - gn / 2 + 0.5) / gn
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


U, V = _gyre(GN)
SI_KW = dict(dt=1.0, depth=10.0, tol=1e-11, solver="chebyshev")
SI_OPEN = dict(dt=0.5, depth=10.0, tol=1e-11, solver="chebyshev",
               open_north=True, bc_amp=0.05, bc_omega=0.3)
TR_KW = dict(dt=0.5, u=U, v=V, kappa=0.02)


def _coupled_base(mod, fs_kw, ssh, c):
    fs = mod[0].build(GN, GN, ndomains=NDOM, open_north=True, halo_width=2,
                      **fs_kw)
    fs.set_initial_ssh(ssh)
    ct = mod[1].CoupledTracer(fs, kappa=0.01)
    ct.set_initial_tracer(c)
    return ct


def _c0(gn):
    return gw.gaussian_eta(gn, gn, amp=1.0, width=0.12) + 0.01


#: name -> (build(module, kwargs), the members' states of field 0, the
#: setter of a sequential model's field 0, run splits)
CASES = {
    "gravity_wave": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, dt=0.05, depth=10.0,
                              **kw),
        lambda M: _etas(M, GN), "set_initial_eta", (12,)),
    "shallow": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, dt=0.02, **kw),
        lambda M: _etas(M, GN, seed=1), "set_initial_eta", (8,)),
    "twolayer": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, dt=0.02, **kw),
        lambda M: _etas(M, GN, seed=2), "set_initial", (6,)),
    "nlayer": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, dt=0.02, layers=3,
                              **kw),
        lambda M: _levels(M, GN, 3), "set_initial", (10,)),
    "semi_implicit": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, **SI_KW, **kw),
        lambda M: _etas(M, GN, seed=3), "set_initial_eta", (5,)),
    "semi_implicit_open": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, **SI_OPEN, **kw),
        lambda M: _etas(M, GN, seed=6) * 0.3, "set_initial_eta",
        (3, 2)),
    "flagship_h1": (
        lambda p, kw: p.build(32, 32, ndomains=NDOM, open_north=True, **kw),
        lambda M: _etas(M, 32, seed=4) * 0.2, "set_initial_ssh",
        (4, 3)),
    "flagship_h2": (
        lambda p, kw: p.build(32, 32, ndomains=NDOM, open_north=True,
                              halo_width=2, **kw),
        lambda M: _etas(M, 32, seed=4) * 0.2, "set_initial_ssh",
        (4, 3)),
    "tracer": (
        lambda p, kw: p.build(GN, GN, ndomains=NDOM, **TR_KW, **kw),
        lambda M: _etas(M, GN, seed=7) + 0.1, "set_initial_tracer",
        (5,)),
}

PKGS = {"jax": (dict(), {"gravity_wave": jgw, "shallow": jsh,
                         "twolayer": jtl, "nlayer": jnlr,
                         "semi_implicit": jsi, "semi_implicit_open": jsi,
                         "flagship_h1": jnl, "flagship_h2": jnl,
                         "tracer": jtr}),
        "torch": (CPU, {"gravity_wave": gw, "shallow": sh, "twolayer": tl,
                        "nlayer": nlr, "semi_implicit": si,
                        "semi_implicit_open": si, "flagship_h1": nl,
                        "flagship_h2": nl, "tracer": tr})}

M = 3


def _ensemble(pkg, name):
    """The package's ensemble of M members of CASES[name], field 0 per
    member from the seeded states."""
    kw, mods = PKGS[pkg]
    build, states, _setter, splits = CASES[name]
    ens = (JEnsemble if pkg == "jax" else Ensemble)(build(mods[name], kw), M)
    ens.set_member_states(0, states(M))
    for n in splits:
        ens.run(n)
    return ens


def _sequential(name, k):
    build, states, setter, splits = CASES[name]
    m = build(PKGS["torch"][1][name], CPU)
    getattr(m, setter)(states(M)[k])
    for n in splits:
        m.run(n)
    return m.gather()


#: the Ensemble's field names -> the models' gather names
_GATHER = {"ssh": "sshn", "u": "un", "v": "vn"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_members_match_sequential(name):
    """Every member equals its own sequential run bitwise; the clock
    continues across run() splits (time-dependent forcing)."""
    ens = _ensemble("torch", name)
    got = ens.gather_all()
    assert ens._istep0 == sum(CASES[name][3])
    for k in range(M):
        want = _sequential(name, k)
        for f, a in got.items():
            wf = _GATHER.get(f, f) if name.startswith("flagship") else f
            assert a.shape == (M,) + want[wf].shape
            np.testing.assert_array_equal(
                a[k], want[wf], err_msg=f"member {k} field {f}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ensemble_matches_jax(name):
    """The port's Ensemble equals the JAX package's on the same
    seeded member states, field by field."""
    gj = _ensemble("jax", name).gather_all()
    gt = _ensemble("torch", name).gather_all()
    assert set(gt) == set(gj)
    for f in gj:
        scale = np.abs(gj[f]).max()
        np.testing.assert_allclose(gt[f], gj[f], rtol=0,
                                   atol=1e-12 * max(scale, 1e-300),
                                   err_msg=f)


def _coupled_ens(pkg):
    mods = (jnl, jtr) if pkg == "jax" else (nl, tr)
    kw = {} if pkg == "jax" else CPU
    base = _coupled_base(mods, kw, gw.gaussian_eta(GN, GN, amp=0.2),
                         _c0(GN))
    base.run(2)                  # the members continue the coupled clock
    ens = (JEnsemble if pkg == "jax" else Ensemble)(base, M)
    ens.set_member_states(0, _etas(M, GN, seed=8) * 0.2)
    ens.run(4)
    ens.run(3)
    return ens


def test_coupled_tracer_ensemble():
    """Online-coupled members (flow and tracer each): members equal
    sequential coupled runs bitwise, and the ensemble equals the JAX
    package's."""
    ens = _coupled_ens("torch")
    assert ens._istep0 == 9
    got = ens.gather_all()
    assert set(got) == {"ssh", "u", "v", "c"}
    for k in range(M):
        m = _coupled_base((nl, tr), CPU, gw.gaussian_eta(GN, GN, amp=0.2),
                          _c0(GN))
        m.run(2)
        m.flagship.set_initial_ssh(_etas(M, GN, seed=8)[k] * 0.2)
        m.run(4)
        m.run(3)
        want = m.gather()
        for f in got:
            np.testing.assert_array_equal(got[f][k], want[_GATHER.get(f, f)],
                                          err_msg=f"member {k} {f}")
    gj = _coupled_ens("jax").gather_all()
    for f in gj:
        np.testing.assert_allclose(got[f], gj[f], rtol=0,
                                   atol=1e-12 * np.abs(gj[f]).max(),
                                   err_msg=f)


def test_flagship_ensemble_continues_base_clock():
    """An ensemble built from a mid-run model inherits its step index:
    member 0 continues exactly like the base run."""
    gn = 32
    eta0 = _etas(1, gn, seed=5)[0] * 0.2
    base = nl.build(gn, gn, open_north=True, **CPU)
    base.set_initial_ssh(eta0)
    base.run(5)
    ens = Ensemble(base, 2)
    ens.run(3)

    seq = nl.build(gn, gn, open_north=True, **CPU)
    seq.set_initial_ssh(eta0)
    seq.run(5)
    seq.run(3)
    np.testing.assert_array_equal(ens.gather_all()["ssh"][0],
                                  seq.gather()["sshn"])
    np.testing.assert_array_equal(ens.member(1)["u"], seq.gather()["un"])


@pytest.mark.parametrize("direction", ["torch_to_torch", "torch_to_jax",
                                       "jax_to_torch"])
def test_ensemble_save_load_restart(tmp_path, direction):
    """Cycling DA needs restarts: save -> load into a FRESH ensemble ->
    continue equals the uninterrupted run, the flagship's forcing clock
    included (``__step__``); the npz crosses between the packages."""
    gn = 32
    etas = _etas(M, gn, seed=5) * 0.3
    src, dst = direction.split("_to_")

    def fresh(pkg):
        if pkg == "jax":
            return JEnsemble(jnl.build(gn, gn, open_north=True), M)
        return Ensemble(nl.build(gn, gn, open_north=True, **CPU), M)

    a = fresh(src)
    a.set_member_states(0, etas)
    a.run(4)
    path = os.path.join(tmp_path, "ens.npz")
    a.save(path)
    with np.load(path) as data:
        assert sorted(data.files) == ["__step__", "ssh", "u", "v"]
        assert int(data["__step__"]) == 4
    a.run(3)

    b = fresh(dst)
    b.load(path)
    assert b._istep0 == 4
    b.run(3)
    ga, gb = a.gather_all(), b.gather_all()
    for k in ga:
        if src == dst:
            np.testing.assert_array_equal(gb[k], ga[k])
        else:
            np.testing.assert_allclose(gb[k], ga[k], rtol=0,
                                       atol=1e-12 * np.abs(ga[k]).max())


def test_ensemble_statistics_and_guards():
    gn = 16
    base = gw.build(gn, gn, dt=0.05, **CPU)
    base.set_initial_eta(gw.gaussian_eta(gn, gn, amp=0.3))
    ens = Ensemble(base, 3)                  # identical members
    ens.run(4)
    mean, spread = ens.mean_and_spread()
    assert mean["eta"].shape == (gn, gn)
    assert float(np.abs(spread["eta"]).max()) < 1e-15
    np.testing.assert_allclose(mean["eta"], ens.member(2)["eta"],
                               rtol=1e-15, atol=0)

    with pytest.raises(ValueError, match="leading dim"):
        ens.set_member_states(0, np.zeros((2, gn, gn)))
    with pytest.raises(ValueError, match="n_members"):
        Ensemble(base, 0)
    with pytest.raises(TypeError, match="adapter"):
        Ensemble(object(), 2)
    with pytest.raises(ValueError, match="chebyshev"):
        Ensemble(si.build(gn, gn, dt=1.0, **CPU), 2)
    with pytest.raises(ValueError, match="fused"):
        Ensemble(gw.build(gn, gn, fused=True, **CPU), 2)
    with pytest.raises(ValueError, match="bathymetry"):
        Ensemble(nl.build(gn, gn, depth=np.full((gn, gn), 50.0), **CPU), 2)
