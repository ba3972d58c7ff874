"""The PyTorch port's ETKF and LETKF against the JAX package.

``models/enkf.py`` on the port's ``Ensemble``, at float64 on the CPU.
Each test is the twin of a test of tests/test_enkf.py (and the two ETKF
tests of tests/test_tracer.py): the same seeded numpy inputs go through
the JAX package and the port, the ensembles and diagnostics are compared,
and the JAX test's own assertions are made on the port's results.  The
port runs as many tiles on one process as the JAX test has devices (8
where it takes the default), so its block sums weight halo copies out.
``_etkf_weights`` and ``gaspari_cohn`` are held against the JAX functions
directly, and the wet mask each adapter gives the filter against the JAX
filter's.

Tolerances (absolute; states of order 0.1-1): one analysis and the
weights 1e-11 against JAX (the same algebra; sums, LAPACK's eigenvector
basis and XLA's contractions differ in the last bits); cycled runs the
JAX tests' own 1e-9; ``gaspari_cohn`` 1e-14; the port's own
decomposition invariance 1e-12.  One single analysis is held at 1e-9
too: the tracer ensemble's at sigma = 1e-3 with 4 members, whose moments
(R^-1 = 1e6) reach ~1e6 times the (m-1) I they are added to, so the
last bit of a moment's sum moves the weights by ~1e-11 even on
identical inputs (1.0e-11 measured).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dl_esm_inf_tpu.models import enkf as jenkf
from dl_esm_inf_tpu.models import gravity_wave as jgw
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models import nlayer as jnlr
from dl_esm_inf_tpu.models import semi_implicit as jsi
from dl_esm_inf_tpu.models import shallow as jsh
from dl_esm_inf_tpu.models import tracer as jtr
from dl_esm_inf_tpu.models import twolayer as jtl
from dl_esm_inf_tpu.models.ensemble import Ensemble as JEnsemble

from dl_esm_inf_tpu_torch.models import enkf
from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import nlayer as nlr
from dl_esm_inf_tpu_torch.models import semi_implicit as si
from dl_esm_inf_tpu_torch.models import shallow as sh
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models import twolayer as tl
from dl_esm_inf_tpu_torch.models.ensemble import Ensemble

torch.set_num_threads(1)

TOL_ONE = 1e-11       # one analysis, the weights
TOL_CYCLED = 1e-9     # tests/test_enkf.py's own tolerance for cycled runs
NDOM = 8              # the JAX tests' default: every CPU device


class _Pkg:
    """One package's modules, with the keywords its builds take."""

    def __init__(self, gw, nl, nlr, si, sh, tl, tr, Ensemble, ETKF, kw):
        (self.gw, self.nl, self.nlr, self.si, self.sh, self.tl, self.tr,
         self.Ensemble, self.ETKF, self.kw) = (gw, nl, nlr, si, sh, tl, tr,
                                               Ensemble, ETKF, kw)


JAX = _Pkg(jgw, jnl, jnlr, jsi, jsh, jtl, jtr, JEnsemble, jenkf.ETKF, {})
#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
TORCH = _Pkg(gw, nl, nlr, si, sh, tl, tr, Ensemble, enkf.ETKF,
             dict(device="cpu"))
PKGS = (JAX, TORCH)


def _smooth_noise(rng, N, ncut=3):
    """tests/test_enkf.py's unit-amplitude low-wavenumber field."""
    z = np.fft.rfft2(rng.standard_normal((N, N)))
    ky = np.abs(np.fft.fftfreq(N) * N)[:, None]
    kx = (np.fft.rfftfreq(N) * N)[None, :]
    f = np.fft.irfft2(np.where((ky <= ncut) & (kx <= ncut), z, 0),
                      s=(N, N))
    return f / np.abs(f).max()


def _member_perturbations(N, m, amp, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([amp * _smooth_noise(rng, N) for _ in range(m)])


def _gw(P, N, ndom=NDOM, depth=10.0):
    return P.gw.build(N, N, ndomains=ndom, dt=0.05, depth=depth, **P.kw)


def _perturbed_ensemble(P, model, m, amp, seed=0):
    N = model.grid.decomp.global_nx
    ens = P.Ensemble(model, m)
    ens.set_member_states(0, gw.gaussian_eta(N, N, amp=0.3)
                          + _member_perturbations(N, m, amp, seed))
    return ens


def _truth_and_obs(N, cycles, fsteps):
    """tests/test_enkf.py's truth run, in the port (its observations are
    the JAX package's to 1e-15; both packages assimilate these)."""
    truth = _gw(TORCH, N)
    truth.set_initial_eta(gw.gaussian_eta(N, N, amp=0.5))
    obs = []
    for _ in range(cycles):
        truth.run(fsteps)
        obs.append(truth.gather()["eta"])
    return obs


def _both(run):
    """``run(P) -> (diagnostics list, gathered ensemble)`` for the JAX
    package and the port."""
    return [run(P) for P in PKGS]


def _compare(res, tol):
    (dj, gj), (dt, gt) = res
    for k in gj:
        assert np.all(np.isfinite(gt[k])), k
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert len(dj) == len(dt)
    for a, b in zip(dt, dj):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol,
                                       err_msg=k)


# --- the building blocks, directly ---------------------------------------------

@pytest.mark.parametrize("batch", [(), (5,), (3, 4)])
@pytest.mark.parametrize("m,rho", [(4, 1.0), (8, 1.3), (16, 2.0)])
def test_etkf_weights_match_jax(m, rho, batch):
    """``Wtot`` from random SPD moments against the JAX function: the
    weights, not the eigenvectors (whose signs and bases LAPACK and XLA
    choose differently)."""
    rng = np.random.default_rng(m + len(batch))
    y = rng.standard_normal(batch + (m, 3 * m))
    S = np.einsum("...ip,...jp->...ij", y, y) * 2.5
    d = rng.standard_normal(batch + (m,))
    want = np.asarray(jenkf._etkf_weights(jnp.asarray(S), jnp.asarray(d), m,
                                          jnp.asarray(rho)))
    got = enkf._etkf_weights(torch.from_numpy(S), torch.from_numpy(d), m,
                             rho).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_ONE)


def test_eigh_in_batches_is_unchanged(monkeypatch):
    """The batched eigh split into calls of EIGH_BATCH matrices (as the
    LETKF's 2^20 point batch on the card is) gives the one call's weights
    bitwise."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((5, 7, 6, 18))
    S = torch.from_numpy(np.einsum("...ip,...jp->...ij", y, y))
    d = torch.from_numpy(rng.standard_normal((5, 7, 6)))
    whole = enkf._etkf_weights(S, d, 6, 1.2)
    monkeypatch.setattr(enkf, "EIGH_BATCH", 4)
    calls = []
    eigh = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh",
                        lambda a: calls.append(a.shape[0]) or eigh(a))
    split = enkf._etkf_weights(S, d, 6, 1.2)
    assert calls == [4] * 8 + [3]
    assert torch.equal(split, whole)


def test_etkf_weights_degenerate_ensemble():
    """All members equal (S = 0): the weights are the identity scaled by
    sqrt(rho) and no NaN, as in the JAX package."""
    m = 6
    S, d = np.zeros((m, m)), np.zeros(m)
    got = enkf._etkf_weights(torch.from_numpy(S), torch.from_numpy(d), m,
                             1.5).numpy()
    want = np.asarray(jenkf._etkf_weights(jnp.asarray(S), jnp.asarray(d), m,
                                          jnp.asarray(1.5)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_ONE)
    np.testing.assert_allclose(got, np.sqrt(1.5) * np.eye(m), atol=1e-14)


def test_gaspari_cohn_matches_jax():
    """The taper on distances across its three branches, the branch
    points r = 0, 1 and 2 included, negative and huge r too."""
    r = np.concatenate([np.linspace(-2.5, 3.5, 601),
                        [0.0, 1.0, 2.0, 1.0 - 1e-12, 2.0 + 1e-12, 1e30]])
    want = np.asarray(jenkf.gaspari_cohn(jnp.asarray(r)))
    got = enkf.gaspari_cohn(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert got[-6] == 1.0                                   # r = 0
    np.testing.assert_allclose(got[-5], 5.0 / 24.0, atol=1e-15)  # r = 1
    np.testing.assert_allclose(got[-4], 0.0, atol=1e-14)    # r = 2
    assert got[-1] == 0.0


def _adapter_models(P):
    """One model per ensemble adapter of the port, at 24^2 on 8 tiles."""
    N = 24
    u, v = P.tr.streamfunction_velocities(gw.gaussian_eta(N, N, amp=0.1))
    fs = P.nl.build(N, N, ndomains=NDOM, open_north=True, halo_width=2,
                    **P.kw)
    return {
        "gravity_wave": _gw(P, N),
        "shallow": P.sh.build(N, N, ndomains=NDOM, dt=0.02, **P.kw),
        "twolayer": P.tl.build(N, N, ndomains=NDOM, dt=0.02, **P.kw),
        "nlayer": P.nlr.build(N, N, ndomains=NDOM, dt=0.02, layers=3,
                              **P.kw),
        "semi_implicit": P.si.build(N, N, ndomains=NDOM, dt=1.0,
                                    solver="chebyshev", **P.kw),
        "flagship": P.nl.build(N, N, ndomains=NDOM, open_north=True,
                               **P.kw),
        "tracer": P.tr.build(N, N, ndomains=NDOM, dt=0.5, u=u, v=v,
                             **P.kw),
        "coupled_tracer": P.tr.CoupledTracer(fs, kappa=0.01),
    }


def test_wet_mask_per_adapter_matches_jax():
    """The filter's observation weight (internal mask x the model's
    ``_t_upd``, else ``_t_wet``) on every adapter equals the JAX
    filter's: halo copies and dry points weigh 0."""
    models = [_adapter_models(P) for P in PKGS]
    for name in models[0]:
        fj = JAX.ETKF(JAX.Ensemble(models[0][name], 2), sigma=0.1)
        ft = TORCH.ETKF(TORCH.Ensemble(models[1][name], 2), sigma=0.1)
        np.testing.assert_array_equal(ft._wet.numpy(), np.asarray(fj._wet),
                                      err_msg=name)


# --- twins of tests/test_enkf.py ------------------------------------------------

def test_twin_experiment_reduces_error_and_spread():
    N, M = 24, 8
    perts = _member_perturbations(N, M, amp=0.2, seed=0)
    base = gw.gaussian_eta(N, N, amp=0.3)
    truth = _gw(TORCH, N)
    truth.set_initial_eta(base + perts.mean(axis=0)
                          + 0.5 * (perts[1] - perts[3])
                          + 0.3 * (perts[5] - perts[2]))
    obs = []
    for _ in range(3):
        truth.run(5)
        obs.append(truth.gather()["eta"])

    def run(P):
        ens = _perturbed_ensemble(P, _gw(P, N), M, amp=0.2, seed=0)
        filt = P.ETKF(ens, sigma=1e-3)
        diags = []
        for y in obs:
            ens.run(5)
            diags.append(filt.analysis(y))
        return diags, ens.gather_all()

    res = _both(run)
    _compare(res, TOL_CYCLED)
    diags = res[1][0]
    for diag in diags:
        assert diag["rms_innovation_after"] < diag["rms_innovation_before"]
        assert diag["spread_after"] < diag["spread_before"]
    assert diags[-1]["rms_innovation_after"] < 0.05 * diags[0][
        "rms_innovation_before"]


def test_analysis_preserves_mean_on_zero_innovation():
    N, M = 24, 6

    def run(P):
        ens = _perturbed_ensemble(P, _gw(P, N), M, amp=0.1)
        ens.run(4)
        mean, _ = ens.mean_and_spread()
        diag = P.ETKF(ens, sigma=0.05).analysis(mean["eta"])
        mean_a, _ = ens.mean_and_spread()
        np.testing.assert_allclose(mean_a["eta"], mean["eta"], rtol=0,
                                   atol=1e-11)
        assert diag["spread_after"] < diag["spread_before"]
        return [diag], ens.gather_all()

    _compare(_both(run), TOL_ONE)


@pytest.mark.parametrize("localized", [False, True], ids=["etkf", "letkf"])
def test_decomposition_invariant_analysis(localized):
    """Twin of test_decomposition_invariant_analysis (and, localized, of
    test_letkf_decomposition_invariant): cycled analyses and a forecast
    after them on 1 and 8 tiles equal each other within 1e-12 in the
    port (its block sums weight halo copies out) and the JAX package's
    runs within its tests' 1e-9."""
    N = 16
    M, seed, sigma = (4, 4, 0.03) if localized else (5, 3, 0.03)
    obs = _truth_and_obs(N, cycles=2, fsteps=4)
    got = {}
    for ndom in (1, 8):
        for P in PKGS:
            ens = _perturbed_ensemble(P, _gw(P, N, ndom), M, amp=0.15,
                                      seed=seed)
            filt = P.ETKF(ens, sigma=sigma,
                          localization_radius=4.0 if localized else None)
            for y in obs:
                ens.run(4)
                filt.analysis(y)
            ens.run(3)     # halo-consistency leg
            got[P is TORCH, ndom] = ens.gather_all()
    for k in got[True, 1]:
        np.testing.assert_allclose(got[True, 8][k], got[True, 1][k],
                                   rtol=0, atol=1e-12, err_msg=k)
        for ndom in (1, 8):
            np.testing.assert_allclose(got[True, ndom][k],
                                       got[False, ndom][k], rtol=0,
                                       atol=TOL_CYCLED, err_msg=k)


def test_observing_eta_updates_velocities():
    N, M = 24, 6
    obs = _truth_and_obs(N, cycles=1, fsteps=6)

    def run(P):
        ens = _perturbed_ensemble(P, _gw(P, N), M, amp=0.15)
        ens.run(6)
        before = ens.gather_all()
        diag = P.ETKF(ens, sigma=0.02).analysis(obs[0])
        after = ens.gather_all()
        assert np.abs(after["u"] - before["u"]).max() > 1e-8
        assert np.abs(after["v"] - before["v"]).max() > 1e-8
        return [diag], after

    _compare(_both(run), TOL_ONE)


def test_partial_observations_and_inflation():
    N, M = 24, 6
    obs = _truth_and_obs(N, cycles=1, fsteps=5)
    mask = np.zeros((N, N))
    mask[:, : N // 2] = 1.0
    spreads = {}
    for rho in (1.0, 1.5):
        def run(P):
            ens = _perturbed_ensemble(P, _gw(P, N), M, amp=0.15, seed=7)
            ens.run(5)
            diag = P.ETKF(ens, sigma=0.02, inflation=rho).analysis(
                obs[0], obs_mask=mask)
            return [diag], ens.gather_all()

        res = _both(run)
        _compare(res, TOL_ONE)
        diag = res[1][0][0]
        assert diag["rms_innovation_after"] < diag["rms_innovation_before"]
        spreads[rho] = diag["spread_after"]
    assert spreads[1.5] > spreads[1.0]


def test_flagship_ensemble_etkf():
    N, M = 32, 5
    truth = nl.build(N, N, ndomains=NDOM, open_north=True, device="cpu")
    truth.set_initial_ssh(gw.gaussian_eta(N, N, amp=0.2))
    truth.run(6)
    y = truth.gather()["sshn"]
    rng = np.random.default_rng(1)
    base = gw.gaussian_eta(N, N, amp=0.2)
    x0 = np.stack([base + 0.05 * rng.standard_normal((N, N))
                   for _ in range(M)])

    def run(P):
        ens = P.Ensemble(P.nl.build(N, N, ndomains=NDOM, open_north=True,
                                    **P.kw), M)
        ens.set_member_states(0, x0)
        ens.run(6)
        return [P.ETKF(ens, sigma=0.01).analysis(y)], ens.gather_all()

    res = _both(run)
    _compare(res, TOL_ONE)
    diag = res[1][0][0]
    assert diag["rms_innovation_after"] < diag["rms_innovation_before"]


def test_letkf_huge_radius_matches_global():
    N, M = 16, 5
    obs = _truth_and_obs(N, cycles=1, fsteps=4)
    got = {}
    for rad in (None, 1e6):
        def run(P):
            ens = _perturbed_ensemble(P, _gw(P, N), M, amp=0.15, seed=2)
            ens.run(4)
            diag = P.ETKF(ens, sigma=0.02,
                          localization_radius=rad).analysis(obs[0])
            return [diag], ens.gather_all()

        res = _both(run)
        _compare(res, TOL_ONE)
        got[rad] = res[1][1]
    for k in got[None]:
        np.testing.assert_allclose(got[1e6][k], got[None][k], rtol=0,
                                   atol=1e-7)


def test_letkf_locality():
    N, M = 24, 5
    obs = _truth_and_obs(N, cycles=1, fsteps=4)
    mask = np.zeros((N, N))
    mask[:, 1:4] = 1.0

    def run(P):
        ens = _perturbed_ensemble(P, _gw(P, N), M, amp=0.15, seed=6)
        ens.run(4)
        before = ens.gather_all()
        diag = P.ETKF(ens, sigma=0.02, localization_radius=3.0).analysis(
            obs[0], obs_mask=mask)
        after = ens.gather_all()
        if P is TORCH:
            assert diag["rms_innovation_after"] <= diag[
                "rms_innovation_before"]
            for k in before:
                # beyond 2L of every observation: unchanged (the
                # identity transform, to its rounding)
                far = np.abs(after[k][:, :, 12:] - before[k][:, :, 12:])
                assert far.max() < 1e-12, k
                near = np.abs(after[k][:, :, :8] - before[k][:, :, :8])
                assert near.max() > 1e-6, k
        return [diag], after

    _compare(_both(run), TOL_ONE)


def test_letkf_implicit_chebyshev_ensemble():
    N, M = 20, 4
    truth = si.build(N, N, ndomains=NDOM, dt=1.0, depth=10.0,
                     solver="chebyshev", device="cpu")
    truth.set_initial_eta(gw.gaussian_eta(N, N, amp=0.5))
    obs = []
    for _ in range(2):
        truth.run(3)
        obs.append(truth.gather()["eta"])
    rng = np.random.default_rng(9)
    x0 = np.stack([gw.gaussian_eta(N, N, amp=0.3)
                   + 0.15 * _smooth_noise(rng, N) for _ in range(M)])

    def run(P):
        ens = P.Ensemble(P.si.build(N, N, ndomains=NDOM, dt=1.0, depth=10.0,
                                    solver="chebyshev", **P.kw), M)
        ens.set_member_states(0, x0)
        filt = P.ETKF(ens, sigma=0.02, localization_radius=5.0,
                      inflation=1.05)
        diags = []
        for y in obs:
            ens.run(3)
            diags.append(filt.analysis(y))
        return diags, ens.gather_all()

    res = _both(run)
    _compare(res, TOL_CYCLED)
    for diag in res[1][0]:
        assert diag["rms_innovation_after"] < diag["rms_innovation_before"]


def test_adaptive_inflation_under_model_error():
    N, M = 24, 6
    obs = _truth_and_obs(N, cycles=6, fsteps=5)
    spread, gain = {}, {}
    for adaptive in (False, True):
        def run(P):
            ens = _perturbed_ensemble(P, _gw(P, N, depth=12.0), M,
                                      amp=0.15, seed=8)
            filt = P.ETKF(ens, sigma=0.005, adaptive_inflation=adaptive,
                          inflation_max=50.0)
            diags = []
            for y in obs:
                ens.run(5)
                diags.append(filt.analysis(y))
            return diags, ens.gather_all()

        res = _both(run)
        _compare(res, TOL_CYCLED)
        diags = res[1][0]
        if adaptive:
            # the estimator itself: clip((rms^2 - sigma^2) / spread^2)
            d1 = diags[1]
            want = min(50.0, max(1.0, (d1["rms_innovation_before"] ** 2
                                       - 0.005 ** 2)
                                 / d1["spread_before"] ** 2))
            assert abs(d1["inflation"] - want) < 1e-9 * want
        spread[adaptive] = diags[-1]["spread_after"]
        gain[adaptive] = sum(d["rms_innovation_before"]
                             - d["rms_innovation_after"] for d in diags[1:])
    assert spread[True] > 2.0 * spread[False], spread
    assert gain[True] > 2.0 * gain[False], gain


def test_multi_level_ensemble_etkf():
    N, M, L = 24, 5, 3
    rng = np.random.default_rng(11)
    base = gw.gaussian_eta(N, N, amp=0.3)
    perts = np.stack([0.1 * _smooth_noise(rng, N) for _ in range(M)])
    truth = nlr.build(N, N, ndomains=NDOM, dt=0.02, layers=L, device="cpu")
    truth.set_initial(np.stack(
        [base + perts.mean(0) + 0.4 * (perts[1] - perts[3])] * L))
    truth.run(5)
    y = truth.gather()["eta"][0]        # top interface only

    def run(P):
        ens = P.Ensemble(P.nlr.build(N, N, ndomains=NDOM, dt=0.02, layers=L,
                                     **P.kw), M)
        ens.set_member_states(0, np.stack(
            [np.stack([base + p] * L) for p in perts]))
        ens.run(5)
        before = ens.gather_all()
        diags = [P.ETKF(ens, sigma=1e-3, localization_radius=rad,
                        obs_level=0).analysis(y) for rad in (None, 6.0)]
        after = ens.gather_all()
        assert np.abs(after["eta"][:, 1:] - before["eta"][:, 1:]).max() > 1e-6
        return diags, after

    res = _both(run)
    _compare(res, TOL_CYCLED)
    for diag in res[1][0]:
        assert diag["rms_innovation_after"] < diag["rms_innovation_before"]


def test_guards():
    ens = Ensemble(_gw(TORCH, 16, ndom=1), 4)
    with pytest.raises(ValueError, match="sigma"):
        enkf.ETKF(ens, sigma=0.0)
    with pytest.raises(ValueError, match="inflation"):
        enkf.ETKF(ens, sigma=0.1, inflation=0.5)
    with pytest.raises(ValueError, match="not in"):
        enkf.ETKF(ens, obs_field="nope")
    with pytest.raises(ValueError, match="localization"):
        enkf.ETKF(ens, sigma=0.1, localization_radius=0.0)
    with pytest.raises(ValueError, match="obs_level"):
        enkf.ETKF(ens, sigma=0.1, obs_level=1)      # 2D observed field
    with pytest.raises(ValueError, match="inflation_max"):
        enkf.ETKF(ens, sigma=0.1, inflation_max=0.5)
    nens = Ensemble(nlr.build(16, 16, ndomains=1, dt=0.02, layers=3,
                              device="cpu"), 3)
    with pytest.raises(ValueError, match=r"obs_level must be in \[0, 3\)"):
        enkf.ETKF(nens, sigma=0.1, obs_level=3)


# --- twins of tests/test_tracer.py's ETKF cases ---------------------------------

def _blob(N, amp=1.0):
    """tests/test_tracer.py's plume."""
    return gw.gaussian_eta(N, N, amp=amp, width=0.08) + amp * 0.01


def _rotating(N):
    """tests/test_tracer.py's divergence-free rotating velocities."""
    x = (np.arange(N) - N / 2 + 0.5) / N
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


def test_ensemble_and_etkf_compose():
    """Twin of tests/test_tracer.py::test_ensemble_and_etkf_compose."""
    N, M = 24, 4
    u, v = _rotating(N)
    rng = np.random.default_rng(2)
    base = _blob(N)
    perts = np.stack([0.1 * rng.standard_normal((N, N)) for _ in range(M)])
    truth = tr.build(N, N, ndomains=NDOM, dt=0.3, u=u, v=v, device="cpu")
    truth.set_initial_tracer(base + perts.mean(0)
                             + 0.4 * (perts[0] - perts[2]))
    truth.run(5)
    y = truth.gather()["c"]

    def run(P):
        ens = P.Ensemble(P.tr.build(N, N, ndomains=NDOM, dt=0.3, u=u, v=v,
                                    **P.kw), M)
        ens.set_member_states(0, base + perts)
        ens.run(5)
        if P is TORCH:
            seq = tr.build(N, N, ndomains=NDOM, dt=0.3, u=u, v=v,
                           device="cpu")
            seq.set_initial_tracer(base + perts[0])
            seq.run(5)
            np.testing.assert_array_equal(ens.member(0)["c"],
                                          seq.gather()["c"])
        return [P.ETKF(ens, sigma=1e-3).analysis(y)], ens.gather_all()

    res = _both(run)
    _compare(res, TOL_CYCLED)    # the ill-conditioned analysis (docstring)
    diag = res[1][0][0]
    assert diag["rms_innovation_after"] < 0.2 * diag["rms_innovation_before"]


def test_coupled_ensemble_plume_obs_corrects_flow():
    """Twin of tests/test_tracer.py::
    test_coupled_ensemble_plume_obs_corrects_flow."""
    N, M = 32, 5
    rng = np.random.default_rng(3)
    base = gw.gaussian_eta(N, N, amp=0.2)
    perts = np.stack([0.05 * rng.standard_normal((N, N)) for _ in range(M)])
    c0 = _blob(N)

    def fresh(P, ssh0):
        fs = P.nl.build(N, N, ndomains=NDOM, open_north=True, halo_width=2,
                        **P.kw)
        ct = P.tr.CoupledTracer(fs, kappa=0.01)
        ct.flagship.set_initial_ssh(ssh0)
        ct.set_initial_tracer(c0)
        return ct

    truth = fresh(TORCH, base + perts.mean(0) + 0.5 * (perts[0] - perts[2]))
    truth.run(8)
    y = truth.gather()["c"]

    def run(P):
        ens = P.Ensemble(fresh(P, base), M)
        ens.set_member_states(0, np.stack([base + p for p in perts]))
        ens.run(8)
        if P is TORCH:
            seq = fresh(P, base + perts[0])
            seq.run(8)
            gm0, gs = ens.member(0), seq.gather()
            for a, b in (("ssh", "sshn"), ("u", "un"), ("v", "vn"),
                         ("c", "c")):
                np.testing.assert_array_equal(gm0[a], gs[b], err_msg=a)
        before = ens.gather_all()
        diag = P.ETKF(ens, obs_field="c", sigma=1e-3).analysis(y)
        after = ens.gather_all()
        assert np.abs(after["u"] - before["u"]).max() > 1e-7
        assert np.abs(after["ssh"] - before["ssh"]).max() > 1e-7
        return [diag], after

    res = _both(run)
    _compare(res, TOL_ONE)
    diag = res[1][0][0]
    assert diag["rms_innovation_after"] < 0.7 * diag["rms_innovation_before"]
