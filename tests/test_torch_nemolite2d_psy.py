"""The port's PSy-built flagship against the JAX package's and against
the port's production model.

Mirrors tests/test_nemolite2d_psy.py: ``NemoLite2DPsy`` (13 metadata
kernels bound into one Schedule) on its three tiers (one ``invoke`` per
kernel, the plain schedule, the fused sweep, whose plain version runs
on the CPU) reproduces the JAX ``NemoLite2DPsy`` and the port's
production ``NemoLite2D`` after 30 steps of 34x30 at float64, on 1 and 4
tiles, at the JAX test's tolerance (1e-10).  The generated CUDA kernel
is held against the plain fused tier on the card
(tests/test_torch_gpu.py, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta as j_gaussian
from dl_esm_inf_tpu.models.nemolite2d_psy import NemoLite2DPsy as JPsy

from dl_esm_inf_tpu_torch.api.kernel_meta import invoke
from dl_esm_inf_tpu_torch.core.field import Field
from dl_esm_inf_tpu_torch.interop import load_reference_state
from dl_esm_inf_tpu_torch.models import nemolite2d as tnl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")
GNX, GNY, NSTEPS = 34, 30, 30
TOL = 1e-10


def check(got, want, tol=TOL):
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def production():
    """The port's production model, 4 tiles."""
    m = tnl.build(GNX, GNY, ndomains=4, **CPU)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    m.run(NSTEPS)
    return m.gather()


@pytest.fixture(scope="module")
def jax_psy():
    """The JAX NemoLite2DPsy on its jnp tier, 4 shards."""
    m = JPsy(GNX, GNY, ndomains=4)
    m.set_initial_ssh(j_gaussian(GNX, GNY, amp=0.2))
    m.run(NSTEPS)
    return {k: np.asarray(v) for k, v in m.gather().items()}


def invoke_steps(m, nsteps):
    """The PSyclone-compatibility tier: one ``invoke`` per kernel call,
    the calls' user scalars those of the step."""
    for _ in range(nsteps):
        it = iter(m._scalars_at(m._step))
        for kern, *args in m._calls():
            invoke(kern, *(a if isinstance(a, Field) else next(it)
                           for a in args))
        m._step += 1


def fused_repeats(m, nsteps, repeats):
    """``nsteps`` steps through the fused program at ``repeats`` steps
    per sweep, with each step's forcing."""
    n = nsteps // repeats
    m._sched.fused_program(n, repeats=repeats)(
        scalars=[[m._scalars_at(m._step + i * repeats + j)
                  for j in range(repeats)] for i in range(n)])
    m._step += n * repeats


def run_psy(ndom=4, tier="schedule"):
    m = NemoLite2DPsy(GNX, GNY, ndomains=ndom, **CPU)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    if tier == "invoke":
        invoke_steps(m, NSTEPS)
    else:
        m.run(NSTEPS, fused=tier == "fused")
    return m.gather()


def test_production_matches_jax_psy(production, jax_psy):
    check(production, jax_psy)


@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("tier", ["invoke", "schedule", "fused"])
def test_psy_tiers_match_jax_and_production(production, jax_psy, tier,
                                            ndom):
    got = run_psy(ndom=ndom, tier=tier)
    check(got, jax_psy)
    check(got, production)


def test_psy_exchange_plan_equals_jax():
    jm = JPsy(GNX, GNY, ndomains=4)
    tm = NemoLite2DPsy(GNX, GNY, ndomains=4, **CPU)
    assert tm._sched.exchanges == jm._sched.exchanges
    assert tm._sched._scalar_src == [(k, float(v)) for k, v in
                                     jm._sched._scalar_src]


def test_psy_fused_repeats_deep_blocking(production):
    """Repeats 3 at halo 8: the dataflow erosion is [3, 5, 7] and 3
    repeats fit; fused_program(10, repeats=3) with per-step forcing ==
    production."""
    m = NemoLite2DPsy(GNX, GNY, ndomains=4, halo_width=8, **CPU)
    s = m._sched
    assert [s.fused_erosion(k) for k in (1, 2, 3)] == [3, 5, 7]
    assert s.max_fused_repeats() == 3
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    fused_repeats(m, NSTEPS, 3)
    check(m.gather(), production)
    m2 = NemoLite2DPsy(GNX, GNY, ndomains=4, halo_width=8, **CPU)
    m2.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    fused_repeats(m2, NSTEPS, 2)
    check(m2.gather(), production)


def test_psy_max_repeats_by_halo():
    assert NemoLite2DPsy(GNX, GNY, ndomains=1,
                         **CPU)._sched.max_fused_repeats() == 2
    m = NemoLite2DPsy(GNX, GNY, ndomains=1, halo_width=1, **CPU)
    with pytest.raises(ValueError, match="halo_width=3"):
        m._sched.max_fused_repeats()
    with pytest.raises(ValueError, match="halo_width=3"):
        m.run(1, fused=True)


def test_psy_non_default_params():
    """Non-default constants (incl. g) reach EVERY kernel, as in the JAX
    package."""
    p = tnl.Params(g=1.62, visc=0.3, cbfr=0.001, amp=0.15)
    jp = jnl.Params(g=1.62, visc=0.3, cbfr=0.001, amp=0.15)
    m1 = tnl.build(GNX, GNY, ndomains=4, params=p, **CPU)
    m1.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    m1.run(20)
    jm = JPsy(GNX, GNY, ndomains=4, params=jp)
    jm.set_initial_ssh(j_gaussian(GNX, GNY, amp=0.2))
    jm.run(20)
    for kw in (dict(), dict(fused=True)):
        m2 = NemoLite2DPsy(GNX, GNY, ndomains=4, params=p, **CPU)
        m2.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
        m2.run(20, **kw)
        check(m2.gather(), m1.gather())
        check(m2.gather(), jm.gather())


def test_psy_state_loaded_from_jax():
    """A JAX NemoLite2DPsy's gathered state and step counter load into
    the port's model (interop), and both then advance alike."""
    jm = JPsy(GNX, GNY, ndomains=4)
    jm.set_initial_ssh(j_gaussian(GNX, GNY, amp=0.2))
    jm.run(12)
    state = {k: np.asarray(v) for k, v in jm.gather().items()}
    tm = NemoLite2DPsy(GNX, GNY, ndomains=4, **CPU)
    load_reference_state(tm, dict(state, depth=100.0,
                                  tmask=tnl.default_tmask(GNX, GNY)),
                         istep0=jm._step)
    assert tm._step == 12
    jm.run(10)
    tm.run(10, fused=True)
    check(tm.gather(), jm.gather())
    with pytest.raises(ValueError, match="depth"):
        load_reference_state(tm, dict(state, depth=50.0))
