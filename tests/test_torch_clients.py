"""The PyTorch port's sweep-engine client models against the JAX package.

Gravity wave, shallow (SW offset, doubly periodic), two-layer and
tracer (upwind and van Leer).  On the CPU the port's fused path runs
the sweep kernels' plain version (:func:`stencil_sweep_reference`), so
these tests pin each model's step, the K-step schedule and the exchange
to the JAX package at float64 — its jnp step and its Pallas sweep in
interpret mode — and to the models' independent numpy goldens, at 1
and 4 domains.  The CUDA kernels themselves are held against the plain
version by tests/test_torch_gpu.py (skipped without a card) and by
``chip_smoke.py``.

Tolerances: rtol 1e-12, atol 1e-13 against the JAX package (both run
the same operations in the same order; XLA:CPU may contract a
multiply-add where PyTorch rounds twice, an ulp); against the goldens,
the tolerances of the JAX package's own tests
(tests/test_gravity_wave.py, test_shallow.py, test_twolayer.py,
test_tracer.py).
"""
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dl_esm_inf_tpu.models import gravity_wave as jgw
from dl_esm_inf_tpu.models import shallow as jsh
from dl_esm_inf_tpu.models import tracer as jtr
from dl_esm_inf_tpu.models import twolayer as jtl

from dl_esm_inf_tpu_torch.interop import load_reference_state
from dl_esm_inf_tpu_torch.models import gravity_wave as tgw
from dl_esm_inf_tpu_torch.models import shallow as tsh
from dl_esm_inf_tpu_torch.models import tracer as ttr
from dl_esm_inf_tpu_torch.models import twolayer as ttl
from dl_esm_inf_tpu_torch.ops.stencil_sweep import stencil_sweep_reference

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")

RTOL, ATOL = 1e-12, 1e-13
GNX, GNY = 96, 64
NSTEPS = 20                     # K = 8: two sweeps and four single steps


def _gyre(gnx, gny):
    """Divergence-free rotating face velocities (tests/test_tracer.py's
    streamfunction, scaled to the domain)."""
    x = (np.arange(gnx) - gnx / 2 + 0.5) / gnx
    y = (np.arange(gny) - gny / 2 + 0.5) / gny
    psi = 12.0 * np.exp(-((x[None, :] ** 2 + y[:, None] ** 2) / 0.18))
    return ttr.streamfunction_velocities(psi)


U_GYRE, V_GYRE = _gyre(GNX, GNY)


@dataclass(frozen=True)
class Client:
    jmod: object
    tmod: object
    kw: dict
    K: int                      # the kernel's largest K
    reach: int
    n_state: int
    n_aux: int                  # float aux planes of the sweep
    has_code: bool
    golden_tol: tuple           # (rtol, atol) of the JAX package's test


def _tracer_kw(scheme):
    return dict(dt=0.2, u=U_GYRE, v=V_GYRE, kappa=0.02, scheme=scheme)


CLIENTS = {
    "gravity_wave": Client(jgw, tgw, dict(dt=0.05, depth=10.0), 8, 1, 3, 0,
                           True, (1e-12, 1e-12)),
    "shallow": Client(jsh, tsh, dict(dt=0.02), 8, 1, 3, 0, False,
                      (1e-11, 1e-12)),
    "twolayer": Client(jtl, ttl, dict(dt=0.01), 8, 1, 6, 0, True,
                       (1e-12, 1e-12)),
    "tracer_upwind": Client(jtr, ttr, _tracer_kw("upwind"), 8, 1, 1, 2,
                            True, (0.0, 1e-12)),
    "tracer_vanleer": Client(jtr, ttr, _tracer_kw("vanleer"), 4, 2, 1, 2,
                             True, (0.0, 1e-12)),
}


def _initial(name):
    """The setter's name and its arguments: the global initial state."""
    if name == "gravity_wave":
        return "set_initial_eta", (tgw.gaussian_eta(GNX, GNY),)
    if name == "shallow":
        # the bump sits on the periodic wrap seam
        return "set_initial_eta", (np.roll(
            tgw.gaussian_eta(GNX, GNY, amp=0.3), GNX // 2, axis=1),)
    if name == "twolayer":
        return "set_initial", (tgw.gaussian_eta(GNX, GNY, amp=0.5),
                               -tgw.gaussian_eta(GNX, GNY, amp=2.0))
    return "set_initial_tracer", (
        tgw.gaussian_eta(GNX, GNY, amp=1.0, width=0.08) + 0.01,)


def _init(name, m):
    setter, args = _initial(name)
    getattr(m, setter)(*args)


def _golden(name, m, nsteps):
    c = CLIENTS[name]
    args = _initial(name)[1]
    if name == "gravity_wave":
        return tgw.golden_reference(args[0], tgw.default_tmask(GNX, GNY),
                                    1.0, 1.0, m.dt, nsteps, depth=m.depth)
    if name == "shallow":
        return tsh.golden_reference(args[0], m.dt, nsteps)
    if name == "twolayer":
        return ttl.golden_reference(*args, ttl.default_tmask(GNX, GNY), 1.0,
                                    1.0, m.dt, nsteps)
    kw = c.kw
    return {"c": ttr.golden_reference(
        args[0], tgw.default_tmask(GNX, GNY), kw["u"], kw["v"], kw["dt"],
        nsteps, kappa=kw["kappa"], scheme=kw["scheme"])}


def _assert_close(got: dict, want: dict, rtol=RTOL, atol=ATOL, where=None):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert np.all(np.isfinite(g)), k
        if where is not None:
            g, w = g[where], w[where]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def _block(c: Client, ly, lx, seed):
    """Seeded state, float aux planes and mask code on one block, as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    state = [0.3 * rng.normal(size=(ly, lx)) for _ in range(c.n_state)]
    aux = [0.4 * rng.normal(size=(ly, lx)) for _ in range(c.n_aux)]
    if c.has_code:
        aux.append(rng.integers(0, 8, size=(ly, lx)).astype(np.int8))
    return state, aux


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", CLIENTS)
def test_step_math_matches_jax(name):
    c = CLIENTS[name]
    mj = c.jmod.build(GNX, GNY, **c.kw)
    mt = c.tmod.build(GNX, GNY, **c.kw, **CPU)
    state, aux = _block(c, 24, 40, seed=len(name))
    tprep = mt._prepare(_torch(aux))
    jprep = [np.asarray(a) for a in tprep]
    want = mj._step_math(*state, *jprep)
    got = mt._step_math(*_torch(state), *tprep)
    assert len(got) == len(want) == c.n_state
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", CLIENTS)
def test_sweep_reference_matches_jax_sweeps(name):
    """stencil_sweep_reference (the kernels' plain version) at the
    kernel's largest K against the JAX chained step on the whole block,
    and against the JAX Pallas sweep in interpret mode on the cells at
    least K*reach from the block edge (edge cells hold each version's
    own wrap values)."""
    c = CLIENTS[name]
    K = c.K
    mj = c.jmod.build(GNX, GNY, pallas=True, steps_per_sweep=K, **c.kw)
    mj.enable_pallas(interpret=True, steps_per_sweep=K)
    mt = c.tmod.build(GNX, GNY, **c.kw, **CPU)
    ly, lx = mj.grid.halo_spec.local_ny, mj.grid.halo_spec.local_nx
    state, aux = _block(c, ly, lx, seed=K)
    got = stencil_sweep_reference(mt._step_math, K, _torch(state),
                                  mt._prepare(_torch(aux)))
    jprep = [np.asarray(a) for a in mt._prepare(_torch(aux))]
    s = tuple(state)
    for _ in range(K):
        s = mj._step_math(*s, *jprep)
    for w, g in zip(s, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    pal = mj._make_sweep(K)(*(jnp.asarray(a) for a in state + aux))
    r = K * c.reach
    assert len(pal) == len(got)
    for w, g in zip(pal, got):
        np.testing.assert_allclose(g.numpy()[r:-r, r:-r],
                                   np.asarray(w)[r:-r, r:-r], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("name", CLIENTS)
def test_slice_matches_jax_and_golden(name, ndom):
    """The whole slice: port build(fused=True) on the CPU at float64
    against the JAX model's Pallas sweep in interpret mode, and against
    the numpy golden; NSTEPS leaves a remainder after the K-step
    sweeps."""
    c = CLIENTS[name]
    mj = c.jmod.build(GNX, GNY, ndomains=ndom, pallas=True,
                      steps_per_sweep=c.K, **c.kw)
    mj.enable_pallas(interpret=True, steps_per_sweep=c.K)
    mt = c.tmod.build(GNX, GNY, ndomains=ndom, fused=True,
                      steps_per_sweep=c.K, **c.kw, **CPU)
    assert mt.grid.dtype == torch.float64 and mt.use_fused
    assert mt.grid.decomp.nprocx * mt.grid.decomp.nprocy == ndom
    for m in (mj, mt):
        _init(name, m)
        m.run(NSTEPS)
    got = mt.gather()
    _assert_close(got, mj.gather())
    cj, ct = mj.checksums(), mt.checksums()
    for k in cj:
        assert ct[k] == pytest.approx(cj[k], rel=1e-12)
    rtol, atol = c.golden_tol
    wet = (tgw.default_tmask(GNX, GNY) == 1 if c.tmod is ttr else None)
    _assert_close(got, _golden(name, mt, NSTEPS), rtol=rtol, atol=atol,
                  where=wet)


@pytest.mark.parametrize("name", CLIENTS)
def test_plain_schedules_match_fused(name):
    """The plain path (one exchange per step, and K chained steps per
    depth-K*reach exchange) equals the fused path's plain version
    bitwise at 4 domains."""
    c = CLIENTS[name]
    ms = [c.tmod.build(GNX, GNY, ndomains=4, **c.kw, **CPU),
          c.tmod.build(GNX, GNY, ndomains=4, steps_per_sweep=3, **c.kw, **CPU),
          c.tmod.build(GNX, GNY, ndomains=4, fused=True, steps_per_sweep=3,
                       **c.kw, **CPU)]
    assert [m.use_fused for m in ms] == [False, False, True]
    for m in ms:
        _init(name, m)
        m.run(11)
    for m in ms[1:]:
        _assert_close(m.gather(), ms[0].gather(), rtol=0, atol=0)


@pytest.mark.parametrize("scheme", ["upwind", "vanleer"])
def test_tracer_mass_conserved_exactly(scheme):
    """As tests/test_tracer.py: flux form + no-flux walls keep the
    tracer mass to roundoff (here 40 steps of rotation + diffusion on
    the fused path, 4 domains)."""
    N = 32
    u, v = _gyre(N, N)
    m = ttr.build(N, N, ndomains=4, dt=0.2, u=u / 30.0, v=v / 30.0,
                  kappa=0.05, scheme=scheme, fused=True,
                  steps_per_sweep=4, **CPU)
    m.set_initial_tracer(tgw.gaussian_eta(N, N, amp=1.0, width=0.08)
                         + 0.01)
    m0 = m.mass()
    m.run(40)
    assert abs(m.mass() - m0) <= 1e-12 * abs(m0)


def test_tracer_tvd_no_new_extrema():
    """As tests/test_tracer.py: both schemes keep a step profile inside
    its initial range, and the limited scheme smears it less."""
    N = 48
    c0 = np.zeros((N, N))
    c0[:, 8:16] = 1.0
    final = {}
    for scheme in ("upwind", "vanleer"):
        m = ttr.build(N, N, dt=0.5, u=0.5, v=0.0, scheme=scheme, fused=True,
                      steps_per_sweep=4, **CPU)
        m.set_initial_tracer(c0)
        m.run(40)
        c = m.gather()["c"]
        assert c.min() >= -1e-13 and c.max() <= 1.0 + 1e-13, scheme
        final[scheme] = c
    mid = N // 2
    smear = {k: int(((v[mid] > 0.05) & (v[mid] < 0.95)).sum())
             for k, v in final.items()}
    assert smear["vanleer"] < smear["upwind"]


@pytest.mark.parametrize("name", CLIENTS)
def test_state_carried_from_jax(name):
    """JAX runs n1 steps on its plain path, the port takes its state
    over, and both run n2 more: the port continues the JAX
    trajectory."""
    c = CLIENTS[name]
    n1, n2 = 5, 11
    mj = c.jmod.build(GNX, GNY, ndomains=4, **c.kw)
    _init(name, mj)
    mj.run(n1)
    mt = c.tmod.build(GNX, GNY, ndomains=4, fused=True,
                      steps_per_sweep=c.K, **c.kw, **CPU)
    state = dict(mj.gather(), tmask=mt.grid.global_tmask())
    if c.tmod is ttr:
        state.update(u=c.kw["u"], v=c.kw["v"])
    load_reference_state(mt, state)
    _assert_close(mt.gather(), mj.gather(), rtol=0, atol=0)
    mj.run(n2)
    mt.run(n2)
    _assert_close(mt.gather(), mj.gather())
    with pytest.raises(ValueError, match="tmask"):
        load_reference_state(mt, dict(state, tmask=np.zeros((GNY, GNX))))
    first = next(iter(mt.gather()))
    with pytest.raises(ValueError, match="missing"):
        load_reference_state(mt, {k: v for k, v in state.items()
                                  if k != first})
    if c.tmod is ttr:
        with pytest.raises(ValueError, match="velocities"):
            load_reference_state(mt, dict(state, u=c.kw["u"] * 2.0))
    elif c.tmod is ttl:
        with pytest.raises(ValueError, match="no depth"):
            load_reference_state(mt, dict(state, depth=10.0))


@pytest.mark.parametrize("name", CLIENTS)
def test_guards_and_no_fallback(name):
    """K beyond the kernel's ring or the halo raises; a tensor that is
    not on the CPU goes to the kernel or raises, and the plain version
    is never taken for it."""
    c = CLIENTS[name]
    with pytest.raises(ValueError, match="steps_per_sweep"):
        c.tmod.build(GNX, GNY, fused=True, steps_per_sweep=c.K + 1, **c.kw,
                     **CPU)
    m = c.tmod.build(GNX, GNY, fused=True, **c.kw, **CPU)       # halo = reach
    with pytest.raises(ValueError, match="halo_width"):
        m.enable_fast_path(steps_per_sweep=2)
    with pytest.raises(ValueError, match="remat"):     # no backward
        m.step_program(4, remat_chunk=2)
    kern = m.sweep_kernel
    meta = [torch.empty((8, 8), dtype=torch.float64, device="meta")
            for _ in range(c.n_state + c.n_aux)]
    aux = meta[c.n_state:] + ([torch.empty((8, 8), dtype=torch.int8,
                                           device="meta")]
                              if c.has_code else [])
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        m._make_sweep(1)(meta[:c.n_state], aux)
    with pytest.raises(ValueError, match="sub-steps"):
        kern(meta[:c.n_state], meta[c.n_state:], aux[-1] if c.has_code
             else None, consts=m.kernel_constants(), K=c.K + 1,
             variant=m._variant)
    assert kern.launches == before


def test_shallow_requires_sw_periodic():
    from dl_esm_inf_tpu_torch.core.constants import (ARAKAWA_C, BC_NONE,
                                                     BC_PERIODIC, OFFSET_NE)
    from dl_esm_inf_tpu_torch.core.grid import Grid, grid_init
    grid = Grid(ARAKAWA_C, (BC_PERIODIC, BC_PERIODIC, BC_NONE), OFFSET_NE,
                **CPU)
    grid.decompose(16, 16)
    grid_init(grid, 1.0, 1.0)
    with pytest.raises(ValueError, match="SW offset"):
        tsh.ShallowModel(grid, dt=0.1)


def test_masks_match_jax():
    """The update masks and the int8 code the kernels read equal the
    JAX model's, halo cells included (4 domains, walls)."""
    mj = jgw.build(GNX, GNY, ndomains=4)
    mt = tgw.build(GNX, GNY, ndomains=4, **CPU)
    np.testing.assert_array_equal(mt._mask_codes.numpy(),
                                  np.asarray(mj._mask_codes))
    for a, b in zip(mt._step_aux, (mj._t_upd, mj._u_wet, mj._v_wet)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tracer_cli_runs_on_cpu(capsys):
    ttr._main(["24", "8", "vanleer", "cpu"])
    out = capsys.readouterr().out
    assert "mass drift" in out and "device=cpu" in out and "K=4" in out
