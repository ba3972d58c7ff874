"""The CUDA sweep kernels on the card, against their plain PyTorch version.

Every test here needs a CUDA GPU.  On a machine without one the whole
module skips while it is collected, so it adds no item to the suite
there: every worker of a run on one machine sees the same answer, so all
collect the same (empty) list.  This file imports neither jax nor the
JAX package, so on a machine with a GPU and no JAX it runs without the
suite's conftest:

    python -m pytest tests/test_torch_gpu.py -q --noconftest
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import nlayer as nlm
from dl_esm_inf_tpu_torch.models import shallow as sh
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models import twolayer as tl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.ops import fused_step as fs
from dl_esm_inf_tpu_torch.ops import solvers as so
from dl_esm_inf_tpu_torch.ops.stencil_sweep import stencil_sweep_reference
from dl_esm_inf_tpu_torch.parallel.halo import exchange_multi_fn

sys.path.insert(0, str(Path(__file__).resolve().parent))
from nemolite2d_golden import golden_run  # noqa: E402

if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)",
                allow_module_level=True)

torch.set_num_threads(2)

GNX, GNY = 96, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the sweep kernel has no CPU mode)")
    return torch.device("cuda")


def _pair(device, ndom, K, dtype, steps):
    ms = [nl.build(GNX, GNY, ndomains=ndom, fused=f, steps_per_sweep=K,
                   halo_width=2 * K, dtype=dtype, device=device)
          for f in (True, False)]
    for m in ms:
        m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.5))
    before = fs.nemolite2d_sweep.launches
    ms[0].run(steps)
    assert fs.nemolite2d_sweep.launches - before == steps // K + steps % K
    ms[1].run(steps)
    assert fs.nemolite2d_sweep.launches - before == steps // K + steps % K
    return [m.gather() for m in ms]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_kernel_matches_plain(cuda_device, K, ndom, dtype):
    """Both versions round every operation once, in the same order (the
    kernel is built without FMA contraction): they agree to roundoff,
    bitwise as measured on an H100."""
    got, want = _pair(cuda_device, ndom, K, dtype, 23)
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


@pytest.mark.gpu
def test_kernel_matches_golden(cuda_device):
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = nl.build(gnx, gny, fused=True, steps_per_sweep=4,
                 dtype=torch.float64, device=cuda_device)
    m.set_initial_ssh(ssh0)
    m.run(10)
    want = golden_run(nl.default_tmask(gnx, gny), ssh0, 10, m.p, m.grid.dx,
                      m.grid.dy, 100.0)
    got = m.gather()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-11, atol=1e-13,
                                   err_msg=k)


@pytest.mark.gpu
def test_wrapper_checks_its_inputs(cuda_device):
    m = nl.build(GNX, GNY, fused=True, device=cuda_device)
    s = (m.sshn_t.data, m.un.data, m.vn.data)
    consts = fs.kernel_constants(m.p, 1000.0, 1000.0, m._fcor, 100.0,
                                 s[0].dtype)
    codes = m._mask_codes
    with pytest.raises(TypeError, match="float32/float64"):
        fs.nemolite2d_sweep(*(t.to(torch.bfloat16) for t in s), codes,
                            consts, [0.0])
    with pytest.raises(ValueError, match="mask_codes"):
        fs.nemolite2d_sweep(*s, codes.to(torch.int32), consts, [0.0])
    with pytest.raises(ValueError, match="contiguous"):
        fs.nemolite2d_sweep(*(t[:, ::2] for t in s), codes[:, ::2], consts,
                            [0.0])
    with pytest.raises(ValueError, match="sub-steps"):
        fs.nemolite2d_sweep(*s, codes, consts, [0.0] * 5)
    with pytest.raises(ValueError, match="constants"):
        fs.nemolite2d_sweep(*s, codes, consts[:-1], [0.0])
    with pytest.raises(ValueError, match="ht"):
        fs.nemolite2d_sweep(*s, codes, consts, [0.0], ht=s[0].float()
                            if s[0].dtype == torch.float64 else s[0].double())
    with pytest.raises(ValueError, match="exchange spec block"):
        fs.nemolite2d_sweep(*(t[:-1] for t in s), codes[:-1], consts, [0.0],
                            exchange=m.grid.halo_spec)


# --- the sweep-engine client models -------------------------------------

def _gyre(gnx, gny):
    x = (np.arange(gnx) - gnx / 2 + 0.5) / gnx
    y = (np.arange(gny) - gny / 2 + 0.5) / gny
    psi = 12.0 * np.exp(-((x[None, :] ** 2 + y[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


_U, _V = _gyre(GNX, GNY)

#: (module, build kwargs, initial state setter, largest K)
CLIENTS = {
    "gravity_wave": (gw, dict(dt=0.05, depth=10.0),
                     lambda m: m.set_initial_eta(gaussian_eta(GNX, GNY)), 8),
    "shallow": (sh, dict(dt=0.02), lambda m: m.set_initial_eta(np.roll(
        gaussian_eta(GNX, GNY, amp=0.3), GNX // 2, axis=1)), 8),
    "twolayer": (tl, dict(dt=0.01), lambda m: m.set_initial(
        gaussian_eta(GNX, GNY, amp=0.5), -gaussian_eta(GNX, GNY, amp=2.0)), 8),
    "tracer_upwind": (tr, dict(dt=0.2, u=_U, v=_V, kappa=0.02,
                               scheme="upwind"),
                      lambda m: m.set_initial_tracer(
                          gaussian_eta(GNX, GNY, width=0.08) + 0.01), 8),
    "tracer_vanleer": (tr, dict(dt=0.2, u=_U, v=_V, kappa=0.02,
                                scheme="vanleer"),
                       lambda m: m.set_initial_tracer(
                           gaussian_eta(GNX, GNY, width=0.08) + 0.01), 4),
    # without diffusion: the kernel skips the gradients (kappa == 0)
    "tracer_upwind_advect": (tr, dict(dt=0.2, u=_U, v=_V, scheme="upwind"),
                             lambda m: m.set_initial_tracer(
                                 gaussian_eta(GNX, GNY, width=0.08) + 0.01),
                             8),
    "tracer_vanleer_advect": (tr, dict(dt=0.2, u=_U, v=_V,
                                       scheme="vanleer"),
                              lambda m: m.set_initial_tracer(
                                  gaussian_eta(GNX, GNY, width=0.08)
                                  + 0.01), 4),
}
CLIENT_K = [(name, K) for name, c in CLIENTS.items()
            for K in range(1, c[3] + 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("name,K", CLIENT_K)
def test_client_kernel_matches_plain(cuda_device, name, K, ndom, dtype):
    """Each client kernel against its plain version (the model's step K
    times per exchange) after 23 steps: bitwise expected, as both round
    every operation once in the same order."""
    mod, kw, init, _ = CLIENTS[name]
    ms = [mod.build(GNX, GNY, ndomains=ndom, fused=f, steps_per_sweep=K,
                    dtype=dtype, device=cuda_device, **kw)
          for f in (True, False)]
    kern = ms[0].sweep_kernel
    for m in ms:
        init(m)
    before = kern.launches
    ms[0].run(23)
    torch.cuda.synchronize()
    assert kern.launches - before == 23 // K + 23 % K
    ms[1].run(23)
    assert kern.launches - before == 23 // K + 23 % K
    got, want = ms[0].gather(), ms[1].gather()
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


#: the client builds at other spacings: a client whose build() takes no
#: spacing is built on a grid initialised with it
SPACED = {"gravity_wave": ("gravity_wave",),
          "shallow": ("shallow",),
          "twolayer": ("twolayer",),
          "tracer": ("tracer_upwind", "tracer_vanleer")}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("client", list(SPACED))
def test_client_kernel_other_spacings(cuda_device, monkeypatch, client,
                                      dtype):
    """Spacings that are no powers of two (dx 0.7, dy 1.3): the plain
    step on the card multiplies by the reciprocals (PyTorch's CUDA
    ``tensor / python_scalar``), as the kernels do; bitwise after 19
    steps at K=4 on 1 and 4 tiles, both tracer schemes."""
    dx, dy = 0.7, 1.3
    for name in SPACED[client]:
        mod, kw, init, _ = CLIENTS[name]
        if "dx" in mod.build.__code__.co_varnames:
            kw = dict(kw, dx=dx, dy=dy)
        else:
            base = mod.grid_init
            monkeypatch.setattr(mod, "grid_init",
                                lambda g, _x, _y, *a, **k:
                                base(g, dx, dy, *a, **k))
        for ndom in (1, 4):
            ms = [mod.build(GNX, GNY, ndomains=ndom, fused=f,
                            steps_per_sweep=4, dtype=dtype,
                            device=cuda_device, **kw) for f in (True, False)]
            assert (ms[0].grid.dx, ms[0].grid.dy) == (dx, dy)
            for m in ms:
                init(m)
            kern = ms[0].sweep_kernel
            before = kern.launches
            ms[0].run(19)
            torch.cuda.synchronize()
            assert kern.launches - before == 19 // 4 + 19 % 4
            ms[1].run(19)
            _assert_bitwise(ms[0].gather(), ms[1].gather())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CLIENTS))
def test_client_wrapper_checks_its_inputs(cuda_device, name):
    mod, kw, _, kmax = CLIENTS[name]
    m = mod.build(GNX, GNY, fused=True, device=cuda_device, **kw)
    kern = m.sweep_kernel
    state = [getattr(m, f).data for f in m._fields]
    planes = list(m._sweep_aux[:kern.n_aux])
    code = m._sweep_aux[kern.n_aux] if kern.has_code else None
    consts = m.kernel_constants()
    call = dict(consts=consts, K=1, variant=m._variant)
    with pytest.raises(TypeError, match="float32/float64"):
        kern([t.to(torch.bfloat16) for t in state],
             [t.to(torch.bfloat16) for t in planes], code, **call)
    with pytest.raises(ValueError, match="contiguous"):
        kern([t[:, ::2] for t in state], [t[:, ::2] for t in planes],
             code[:, ::2] if code is not None else None, **call)
    with pytest.raises(ValueError, match="sub-steps"):
        kern(state, planes, code, **dict(call, K=kmax + 1))
    with pytest.raises(ValueError, match="constants"):
        kern(state, planes, code, **dict(call, consts=consts[:-1]))
    with pytest.raises(ValueError, match="state"):
        kern(state[:-1], planes, code, **call)
    if code is not None:
        with pytest.raises(ValueError, match="mask_codes"):
            kern(state, planes, code.to(torch.int32), **call)
    # an unsupported configuration raises on the card; nothing falls back
    with pytest.raises(ValueError, match="steps_per_sweep"):
        mod.build(GNX, GNY, fused=True, steps_per_sweep=kmax + 1,
                  device=cuda_device, **kw)
    before = kern.launches
    with pytest.raises(ValueError, match="sub-steps"):
        kern(state, planes, code, **dict(call, K=0))
    assert kern.launches == before


@pytest.mark.gpu
def test_client_kernels_match_golden(cuda_device):
    """The kernels against the models' numpy goldens at float64 (the
    JAX package's test sizes and tolerances)."""
    eta0 = gaussian_eta(48, 40)
    m = gw.build(48, 40, dt=0.05, depth=10.0, fused=True, steps_per_sweep=8,
                 dtype=torch.float64, device=cuda_device)
    m.set_initial_eta(eta0)
    m.run(100)
    want = gw.golden_reference(eta0, gw.default_tmask(48, 40), 1.0, 1.0,
                               0.05, 100, depth=10.0)
    got = m.gather()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    eta0 = gaussian_eta(32, 32, amp=0.3)
    m = sh.build(32, 32, ndomains=4, dt=0.02, fused=True, steps_per_sweep=8,
                 dtype=torch.float64, device=cuda_device)
    m.set_initial_eta(eta0)
    m.run(200)
    want = sh.golden_reference(eta0, 0.02, 200)
    got = m.gather()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-11, atol=1e-12,
                                   err_msg=k)


# --- the fused Chebyshev sweep and the N-layer sweep ---------------------

def _cheb_solver(device, ndom, K, dtype, fused=True, **kw):
    tmask = gw.default_tmask(GNX, GNY)
    tmask[20:30, 25:45] = 0                        # an island
    grid = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                    tdl.BC_NONE), tdl.OFFSET_NE,
                    dtype=dtype, device=device)
    grid.decompose(GNX, GNY, ndomains=ndom, halo_width=K)
    tdl.grid_init(grid, 1.0, 1.0, tmask)
    return so.HelmholtzSolver(grid, 6.0, 4.0, method="chebyshev",
                              steps_per_exchange=K, fused=fused, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("K", list(range(1, 9)))
def test_cheb_kernel_matches_plain(cuda_device, K, ndom, dtype):
    """Three chained sweeps with the solver's recurrence scalars (new
    ones in every sweep) on the kernel and on its plain version:
    bitwise on the internal cells, as both round every operation once
    in the same order."""
    s = _cheb_solver(cuda_device, ndom, K, dtype)
    sweep = s._make_cheb_sweep(K)
    prep = so.cheb_prepare(s._codes, 6.0, 4.0, dtype)
    exch = exchange_multi_fn(s.grid.halo_spec, depth=K)
    rng = np.random.default_rng(K)
    ker = tuple(torch.from_numpy(rng.standard_normal(s.grid.array_shape))
                .to(cuda_device, dtype) for _ in range(3))
    ref = ker
    scal = so.chebyshev_scalars(*s._lam_bounds, 3 * K)
    before = so.helmholtz_cheb_sweep.launches
    for j in range(3):
        sc = scal[j * K:(j + 1) * K]
        ker = sweep(*exch(ker), sc)
        ref = stencil_sweep_reference(so.cheb_step, K, exch(ref), prep,
                                      scalars=[tuple(r) for r in sc])
    torch.cuda.synchronize()
    assert so.helmholtz_cheb_sweep.launches - before == 3
    inner = s.grid.region_mask(dtype=torch.float64).bool()
    for a, b in zip(ker, ref):
        assert torch.isfinite(a).all()
        assert torch.equal(a[inner], b[inner])


@pytest.mark.gpu
def test_cheb_fused_solve_matches_plain_solve(cuda_device):
    b = np.random.default_rng(1).standard_normal((GNY, GNX))
    xs = []
    for fused in (True, False):
        s = _cheb_solver(cuda_device, 4, 4, torch.float64, fused=fused,
                         tol=1e-11)
        x, info = s.solve(tdl.Field(s.grid, tdl.T_POINTS,
                                    init_global_data=b))
        assert info["converged"] and info["iterations"] == s.niters()
        xs.append(x)
    inner = s.grid.region_mask(dtype=torch.float64).bool()
    assert torch.equal(xs[0][inner], xs[1][inner])


@pytest.mark.gpu
def test_cheb_wrapper_checks_its_inputs(cuda_device):
    s = _cheb_solver(cuda_device, 1, 2, torch.float32)
    kern = so.helmholtz_cheb_sweep
    state = [torch.zeros(s.grid.array_shape, dtype=torch.float32,
                         device=cuda_device) for _ in range(3)]
    consts = so.cheb_sweep_constants(6.0, 4.0, np.ones((2, 2)))
    before = kern.launches
    with pytest.raises(ValueError, match="sub-steps"):
        kern(state, (), s._codes, consts=consts, K=9)
    with pytest.raises(ValueError, match="constants"):
        kern(state, (), s._codes, consts=consts[:-1], K=2)
    with pytest.raises(ValueError, match="mask_codes"):
        kern(state, (), s._codes.to(torch.int32), consts=consts, K=2)
    with pytest.raises(ValueError, match="1..8"):
        _cheb_solver(cuda_device, 1, 9, torch.float32)
    assert kern.launches == before


def _nlayer_eta0(layers):
    return np.stack([gaussian_eta(GNX, GNY, amp=0.5 * (k + 1)) * (-1) ** k
                     for k in range(layers)])


def _nlayer_pair(device, layers, K, ndom, dtype, **kw):
    """(kernel model, plain model) after 19 steps from the same start
    (n // K sweeps + n % K single steps); the kernel's launches checked."""
    ms = [nlm.build(GNX, GNY, ndomains=ndom, dt=0.01, layers=layers,
                    fused=f, steps_per_sweep=K, dtype=dtype, device=device,
                    **kw) for f in (True, False)]
    for m in ms:
        m.set_initial(_nlayer_eta0(layers))
    before = nlm.nlayer_sweep.launches
    ms[0].run(19)
    torch.cuda.synchronize()
    assert nlm.nlayer_sweep.launches - before == 19 // K + 19 % K
    ms[1].run(19)
    return ms[0].gather(), ms[1].gather()


def _assert_bitwise(got, want):
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("K", list(range(1, 9)))
@pytest.mark.parametrize("layers", list(range(1, 9)))
def test_nlayer_kernel_matches_plain(cuda_device, layers, K, ndom, dtype):
    """The N-layer kernel (the compiled march, L = 1..8) against the
    model's plain path after 19 steps: bitwise."""
    _assert_bitwise(*_nlayer_pair(cuda_device, layers, K, ndom, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("layers,K,dtype", [
    (9, 8, torch.float32), (16, 8, torch.float32), (33, 8, torch.float32),
    (48, 4, torch.float32), (64, 4, torch.float32), (9, 8, torch.float64),
    (16, 8, torch.float64)])
def test_nlayer_kernel_many_layers_matches_plain(cuda_device, layers, K,
                                                 dtype):
    """More than eight layers (the run-time variant, up to what one
    window holds: 33 at float32 and K=8), 1 and 4 tiles: bitwise with
    the plain path after 19 steps."""
    assert layers > nlm.COMPILED_LAYERS
    for ndom in (1, 4):
        _assert_bitwise(*_nlayer_pair(cuda_device, layers, K, ndom, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [3, 9])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nlayer_kernel_other_spacings(cuda_device, layers, dtype):
    """Spacings that are no powers of two (dx 0.7, dy 1.3): the plain
    path on the card multiplies by the reciprocals, as the kernel does;
    bitwise after 19 steps on 4 tiles, K=4."""
    _assert_bitwise(*_nlayer_pair(cuda_device, layers, 4, 4, dtype, dx=0.7,
                                  dy=1.3))


@pytest.mark.gpu
def test_nlayer_outside_the_kernel_set_raises(cuda_device):
    """Layers beyond what one window holds (the shared-memory budget),
    or K beyond 8, raise on the card: nothing runs the plain version
    instead."""
    with pytest.raises(ValueError, match="shared memory budget"):
        nlm.build(GNX, GNY, layers=17, fused=True, steps_per_sweep=8,
                  dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="at most 33 layers"):
        nlm.build(GNX, GNY, layers=34, fused=True, steps_per_sweep=8,
                  halo_width=8, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="steps_per_sweep"):
        nlm.build(GNX, GNY, layers=3, fused=True, steps_per_sweep=9,
                  device=cuda_device)
    m = nlm.build(GNX, GNY, layers=2, fused=True, device=cuda_device)
    state = (m.eta.data, m.u.data, m.v.data)
    w = m.kernel_weights(m.eta.data)
    before = nlm.nlayer_sweep.launches
    with pytest.raises(ValueError, match="3 level blocks"):
        nlm.nlayer_sweep(state + state[:1], m._mask_codes, w,
                         consts=m.kernel_constants(), K=1)
    with pytest.raises(ValueError, match="sub-steps"):
        nlm.nlayer_sweep(state, m._mask_codes, w,
                         consts=m.kernel_constants(), K=9)
    with pytest.raises(ValueError, match="weights"):
        nlm.nlayer_sweep(state, m._mask_codes, w[:3],
                         consts=m.kernel_constants(), K=1)
    with pytest.raises(ValueError, match="layers"):
        nlm.nlayer_sweep(state, m._mask_codes, w,
                         consts=m.kernel_constants()[:3] + [3.0], K=1)
    assert nlm.nlayer_sweep.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nlayer_threads_are_whole_strips(cuda_device, dtype):
    """The threads the library launches with: whole warps of whole column
    strips, at most 1024, and 0 exactly where the tile rule raises."""
    for K in (1, 4, 8):
        for L in (1, 3, 8, 9, 16, 33, 34):
            threads = nlm.nlayer_sweep.threads(dtype, L, K)
            try:
                ty, tx = nlm.kernel_tile(L, dtype, K)
            except ValueError:
                assert threads == 0, (L, K)
                continue
            strips = -(-(tx + 2 * K - 1) // 31)
            assert threads % (32 * strips) == 0 and 0 < threads <= 1024


# --- the fused schedule sweep generated from a kernel schedule -----------

def _psy(device, ndom, dtype, halo=8):
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    m = NemoLite2DPsy(GNX, GNY, ndomains=ndom, halo_width=halo, dtype=dtype,
                      device=device)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("repeats", [1, 2, 3])
def test_psy_schedule_kernel_matches_plain(cuda_device, repeats, ndom,
                                           dtype):
    """The PSy flagship's generated sweep kernel against the plain fused
    tier, 12 steps: bitwise on internal points (the CUDA bodies follow
    the torch bodies operation for operation)."""
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    mk, mp = _psy(cuda_device, ndom, dtype), _psy(cuda_device, ndom, dtype)
    n = 12 // repeats
    rows = [[mk._scalars_at(i * repeats + j) for j in range(repeats)]
            for i in range(n)]
    before = ss.schedule_sweep.launches
    mk._sched.fused_program(n, repeats=repeats)(scalars=rows)
    torch.cuda.synchronize()
    assert ss.schedule_sweep.launches - before == n
    mp._sched.fused_program(n, repeats=repeats, plain=True)(scalars=rows)
    assert ss.schedule_sweep.launches - before == n
    got, want = mk.gather(), mp.gather()
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.gpu
def test_psy_schedule_kernel_matches_production(cuda_device):
    m = _psy(cuda_device, 4, torch.float64, halo=5)
    m.run(30, fused=True)
    p = nl.build(GNX, GNY, ndomains=4, dtype=torch.float64, device=cuda_device)
    p.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    p.run(30)
    got, want = m.gather(), p.gather()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-10,
                                   err_msg=k)


#: the generated sweep vs the plain fused tier where a level sum is the
#: only difference (relative to max |field|): the kernel adds levels in
#: order, PyTorch's CUDA reduction may group them
TOL_LEVEL_SUM = {torch.float64: 1e-14, torch.float32: 1e-6}


def _level_grid(device, dtype, ndom):
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, dtype=dtype,
                 device=device)
    g.decompose(GNX, GNY, ndomains=ndom, halo_width=4)
    tdl.grid_init(g, 1.0, 1.0)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("ndom", [1, 4])
def test_schedule_sweep_scratch_form(cuda_device, ndom):
    """The levels chain at 29 levels, float64 (a window past a CTA's
    shared memory even on 8-cell tiles, which took the scratch form
    before the cluster form existed): both sweeps take the cluster form
    (4 CTAs a cluster) and equal the plain fused tier bitwise but for the
    level sum, with one launch a step; 28 levels keep the shared form."""
    from dl_esm_inf_tpu_torch import level_schedules as sc
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    out = {}
    for kind in ("kernel", "plain"):
        f = sc.ml_fields(_level_grid(cuda_device, torch.float64, ndom), 29)
        sched = km.Schedule(*sc.ml_calls(*f))
        before = ss.schedule_sweep.launches
        sched.fused_program(3, plain=kind == "plain")()
        torch.cuda.synchronize()
        assert ss.schedule_sweep.launches - before == (
            3 if kind == "kernel" else 0)
        if kind == "kernel":
            gens = [v[0].generated
                    for v in sched._fused_prog(3, 1)[3].values()]
            assert {(g.form, g.cluster) for g in gens} == {("cluster", 4)}
        out[kind] = [x.gather_inner_data() for x in f]
    for i, (k, p) in enumerate(zip(out["kernel"], out["plain"])):
        if i < 4:
            np.testing.assert_array_equal(k, p)
        else:            # the vertical sum
            assert np.abs(k - p).max() <= TOL_LEVEL_SUM[torch.float64] * \
                np.abs(p).max()
    f = sc.ml_fields(_level_grid(cuda_device, torch.float64, ndom), 28)
    sched = km.Schedule(*sc.ml_calls(*f))
    assert {v[0].generated.form for v in sched._fused_prog(
        3, 1)[3].values()} == {"shared"}


@pytest.mark.gpu
def test_schedule_sweep_scratch_form_past_the_largest_cluster(cuda_device):
    """A window no cluster holds (level_ends and shift at the fewest levels
    past the largest cluster, float64, one 128^2 tile: a pass, a barrier
    and a staged pass that reads one cell east, ring 1) takes the
    global-memory scratch form, and equals the plain fused tier bitwise
    after 3 steps of one launch each."""
    from dl_esm_inf_tpu_torch import level_schedules as sc
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    L = 1
    while ss.window_tile(L + 1, 0, 1, 1, torch.float64)[2]:
        L += 1
    out = {}
    for kind in ("kernel", "plain"):
        g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                     tdl.BC_NONE), tdl.OFFSET_NE,
                     dtype=torch.float64, device=cuda_device)
        g.decompose(128, 128, ndomains=1, halo_width=4)
        tdl.grid_init(g, 1.0, 1.0)
        f = sc.ends_fields(g, L)
        sched = km.Schedule(*sc.ends_calls(*f))
        assert sched.fused_erosion(1) == 1
        before = ss.schedule_sweep.launches
        sched.fused_program(3, plain=kind == "plain")()
        torch.cuda.synchronize()
        assert ss.schedule_sweep.launches - before == (
            3 if kind == "kernel" else 0)
        if kind == "kernel":
            gens = [v[0].generated
                    for v in sched._fused_prog(3, 1)[3].values()]
            assert {gen.form for gen in gens} == {"scratch"}
            assert all(sum(gen.plan.barrier_before) for gen in gens)
        out[kind] = [x.gather_inner_data() for x in f]
    for k, p in zip(out["kernel"], out["plain"]):
        np.testing.assert_array_equal(k, p)


@pytest.mark.gpu
def test_schedule_sweep_refuses_what_it_cannot_generate(cuda_device):
    """On a CUDA grid every schedule the JAX fused tier takes runs
    through the generated kernel.  A kernel without a CUDA body gets one
    derived from its torch body: the PSy flagship with all 13 bodies
    derived equals the hand-written one and the plain fused tier
    bitwise.  levels=N fields take level planes: the nlayer-style chain
    at levels 3 and 8 (derived, and with hand-written level bodies)
    equals the plain fused tier bitwise but for the level sum.  What the
    tracer cannot derive raises with nothing launched."""
    from dl_esm_inf_tpu_torch import level_schedules as sc
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.ops import point_trace as pt
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    for dtype in (torch.float64, torch.float32):
        got = {}
        for kind in ("hand", "derived", "plain"):
            m = _psy(cuda_device, 4, dtype)
            if kind == "derived":
                m._sched = km.Schedule(*[(pt.derived(k), *rest)
                                         for k, *rest in m._calls()])
            before = ss.schedule_sweep.launches
            m._sched.fused_program(3, repeats=2, plain=kind == "plain")(
                scalars=[[m._scalars_at(2 * i + j) for j in range(2)]
                         for i in range(3)])
            torch.cuda.synchronize()
            assert ss.schedule_sweep.launches - before == (
                0 if kind == "plain" else 3)
            got[kind] = m.gather()
        for k in got["plain"]:
            assert np.all(np.isfinite(got["derived"][k]))
            np.testing.assert_array_equal(got["derived"][k], got["hand"][k])
            np.testing.assert_array_equal(got["derived"][k],
                                          got["plain"][k])
        for levels in (3, 8):
            out = {}
            for kind in ("derived", "hand", "plain"):
                f = sc.ml_fields(_level_grid(cuda_device, dtype, 4), levels)
                mom = sc.mom3_hw if kind == "hand" else sc.mom3
                before = ss.schedule_sweep.launches
                km.Schedule(*sc.ml_calls(*f, mom=mom)).fused_program(3, plain=(
                    kind == "plain"))()
                torch.cuda.synchronize()
                assert ss.schedule_sweep.launches - before == (
                    0 if kind == "plain" else 3)
                out[kind] = [x.gather_inner_data() for x in f]
            for i, (d, h, p) in enumerate(zip(*out.values())):
                np.testing.assert_array_equal(d, h)
                if i < 4:
                    np.testing.assert_array_equal(d, p)
                else:        # the vertical sum
                    assert np.abs(d - p).max() <= TOL_LEVEL_SUM[dtype] * \
                        np.abs(p).max()
            bc = {}
            for kind in ("derived", "hand", "plain"):
                e, c = sc.bc_fields(_level_grid(cuda_device, dtype, 4),
                                    levels)
                ks = ((sc.set_all_levels_hw, sc.relax_hw) if kind == "hand"
                      else (sc.set_all_levels, sc.relax))
                km.Schedule(*sc.bc_calls(e, c, *ks)).fused_program(
                    2, plain=kind == "plain")()
                bc[kind] = e.gather_inner_data()
            np.testing.assert_array_equal(bc["derived"], bc["plain"])
            np.testing.assert_array_equal(bc["hand"], bc["plain"])

    @km.kernel(args=[km.Arg(km.GO_WRITE, km.GO_CT),
                     km.Arg(km.GO_READ, km.GO_CT)], name="sine")
    def sine(out, x):
        return torch.sin(x)
    g = _level_grid(cuda_device, torch.float32, 4)
    a, b = tdl.Field(g, tdl.T_POINTS), tdl.Field(g, tdl.T_POINTS)
    w3 = tdl.Field(g, tdl.T_POINTS, levels=3)
    before = ss.schedule_sweep.launches
    with pytest.raises(NotImplementedError, match="sine: torch.sin"):
        km.Schedule((sine, b, a)).fused()
    with pytest.raises(ValueError, match="level planes"):
        km.Schedule((sc.wrong_levels, w3, a)).fused()
    assert ss.schedule_sweep.launches == before
    # the plain tiers run on the card as torch operations
    km.Schedule((sine, b, a))()
    km.invoke(sine, b, a)


# --- the halo-exchange transports and variable bathymetry ---------------

def _exch_grid(device, tiles, wrap, halo):
    bc = [tdl.BC_PERIODIC if w else tdl.BC_EXTERNAL for w in wrap]
    g = tdl.Grid(tdl.ARAKAWA_C, (bc[0], bc[1], tdl.BC_NONE), tdl.OFFSET_NE,
                 device=device)
    base = max(halo, 5)
    g.decompose(base * tiles[0] + (0 if wrap[0] else 1),
                base * tiles[1] + (0 if wrap[1] else 2), ndomainx=tiles[0],
                ndomainy=tiles[1], halo_width=halo)
    tdl.grid_init(g, 1.0, 1.0)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [1, 2, 8])
@pytest.mark.parametrize("wrap", [(False, False), (True, False),
                                  (False, True), (True, True)])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2),
                                   (4, 4)])
def test_exchange_kernel_matches_plain(cuda_device, tiles, wrap, halo):
    """The exchange kernel copies words: bitwise equal to the plain
    exchange on every cell, at every depth, for float32, float64 and
    int32, 2D and 3 levels."""
    from dl_esm_inf_tpu_torch.parallel import halo as hm
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk
    spec = _exch_grid(cuda_device, tiles, wrap, halo).halo_spec
    rng = np.random.default_rng(halo)
    before = hk.halo_exchange.launches
    n = 0
    for depth in range(1, halo + 1):
        for dtype in (torch.float32, torch.float64, torch.int32):
            for lead in ((), (3,)):
                shape = lead + spec.array_shape
                a = torch.from_numpy(rng.permutation(int(np.prod(shape)))
                                     .reshape(shape)).to(cuda_device, dtype)
                got = hk.exchange_kernel(a, spec, depth)
                want = hm._exchange_blocks((a,), spec, depth)[0]
                assert got.dtype == dtype
                assert torch.equal(got, want), (depth, dtype, lead)
                n += 1
    torch.cuda.synchronize()
    assert hk.halo_exchange.launches - before == n


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [1, 2, 8])
@pytest.mark.parametrize("wrap", [(False, False), (True, False),
                                  (False, True), (True, True)])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2),
                                   (4, 4)])
def test_exchange_ring_matches_plain(cuda_device, tiles, wrap, halo):
    """The ring form updates the block in place (only the ring), bitwise
    equal to the plain exchange on every cell, at every depth, for
    float32, float64 and int32, 2D and 3 levels (tiles of at least the
    halo: every depth is in place)."""
    from dl_esm_inf_tpu_torch.parallel import halo as hm
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk
    spec = _exch_grid(cuda_device, tiles, wrap, halo).halo_spec
    rng = np.random.default_rng(halo)
    before = hk.halo_exchange_ring.launches
    n = 0
    for depth in range(1, halo + 1):
        assert hk.ring_in_place(spec, depth)
        for dtype in (torch.float32, torch.float64, torch.int32):
            for lead in ((), (3,)):
                shape = lead + spec.array_shape
                a = torch.from_numpy(rng.permutation(int(np.prod(shape)))
                                     .reshape(shape)).to(cuda_device, dtype)
                want = hm._exchange_blocks((a,), spec, depth)[0]
                blk = a.clone()
                assert hk.halo_exchange_ring(blk, spec, depth) is blk
                assert torch.equal(blk, want), (depth, dtype, lead)
                n += 1
    torch.cuda.synchronize()
    assert hk.halo_exchange_ring.launches - before == n


def _odd_rows_grid(device, tiles, gnx, gny, halo):
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, device=device)
    g.decompose(gnx, gny, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=halo)
    tdl.grid_init(g, 1.0, 1.0)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("tiles,gnx,gny,halo", [((1, 1), 7, 6, 1),
                                                ((2, 2), 13, 11, 1),
                                                ((2, 2), 25, 20, 2),
                                                ((3, 2), 40, 33, 8)])
def test_exchange_kernel_element_rows(cuda_device, tiles, gnx, gny, halo,
                                      dtype, offset):
    """Rows that are no whole number of 16-byte words (widths of 9, 18,
    34 and 90 columns: every one at 4 bytes, the 9 at 8), or blocks that
    are not 16-byte aligned (``offset``): both forms copy by elements
    there, bitwise equal to the plain exchange."""
    from dl_esm_inf_tpu_torch.parallel import halo as hm
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk
    spec = _odd_rows_grid(cuda_device, tiles, gnx, gny, halo).halo_spec
    es = torch.empty((), dtype=dtype).element_size()
    shape = (2,) + spec.array_shape
    n = int(np.prod(shape))
    vals = torch.from_numpy(np.random.default_rng(gnx).permutation(n + 1))
    a = vals.to(cuda_device, dtype)[offset:offset + n].view(shape)
    assert spec.array_shape[1] * es % 16 or a.data_ptr() % 16 or not offset
    for depth in range(1, halo + 1):
        want = hm._exchange_blocks((a,), spec, depth)[0]
        assert torch.equal(hk.halo_exchange(a, spec, depth), want), depth
        if hk.ring_in_place(spec, depth):
            blk = vals.to(cuda_device, dtype)[offset:offset + n].view(shape)
            assert hk.halo_exchange_ring(blk, spec, depth) is blk
            assert torch.equal(blk, want), depth
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_exchange_ring_checks_its_inputs(cuda_device):
    from dl_esm_inf_tpu_torch.parallel import halo as hm
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk
    spec = _exch_grid(cuda_device, (2, 2), (True, True), 2).halo_spec
    a = torch.zeros(spec.array_shape, device=cuda_device)
    ring = hk.halo_exchange_ring
    before = ring.launches
    with pytest.raises(ValueError, match="CUDA"):
        ring(a.cpu(), spec, 1)
    with pytest.raises(TypeError, match="float32/float64/int32"):
        ring(a.to(torch.int16), spec, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ring(a.t().contiguous().t(), spec, 1)
    with pytest.raises(ValueError, match="blocks"):
        ring(a[:-1], spec, 1)
    with pytest.raises(ValueError, match="depth"):
        ring(a, spec, 3)
    over = hm.HaloSpec(**{**spec.__dict__, "repx": 1})
    with pytest.raises(NotImplementedError, match="every tile"):
        ring(torch.zeros(over.array_shape, device=cuda_device), over, 1)
    small = _odd_rows_grid(cuda_device, (3, 2), 7, 6, 4).halo_spec
    assert small.tile_nx < 4
    b = torch.zeros(small.array_shape, device=cuda_device)
    with pytest.raises(ValueError, match="tile extent"):
        ring(b, small, 4)
    assert ring.launches == before
    # the field's exchange takes the functional form there
    fun = hk.halo_exchange.launches
    assert hk.remote_dma_exchange(b, small, 4) is not b
    assert hk.halo_exchange.launches == fun + 1


@pytest.mark.gpu
def test_exchange_kernel_checks_its_inputs(cuda_device):
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk
    spec = _exch_grid(cuda_device, (2, 2), (True, True), 2).halo_spec
    a = torch.zeros(spec.array_shape, device=cuda_device)
    with pytest.raises(TypeError, match="float32/float64/int32"):
        hk.halo_exchange(a.to(torch.int16), spec, 1)
    with pytest.raises(ValueError, match="contiguous"):
        hk.halo_exchange(a.t().contiguous().t(), spec, 1)
    with pytest.raises(ValueError, match="blocks"):
        hk.halo_exchange(a[:-1], spec, 1)
    with pytest.raises(ValueError, match="depth"):
        hk.halo_exchange(a, spec, 3)


def _bathymetry(gnx, gny, seed=11):
    return 50.0 + 100.0 * np.random.default_rng(seed).random((gny, gnx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_ht_kernel_matches_plain(cuda_device, K, ndom, dtype):
    """Variable bathymetry on the kernel: the face depths and Flather
    coefficients derived per point as make_prep derives them, bitwise
    equal to the plain version."""
    depth = _bathymetry(GNX, GNY)
    ms = [nl.build(GNX, GNY, ndomains=ndom, fused=f, steps_per_sweep=K,
                   halo_width=2 * K, depth=depth, dtype=dtype,
                   device=cuda_device) for f in (True, False)]
    for m in ms:
        m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.5))
    before = fs.nemolite2d_sweep.launches
    ms[0].run(23)
    assert fs.nemolite2d_sweep.launches - before == 23 // K + 23 % K
    ms[1].run(23)
    got, want = ms[0].gather(), ms[1].gather()
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _transport_model(device, tiles, K, dtype, transport):
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, dtype=dtype,
                 device=device)
    g.decompose(GNX, GNY, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=8)
    tdl.grid_init(g, 1000.0, 1000.0, nl.default_tmask(GNX, GNY))
    m = nl.NemoLite2D(g, depth=_bathymetry(GNX, GNY) if K == 3 else 100.0)
    m.enable_fast_path(K, transport=transport)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.5))
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_fused_transport_matches_ppermute(cuda_device, K, tiles, dtype):
    """The exchange inside the sweep (one launch per sweep, the plain
    exchange never called) equals the ppermute transport on the kernel
    bitwise on internal points; K = 3 runs with variable bathymetry."""
    from dl_esm_inf_tpu_torch.parallel import halo as hm
    from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk
    mf = _transport_model(cuda_device, tiles, K, dtype, "fused")
    mp = _transport_model(cuda_device, tiles, K, dtype, "ppermute")
    saved = hm._exchange_blocks

    def refuse(*args, **kwargs):
        raise AssertionError("the plain exchange ran on the fused path")
    before = fs.nemolite2d_sweep.launches
    hm._exchange_blocks = hk._exchange_blocks = refuse
    try:
        mf.run(23)
    finally:
        hm._exchange_blocks = hk._exchange_blocks = saved
    assert fs.nemolite2d_sweep.launches - before == 23 // K + 23 % K
    mp.run(23)
    got, want = mf.gather(), mp.gather()
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the kernel-variant microbench and rectangular cells -----------------

#: compute_fast vs its plain version, relative on internal points, per
#: pass (chip_smoke.TOL_FAST)
TOL_FAST = 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_variant_kernels_match_plain(cuda_device, K, ndom, dtype):
    """dma and compute (reps 1 and 3) bitwise with their plain versions
    on every cell, compute(reps=1) bitwise with production, compute_fast
    within TOL_FAST per pass."""
    m = nl.build(GNX, GNY, ndomains=ndom, fused=True, steps_per_sweep=4,
                 dtype=dtype, device=cuda_device)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.5))
    m.run(8)
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    codes, inner = m._mask_codes, m.sshn_t.internal_mask.bool()
    args = (*m.grid.array_shape, dtype, m.p, m.grid.dx, m.grid.dy, m._fcor,
            m.depth)
    plain = dict(p=m.p, dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
                 depth=m.depth)
    f = m.forcing_series(m._istep0, K)
    before = {k: v.launches for k, v in fs.VARIANT_KERNELS.items()}
    got = fs.make_variant(*args, K, "dma")(*state, codes, f)
    for g, w in zip(got, fs.variant_dma_reference(*state, codes, f)):
        assert torch.equal(g, w)
    prod = fs.make_fused_step(*args, steps_per_sweep=K)(*state, codes, f)
    for reps in (1, 3):
        got = fs.make_variant(*args, K, "compute")(*state, codes, f,
                                                   reps=reps)
        want = fs.variant_compute_reference(*state, codes, f, reps, **plain)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if reps == 1:
            for g, w in zip(got, prod):
                assert torch.equal(g, w)
        if dtype == torch.float32:
            got = fs.make_variant(*args, K, "compute_fast")(
                *state, codes, f, reps=reps)
            want = fs.variant_compute_reference(*state, codes, f, reps,
                                                fast=True, **plain)
            for g, w in zip(got, want):
                assert torch.isfinite(g).all()
                rel = (g - w).abs()[inner].max() / w.abs()[inner].max()
                assert rel <= TOL_FAST * reps
    torch.cuda.synchronize()
    after = {k: v.launches for k, v in fs.VARIANT_KERNELS.items()}
    assert after["dma"] - before["dma"] == 1
    assert after["compute"] - before["compute"] == 2
    assert after["compute_fast"] - before["compute_fast"] == (
        2 if dtype == torch.float32 else 0)


@pytest.mark.gpu
def test_variant_wrappers_check_their_inputs(cuda_device):
    m = nl.build(GNX, GNY, fused=True, device=cuda_device)
    s = (m.sshn_t.data, m.un.data, m.vn.data)
    consts = fs.kernel_constants(m.p, 1000.0, 1000.0, m._fcor, 100.0,
                                 s[0].dtype)
    codes = m._mask_codes
    with pytest.raises(TypeError, match="float32/float64"):
        fs.variant_compute(*(t.to(torch.bfloat16) for t in s), codes, consts,
                           [0.0])
    with pytest.raises(ValueError, match="mask_codes"):
        fs.variant_dma(*s, codes.to(torch.int32), consts, [0.0])
    with pytest.raises(ValueError, match="sub-steps"):
        fs.variant_compute(*s, codes, consts, [0.0] * 5)
    with pytest.raises(ValueError, match="reps"):
        fs.variant_dma(*s, codes, consts, [0.0], reps=2)
    with pytest.raises(ValueError, match="constants"):
        fs.variant_compute(*s, codes, consts[:-1], [0.0])
    with pytest.raises(TypeError, match="float32 only"):
        fs.variant_compute_fast(*(t.double() for t in s), codes, consts,
                                [0.0])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["flat", "ht", "exch"])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 2)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dxdy", [(1000.0, 1500.0), (1500.0, 1000.0)])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_rect_kernel_matches_plain(cuda_device, K, dxdy, dtype, tiles,
                                   variant):
    """Rectangular cells on the flagship kernel, bitwise with the plain
    path on internal points: flat, variable depth (HT) and the fused
    transport (EXCH)."""
    def model(transport):
        g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                     tdl.BC_NONE), tdl.OFFSET_NE,
                     dtype=dtype, device=cuda_device)
        g.decompose(GNX, GNY, ndomainx=tiles[0], ndomainy=tiles[1],
                    halo_width=8)
        tdl.grid_init(g, *dxdy, nl.default_tmask(GNX, GNY))
        m = nl.NemoLite2D(g, depth=(_bathymetry(GNX, GNY)
                                    if variant == "ht" else 100.0))
        if transport is None:
            m.set_steps_per_exchange(K)
        else:
            m.enable_fast_path(K, transport=transport)
        m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.5))
        return m
    mk = model("fused" if variant == "exch" else "ppermute")
    mp = model(None)
    before = fs.nemolite2d_sweep.launches
    mk.run(23)
    assert fs.nemolite2d_sweep.launches - before == 23 // K + 23 % K
    mp.run(23)
    got, want = mk.gather(), mp.gather()
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- both staging paths of the flagship kernels ---------------------------

#: blocks whose tiles include interior CTAs (16-byte cp.async staging)
#: and edge CTAs (clamped scalar reads) at every K and dtype, and a block
#: whose float32 rows are not 16-byte aligned (scalar staging throughout)
STAGING_BLOCKS = ((170, 272), (97, 206))


def _staging_block(device, ly, lx, dtype, seed, ht=False):
    rng = np.random.default_rng(seed)
    state = [torch.from_numpy(a * rng.standard_normal((ly, lx))).to(
        device=device, dtype=dtype) for a in (0.2, 0.05, 0.05)]
    tm = np.zeros((ly, lx), np.int8)
    tm[2:-2, 2:-2] = nl.default_tmask(lx - 4, ly - 4)
    codes = nl.encode_masks(torch.from_numpy(tm)).to(device)
    depth = (torch.from_numpy(50.0 + 100.0 * rng.random((ly, lx))).to(
        device=device, dtype=dtype) if ht else None)
    return state, codes, depth


def _has_interior_cta(ly, lx, dtype, K, ht):
    """Whether some CTA's window (with 16 columns of alignment slack) lies
    inside the block."""
    t = fs.tile(dtype, K, ht)
    R = 2 * K
    ys = [by for by in range(-(-ly // t.ty))
          if by * t.ty - R >= 0 and (by + 1) * t.ty + R <= ly]
    xs = [bx for bx in range(-(-lx // t.tx))
          if bx * t.tx - R - 16 >= 0 and (bx + 1) * t.tx + R + 16 <= lx]
    return bool(ys and xs)


@pytest.mark.gpu
@pytest.mark.parametrize("cells", ["square", "rect"])
@pytest.mark.parametrize("ht", [False, True])
@pytest.mark.parametrize("block", STAGING_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_kernel_staging_paths_match_plain(cuda_device, K, dtype, block, ht,
                                          cells):
    """The sweep kernel on blocks with interior and edge CTAs, and with
    rows that are not 16-byte aligned: bitwise with its plain version on
    every point 2K or more inside the block."""
    ly, lx = block
    if block == STAGING_BLOCKS[0]:
        assert _has_interior_cta(ly, lx, dtype, K, ht)
    dx, dy = (1000.0, 1000.0) if cells == "square" else (1000.0, 1500.0)
    state, codes, depth = _staging_block(cuda_device, ly, lx, dtype, K, ht)
    p = nl.Params()
    fcor = float(2.0 * p.omega * np.sin(50.0 * p.d2r))
    forcing = [0.01 * (k + 1) for k in range(K)]
    fused = fs.make_fused_step(ly, lx, dtype, p, dx, dy, fcor, 100.0, K,
                               variable_bathy=ht)
    before = fs.nemolite2d_sweep.launches
    got = fused(*state, codes, forcing, ht=depth)
    assert fs.nemolite2d_sweep.launches - before == 1
    want = fs.fused_step_reference(*state, codes, forcing, p=p, dx=dx, dy=dy,
                                   fcor=fcor, depth=100.0, ht=depth)
    r = 2 * K
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g[r:-r, r:-r], w[r:-r, r:-r])


@pytest.mark.gpu
@pytest.mark.parametrize("block", STAGING_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_variant_staging_paths_match_plain(cuda_device, K, dtype, block):
    """dma and compute (reps 1 and 3) bitwise with their plain versions on
    every cell of blocks with interior and edge CTAs and with rows that
    are not 16-byte aligned; compute(reps=1) bitwise with production."""
    ly, lx = block
    state, codes, _ = _staging_block(cuda_device, ly, lx, dtype, 10 + K)
    p = nl.Params()
    fcor = float(2.0 * p.omega * np.sin(50.0 * p.d2r))
    args = (ly, lx, dtype, p, 1000.0, 1000.0, fcor, 100.0)
    plain = dict(p=p, dx=1000.0, dy=1000.0, fcor=fcor, depth=100.0)
    forcing = [0.01 * (k + 1) for k in range(K)]
    got = fs.make_variant(*args, K, "dma")(*state, codes, forcing)
    for g, w in zip(got, fs.variant_dma_reference(*state, codes, forcing)):
        assert torch.equal(g, w)
    prod = fs.make_fused_step(*args, steps_per_sweep=K)(*state, codes,
                                                        forcing)
    for reps in (1, 3):
        got = fs.make_variant(*args, K, "compute")(*state, codes, forcing,
                                                   reps=reps)
        want = fs.variant_compute_reference(*state, codes, forcing, reps,
                                            **plain)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if reps == 1:
            for g, w in zip(got, prod):
                assert torch.equal(g, w)


@pytest.mark.gpu
def test_gang_peer_seams_match_gloo(cuda_device, tmp_path):
    """A 2-rank gang sharing the card runs its seam legs under the
    "peer" transport (the strips card to card, parallel/seam.py) and
    then under "gloo" (through host memory): the exchanges (walled and
    periodic, 1 and 4 tiles a rank, depth 1 and 8, 2D and 3 levels) and
    the autograd probe (the exchange's and the strip transfer's
    transposes) bitwise equal between the two; the peer legs enqueued
    seam batches and the gloo legs none; one profiled peer transfer, one
    all_reduce and one all_gather (the collectives, which move by the
    same transport) made no copy to or from the host and no host
    synchronisation."""
    import os

    from dl_esm_inf_tpu_torch.launch import launch
    from dl_esm_inf_tpu_torch.parallel import mp_check
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root)]
                                                      + sys.path))
    out = tmp_path / "seams.npz"
    legs = ("periodic", "exchange", "autograd")
    rc = launch(None, ["--out", str(out), "--legs", ",".join(legs),
                       "--n", "64", "--ndomains", "8", "--reps", "2",
                       "--seams", "peer,gloo"], num_processes=2,
                base_env=env, module="dl_esm_inf_tpu_torch.parallel.mp_check",
                timeout=300)
    assert rc == 0
    r = dict(np.load(out))
    pairs = mp_check.seam_pairs(r)
    assert len(pairs) > 30 and all(pairs.values()), [
        k for k, same in pairs.items() if not same]
    for leg in legs:
        assert str(r[f"seam_transport_{leg}"]) == "peer"
        assert str(r[f"gloo__seam_transport_{leg}"]) == "gloo"
        assert int(r[f"seam_batches_{leg}"]) > 0
        assert int(r[f"gloo__seam_batches_{leg}"]) == 0
    for probe in ("seam_profile_", "seam_allreduce_profile_",
                  "seam_allgather_profile_"):
        assert all(int(r[f"{probe}{k}"]) == 0
                   for k in ("dtoh", "htod", "syncs")), probe
        assert int(r[f"gloo__{probe}dtoh"]) > 0, probe
