"""The CUDA sweep kernels on the card, against their plain PyTorch version.

Every test here needs a CUDA GPU and skips without one.  This file
imports neither jax nor the JAX package, so on a machine with a GPU and
no JAX it runs without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py -q --noconftest
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import shallow as sh
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models import twolayer as tl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.ops import fused_step as fs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from nemolite2d_golden import golden_run  # noqa: E402

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
    with pytest.raises(NotImplementedError, match="bathymetry"):
        nl.build(GNX, GNY, fused=True, device=cuda_device,
                 depth=np.full((GNY, GNX), 50.0))


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
