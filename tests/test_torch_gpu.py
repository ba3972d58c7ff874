"""The CUDA sweep kernel on the card, against its plain PyTorch version.

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

from dl_esm_inf_tpu_torch.models import nemolite2d as nl
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
