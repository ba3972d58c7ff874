"""The PyTorch port's N-layer model and multi-level fields against the
JAX package.

``models/nlayer.py`` on ``Field(levels=N)``: its level-axis step (torch
cumsums), its per-layer step (the sweep kernel's plain version), the
K-step schedule on the fused path (the plain sweep on the CPU) and the
plain path, against the JAX model's jnp step and its Pallas sweep in
interpret mode, the numpy golden, and the port's own two-layer model.
The CUDA kernel itself is held against its plain version by
tests/test_torch_gpu.py (skipped without a card) and by
``chip_smoke.py``.

Tolerances: rtol 1e-12, atol 1e-13 against the JAX package and between
the port's own paths (the same operations in the same order; a
multiply-add that XLA:CPU contracts is an ulp); against the golden,
tests/test_nlayer.py's rtol 1e-11, atol 1e-13.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.models import nlayer as jnl

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.interop import load_reference_state
from dl_esm_inf_tpu_torch.models import nlayer as tnl
from dl_esm_inf_tpu_torch.models import twolayer as ttl
from dl_esm_inf_tpu_torch.ops import stencil_sweep as tsst
from dl_esm_inf_tpu_torch.ops import stencils as tst
from dl_esm_inf_tpu_torch.ops.stencil_sweep import stencil_sweep_reference

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")

RTOL, ATOL = 1e-12, 1e-13
GNX, GNY = 48, 40


def init_eta(layers, gnx=GNX, gny=GNY):
    """tests/test_nlayer.py's initial interfaces."""
    e = np.zeros((layers, gny, gnx))
    e[0] = tnl.gaussian_eta(gnx, gny, amp=0.5)
    if layers > 1:
        e[1] = -tnl.gaussian_eta(gnx, gny, amp=2.0)
    if layers > 2:
        e[2] = 0.3 * tnl.gaussian_eta(gnx, gny, amp=1.0, width=0.2)
    return e


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        g = np.asarray(got[k])
        assert np.all(np.isfinite(g)), k
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _block(layers, ly, lx, seed):
    """Seeded (eta, u, v) level blocks and a 3-bit mask code."""
    rng = np.random.default_rng(seed)
    state = [0.3 * rng.normal(size=(layers, ly, lx)) for _ in range(3)]
    code = rng.integers(0, 8, size=(ly, lx)).astype(np.int8)
    return state, code


@pytest.mark.parametrize("layers", [1, 2, 4, 5, 8])
def test_step_math_and_layer_step_match_jax(layers):
    """The level-axis step (cumsums) and the per-layer step against the
    JAX model's, on one seeded block; the two port steps agree."""
    mj = jnl.build(GNX, GNY, layers=layers, thickness=np.arange(1, layers + 1)
                   * 10.0, gp=0.03)
    mt = tnl.build(GNX, GNY, layers=layers, thickness=np.arange(1, layers + 1)
                   * 10.0, gp=0.03, **CPU)
    (eta, u, v), code = _block(layers, 24, 40, seed=layers)
    masks = tst.unpack_mask_bits(torch.from_numpy(code), 3, torch.float64)
    jm = [np.asarray(m) for m in masks]
    want = mj._step_math(eta, u, v, *jm)
    got = mt._step_math(*(torch.from_numpy(a) for a in (eta, u, v)), *masks)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    blocks = mt._sweep_step(*(torch.from_numpy(a) for a in (eta, u, v)),
                            *masks)
    wl = mj._layer_step([eta[k] for k in range(layers)],
                        [u[k] for k in range(layers)],
                        [v[k] for k in range(layers)], *jm)
    assert len(blocks) == 3 and len(wl) == 3 * layers
    flat = [b[k] for b in blocks for k in range(layers)]
    for w, g in zip(wl, flat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    for i, g in enumerate(got):
        for k in range(layers):
            np.testing.assert_allclose(flat[i * layers + k].numpy(),
                                       g[k].numpy(), rtol=RTOL, atol=ATOL)


def test_sweep_reference_matches_jax_pallas_interpret():
    """The kernel's plain version (the per-layer step K times on the
    whole block) against the JAX Pallas sweep in interpret mode, on the
    cells at least K from the block edge (edge cells hold each
    version's own wrap values), 3 layers, K=3."""
    L, K = 3, 3
    mj = jnl.build(GNX, GNY, layers=L, pallas=True, steps_per_sweep=K)
    mj.enable_pallas(interpret=True, steps_per_sweep=K)
    mt = tnl.build(GNX, GNY, layers=L, **CPU)
    ly, lx = mj.grid.halo_spec.local_ny, mj.grid.halo_spec.local_nx
    (eta, u, v), code = _block(L, ly, lx, seed=7)
    planes = [a[k] for a in (eta, u, v) for k in range(L)]
    blocks = stencil_sweep_reference(
        mt._sweep_step, K, [torch.from_numpy(a) for a in (eta, u, v)],
        mt._prepare((torch.from_numpy(code),)))
    got = [b[k] for b in blocks for k in range(L)]
    pal = mj._make_sweep(K)(*(jnp.asarray(p) for p in planes),
                            jnp.asarray(code))
    assert len(pal) == len(got) == 3 * L
    for w, g in zip(pal, got):
        np.testing.assert_allclose(g.numpy()[K:-K, K:-K],
                                   np.asarray(w)[K:-K, K:-K], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("fused,K", [(False, 1), (False, 3), (True, 3),
                                     (True, 8)])
def test_slice_matches_jax(ndom, fused, K):
    """The whole slice at 3 layers: port build() on the CPU against the
    JAX model's plain path, 1 and 4 tiles; 19 steps leave a remainder
    after the K-step sweeps."""
    L = 3
    mj = jnl.build(GNX, GNY, ndomains=ndom, dt=0.01, layers=L)
    mt = tnl.build(GNX, GNY, ndomains=ndom, dt=0.01, layers=L, fused=fused,
                   steps_per_sweep=K, **CPU)
    assert mt.use_fused == fused and mt._sweep_K == K
    for m in (mj, mt):
        m.set_initial(init_eta(L))
        m.run(19)
    _assert_close(mt.gather(), mj.gather())
    for k, v in mj.checksums().items():
        assert mt.checksums()[k] == pytest.approx(v, rel=1e-12)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_vs_golden(layers):
    """tests/test_nlayer.py's golden: 48x40, 4 domains, dt 0.01, 60
    steps, on the fused path (K=8) and the plain path."""
    e0 = init_eta(layers)
    want = tnl.golden_reference(e0, tnl.default_tmask(GNX, GNY), 1.0, 1.0,
                                0.01, 60)
    for fused in (True, False):
        m = tnl.build(GNX, GNY, ndomains=4, dt=0.01, layers=layers,
                      fused=fused, steps_per_sweep=8 if fused else 1, **CPU)
        m.set_initial(e0)
        m.run(60)
        _assert_close(m.gather(), want, rtol=1e-11, atol=1e-13)


def test_two_layers_equal_the_twolayer_model():
    """layers=2 with matching parameters reproduces the port's two-layer
    model (another state layout and level coupling) to 1e-12: the
    interface flux dt*(H2*div2) is (dt*H2)*div2 there, an ulp."""
    e1 = tnl.gaussian_eta(GNX, GNY, amp=0.5)
    e2 = -tnl.gaussian_eta(GNX, GNY, amp=2.0)
    mn = tnl.build(GNX, GNY, ndomains=4, dt=0.01, layers=2, gp=0.02,
                   thickness=[20.0, 80.0], fused=True, steps_per_sweep=8,
                   **CPU)
    mn.set_initial(np.stack([e1, e2]))
    mt = ttl.build(GNX, GNY, ndomains=4, dt=0.01, gp=0.02, h1=20.0, h2=80.0,
                   **CPU)
    mt.set_initial(e1, e2)
    mn.run(50)
    mt.run(50)
    gn, gt = mn.gather(), mt.gather()
    for lk, tk in (("eta", "eta1"), ("u", "u1"), ("v", "v1")):
        np.testing.assert_allclose(gn[lk][0], gt[tk], rtol=1e-12,
                                   atol=1e-12)
    for lk, tk in (("eta", "eta2"), ("u", "u2"), ("v", "v2")):
        np.testing.assert_allclose(gn[lk][1], gt[tk], rtol=1e-12,
                                   atol=1e-12)


def test_one_tile_equals_four_tiles():
    e0 = init_eta(3)
    out = []
    for ndom in (1, 4):
        m = tnl.build(GNX, GNY, ndomains=ndom, dt=0.01, layers=3, fused=True,
                      steps_per_sweep=4, **CPU)
        m.set_initial(e0)
        m.run(21)
        out.append(m.gather())
    _assert_close(out[1], out[0])


def test_per_interface_volume_conserved():
    """Closed basin: every interface displacement integrates to a
    constant (tests/test_nlayer.py)."""
    m = tnl.build(40, 40, ndomains=4, dt=0.01, layers=3, fused=True,
                  steps_per_sweep=8, **CPU)
    m.set_initial(init_eta(3, 40, 40))
    wet = tnl.default_tmask(40, 40) == 1
    v0 = [m.gather()["eta"][k][wet].sum() for k in range(3)]
    m.run(100)
    v1 = [m.gather()["eta"][k][wet].sum() for k in range(3)]
    for k in range(3):
        assert abs(v1[k] - v0[k]) < 1e-8 * max(1.0, abs(v0[k])), k


@pytest.mark.parametrize("pts", ["T", "U"])
@pytest.mark.parametrize("ndom", [1, 4])
def test_level_field_round_trip_and_checksum_match_jax(pts, ndom):
    """Field(levels=3): init, gather, set/get, halo exchange and checksum
    against the JAX package's multi-level field."""
    gj = jdl.Grid(jdl.ARAKAWA_C, (jdl.BC_PERIODIC, jdl.BC_EXTERNAL,
                                  jdl.BC_NONE), jdl.OFFSET_NE,
                  dtype="float64")
    gj.decompose(24, 16, ndomains=ndom, halo_width=2)
    jdl.grid_init(gj, 1.0, 1.0)
    gt = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_PERIODIC, tdl.BC_EXTERNAL,
                                  tdl.BC_NONE), tdl.OFFSET_NE,
                  dtype="float64", **CPU)
    gt.decompose(24, 16, ndomains=ndom, halo_width=2)
    tdl.grid_init(gt, 1.0, 1.0)
    g = np.random.default_rng(ndom).standard_normal((3, 16, 24))
    point = {"T": (jdl.T_POINTS, tdl.T_POINTS),
             "U": (jdl.U_POINTS, tdl.U_POINTS)}[pts]
    fj = jdl.Field(gj, point[0], init_global_data=g, levels=3)
    ft = tdl.Field(gt, point[1], init_global_data=g, levels=3)
    assert ft.levels == 3 and tuple(ft.data.shape) == (3,) + gt.array_shape
    np.testing.assert_array_equal(ft.gather_inner_data(), g)
    np.testing.assert_array_equal(ft.get_data(), np.asarray(fj.data))
    assert ft.checksum() == pytest.approx(fj.checksum(), rel=1e-14)
    fj.halo_exchange(2)
    ft.halo_exchange(2)
    np.testing.assert_array_equal(ft.get_data(), np.asarray(fj.data))
    ft.set_data(ft.get_data() * 2.0)
    np.testing.assert_array_equal(ft.gather_inner_data(), 2.0 * g)
    with pytest.raises(ValueError, match="stacked shape"):
        ft.set_data(np.zeros(gt.array_shape))
    with pytest.raises(ValueError, match="init_global_data"):
        tdl.Field(gt, point[1], init_global_data=g[0], levels=3)
    with pytest.raises(ValueError, match="levels"):
        tdl.Field(gt, point[1], levels=0)
    assert tuple(tdl.Field(gt, point[1]).data.shape) == gt.array_shape


def test_state_carried_from_jax():
    """JAX runs 5 steps on its plain path, the port takes the
    (layers, gny, gnx) state over, and both run 11 more."""
    L = 3
    mj = jnl.build(GNX, GNY, ndomains=4, dt=0.01, layers=L)
    mj.set_initial(init_eta(L))
    mj.run(5)
    mt = tnl.build(GNX, GNY, ndomains=4, dt=0.01, layers=L, fused=True,
                   steps_per_sweep=4, **CPU)
    state = dict(mj.gather(), tmask=mt.grid.global_tmask())
    load_reference_state(mt, state)
    _assert_close(mt.gather(), mj.gather(), rtol=0, atol=0)
    mj.run(11)
    mt.run(11)
    _assert_close(mt.gather(), mj.gather())
    with pytest.raises(ValueError, match=r"\(3, 40, 48\)"):
        load_reference_state(mt, dict(state, eta=state["eta"][0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_tile_chooser(dtype):
    """The N-layer kernel's tile per (L, dtype, K): the skeleton's tile
    rule with the column march's widths for 3L planes and the code, ring
    K; beyond the compiled 8 layers the weights (2L values, 16-byte
    rounded) sit beside the window.  Every window fits the share of an SM
    its CTAs leave, and a ValueError naming the budget and the most
    layers that fit comes at the first L whose window fits no CTA
    (float32, K=8: 34; float64, K=8: 17)."""
    item = dtype.itemsize
    for K in range(1, 9):
        for L in list(range(1, 20)) + [24, 33, 48, 64]:
            bpp = 3 * L * item + 1
            extra = 0 if L <= 8 else -(-2 * L * item // 16) * 16
            assert tnl.weight_bytes(L, dtype) == extra
            shape = tsst.tile(K, bpp, march=True, extra=extra)
            if shape is None:
                with pytest.raises(ValueError, match="227 KiB"):
                    tnl.kernel_tile(L, dtype, K)
                continue
            assert tnl.kernel_shape(L, dtype, K) == shape
            assert tnl.kernel_tile(L, dtype, K) == (shape.ty, shape.tx)
            assert shape.window_bytes(K, bpp) + extra <= \
                tsst.SMEM_PER_SM // shape.ctas - tsst.SMEM_RESERVE
            # the velocity columns fill at most three strips of 31 lanes
            assert shape.tx + 2 * K - 1 <= 3 * 31
    first = 34 if dtype == torch.float32 else 17
    assert tnl.kernel_tile(first - 1, dtype, 8) == (8, 8)
    with pytest.raises(ValueError, match=rf"227 KiB.*at most {first - 1} "
                       "layers fit"):
        tnl.kernel_tile(first, dtype, 8)
    # K=4 and K=1 hold more (float32: 75 and 192; float64: 37 and 96)
    for K, most in ((4, 75 if item == 4 else 37), (1, 192 if item == 4
                                                     else 96)):
        assert tnl.kernel_tile(most, dtype, K)
        with pytest.raises(ValueError, match=f"at most {most} layers"):
            tnl.kernel_tile(most + 1, dtype, K)


def test_guards_and_no_fallback():
    """Outside the kernel's (L, K) set the wrapper raises; a tensor that
    is not on the CPU goes to the kernel or raises, and the plain version
    is never taken for it."""
    with pytest.raises(ValueError, match="layers"):
        tnl.build(16, 16, layers=0, **CPU)
    with pytest.raises(ValueError, match="thickness"):
        tnl.build(16, 16, layers=2, thickness=[10.0, -1.0], **CPU)
    with pytest.raises(ValueError, match="steps_per_sweep"):
        tnl.build(32, 32, fused=True, steps_per_sweep=9, **CPU)
    m = tnl.build(32, 32, layers=2, fused=True, **CPU)           # halo = 1
    with pytest.raises(ValueError, match="halo_width"):
        m.enable_fast_path(steps_per_sweep=2)
    with pytest.raises(TypeError, match="remat_chunk"):
        m.step_program(4, remat_chunk=2)
    with pytest.raises(ValueError, match="shape"):
        m.set_initial(np.zeros((3, 32, 32)))
    kern = tnl.nlayer_sweep
    assert m.kernel_constants() == [m.dt, 1.0, 1.0, 2.0]

    def meta(L, n=3, dtype=torch.float64):
        return [torch.empty((L, 8, 8), dtype=dtype, device="meta")
                for _ in range(n)]
    code = torch.empty((8, 8), dtype=torch.int8, device="meta")
    w = torch.empty(4, dtype=torch.float64, device="meta")
    call = dict(consts=m.kernel_constants(), K=1)
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        m._make_sweep(1)(meta(2), (code,))
    with pytest.raises(ValueError, match="CUDA"):
        kern(meta(2), code, w, **call)
    with pytest.raises(ValueError, match="3 level blocks"):
        kern(meta(2, 6), code, w, **call)
    with pytest.raises(ValueError, match="sub-steps"):
        kern(meta(2), code, w, **dict(call, K=9))
    assert kern.launches == before
    # a grid that is not on the CPU refuses up front the layers whose
    # window fits no CTA
    m17 = tnl.build(16, 16, layers=17, halo_width=8, **CPU)
    m17.grid.device = torch.device("meta")
    with pytest.raises(ValueError, match="shared memory budget"):
        m17.enable_fast_path(8)
    m17.enable_fast_path(4)                  # fits with K=4
    m34 = tnl.build(16, 16, layers=34, halo_width=8, dtype="float32",
                    **CPU)
    m34.grid.device = torch.device("meta")
    with pytest.raises(ValueError, match="at most 33 layers"):
        m34.enable_fast_path(8)
    m34.enable_fast_path(4)
    # on the CPU more layers than any window holds run the plain version
    m5 = tnl.build(GNX, GNY, layers=5, fused=True, steps_per_sweep=2, **CPU)
    m5.set_initial(np.concatenate([init_eta(3), init_eta(2)]))
    m5.run(5)
    assert all(np.isfinite(a).all() for a in m5.gather().values())


def test_kernel_constants_and_weights_layout():
    """The kernel's constants are dt, dx, dy and the layer count (the
    launch carries nothing per layer); the weights are pw then H in the
    planes' dtype, rounded once from double, one tensor per dtype and
    device; the grid's spacings reach the constants as given."""
    m = tnl.build(32, 24, layers=5, dt=0.015, gp=[0.03, 0.02, 0.01, 0.005],
                  thickness=[10.0, 20.0, 30.0, 40.0, 50.0], dx=0.7, dy=1.3,
                  **CPU)
    assert m.kernel_constants() == [0.015, 0.7, 1.3, 5.0]
    for dtype in (torch.float32, torch.float64):
        like = torch.zeros(1, dtype=dtype)
        w = m.kernel_weights(like)
        assert w.dtype == dtype and tuple(w.shape) == (10,)
        want = torch.tensor([9.81, 0.03, 0.02, 0.01, 0.005, 10.0, 20.0,
                             30.0, 40.0, 50.0], dtype=torch.float64)
        assert torch.equal(w, want.to(dtype))
        assert m.kernel_weights(like) is w
    assert (m.grid.dx, m.grid.dy) == (0.7, 1.3)


@pytest.mark.parametrize("layers,K", [(33, 4), (48, 2), (64, 1)])
def test_many_layers_match_jax(layers, K):
    """Layer counts beyond the parameter block the kernel once had: the
    port's fused path on the CPU (the kernel's plain version, on the
    level blocks) against the JAX package's plain path at float64, 2 x 2
    tiles, 9 steps (sweeps and a remainder), within 1e-12."""
    n = 24
    rng = np.random.default_rng(layers)
    e0 = 0.1 * rng.normal(size=(layers, n, n))
    kw = dict(ndomains=4, dt=0.01, layers=layers,
              gp=0.02 + 0.001 * np.arange(layers - 1),
              thickness=1.0 + np.arange(layers, dtype=np.float64))
    mj = jnl.build(n, n, **kw)
    mt = tnl.build(n, n, fused=True, steps_per_sweep=K, **kw, **CPU)
    assert mt.use_fused and mt._sweep_K == K
    for m in (mj, mt):
        m.set_initial(e0)
        m.run(9)
    _assert_close(mt.gather(), mj.gather())
