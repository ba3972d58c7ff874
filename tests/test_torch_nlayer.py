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
    split = [torch.from_numpy(a[k]) for a in (eta, u, v)
             for k in range(layers)]
    flat = mt._sweep_step(*split, *masks)
    wl = mj._layer_step([eta[k] for k in range(layers)],
                        [u[k] for k in range(layers)],
                        [v[k] for k in range(layers)], *jm)
    assert len(flat) == len(wl) == 3 * layers
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
    got = stencil_sweep_reference(
        mt._sweep_step, K, [torch.from_numpy(p) for p in planes],
        mt._prepare((torch.from_numpy(code),)))
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
    rule for the compiled L <= 4 at every K (3L planes and the code, ring
    K), whose window fits a CTA; beyond, the largest square of 32, 16, 8
    whose window (3L planes of (tile + 2K)^2 points and the code) fits
    227 KiB less the run-time variants' 2 KiB of static shared memory; a
    ValueError naming the budget above what the 8-cell tile holds, and
    the parameter block's 32 layers."""
    item = 8 if dtype == torch.float64 else 4
    assert tnl.window_bytes(9, dtype, 8, 16) == 9 * 3 * 32 * 32 * item + 1024
    assert tnl.window_bytes(4, dtype, 8, 32) == 4 * 3 * 48 * 48 * item + 2304
    for K in range(1, 9):
        for L in range(1, 5):
            shape = tsst.tile(K, 3 * L * item + 1)
            assert tnl.kernel_tile(L, dtype, K) == (shape.ty, shape.tx)
            assert shape.window_bytes(K, 3 * L * item + 1) <= 232448
            assert tnl.kernel_variant(L, dtype, K) == L - 1
    # K=8 boundaries: f64 16-cell tiles to 9 layers, 8-cell to 16;
    # f32 32-cell to 8, 16-cell to 18, 8-cell to the 32-layer cap
    last = ({32: 4, 16: 9, 8: 16} if dtype == torch.float64
            else {32: 8, 16: 18, 8: 32})
    lo = 5
    for tile, hi in last.items():
        for L in range(lo, hi + 1):
            assert tnl.kernel_tile(L, dtype, 8) == (tile, tile), L
            assert tnl.kernel_variant(L, dtype, 8) == \
                4 + tnl.MANY_TILES.index(tile)
            assert tnl.window_bytes(L, dtype, 8, tile) <= 232448 - 2048
        lo = max(lo, hi + 1)
    if dtype == torch.float64:
        assert tnl.window_bytes(17, dtype, 8, 8) > 232448 - 2048
        with pytest.raises(ValueError, match=r"227 KiB.*at most 16 layers"):
            tnl.kernel_tile(17, dtype, 8)
        assert tnl.kernel_tile(17, dtype, 4) == (8, 8)
    with pytest.raises(ValueError, match="at most 32 layers"):
        tnl.kernel_tile(33, dtype, 1)


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
    with pytest.raises(NotImplementedError, match="A10"):
        m.step_program(4, remat_chunk=2)
    with pytest.raises(ValueError, match="shape"):
        m.set_initial(np.zeros((3, 32, 32)))
    kern = tnl.nlayer_sweep
    assert len(m.kernel_constants()) == 4 + 2 * tnl.KERNEL_MAX_LAYERS
    assert m.kernel_constants()[3] == 2.0          # the layer count

    def meta(n, dtype=torch.float64):
        return [torch.empty((8, 8), dtype=dtype, device="meta")
                for _ in range(n)]
    code = meta(1, torch.int8)[0]
    call = dict(consts=m.kernel_constants(), K=1)
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        m._make_sweep(1)(meta(6), (code,))
    # the run-time layer variants take 5..32 layers, nothing beyond
    with pytest.raises(ValueError, match="no variant 7"):
        kern(meta(15), (), code, variant=7, **call)
    with pytest.raises(ValueError, match=r"expected 15\.\.96 \(step 3\)"):
        kern(meta(99), (), code, variant=4, **call)
    with pytest.raises(ValueError, match=r"expected 15\.\.96"):
        kern(meta(12), (), code, variant=6, **call)
    with pytest.raises(ValueError, match="expected 6 state"):
        kern(meta(9), (), code, variant=1, **call)
    with pytest.raises(ValueError, match="sub-steps"):
        kern(meta(6), (), code, variant=1, **dict(call, K=9))
    assert kern.launches == before
    # a grid that is not on the CPU refuses up front the layers the
    # kernel's shared memory or parameter block cannot hold
    m17 = tnl.build(16, 16, layers=17, halo_width=8, **CPU)
    m17.grid.device = torch.device("meta")
    with pytest.raises(ValueError, match="shared memory budget"):
        m17.enable_fast_path(8)
    m17.enable_fast_path(4)                  # fits with K=4
    m33 = tnl.build(16, 16, layers=33, **CPU)
    m33.grid.device = torch.device("meta")
    with pytest.raises(ValueError, match="at most 32 layers"):
        m33.enable_fast_path(1)
    # on the CPU five layers run the plain version, as documented
    m5 = tnl.build(GNX, GNY, layers=5, fused=True, steps_per_sweep=2, **CPU)
    m5.set_initial(np.concatenate([init_eta(3), init_eta(2)]))
    m5.run(5)
    assert all(np.isfinite(a).all() for a in m5.gather().values())
