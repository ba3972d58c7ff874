"""The PyTorch port's core against the JAX package, on the CPU.

Same inputs (seeded numpy) through both packages: the copied
decomposition/layout helpers must give identical results, the port's
single-device halo exchange must be BITWISE equal to the JAX exchange
on the 8-device CPU mesh, and the grid/field/reduction layer must agree
to float64 roundoff.  Also pins that the port never imports jax.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.core import decomposition as jdec
from dl_esm_inf_tpu.core import layout as jlay
from dl_esm_inf_tpu.ops import stencils as jst
from dl_esm_inf_tpu.parallel import halo as jhalo

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.core import decomposition as tdec
from dl_esm_inf_tpu_torch.core import kinds as tkinds
from dl_esm_inf_tpu_torch.core import layout as tlay
from dl_esm_inf_tpu_torch.ops import stencils as tst
from dl_esm_inf_tpu_torch.parallel import halo as thalo
from dl_esm_inf_tpu_torch.parallel import collectives as tcoll

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")

REPO = Path(__file__).resolve().parents[1]

DECOMP_CASES = [
    # (gnx, gny, ndomains, halo, align)
    (34, 30, 1, 1, 1),
    (34, 30, 4, 2, 1),
    (96, 64, 4, 4, 1),
    (50, 23, 6, 1, 8),
    (96, 64, 8, 3, 128),
    (17, 41, 3, 2, 4),
]


@pytest.mark.parametrize("gnx,gny,ndom,halo,align", DECOMP_CASES)
def test_decomposition_and_layout_match_jax(gnx, gny, ndom, halo, align):
    dj = jdec.decompose(gnx, gny, ndomains=ndom, halo_width=halo,
                        align=align)
    dt = tdec.decompose(gnx, gny, ndomains=ndom, halo_width=halo,
                        align=align)
    assert dataclasses.asdict(dj) == dataclasses.asdict(dt)
    g = np.random.default_rng(gnx * gny + ndom).normal(size=(gny, gnx))
    for mode in ("edge", "zeros"):
        np.testing.assert_array_equal(jlay.stack_global(dj, g, mode=mode),
                                      tlay.stack_global(dt, g, mode=mode))
    stacked = tlay.stack_global(dt, g, mode="edge")
    np.testing.assert_array_equal(
        np.asarray(tlay.unstack_internal(dt, torch.from_numpy(stacked))), g)
    np.testing.assert_array_equal(jlay.unstack_internal(dj, stacked),
                                  tlay.unstack_internal(dt, stacked))
    for off in ((0, 0), (1, 0), (0, 1), (1, 1)):
        np.testing.assert_array_equal(jlay.region_mask(dj, *off),
                                      tlay.region_mask(dt, *off))
        np.testing.assert_array_equal(jlay.external_mask(dj, *off),
                                      tlay.external_mask(dt, *off))
    np.testing.assert_array_equal(jlay.global_x_index(dj),
                                  tlay.global_x_index(dt))
    np.testing.assert_array_equal(jlay.global_y_index(dj),
                                  tlay.global_y_index(dt))


def _grids(gnx, gny, ndom, halo, periodic):
    bc = jdl.BC_PERIODIC if periodic else jdl.BC_EXTERNAL
    bcs = (bc, bc, jdl.BC_NONE)
    gj = jdl.Grid(jdl.ARAKAWA_C, bcs, jdl.OFFSET_NE)
    gj.decompose(gnx, gny, ndomains=ndom, halo_width=halo)
    gt = tdl.Grid(tdl.ARAKAWA_C, bcs, tdl.OFFSET_NE, **CPU)
    gt.decompose(gnx, gny, ndomains=ndom, halo_width=halo)
    return gj, gt


def _random_stacked(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        # beyond 2^24: an int32 halo through a float32 message would round
        return rng.integers(-2**30, 2**30, size=shape, dtype=np.int32)
    return rng.normal(size=shape)


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ndom", [1, 2, 4, 8])
def test_halo_exchange_bitwise_equals_jax_mesh(ndom, periodic, dtype):
    gj, gt = _grids(48, 40, ndom, 2, periodic)
    assert gt.halo_spec.repx == gt.decomp.nprocx
    data = _random_stacked(gj.array_shape, dtype, ndom)
    for depth in (1, 2):
        want = np.asarray(jhalo.exchange(
            jax.device_put(data, gj.sharding), gj.mesh, gj.halo_spec,
            depth))
        got = thalo.exchange(torch.from_numpy(data), gt.halo_spec, depth)
        assert got.dtype == torch.from_numpy(data).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_halo_exchange_mixed_dtypes_and_levels():
    """int32, float64 and a 2-level float64 field in one call: dtype
    groups travel separately and keep their values exactly."""
    gj, gt = _grids(48, 40, 4, 2, True)
    rng = np.random.default_rng(7)
    a = _random_stacked(gj.array_shape, np.int32, 1)
    b = rng.normal(size=gj.array_shape)
    c = rng.normal(size=(2,) + gj.array_shape)
    want = jhalo.exchange_multi([jax.device_put(a, gj.sharding),
                                 jax.device_put(b, gj.sharding)],
                                gj.mesh, gj.halo_spec, 2)
    got = thalo.exchange_multi([torch.from_numpy(x) for x in (a, b, c)],
                               gt.halo_spec, 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for k in range(2):
        np.testing.assert_array_equal(
            got[2][k].numpy(),
            thalo.exchange(torch.from_numpy(c[k]), gt.halo_spec, 2).numpy())
    with pytest.raises(ValueError, match="depth"):
        thalo.exchange(torch.from_numpy(b), gt.halo_spec, 3)


@pytest.mark.parametrize("periodic", [False, True])
def test_grid_field_reductions_match_jax(periodic):
    gnx, gny = 48, 40
    rng = np.random.default_rng(3)
    tmask = np.where(rng.random((gny, gnx)) < 0.2, 0, 1).astype(np.int32)
    gj, gt = _grids(gnx, gny, 4, 2, periodic)
    jdl.grid_init(gj, 1000.0, 1000.0, tmask)
    tdl.grid_init(gt, 1000.0, 1000.0, tmask)
    np.testing.assert_array_equal(gt.tmask.numpy(), np.asarray(gj.tmask))
    np.testing.assert_array_equal(gt.global_tmask(), tmask)
    assert (gt.dx, gt.dy) == (gj.dx, gj.dy) == (1000.0, 1000.0)
    g = rng.normal(size=(gny, gnx))
    for pts in (tdl.T_POINTS, tdl.U_POINTS):
        fj = jdl.Field(gj, pts, init_global_data=g)
        ft = tdl.Field(gt, pts, init_global_data=g)
        np.testing.assert_array_equal(ft.get_data(), np.asarray(fj.data))
        fj.halo_exchange(2)
        ft.halo_exchange(2)
        np.testing.assert_array_equal(ft.get_data(), np.asarray(fj.data))
        np.testing.assert_array_equal(ft.internal_mask.numpy(),
                                      np.asarray(fj.internal_mask))
        np.testing.assert_allclose(ft.checksum(), fj.checksum(),
                                   rtol=1e-13)
        np.testing.assert_array_equal(ft.gather_inner_data(), g)
        np.testing.assert_allclose(tdl.field_checksum(ft),
                                   np.abs(g).sum(), rtol=1e-13)
    data = torch.from_numpy(g)
    assert tcoll.global_sum(data) == pytest.approx(g.sum(), rel=1e-13)
    assert tcoll.global_min(data) == g.min()
    assert tcoll.global_max(data) == g.max()
    with pytest.raises(ValueError, match="stacked shape"):
        ft.set_data(np.zeros((3, 3)))


def test_stencils_and_mask_bits_match_jax():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(12, 17))
    t = torch.from_numpy(a)
    for name in ("xp", "xm", "yp", "ym", "avg_x", "avg_y", "avg_x_back",
                 "avg_y_back"):
        np.testing.assert_array_equal(getattr(tst, name)(t).numpy(),
                                      np.asarray(getattr(jst, name)(a)))
    np.testing.assert_array_equal(tst.shift(t, 2, -1).numpy(),
                                  np.asarray(jst.shift(a, 2, -1)))
    np.testing.assert_array_equal(tst.ddx(t, 3.0).numpy(),
                                  np.asarray(jst.ddx(a, 3.0)))
    masks = [rng.integers(0, 2, size=(12, 17)) for _ in range(6)]
    codes = tst.pack_mask_bits([torch.from_numpy(m) for m in masks])
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jst.pack_mask_bits(masks)))
    for m, u in zip(masks, tst.unpack_mask_bits(codes, 6, torch.float64)):
        np.testing.assert_array_equal(u.numpy(), m)
    with pytest.raises(ValueError, match="at most 8"):
        tst.pack_mask_bits([torch.zeros(2, 2)] * 9)


def test_precision_policy(monkeypatch):
    monkeypatch.delenv("DL_ESM_DTYPE", raising=False)
    assert tkinds.wp("cpu") == torch.float64
    assert tkinds.wp(torch.device("cuda")) == torch.float32
    monkeypatch.setenv("DL_ESM_DTYPE", "f32")
    assert tkinds.wp("cpu") == torch.float32
    tdl.set_working_precision("bf16")
    try:
        assert tkinds.wp("cpu") == torch.bfloat16
        assert tdl.Grid(**CPU).dtype == torch.bfloat16
    finally:
        tdl.set_working_precision(None)
    assert tkinds.sum_dtype(torch.float64) == torch.float64
    assert tkinds.sum_dtype(torch.bfloat16) == torch.float32
    with pytest.raises(ValueError, match="not understood"):
        tdl.set_working_precision("f16")


def test_port_never_imports_jax():
    """Importing every module of the port pulls in no jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dl_esm_inf_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 43, mods\n"
        "for m in ('ops.stencil_sweep', 'models.gravity_wave', "
        "'models.shallow', 'models.twolayer', 'models.tracer', "
        "'ops.solvers', 'models.semi_implicit', 'models.nlayer', "
        "'interop', 'api.kernel_meta', 'ops.schedule_sweep', "
        "'models.nemolite2d_psy', 'parallel.halo_kernel', "
        "'models.example_model', 'testing', 'utils.config', "
        "'utils.diagnostics', 'utils.io', 'utils.checkpoint', "
        "'utils.profiling', 'kbench'):\n"
        "    assert p.__name__ + '.' + m in mods, m\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'dl_esm_inf_tpu.')) or "
        "k == 'dl_esm_inf_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_cuda_device_without_cuda_raises():
    """Asking for CUDA where there is none raises; nothing carries on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tdl.Grid(device="cuda")


def _default_device_entry_points():
    from dl_esm_inf_tpu_torch.models import (gravity_wave, nemolite2d,
                                             nlayer, semi_implicit, shallow,
                                             tracer, twolayer)
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    return {"Grid": lambda **kw: tdl.Grid(**kw),
            "nemolite2d": lambda **kw: nemolite2d.build(16, 16, **kw),
            "gravity_wave": lambda **kw: gravity_wave.build(16, 16, **kw),
            "shallow": lambda **kw: shallow.build(16, 16, **kw),
            "twolayer": lambda **kw: twolayer.build(16, 16, **kw),
            "tracer": lambda **kw: tracer.build(16, 16, **kw),
            "semi_implicit": lambda **kw: semi_implicit.build(16, 16, **kw),
            "nlayer": lambda **kw: nlayer.build(16, 16, **kw),
            "NemoLite2DPsy": lambda **kw: NemoLite2DPsy(16, 16, **kw)}


@pytest.mark.parametrize("entry", ["Grid", "nemolite2d", "gravity_wave",
                                   "shallow", "twolayer", "tracer",
                                   "semi_implicit", "nlayer",
                                   "NemoLite2DPsy"])
def test_default_device_is_the_card(monkeypatch, entry):
    """Every entry point runs on the card unless given a device: with no
    CUDA device and no ``device`` it raises, naming ``device="cpu"``;
    it never carries on on the CPU.  With ``device="cpu"`` it runs
    there."""
    make = _default_device_entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    made = make(**CPU)
    grid = made if entry == "Grid" else made.grid
    assert grid.device == torch.device("cpu")


def test_environment_and_logging(capsys):
    tdl.initialise()
    assert (tdl.get_rank(), tdl.get_num_ranks(), tdl.on_master()) == (0, 1,
                                                                      True)
    tdl.model_write_log("step", 3, 1.5)
    assert capsys.readouterr().out == "step 3 1.500000E+00\n"
    with pytest.raises(tdl.GOceanStop, match="bye"):
        tdl.stop("bye")
    tdl.finalise()
