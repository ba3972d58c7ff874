"""The port's grid/field/communication API against the JAX package.

The five functional oracles of the JAX package (ROADMAP.md, "Pruned as
done": PR 1-6) run against the port with the JAX tests' expected
values: the hill halo oracle with
its corners, periodic, integer and multi-level cases
(tests/test_halo_exchange.py), the checksum and scatter/gather oracles
(tests/test_reductions.py), the staggered-bounds truth table and the
field operations (tests/test_field_bounds.py), the example program
(tests/test_example_model.py) and the cases of
tests/test_overdecomposition.py that need no JAX mesh.  Every exchange
runs under both transports: "ppermute" (the plain exchange) and
"remote_dma" (the exchange kernel, whose plain version runs here).

The port's N tiles all live on one device, where they play the part of
the JAX package's N devices with one tile each: the transports that the
JAX package keeps to one tile per device (test_pallas_paths_guard) take
any tile count in the port.
"""
import numpy as np
import pytest
import torch

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.models import example_model as jexm

import dl_esm_inf_tpu_torch as dl
from dl_esm_inf_tpu_torch.core.field import staggering_offsets
from dl_esm_inf_tpu_torch.models import example_model
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models import shallow as sh
from dl_esm_inf_tpu_torch.models import tracer as tr
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.parallel import halo_kernel
from dl_esm_inf_tpu_torch.testing import (hill_stacked, init_field_hill,
                                          unique_global_values)

torch.set_num_threads(2)

CPU = dict(device="cpu")
TOL = 1.0e-8
POISON = -666.0
TRANSPORTS = ["ppermute", "remote_dma"]


def make_grid(gnx, gny, ndom=None, halo_width=1, bcs=None,
              offset=dl.OFFSET_NE, ndx=None, ndy=None, align=None):
    grid = dl.Grid(dl.ARAKAWA_C,
                   bcs or (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   offset, **CPU)
    grid.decompose(gnx, gny, ndomains=ndom, ndomainx=ndx, ndomainy=ndy,
                   halo_width=halo_width, align=align)
    dl.grid_init(grid, 1.0, 1.0)
    return grid


def check_hill_halos(field, depth=1):
    """tests/test_halo_exchange.py::check_hill_halos on a port field: all
    four sides, depth > 1, and no-neighbour strips NOT overwritten."""
    d = field.grid.decomp
    data = field.get_data()
    oracle = hill_stacked(field)
    for rank in range(d.ndomains):
        sub = d.subdomains[rank]
        sy, sx = d.shard_slices(rank)
        loc = data[sy, sx]
        orc = oracle[sy, sx]
        r = field.internal_region(rank)
        for dd in range(1, depth + 1):
            strips = {
                "-x": (slice(r.ystart, r.ystop), r.xstart - dd,
                       sub.global_.xstart > 0,
                       sub.global_.xstart - dd >= 0),
                "+x": (slice(r.ystart, r.ystop), r.xstop - 1 + dd,
                       sub.global_.xstop < field.grid.global_nx,
                       sub.global_.xstop - 1 + dd < field.grid.global_nx),
                "-y": (r.ystart - dd, slice(r.xstart, r.xstop),
                       sub.global_.ystart > 0,
                       sub.global_.ystart - dd >= 0),
                "+y": (r.ystop - 1 + dd, slice(r.xstart, r.xstop),
                       sub.global_.ystop < field.grid.global_ny,
                       sub.global_.ystop - 1 + dd < field.grid.global_ny),
            }
            for name, (yy, xx, has_neighbour, in_domain) in strips.items():
                got = loc[yy, xx]
                if has_neighbour and in_domain:
                    assert np.allclose(got, orc[yy, xx], atol=TOL), (
                        f"rank {rank} {name} depth {dd} halo wrong")
                elif not has_neighbour:
                    assert np.all(got == POISON), (
                        f"rank {rank} {name} halo has no neighbour but was "
                        "overwritten")


# --- tests/test_halo_exchange.py ---------------------------------------------

@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("gnx,gny,ndom", [
    (10, 4, 2), (4, 10, 2), (10, 10, 4), (10, 10, 6), (10, 10, 1),
    (17, 13, 6)])
@pytest.mark.parametrize("points", [dl.T_POINTS, dl.U_POINTS, dl.V_POINTS,
                                    dl.F_POINTS])
def test_hill_halos(gnx, gny, ndom, points, transport):
    grid = make_grid(gnx, gny, ndom)
    fld = dl.Field(grid, points)
    init_field_hill(fld, POISON)
    fld.halo_exchange(1, transport=transport)
    check_hill_halos(fld, depth=1)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_hill_halos_depth2(transport):
    grid = make_grid(12, 12, 4, halo_width=2)
    for points in (dl.T_POINTS, dl.U_POINTS):
        fld = dl.Field(grid, points)
        init_field_hill(fld, POISON)
        fld.halo_exchange(2, transport=transport)
        check_hill_halos(fld, depth=2)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_depth_validation(transport):
    fld = dl.Field(make_grid(10, 10, 4, halo_width=1), dl.T_POINTS)
    for depth in (2, 0):
        with pytest.raises(ValueError, match="depth"):
            fld.halo_exchange(depth, transport=transport)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_corners_propagate(transport):
    grid = make_grid(8, 8, 4)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, POISON)
    fld.halo_exchange(1, transport=transport)
    data, oracle = fld.get_data(), hill_stacked(fld)
    sy, sx = grid.decomp.shard_slices(0)
    r = fld.internal_region(0)
    assert abs(data[sy, sx][r.ystop, r.xstop]
               - oracle[sy, sx][r.ystop, r.xstop]) < TOL


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("ndom", [1, 2, 4])
def test_periodic_wraparound(ndom, transport):
    gnx = gny = 8
    grid = make_grid(gnx, gny, ndom,
                     bcs=(dl.BC_PERIODIC, dl.BC_PERIODIC, dl.BC_NONE))
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    fld = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    fld.halo_exchange(1, transport=transport)
    data = fld.get_data()
    d = grid.decomp
    for rank in range(d.ndomains):
        g = d.subdomains[rank].global_
        sy, sx = d.shard_slices(rank)
        loc = data[sy, sx]
        r = fld.internal_region(rank)
        ys, xs = np.arange(g.ystart, g.ystop), np.arange(g.xstart, g.xstop)
        np.testing.assert_allclose(loc[r.ystart:r.ystop, r.xstart - 1],
                                   vals[ys % gny, (g.xstart - 1) % gnx])
        np.testing.assert_allclose(loc[r.ystart:r.ystop, r.xstop],
                                   vals[ys % gny, g.xstop % gnx])
        np.testing.assert_allclose(loc[r.ystart - 1, r.xstart:r.xstop],
                                   vals[(g.ystart - 1) % gny, xs % gnx])
        np.testing.assert_allclose(loc[r.ystop, r.xstart:r.xstop],
                                   vals[g.ystop % gny, xs % gnx])
        np.testing.assert_allclose(
            loc[r.ystart - 1, r.xstart - 1],
            vals[(g.ystart - 1) % gny, (g.xstart - 1) % gnx])


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_exchange_3d_and_int(transport):
    """3D-real and integer halo exchange (the reference aborts on both,
    parallel_comms_mod.f90:1693-1742)."""
    grid = make_grid(8, 8, 4)
    vals = np.arange(64, dtype=float).reshape(8, 8)
    lvl = np.stack([vals + 1000.0 * k for k in range(5)])
    f3 = dl.Field(grid, dl.T_POINTS, init_global_data=lvl, levels=5)
    f3.halo_exchange(1, transport=transport)
    out = f3.get_data()
    d = grid.decomp
    sy, sx = d.shard_slices(0)
    r = f3.internal_region(0)
    for k in range(5):
        # east halo of rank 0: rank 1's first internal column, per level
        np.testing.assert_array_equal(
            out[k][sy, sx][r.ystart:r.ystop, r.xstop],
            vals[0:4, 4] + 1000.0 * k)
    fi = dl.Field(grid, dl.T_POINTS, init_global_data=vals,
                  dtype=torch.int32)
    fi.halo_exchange(1, transport=transport)
    out = fi.get_data()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out[sy, sx][r.ystart:r.ystop, r.xstop],
                                  vals[0:4, 4].astype(np.int32))


def test_field_transport_api():
    """As tests/test_halo_pallas.py:105-148: an unknown transport raises,
    the default is the plain exchange, and a levels=3 field rides the
    exchange kernel whole, equal to the plain exchange."""
    grid = make_grid(16, 16, ndx=4, ndy=1)
    fld = dl.Field(grid, dl.T_POINTS,
                   init_global_data=np.arange(256.0).reshape(16, 16))
    with pytest.raises(ValueError, match="transport"):
        fld.halo_exchange(transport="smoke-signals")
    fld.halo_exchange(1)
    g3 = np.stack([np.arange(256.0).reshape(16, 16) + 1000 * k
                   for k in range(3)])
    for g in (make_grid(16, 16, 1),
              make_grid(16, 16, bcs=(dl.BC_PERIODIC, dl.BC_EXTERNAL,
                                     dl.BC_NONE), ndx=4, ndy=1)):
        fld = dl.Field(g, dl.T_POINTS, init_global_data=g3, levels=3)
        ref = dl.Field(g, dl.T_POINTS, init_global_data=g3, levels=3)
        before = halo_kernel.halo_exchange.launches
        fld.halo_exchange(1, transport="remote_dma")
        ref.halo_exchange(1)
        assert halo_kernel.halo_exchange.launches == before   # CPU: plain
        np.testing.assert_array_equal(fld.get_data(), ref.get_data())


# --- tests/test_reductions.py -------------------------------------------------

@pytest.mark.parametrize("ndom", [1, 4, 6])
@pytest.mark.parametrize("points", [dl.T_POINTS, dl.U_POINTS, dl.V_POINTS,
                                    dl.F_POINTS])
def test_gsum(ndom, points):
    fld = dl.Field(make_grid(4, 10, ndom), points)
    m = fld.internal_mask_np()
    fld.set_data(np.where(m, 1.0, -100.0))
    assert dl.field_checksum(fld) == 40.0


@pytest.mark.parametrize("ndom", [1, 4, 6])
def test_scatter_update_gather(ndom):
    gnx = gny = 10
    grid = make_grid(gnx, gny, ndom)
    g = unique_global_values(gnx, gny)
    fld = dl.Field(grid, dl.T_POINTS, init_global_data=g)
    d = grid.decomp
    data = fld.get_data()
    for rank in range(d.ndomains):
        sub = d.subdomains[rank]
        sy, sx = d.shard_slices(rank)
        loc = data[sy, sx]
        r = fld.internal_region(rank)
        want = g[sub.global_.ystart:sub.global_.ystop,
                 sub.global_.xstart:sub.global_.xstop]
        np.testing.assert_array_equal(loc[r.slices()], want)
        np.testing.assert_array_equal(fld.local_view(rank), loc)
        mask = np.zeros_like(loc, dtype=bool)
        mask[r.slices()] = True
        assert np.all(loc[~mask] == 0.0)
    fld.data = fld.data + fld.internal_mask
    np.testing.assert_array_equal(fld.gather_inner_data(), g + 1.0)


def test_gather_shape_and_dtype():
    fld = dl.Field(make_grid(7, 5, 4), dl.T_POINTS)
    out = fld.gather_inner_data()
    assert out.shape == (5, 7) and out.dtype == np.float64


def test_global_sum_collectives():
    grid = make_grid(8, 8, 4)
    fld = dl.Field(grid, dl.T_POINTS, init_global_data=np.full((8, 8), 2.0))
    assert dl.collectives.global_sum(fld.data * fld.internal_mask) == 128.0
    assert dl.collectives.global_max(fld.data) == 2.0
    assert dl.collectives.global_min(fld.data) == 0.0


# --- tests/test_field_bounds.py -----------------------------------------------

TRUTH = {
    (dl.OFFSET_NE, False, False, dl.U_POINTS): (0, 0),
    (dl.OFFSET_NE, False, False, dl.V_POINTS): (0, 0),
    (dl.OFFSET_NE, False, False, dl.T_POINTS): (0, 0),
    (dl.OFFSET_NE, False, False, dl.F_POINTS): (0, 0),
    (dl.OFFSET_SW, False, False, dl.U_POINTS): (1, 0),
    (dl.OFFSET_SW, False, False, dl.V_POINTS): (0, 1),
    (dl.OFFSET_SW, False, False, dl.T_POINTS): (0, 0),
    (dl.OFFSET_SW, False, False, dl.F_POINTS): (1, 1),
    (dl.OFFSET_SW, True, True, dl.U_POINTS): (0, 0),
    (dl.OFFSET_SW, True, True, dl.V_POINTS): (0, 0),
    (dl.OFFSET_SW, True, True, dl.T_POINTS): (0, 0),
    (dl.OFFSET_SW, True, True, dl.F_POINTS): (0, 0),
    (dl.OFFSET_SW, True, False, dl.U_POINTS): (0, 0),
    (dl.OFFSET_SW, True, False, dl.V_POINTS): (0, 1),
    (dl.OFFSET_SW, True, False, dl.F_POINTS): (0, 1),
    (dl.OFFSET_SW, False, True, dl.U_POINTS): (1, 0),
    (dl.OFFSET_SW, False, True, dl.V_POINTS): (0, 0),
    (dl.OFFSET_SW, False, True, dl.T_POINTS): (0, 0),
    (dl.OFFSET_SW, False, True, dl.F_POINTS): (1, 0),
    (dl.OFFSET_NE, True, False, dl.U_POINTS): (0, 0),
    (dl.OFFSET_NE, False, True, dl.V_POINTS): (0, 0),
}


@pytest.mark.parametrize("key,expect", sorted(TRUTH.items()))
def test_staggering_truth_table(key, expect):
    offset, px, py, points = key
    bcs = (dl.BC_PERIODIC if px else dl.BC_EXTERNAL,
           dl.BC_PERIODIC if py else dl.BC_EXTERNAL, dl.BC_NONE)
    grid = make_grid(8, 8, 1, bcs=bcs, offset=offset)
    assert staggering_offsets(grid, points) == expect


def test_internal_region_single_shard():
    grid = make_grid(10, 8, 1, offset=dl.OFFSET_SW)
    h = grid.decomp.halo
    u = dl.Field(grid, dl.U_POINTS)
    r = u.internal
    assert (r.xstart, r.xstop) == (h + 1, h + 10)
    assert (r.ystart, r.ystop) == (h, h + 8)
    assert u.whole == r.grow(1)
    f = dl.Field(grid, dl.F_POINTS)
    assert (f.internal.xstart, f.internal.ystart) == (h + 1, h + 1)


def test_internal_region_multi_shard_sw_seamless():
    grid = make_grid(8, 8, 4, offset=dl.OFFSET_SW)
    u = dl.Field(grid, dl.U_POINTS)
    d = grid.decomp
    for rank in range(4):
        ix, _ = d.rank_coords(rank)
        assert u.internal_region(rank).xstart == (d.halo + 1 if ix == 0
                                                  else d.halo)
    assert sum(u.internal_region(k).npts for k in range(4)) == 7 * 8
    assert int(u.internal_mask_np().sum()) == 7 * 8


def test_all_points_field():
    grid = make_grid(10, 8, 1)
    fld = dl.Field(grid, dl.ALL_POINTS)
    r = fld.internal
    assert (r.xstart, r.xstop) == (0, grid.nx)
    assert (r.ystart, r.ystop) == (0, grid.ny)
    assert fld.num_halos == 0


def test_mask_counts_match_regions():
    for ndom in (1, 4, 6):
        grid = make_grid(10, 9, ndom)
        for pts in (dl.T_POINTS, dl.U_POINTS, dl.V_POINTS, dl.F_POINTS):
            fld = dl.Field(grid, pts)
            n_regions = sum(fld.internal_region(k).npts
                            for k in range(grid.decomp.ndomains))
            assert int(fld.internal_mask_np().sum()) == n_regions == 90


def test_field_requires_initialised_grid():
    grid = dl.Grid(dl.ARAKAWA_C, (dl.BC_EXTERNAL, dl.BC_EXTERNAL,
                                  dl.BC_NONE), dl.OFFSET_NE, **CPU)
    with pytest.raises(RuntimeError):
        dl.Field(grid, dl.T_POINTS)
    grid.decompose(4, 4, ndomains=1)
    with pytest.raises(RuntimeError):
        dl.Field(grid, dl.T_POINTS)


def test_arakawa_b_rejected():
    with pytest.raises(NotImplementedError):
        dl.Grid(dl.ARAKAWA_B, (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                dl.OFFSET_NE, **CPU)


def test_copy_set_free_field():
    grid = make_grid(10, 8, 1)
    a = dl.Field(grid, dl.T_POINTS)
    b = dl.Field(grid, dl.T_POINTS)
    dl.set_field(a, 3.0)
    assert np.all(a.get_data() == 3.0)
    dl.copy_field(a, b)
    assert np.all(b.get_data() == 3.0)
    dl.set_field(a, 1.0)                    # b is a copy, not a view
    assert np.all(b.get_data() == 3.0)
    dl.copy_field_patch(a, dl.Region(0, 2, 0, 2), dl.Region(4, 6, 4, 6))
    dl.copy_field_patch(b, dl.Region(0, 2, 0, 2), dl.Region(4, 6, 4, 6))
    assert np.all(b.get_data()[4:6, 4:6] == 3.0)
    dl.free_field(a)
    assert a.data is None


def test_sub_region_read_write():
    """As tests/device_computation/test_device_io.f90: partial host <->
    device sync of sub-regions."""
    fld = dl.Field(make_grid(5, 5, 1), dl.T_POINTS)
    dl.set_field(fld, 0.0)
    fld.write_to_device(dl.Region(2, 5, 2, 5), np.ones((3, 3)))
    fld.data = fld.data * 2.0
    quad = fld.read_from_device(dl.Region(3, 6, 3, 6))
    assert np.all(quad[:2, :2] == 2.0)
    assert np.all(quad[2:, :] == 0.0) and np.all(quad[:, 2:] == 0.0)
    full = fld.get_data()
    assert full[2, 2] == 2.0 and full[0, 0] == 0.0


def test_alignment_padding_grid():
    grid = make_grid(10, 10, 2, align=16)
    assert grid.nx % 16 == 0
    fld = dl.Field(grid, dl.T_POINTS)
    m = fld.internal_mask_np()
    assert int(m.sum()) == 100
    fld.set_data(np.where(m, 1.0, -5.0))
    assert dl.field_checksum(fld) == 100.0


@pytest.mark.parametrize("points", [dl.T_POINTS, dl.U_POINTS, dl.F_POINTS])
@pytest.mark.parametrize("ndom", [1, 4])
def test_field_and_grid_surface_match_jax(ndom, points):
    """Regions, wrap-copy descriptors, coordinates, masks, the wrap
    copies, integral and max_abs of a port field equal the JAX field's on
    the same periodic-x SW grid."""
    bcs = (dl.BC_PERIODIC, dl.BC_EXTERNAL, dl.BC_NONE)
    gt = make_grid(12, 10, ndom, halo_width=2, bcs=bcs, offset=dl.OFFSET_SW)
    gj = jdl.Grid(jdl.ARAKAWA_C, bcs, jdl.OFFSET_SW)
    gj.decompose(12, 10, ndomains=ndom, halo_width=2)
    jdl.grid_init(gj, 1.0, 1.0)
    assert (gt.nx, gt.ny) == (gj.nx, gj.ny)
    # the two packages' region classes differ; their fields must not
    assert repr(gt.subdomain(ndom - 1)) == repr(gj.subdomain(ndom - 1))
    np.testing.assert_array_equal(gt.get_tmask().numpy(),
                                  np.asarray(gj.get_tmask()))
    np.testing.assert_array_equal(gt.xt_1d(), gj.xt_1d())
    np.testing.assert_array_equal(gt.yt_1d(), gj.yt_1d())
    np.testing.assert_array_equal(gt.xt.numpy(), np.asarray(gj.xt))
    np.testing.assert_array_equal(gt.yt.numpy(), np.asarray(gj.yt))
    for off in ((0, 0), (1, 1)):
        np.testing.assert_array_equal(gt.region_mask_np(*off),
                                      gj.region_mask_np(*off))
        np.testing.assert_array_equal(gt.external_mask_np(*off),
                                      gj.external_mask_np(*off))
    g = np.random.default_rng(ndom).normal(size=(10, 12))
    ft = dl.Field(gt, points, init_global_data=g)
    fj = jdl.Field(gj, points, init_global_data=g)
    assert repr(ft.halos) == repr(fj.halos)
    assert ft.num_halos == fj.num_halos
    for rank in range(ndom):
        assert repr(ft.internal_region(rank)) == repr(
            fj.internal_region(rank))
        assert repr(ft.whole_region(rank)) == repr(fj.whole_region(rank))
    ft.apply_periodic_bcs()
    fj.apply_periodic_bcs()
    np.testing.assert_array_equal(ft.get_data(), np.asarray(fj.data))
    assert ft.integral() == pytest.approx(fj.integral(), rel=1e-13)
    assert ft.max_abs() == fj.max_abs()
    np.testing.assert_array_equal(ft.local_view(ndom - 1),
                                  fj.local_view(ndom - 1))


# --- tests/test_example_model.py ------------------------------------------------

@pytest.mark.parametrize("transport", TRANSPORTS)
def test_example_serial(transport):
    sums = example_model.run(4, 10, ndomains=1, transport=transport, **CPU)
    assert all(v == 40.0 for v in sums.values())


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("ndom", [2, 4])
def test_example_distributed(ndom, transport):
    sums = example_model.run(4, 10, ndomains=ndom, transport=transport,
                             **CPU)
    fld = dl.Field(make_grid(4, 10, ndom), dl.T_POINTS)
    want = example_model.expected_checksum(fld)
    assert all(v == want for v in sums.values())
    assert sums == jexm.run(4, 10, ndomains=ndom)


def test_example_default_device(monkeypatch, capsys):
    """On the card by default: without one it raises, naming
    device="cpu"; with it, the four checksums print as in the JAX
    package."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        example_model.run()
    sums = example_model.run(8, 12, **CPU)
    assert sums["u"] == sums["v"] == sums["t"] == sums["f"] > 0
    out = capsys.readouterr().out
    assert "T checksum = 9.60000000E+01" in out
    assert "Example model set-up complete." in out


# --- tests/test_overdecomposition.py (the cases without a JAX mesh) ---------

@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("ndx,ndy", [(8, 4), (16, 1), (1, 16), (3, 6),
                                     (2, 2)])
@pytest.mark.parametrize("points", [dl.T_POINTS, dl.U_POINTS])
def test_hill_halos_many_tiles(ndx, ndy, points, transport):
    fld = dl.Field(make_grid(48, 48, ndx=ndx, ndy=ndy), points)
    init_field_hill(fld, POISON)
    fld.halo_exchange(1, transport=transport)
    check_hill_halos(fld, depth=1)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_hill_halos_many_tiles_depth2(transport):
    fld = dl.Field(make_grid(48, 40, ndx=8, ndy=4, halo_width=2),
                   dl.T_POINTS)
    init_field_hill(fld, POISON)
    fld.halo_exchange(2, transport=transport)
    check_hill_halos(fld, depth=2)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_corners_propagate_between_tiles(transport):
    grid = make_grid(32, 32, ndx=4, ndy=4)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, POISON)
    fld.halo_exchange(1, transport=transport)
    data, oracle = fld.get_data(), hill_stacked(fld)
    for rank in (0, 5, 10):
        sy, sx = grid.decomp.shard_slices(rank)
        r = fld.internal_region(rank)
        assert abs(data[sy, sx][r.ystop, r.xstop]
                   - oracle[sy, sx][r.ystop, r.xstop]) < TOL, rank


@pytest.mark.parametrize("ndom", [32, 18])
def test_flagship_decomposition_invariance_many_tiles(ndom):
    def build(n):
        m = nl.build(48, 40, ndomains=n, open_north=True, **CPU)
        m.set_initial_ssh(gaussian_eta(48, 40, amp=1.0))
        return m

    m1, mn = build(1), build(ndom)
    m1.run(50)
    mn.run(50)
    g1, gn = m1.gather(), mn.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(gn[k], g1[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


def test_periodic_many_tiles():
    eta0 = np.random.default_rng(3).normal(size=(32, 32)) * 0.1
    ma = sh.build(32, 32, ndomains=1, dt=0.01, **CPU)
    mb = sh.build(32, 32, ndomains=16, dt=0.01, **CPU)
    for m in (ma, mb):
        m.set_initial_eta(eta0)
        m.run(20)
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


@pytest.mark.parametrize("transport", ["ppermute", "fused"])
def test_flagship_fused_many_tiles(transport):
    """32 tiles on the fused path with K=2, under both transports (the
    fused one exchanges at the full halo depth 8), equal to the 1-tile
    plain run to fp64 roundoff."""
    gnx, gny = 64, 48
    m1 = nl.build(gnx, gny, ndomains=1, open_north=True, **CPU)
    mo = nl.build(gnx, gny, ndomains=32, open_north=True, fused=True,
                  steps_per_sweep=2, halo_width=8 if transport == "fused"
                  else 4, **CPU)
    mo.enable_fast_path(2, transport=transport)
    ssh0 = gaussian_eta(gnx, gny, amp=0.5)
    for m in (m1, mo):
        m.set_initial_ssh(ssh0)
        m.run(24)
    g1, go = m1.gather(), mo.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(go[k], g1[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


def test_tracer_many_tiles():
    gnx, gny = 48, 48
    x = (np.arange(gnx) - gnx / 2 + 0.5) / gnx
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    u, v = tr.streamfunction_velocities(psi)
    c0 = gaussian_eta(gnx, gny, amp=1.0) + 0.01
    m1 = tr.build(gnx, gny, ndomains=1, dt=0.2, u=u, v=v, kappa=0.02, **CPU)
    m1.set_initial_tracer(c0)
    m1.run(12)
    mo = tr.build(gnx, gny, ndomains=24, dt=0.2, u=u, v=v, kappa=0.02,
                  fused=True, steps_per_sweep=2, **CPU)
    mo.set_initial_tracer(c0)
    mass0 = mo.mass()
    mo.run(12)
    assert abs(mo.mass() - mass0) <= 1e-12 * abs(mass0)
    np.testing.assert_allclose(mo.gather()["c"], m1.gather()["c"],
                               rtol=1e-12, atol=1e-13)


def test_transports_take_many_tiles():
    """The JAX package keeps its remote-DMA transports to one tile per
    device and refuses over-decomposed grids (test_pallas_paths_guard).
    The port's tiles all live on one device, where they stand for JAX's
    devices, not for its over-decomposition: both transports take 32
    tiles."""
    m = nl.build(64, 64, ndomains=32, halo_width=8, fused=True, **CPU)
    m.enable_fast_path(1, transport="fused")
    assert m._in_sweep_exchange
    g = make_grid(64, 64, 32, halo_width=2)
    fld = dl.Field(g, dl.T_POINTS)
    init_field_hill(fld, POISON)
    want = dl.halo.exchange(fld.data, g.halo_spec, 2)
    got = halo_kernel.exchange_kernel(fld.data, g.halo_spec, 2)
    assert torch.equal(got, want)
