"""The PyTorch port's utilities against the JAX package.

``dl_esm_inf_tpu_torch/utils``: config (``GOCEAN_OMP_GRID`` seeding
``Grid.decompose``), diagnostics, profiling (step timer, comms schedule,
decomposition report), io (dumps, NetCDF-3 files and history time
series) and checkpoint (npz, mesh-elastic).  The expectations of
tests/test_utils.py hold against the port (its orbax tests aside: the
orbax backend is not ported), and the two packages read each other's
files: checkpoints resume across the packages at 1e-12 (float64) and
NetCDF files load in both readers and in scipy.
"""
import dataclasses

import numpy as np
import pytest
import torch

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.parallel import halo as jhalo
from dl_esm_inf_tpu.utils import checkpoint as jck
from dl_esm_inf_tpu.utils import diagnostics as jdiag
from dl_esm_inf_tpu.utils import io as jio
from dl_esm_inf_tpu.utils import profiling as jprof

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.models import nemolite2d as tnl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.utils import checkpoint, config, diagnostics
from dl_esm_inf_tpu_torch.utils import io as dio
from dl_esm_inf_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = dict(device="cpu")
RTOL, ATOL = 1e-12, 1e-13


def build(ndom=4, gnx=32, gny=24, **kw):
    m = tnl.build(gnx, gny, ndomains=ndom, open_north=False, **CPU, **kw)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    return m


def jbuild(ndom=4, gnx=32, gny=24, **kw):
    m = jnl.build(gnx, gny, ndomains=ndom, open_north=False, **kw)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    return m


def _grid(**kw):
    return tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                    tdl.BC_NONE), tdl.OFFSET_NE, **CPU, **kw)


def _assert_close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# --- checkpoint --------------------------------------------------------------

def test_checkpoint_roundtrip_same_mesh(tmp_path):
    m = build()
    m.run(20)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_model(path, m)
    m2 = build()
    checkpoint.load_model(path, m2)
    assert m2._istep0 == 20
    for k in ("sshn", "un", "vn"):
        np.testing.assert_array_equal(m2.gather()[k], m.gather()[k])
    # resumed run == uninterrupted run
    m.run(20)
    m2.run(20)
    _assert_close(m2.gather(), m.gather())


def test_checkpoint_across_mesh_shapes(tmp_path):
    """Save on 6 tiles, restore on 1: elastic restart through the global
    form."""
    m6 = build(ndom=6)
    m6.run(10)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_model(path, m6)
    m1 = build(ndom=1)
    checkpoint.load_model(path, m1)
    m6.run(10)
    m1.run(10)
    _assert_close(m1.gather(), m6.gather())


def test_checkpoint_missing_field(tmp_path):
    m = build()
    path = str(tmp_path / "ck.npz")
    checkpoint.save_fields(path, {"only": m.sshn_t})
    with pytest.raises(KeyError):
        checkpoint.load_fields(path, {"other": m.sshn_t})


@pytest.mark.parametrize("ndom", [1, 6])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_across_packages(tmp_path, writer, ndom):
    """A checkpoint written by one package resumes in the other: the
    reader's run continues the writer's at 1e-12 (float64)."""
    mj, mt = jbuild(ndom=ndom), build(ndom=ndom)
    path = str(tmp_path / "ck.npz")
    if writer == "jax":
        mj.run(10)
        jck.save_model(path, mj, extra={"by": "jax"})
        meta = checkpoint.load_model(path, mt)
    else:
        mt.run(10)
        checkpoint.save_model(path, mt, extra={"by": "port"})
        meta = jck.load_model(path, mj)
    assert meta["step"] == 10 and meta["attrs"] == {"by": writer}
    assert meta["names"] == ["sshn_t", "un", "vn"]
    assert mj._istep0 == mt._istep0 == 10
    _assert_close(mt.gather(), mj.gather(), rtol=0, atol=0)
    mj.run(10)
    mt.run(10)
    _assert_close(mt.gather(), mj.gather())


# --- profiling ---------------------------------------------------------------

def test_comms_schedule():
    m = build(ndom=6, halo_width=2)
    sched = profiling.comms_schedule(m.grid.halo_spec, depth=2)
    with pytest.raises(ValueError, match="depth"):
        profiling.comms_schedule(build(ndom=6).grid.halo_spec, depth=2)
    axes = {(e["axis"], e["direction"]) for e in sched}
    assert axes == {("x", "east"), ("x", "west"),
                    ("y", "north"), ("y", "south")}
    east = next(e for e in sched if e["direction"] == "east")
    # 32x24 domain on 6 tiles -> 3x2 tile grid: x pairs (0,1),(1,2)
    assert east["pairs"] == [(0, 1), (1, 2)]
    assert east["strip"][1] == 2  # depth


@pytest.mark.parametrize("tiles,wrap,halo,depth", [
    ((1, 1), (False, False), 1, 1),
    ((1, 1), (True, True), 2, 2),
    ((3, 2), (False, False), 2, 1),
    ((2, 2), (True, False), 4, 3),
    ((4, 2), (False, True), 2, 2),
    ((2, 3), (True, True), 8, 8),
])
def test_comms_schedule_matches_jax(tiles, wrap, halo, depth):
    bc = [tdl.BC_PERIODIC if w else tdl.BC_EXTERNAL for w in wrap]
    g = tdl.Grid(tdl.ARAKAWA_C, (bc[0], bc[1], tdl.BC_NONE), tdl.OFFSET_NE,
                 **CPU)
    g.decompose(12 * tiles[0], 10 * tiles[1], ndomainx=tiles[0],
                ndomainy=tiles[1], halo_width=halo)
    spec = g.halo_spec
    jspec = jhalo.HaloSpec(**dataclasses.asdict(spec))
    assert profiling.comms_schedule(spec, depth) == jprof.comms_schedule(
        jspec, depth)


def test_decomposition_report():
    d = tdl.decompose(10, 10, ndomains=4)
    rep = profiling.decomposition_report(d)
    assert "2x2" in rep and "load imbalance" in rep
    assert rep.count("subdomain[") == 4


@pytest.mark.parametrize("gnx,gny,ndom", [(10, 10, 4), (33, 17, 6),
                                          (64, 48, 1), (7, 5, 3)])
def test_decomposition_report_matches_jax(gnx, gny, ndom):
    assert profiling.decomposition_report(
        tdl.decompose(gnx, gny, ndomains=ndom)) == \
        jprof.decomposition_report(jdl.decompose(gnx, gny, ndomains=ndom))


def test_step_timer():
    t = profiling.StepTimer()
    with t.measure():
        pass
    assert t.summary()["n"] == 1 and t.best >= 0


def test_slope_time_and_trace(tmp_path):
    """The slope cancels a chain's fixed cost; the trace lands in the
    log directory as a Chrome trace."""
    calls = []

    def chain(n):
        return lambda: calls.append(n)
    t = profiling.slope_time(chain, 1, 3, reps=2)
    assert calls.count(1) == calls.count(3) == 3 and t == t
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").is_file()
    assert prof.key_averages()


# --- config ------------------------------------------------------------------

def test_config_env(monkeypatch):
    monkeypatch.setenv("DL_ESM_ALIGNMENT", "64")
    monkeypatch.setenv("GOCEAN_OMP_GRID", "4x2")
    monkeypatch.setenv("JPIGLO", "100")
    cfg = config.read_env()
    assert cfg.alignment == 64
    assert cfg.tile_grid == (4, 2)
    assert cfg.jpiglo == 100 and cfg.jpjglo is None
    assert config.parse_grid_dims("bad") is None
    assert config.parse_grid_dims("ax2") is None


def test_gocean_omp_grid_seeds_decompose(monkeypatch):
    """GOCEAN_OMP_GRID shapes the decomposition when no explicit sizing
    is given, as in the JAX package."""
    monkeypatch.setenv("GOCEAN_OMP_GRID", "4x2")
    d = _grid().decompose(32, 24)
    assert (d.nprocx, d.nprocy) == (4, 2)
    jg = jdl.Grid(jdl.ARAKAWA_C, (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL,
                                  jdl.BC_NONE), jdl.OFFSET_NE)
    assert (jg.decompose(32, 24).nprocx, jg.decomp.nprocy) == (4, 2)
    # explicit arguments win over the environment
    d2 = _grid().decompose(32, 24, ndomainx=2, ndomainy=2)
    assert (d2.nprocx, d2.nprocy) == (2, 2)
    # malformed values keep the one-tile default (the JAX package's
    # "every device"; the port has one)
    monkeypatch.setenv("GOCEAN_OMP_GRID", "nonsense")
    d3 = _grid().decompose(32, 24)
    assert (d3.nprocx, d3.nprocy) == (1, 1)


# --- io ----------------------------------------------------------------------

def test_dump_netcdf_scipy_roundtrip(tmp_path):
    """The NetCDF-3 writer against scipy's independent reader: dims,
    coords, data, and attributes of 2D + multi-level fields."""
    scipy_io = pytest.importorskip("scipy.io")
    m = build(ndom=4, gnx=8, gny=6)
    g3 = np.stack([np.arange(48.0).reshape(6, 8) + 100 * k
                   for k in range(3)])
    f3 = tdl.Field(m.grid, tdl.T_POINTS, init_global_data=g3, levels=3)
    p = str(tmp_path / "out.nc")
    dio.dump_netcdf({"ssh": m.sshn_t, "temp": f3}, p,
                    global_attrs={"title": "dl_esm_inf_tpu dump",
                                  "step": 7})
    with scipy_io.netcdf_file(p, "r", mmap=False) as nc:
        assert nc.title == b"dl_esm_inf_tpu dump"
        assert int(nc.step) == 7
        assert nc.dimensions["x"] == 8
        assert nc.dimensions["y"] == 6
        assert nc.dimensions["z"] == 3
        np.testing.assert_allclose(nc.variables["x"][:],
                                   (np.arange(8) + 1) * m.grid.dx)
        np.testing.assert_allclose(nc.variables["ssh"][:],
                                   m.sshn_t.gather_inner_data())
        np.testing.assert_allclose(nc.variables["temp"][:], g3)
        assert nc.variables["ssh"].coordinates == b"y x"

    # single field, list form, and mixed extents get suffixed dims
    m2 = build(ndom=1, gnx=12, gny=6)
    p2 = str(tmp_path / "two.nc")
    dio.dump_netcdf([m.sshn_t, m2.sshn_t], p2, names=["a", "b"])
    with scipy_io.netcdf_file(p2, "r", mmap=False) as nc:
        assert nc.variables["a"].shape == (6, 8)
        assert nc.variables["b"].shape == (6, 12)
        assert nc.dimensions["x"] == 8 and nc.dimensions["x12"] == 12


def test_load_netcdf_roundtrip_and_foreign(tmp_path):
    """The numpy NetCDF reader: round-trip through the port's writer and
    scipy-written files with a record dimension, and CDF-2."""
    scipy_io = pytest.importorskip("scipy.io")
    m = build(ndom=4, gnx=8, gny=6)
    p = str(tmp_path / "rt.nc")
    dio.dump_netcdf({"ssh": m.sshn_t}, p, global_attrs={"step": 3})
    d = dio.load_netcdf(p)
    np.testing.assert_array_equal(d["variables"]["ssh"],
                                  m.sshn_t.gather_inner_data())
    np.testing.assert_allclose(d["variables"]["x"],
                               (np.arange(8) + 1) * m.grid.dx)
    assert int(d["attributes"]["step"]) == 3
    assert d["variable_attrs"]["ssh"]["coordinates"] == "y x"

    pf = str(tmp_path / "foreign.nc")
    with scipy_io.netcdf_file(pf, "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("x", 3)
        v = nc.createVariable("h", "f8", ("time", "x"))
        v[0] = [1.0, 2.0, 3.0]
        v[1] = [4.0, 5.0, 6.0]
        s = nc.createVariable("n", "i4", ("time",))
        s[0] = 7
        s[1] = 8
        f = nc.createVariable("fix", "f4", ("x",))
        f[:] = [9.0, 10.0, 11.0]
        f.units = "m"
    d = dio.load_netcdf(pf)
    assert d["dimensions"] == {"time": 2, "x": 3}
    assert d["variables"]["h"].tolist() == [[1, 2, 3], [4, 5, 6]]
    assert d["variables"]["n"].tolist() == [7, 8]
    assert d["variables"]["fix"].tolist() == [9.0, 10.0, 11.0]
    assert d["variable_attrs"]["fix"]["units"] == "m"

    po = str(tmp_path / "single.nc")
    with scipy_io.netcdf_file(po, "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("x", 3)
        v = nc.createVariable("only", "i2", ("time", "x"))
        for r in range(3):
            v[r] = [3 * r + 1, 3 * r + 2, 3 * r + 3]
    d = dio.load_netcdf(po)
    assert d["variables"]["only"].tolist() == [[1, 2, 3], [4, 5, 6],
                                               [7, 8, 9]]

    p2 = str(tmp_path / "cdf2.nc")
    with scipy_io.netcdf_file(p2, "w", version=2) as nc:
        nc.createDimension("x", 5)
        v = nc.createVariable("a", "f8", ("x",))
        v[:] = [1.0, 2.0, 3.0, 4.0, 5.0]
    with open(p2, "rb") as fh:
        assert fh.read(4)[3] == 2
    assert dio.load_netcdf(p2)["variables"]["a"].tolist() == [
        1.0, 2.0, 3.0, 4.0, 5.0]

    bad = str(tmp_path / "bad.nc")
    with open(bad, "wb") as fh:
        fh.write(b"HDF\x05notnetcdf3")
    with pytest.raises(ValueError, match="not a NetCDF-3"):
        dio.load_netcdf(bad)


def test_netcdf_timeseries(tmp_path):
    """Streaming record-dimension output: snapshots appended straight
    to disk, read back by scipy and load_netcdf."""
    scipy_io = pytest.importorskip("scipy.io")
    m = build(ndom=4, gnx=8, gny=6)
    p = str(tmp_path / "hist.nc")
    snaps = []
    with dio.NetCDFTimeSeries(p, {"ssh": m.sshn_t},
                              global_attrs={"title": "hist"}) as ts:
        for k in range(3):
            m.run(5)
            snaps.append(m.sshn_t.gather_inner_data().copy())
            ts.append(time=5.0 * (k + 1))
        m2 = build(ndom=1, gnx=12, gny=6)
        with pytest.raises(ValueError, match="share one grid"):
            dio.NetCDFTimeSeries(str(tmp_path / "bad.nc"),
                                 {"a": m.sshn_t, "b": m2.sshn_t})
    d = dio.load_netcdf(p)
    assert d["dimensions"] == {"time": 3, "y": 6, "x": 8}
    assert d["variables"]["time"].tolist() == [5.0, 10.0, 15.0]
    for k in range(3):
        np.testing.assert_array_equal(d["variables"]["ssh"][k], snaps[k])
    with scipy_io.netcdf_file(p, "r", mmap=False) as nc:
        assert nc.title == b"hist"
        np.testing.assert_array_equal(nc.variables["ssh"][2], snaps[2])


def test_netcdf_int_narrowing_and_flush(tmp_path):
    """Integer narrowing is range-checked (dump) and kind-consistent
    (time series), and append() flushes, so a reader sees each record
    before close."""
    m = build(ndom=1, gnx=8, gny=6)

    a64 = np.arange(48, dtype=np.int64).reshape(6, 8) * 100000
    p = str(tmp_path / "ints.nc")
    dio.dump_netcdf({"codes": a64}, p)
    d = dio.load_netcdf(p)
    assert d["variables"]["codes"].dtype == np.int32
    np.testing.assert_array_equal(d["variables"]["codes"], a64)

    bad = a64.copy()
    bad[0, 0] = 2**31 + 5
    with pytest.raises(ValueError, match="int32 range"):
        dio.dump_netcdf({"codes": bad}, str(tmp_path / "bad.nc"))

    fi = tdl.Field(m.grid, tdl.T_POINTS, dtype=np.int64,
                   init_global_data=np.arange(48).reshape(6, 8) * 10**6)
    pts = str(tmp_path / "ints_ts.nc")
    ts = dio.NetCDFTimeSeries(pts, {"n": fi})
    ts.append(time=1.0)
    mid = dio.load_netcdf(pts)
    assert mid["dimensions"]["time"] == 1
    assert mid["variables"]["n"].dtype == np.int32
    np.testing.assert_array_equal(mid["variables"]["n"][0],
                                  np.arange(48).reshape(6, 8) * 10**6)
    fi.set_data(np.full(m.grid.array_shape, 2**31 + 7, np.int64))
    with pytest.raises(ValueError, match="range"):
        ts.append(time=2.0)
    ts.close()

    # same-width unsigned -> signed (uint32 -> i4) wraps at >= 2**31
    fu = tdl.Field(m.grid, tdl.T_POINTS, dtype=np.uint32,
                   init_global_data=np.full((6, 8), 2**31 + 9, np.uint32))
    tsu = dio.NetCDFTimeSeries(str(tmp_path / "u32_ts.nc"), {"u": fu})
    with pytest.raises(ValueError, match="range"):
        tsu.append(time=1.0)
    tsu.close()


def test_dump_field(tmp_path):
    m = build(ndom=4, gnx=8, gny=6)
    p = str(tmp_path / "fld.npz")
    dio.dump_field(m.sshn_t, p, halo_depth=1)
    d = dio.load_dump(p)
    assert d["data"].shape == (6, 8)
    assert d["x"][0] == m.grid.dx
    assert d["local_views"].shape == (4,) + (m.grid.ny, m.grid.nx)
    pd = str(tmp_path / "fld.dat")
    dio.dump_field(m.sshn_t, pd, fmt="dat")
    with open(pd) as fh:
        blocks = fh.read().strip().split("\n\n")
    assert len(blocks) == 6  # one block per row


def test_netcdf_files_cross_packages(tmp_path):
    """The port's files load in the JAX package's reader and in scipy,
    and the JAX package's in the port's, with equal arrays."""
    scipy_io = pytest.importorskip("scipy.io")
    mt, mj = build(ndom=4, gnx=8, gny=6), jbuild(ndom=4, gnx=8, gny=6)
    for m in (mt, mj):
        m.run(3)
    pt, pj = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    dio.dump_netcdf({"ssh": mt.sshn_t, "u": mt.un}, pt,
                    global_attrs={"step": 3})
    jio.dump_netcdf({"ssh": mj.sshn_t, "u": mj.un}, pj,
                    global_attrs={"step": 3})
    a, b = jio.load_netcdf(pt), dio.load_netcdf(pj)
    assert a["dimensions"] == b["dimensions"]
    assert a["variable_attrs"] == b["variable_attrs"]
    for k in ("x", "y", "ssh", "u"):
        np.testing.assert_allclose(a["variables"][k], b["variables"][k],
                                   rtol=RTOL, atol=ATOL)
    with scipy_io.netcdf_file(pt, "r", mmap=False) as nc:
        np.testing.assert_array_equal(nc.variables["ssh"][:],
                                      a["variables"]["ssh"])
    hp = str(tmp_path / "hist.nc")
    with dio.NetCDFTimeSeries(hp, {"ssh": mt.sshn_t, "v": mt.vn}) as ts:
        for k in range(2):
            mt.run(2)
            ts.append(time=float(k))
    h = jio.load_netcdf(hp)
    assert h["dimensions"] == {"time": 2, "y": 6, "x": 8}
    np.testing.assert_array_equal(h["variables"]["v"][1],
                                  mt.vn.gather_inner_data())
    with scipy_io.netcdf_file(hp, "r", mmap=False) as nc:
        np.testing.assert_array_equal(nc.variables["ssh"][1],
                                      mt.sshn_t.gather_inner_data())


# --- diagnostics -------------------------------------------------------------

@pytest.mark.parametrize("variable_depth", [False, True])
def test_diagnostics_match_jax(variable_depth):
    gnx, gny = 32, 24
    depth = (60.0 + 40.0 * np.random.default_rng(5).random((gny, gnx))
             if variable_depth else 100.0)
    mt, mj = (build(ndom=4, depth=depth), jbuild(ndom=4, depth=depth))
    for m in (mt, mj):
        m.run(6)
    g, dx, dy = 9.81, mt.grid.dx, mt.grid.dy
    pairs = [
        (diagnostics.volume(mt.sshn_t, dx, dy),
         jdiag.volume(mj.sshn_t, dx, dy)),
        (diagnostics.potential_energy(mt.sshn_t, g, dx, dy),
         jdiag.potential_energy(mj.sshn_t, g, dx, dy)),
        (diagnostics.kinetic_energy(mt.un, mt.vn, mt.bathymetry, dx, dy),
         jdiag.kinetic_energy(mj.un, mj.vn, mj.bathymetry, dx, dy)),
        (diagnostics.kinetic_energy(mt.un, mt.vn, mt.bathymetry, dx, dy,
                                    ssh_u=mt.sshn_u, ssh_v=mt.sshn_v),
         jdiag.kinetic_energy(mj.un, mj.vn, mj.bathymetry, dx, dy,
                              ssh_u=mj.sshn_u, ssh_v=mj.sshn_v)),
        (diagnostics.cfl_number(mt.un, mt.vn, mt.p.rdt, dx, dy),
         jdiag.cfl_number(mj.un, mj.vn, mj.p.rdt, dx, dy)),
        (diagnostics.cfl_number(mt.un, mt.vn, mt.p.rdt, dx, dy,
                                depth=100.0),
         jdiag.cfl_number(mj.un, mj.vn, mj.p.rdt, dx, dy, depth=100.0)),
    ]
    for got, want in pairs:
        assert isinstance(got, float) and got != 0.0
        assert got == pytest.approx(float(want), rel=RTOL, abs=1e-300)


# --- the slice: the CLI's history file against the JAX CLI -----------------

def test_cli_history_matches_jax(tmp_path, capsys):
    """The port's CLI (plain fused path, K = 4, on the CPU) and the JAX
    CLI at the same N and steps write the same records, at float64."""
    pt, pj = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    tnl.main(["24", "10", "cpu", pt])
    jnl.main(["24", "10", pj])
    out = capsys.readouterr().out
    assert out.count("history written to") == 2
    a, b = dio.load_netcdf(pt), jio.load_netcdf(pj)
    assert a["dimensions"] == b["dimensions"] == {"time": 5, "y": 24,
                                                  "x": 24}
    assert a["attributes"] == b["attributes"]
    assert a["variables"]["ssh"].dtype == np.float64
    for k in ("time", "x", "y", "ssh", "u", "v"):
        np.testing.assert_allclose(a["variables"][k], b["variables"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
