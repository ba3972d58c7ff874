"""The port's kernel Schedule against the JAX package's.

Mirrors tests/test_schedule.py.  The same schedule of twin kernels (a
jnp body for the JAX package, a torch body for the port) on the same
seeded fields, at float64:

* the static exchange plan (``schedule.exchanges``) is EQUAL to the JAX
  plan;
* the plain tier (``schedule()``) equals the JAX jnp tier;
* the fused tier (``fused``, ``fused_program``), which on the CPU runs
  the sweep's plain PyTorch version, equals the JAX jnp tier and the
  JAX fused tier in interpret mode, on internal points (rtol/atol
  1e-12; halo cells hold values of no meaning in both);
* a kernel without a hand-written CUDA body gets one derived from its
  torch body (``ops/point_trace.py``): each record's replay equals its
  body bitwise (the fuzz, twin and multi-level kernels at levels 3 and
  8, float64 and float32), and the multi-level schedules run through
  the replayed records equal the JAX fused tier (interpret) at 1e-12
  and the port's plain fused tier bitwise;
* the CUDA generator emits a source for these schedules, hand-written,
  derived and levels=N alike (plane counts, shared memory, the tile
  it picks), and refuses, before anything is built or launched,
  what the tracer cannot derive.  The generated kernels themselves run
  in tests/test_torch_gpu.py and ``chip_smoke.py``.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.api import kernel_meta as jkm
from dl_esm_inf_tpu.ops import stencils as jst

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.api import kernel_meta as tkm
from dl_esm_inf_tpu_torch.ops import point_trace as tpt
from dl_esm_inf_tpu_torch.ops import schedule_sweep as tss
from dl_esm_inf_tpu_torch.ops import stencil_sweep as tsst
from dl_esm_inf_tpu_torch.ops import stencils as tst

from dl_esm_inf_tpu_torch import level_schedules as sc

torch.set_num_threads(2)

#: the port runs on the card unless told otherwise; these tests run on
#: the CPU
CPU = dict(device="cpu")
TOL = dict(rtol=1e-12, atol=1e-12)


def _args(km, spec):
    out = []
    for acc, el, *sten in spec:
        element = (getattr(km.GridProp, el.split(".")[1])
                   if el.startswith("GridProp.") else getattr(km, el))
        out.append(km.Arg(getattr(km, acc), element,
                          km.Stencil(*sten[0]) if sten else km.GO_POINTWISE))
    return out


def twin(spec, jfn, tfn, cuda=None, **kw):
    """The same metadata on a jnp body, and on a torch body with its
    CUDA point body."""
    jw = functools.wraps(jfn)(lambda *a: jfn(*a))
    return (jkm.kernel(args=_args(jkm, spec), **kw)(jw),
            tkm.kernel(args=_args(tkm, spec), cuda=cuda, **kw)(tfn))


J_EAST_PLUS, T_EAST_PLUS = twin(
    [("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT", (0, 11, 0)),
     ("GO_READ", "GO_R_SCALAR")],
    lambda out, x, a: jst.xp(x) + a, lambda out, x, a: tst.xp(x) + a,
    cuda="out = x(0, 1) + T(a);", name="east_plus")
J_DOUBLE, T_DOUBLE = twin(
    [("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")],
    lambda out, x: 2.0 * x, lambda out, x: 2.0 * x,
    cuda="out = T(2.0) * x();", name="double")
J_TOTAL, T_TOTAL = twin(
    [("GO_SUM", "GO_R_SCALAR"), ("GO_READ", "GO_CT")],
    lambda x: jnp.sum(x), lambda x: torch.sum(x), name="total")
J_INCR, T_INCR = twin([("GO_READWRITE", "GO_CT")], lambda x: x + 1.0,
                      lambda x: x + 1.0, cuda="x = x() + T(1.0);",
                      name="incr")


def grids(gnx=12, gny=10, ndom=4, halo=1, wrap=False, dx=1.0):
    out = []
    for dl, extra in ((jdl, {}), (tdl, CPU)):
        bc = dl.BC_PERIODIC if wrap else dl.BC_EXTERNAL
        g = dl.Grid(dl.ARAKAWA_C, (bc, bc, dl.BC_NONE), dl.OFFSET_NE,
                    **extra)
        g.decompose(gnx, gny, ndomains=ndom, halo_width=halo,
                    **({"align_y": 8} if dl is jdl else {}))
        dl.grid_init(g, dx, dx)
        out.append(g)
    return out


def chain_fields(g, vals=None):
    """a (a ramp, or ``vals``), b, c on one grid of either package."""
    dl = jdl if isinstance(g, jdl.Grid) else tdl
    gny, gnx = g.global_ny, g.global_nx
    if vals is None:
        vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    return (dl.Field(g, dl.T_POINTS, init_global_data=vals),
            dl.Field(g, dl.T_POINTS), dl.Field(g, dl.T_POINTS))


def same(fj, ft, **tol):
    np.testing.assert_allclose(ft.gather_inner_data(),
                               np.asarray(fj.gather_inner_data()),
                               **(tol or TOL))


# --- the plain tier and the exchange plan ------------------------------------

def test_exchange_plan_equals_jax():
    for calls in (lambda k, a, b, c: ((k[0], b, a, 3.0), (k[0], c, b, 1.0),
                                      (k[1], b, c)),
                  lambda k, a, b, c: ((k[0], b, a, 3.0), (k[0], c, a, 1.0)),
                  lambda k, a, b, c: ((k[1], b, a), (k[0], c, b, 0.5),
                                      (k[0], a, c, 0.5), (k[0], b, a, 1.0))):
        gj, gt = grids()
        sj = jkm.Schedule(*calls((J_EAST_PLUS, J_DOUBLE), *chain_fields(gj)))
        st_ = tkm.Schedule(*calls((T_EAST_PLUS, T_DOUBLE),
                                  *chain_fields(gt)))
        assert st_.exchanges == sj.exchanges
    gj, gt = grids()
    aj, bj, cj = chain_fields(gj)
    at, bt, ct = chain_fields(gt)
    plan = tkm.Schedule((T_EAST_PLUS, bt, at, 3.0),
                        (T_EAST_PLUS, ct, at, 1.0)).exchanges
    assert set(plan) == {0} and plan[0][0] == (1,)


def test_schedule_matches_jax_and_eager_invokes():
    """A dependent chain across tile seams: the port's schedule == its
    eager invokes == the JAX jnp schedule (bitwise on internal
    points)."""
    gj, gt, ge = *grids(), grids()[1]
    aj, bj, cj = chain_fields(gj)
    at, bt, ct = chain_fields(gt)
    ae, be, ce = chain_fields(ge)
    jkm.Schedule((J_EAST_PLUS, bj, aj, 3.0), (J_EAST_PLUS, cj, bj, 1.0),
                 (J_DOUBLE, bj, cj))()
    tkm.Schedule((T_EAST_PLUS, bt, at, 3.0), (T_EAST_PLUS, ct, bt, 1.0),
                 (T_DOUBLE, bt, ct))()
    tkm.invoke(T_EAST_PLUS, be, ae, 3.0)
    tkm.invoke(T_EAST_PLUS, ce, be, 1.0)
    tkm.invoke(T_DOUBLE, be, ce)
    for fj, ft, fe in ((bj, bt, be), (cj, ct, ce)):
        np.testing.assert_array_equal(ft.gather_inner_data(),
                                      fe.gather_inner_data())
        same(fj, ft, rtol=0, atol=0)


def test_schedule_reductions_and_rerun():
    gj, gt = grids(8, 8, 4)
    ones = np.ones((8, 8))
    aj, bj, _ = chain_fields(gj, ones)
    at, bt, _ = chain_fields(gt, ones)
    sj = jkm.Schedule((J_DOUBLE, bj, aj), (J_TOTAL, bj))
    st_ = tkm.Schedule((T_DOUBLE, bt, at), (T_TOTAL, bt))
    assert st_() == sj() == 128.0
    assert st_() == 128.0


def test_schedule_scalar_rebind():
    gj, gt = grids(8, 8, 2)
    aj, bj, _ = chain_fields(gj)
    at, bt, _ = chain_fields(gt)
    sj = jkm.Schedule((J_EAST_PLUS, bj, aj, 0.0))
    st_ = tkm.Schedule((T_EAST_PLUS, bt, at, 0.0))
    st_(scalars=[5.0])
    sj(scalars=[5.0])
    same(bj, bt)
    m = bt.internal_mask_np()
    plus5 = bt.get_data()[m].copy()
    st_(scalars=[0.0])
    np.testing.assert_allclose(plus5 - bt.get_data()[m], 5.0, rtol=1e-12)


def test_schedule_rebind_cannot_clobber_grid_scalars():
    jk, tk = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT"),
                   ("GO_READ", "GO_R_SCALAR"),
                   ("GO_READ", "GridProp.GRID_DX_CONST")],
                  lambda out, x, a, dx: a * x * dx,
                  lambda out, x, a, dx: a * x * dx)
    gj, gt = grids(8, 8, 2, dx=2.5)
    xj, oj, _ = chain_fields(gj, np.ones((8, 8)))
    xt, ot, _ = chain_fields(gt, np.ones((8, 8)))
    jkm.Schedule((jk, oj, xj, 3.0))(scalars=[4.0])
    s = tkm.Schedule((tk, ot, xt, 3.0))
    s(scalars=[4.0])
    assert np.allclose(ot.get_data()[ot.internal_mask_np()], 4.0 * 2.5)
    same(oj, ot)
    with pytest.raises(ValueError, match="1 user scalar"):
        s(scalars=[4.0, 9.0])


def test_schedule_depth_guard_and_arity():
    g0 = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                  tdl.BC_NONE), tdl.OFFSET_NE, **CPU)
    g0.decompose(12, 10, ndomains=1, halo_width=0)
    tdl.grid_init(g0, 1.0, 1.0)
    a0, b0, _ = chain_fields(g0)
    with pytest.raises(ValueError, match="halo depth"):
        tkm.Schedule((T_EAST_PLUS, b0, a0, 1.0))
    _, gt = grids()
    a, b, _ = chain_fields(gt)
    with pytest.raises(TypeError, match="caller arguments"):
        tkm.Schedule((T_EAST_PLUS, b, a))
    with pytest.raises(ValueError, match="empty schedule"):
        tkm.Schedule()


def test_invoke_schedule_with_grid_property():
    jk, tk = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT"),
                   ("GO_READ", "GridProp.GRID_DX_CONST")],
                  lambda out, x, dx: x * dx, lambda out, x, dx: x * dx)
    gj, gt = grids(8, 8, 2)
    aj, bj, _ = chain_fields(gj)
    at, bt, _ = chain_fields(gt)
    jkm.invoke_schedule((jk, bj, aj))
    assert tkm.invoke_schedule((tk, bt, at)) is None
    same(bj, bt)


def test_schedule_rejects_wrong_kernel_arity():
    _, tk = twin([("GO_WRITE", "GO_CT"), ("GO_WRITE", "GO_CT"),
                  ("GO_READ", "GO_CT")],
                 lambda o1, o2, x: 2.0 * x, lambda o1, o2, x: 2.0 * x)
    _, gt = grids()
    a, b, c = chain_fields(gt)
    with pytest.raises(ValueError, match="declares 2 written"):
        tkm.Schedule((tk, b, c, a))()


def test_schedule_consts_deduplicated():
    jk, tk = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT"),
                   ("GO_READ", "GridProp.GRID_AREA_T")],
                  lambda out, x, area: x * area,
                  lambda out, x, area: x * area,
                  cuda="out = x() * area();")
    _, gt = grids(32, 32, 4, halo=4)
    a, b, c = chain_fields(gt)
    s = tkm.Schedule((tk, b, a), (tk, c, b), (tk, c, c))
    assert len(s._consts) == 1
    s()
    np.testing.assert_allclose(c.gather_inner_data(), a.gather_inner_data(),
                               rtol=1e-12)


# --- the fused tier (its plain version on the CPU) ---------------------------

def fused_pair(calls, halo=4, ndom=4, gnx=32, gny=32, wrap=False, fields=None):
    """(JAX fields, port fields, JAX schedule, port schedule) of
    ``calls(kernels, *fields)``."""
    gj, gt = grids(gnx, gny, ndom, halo=halo, wrap=wrap)
    fj = (fields or chain_fields)(gj)
    ft = (fields or chain_fields)(gt)
    return (fj, ft, jkm.Schedule(*calls(J, *fj)),
            tkm.Schedule(*calls(T, *ft)))


J = types.SimpleNamespace(east_plus=J_EAST_PLUS, double=J_DOUBLE,
                          incr=J_INCR)
T = types.SimpleNamespace(east_plus=T_EAST_PLUS, double=T_DOUBLE,
                          incr=T_INCR)


def _chain3(k, a, b, c):
    return ((k.east_plus, b, a, 3.0), (k.double, c, b),
            (k.east_plus, c, c, 0.5))


@pytest.mark.parametrize("ndom", [1, 4, 16])
def test_fused_schedule_matches_jax(ndom):
    """The whole sequence as ONE sweep (single up-front exchange,
    redundant halo compute) == the JAX jnp schedule and the JAX fused
    sweep in interpret mode, across tile seams (16 tiles:
    over-decomposed in the JAX package too)."""
    fj, ft, sj, st_ = fused_pair(_chain3, ndom=ndom)
    st_.fused()
    sj.fused(interpret=True)
    gj = grids(32, 32, ndom, halo=4)[0]
    fjj = chain_fields(gj)
    jkm.Schedule(*_chain3(J, *fjj))()
    for x_j, x_t, x_jj in zip(fj, ft, fjj):
        same(x_j, x_t)
        same(x_jj, x_t)


def test_fused_schedule_repeats_and_scalars():
    calls = lambda k, a, b, c: ((k.east_plus, b, a, 1.5), (k.double, a, b))
    fj, ft, sj, st_ = fused_pair(calls, halo=8)
    for _ in range(3):
        sj(scalars=[2.5])
    st_.fused(scalars=[2.5], repeats=3)
    for x_j, x_t in zip(fj, ft):
        same(x_j, x_t)


def test_fused_schedule_per_repeat_scalars():
    calls = lambda k, a, b, c: ((k.east_plus, b, a, 0.0), (k.double, a, b))
    fj, ft, sj, st_ = fused_pair(calls, halo=8)
    series = [[0.25], [-1.0], [3.5]]
    sj.fused(scalars=series, repeats=3, interpret=True)
    st_.fused(scalars=series, repeats=3)
    for x_j, x_t in zip(fj, ft):
        same(x_j, x_t)
    with pytest.raises(ValueError, match="per-repeat scalars"):
        st_.fused(scalars=[[1.0]], repeats=3)


def test_fused_schedule_flat_scalars_with_0d_values():
    calls = lambda k, a, b, c: ((k.east_plus, b, a, 0.0),)
    fj, ft, sj, st_ = fused_pair(calls)
    sj(scalars=[5.0])
    st_.fused(scalars=[torch.tensor(5.0, dtype=torch.float64)])
    same(fj[1], ft[1])


def test_fused_schedule_grid_property_array():
    jk, tk = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT"),
                   ("GO_READ", "GridProp.GRID_AREA_T")],
                  lambda out, x, area: x * area,
                  lambda out, x, area: x * area, cuda="out = x() * area();")
    gj, gt = grids(32, 32, 4, halo=4, dx=0.5)
    aj, bj, _ = chain_fields(gj)
    at, bt, _ = chain_fields(gt)
    jkm.Schedule((jk, bj, aj)).fused(interpret=True)
    tkm.Schedule((tk, bt, at)).fused()
    same(bj, bt)


def test_fused_schedule_guards():
    _, gt = grids(32, 32, 4, halo=1)
    a, b, c = chain_fields(gt)
    with pytest.raises(NotImplementedError, match="reduction"):
        tkm.Schedule((T_TOTAL, a)).fused()
    s = tkm.Schedule((T_EAST_PLUS, b, a, 1.0), (T_EAST_PLUS, c, b, 1.0))
    assert s.fused_erosion(1) == 2
    with pytest.raises(ValueError, match="halo_width=2"):
        s.fused()
    with pytest.raises(ValueError, match="repeats must be"):
        tkm.Schedule((T_DOUBLE, b, a)).fused(repeats=0)


def _fuzz_cases():
    """tests/test_schedule.py::test_fused_schedule_fuzz's seeded chains
    (seed 42): random shifts, scalars, spaces, sizes, tile counts and
    wrap.  Yields (trial, names, scalars, spaces, wrap, gnx, gny, ndom,
    halo, values)."""
    rng = np.random.default_rng(42)
    for trial in range(6):
        wrap = bool(rng.integers(0, 2))
        gnx = int(rng.choice([24, 32, 40]))
        gny = int(rng.choice([24, 32, 40]))
        ndom = int(rng.choice([1, 4, 8, 16]))
        n_calls = int(rng.integers(1, 4))
        names = [str(n) for n in rng.choice(list(SHIFTS), size=n_calls)]
        halo = max(sum(2 if n == "EE" else 1 for n in names), 1)
        vals = rng.standard_normal((gny, gnx))
        rng.standard_normal((gny, gnx))     # the JAX test's second build
        scal, spaces = [], []
        for _ in names:
            scal.append(float(rng.uniform(-1, 1)))
            spaces.append(tkm.GO_ALL_PTS if rng.integers(0, 3) == 0
                          else tkm.GO_INTERNAL_PTS)
        yield trial, names, scal, spaces, wrap, gnx, gny, ndom, halo, vals


#: (stencil rows, jnp shift, torch shift, CUDA read) of the fuzz
SHIFTS = {
    "E": ((0, 11, 0), jst.xp, tst.xp, "x(0, 1)"),
    "W": ((0, 110, 0), jst.xm, tst.xm, "x(0, -1)"),
    "N": ((10, 10, 0), jst.yp, tst.yp, "x(1, 0)"),
    "S": ((0, 10, 10), jst.ym, tst.ym, "x(-1, 0)"),
    "EE": ((0, 12, 0), lambda a: jst.xp(jst.xp(a)),
           lambda a: tst.xp(tst.xp(a)), "x(0, 2)"),
}


def fuzz_kernel(name, space, tag):
    rows, jf, tf, read = SHIFTS[name]
    return twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT", rows),
                 ("GO_READ", "GO_R_SCALAR")],
                lambda out, x, a: jf(x) + a, lambda out, x, a: tf(x) + a,
                cuda=f"out = {read} + T(a);", iterates_over=space,
                name=f"fz_{tag}_{name}")


def test_fused_schedule_fuzz():
    ran = 0
    for trial, names, scal, spaces, wrap, gnx, gny, ndom, halo, vals in \
            _fuzz_cases():
        try:
            gj, gt = grids(gnx, gny, ndom, halo=halo, wrap=wrap)
            gj2 = grids(gnx, gny, ndom, halo=halo, wrap=wrap)[0]
        except ValueError:
            continue        # indivisible periodic decomposition
        fs = [(dl.Field(g, dl.T_POINTS, init_global_data=vals),
               dl.Field(g, dl.T_POINTS))
              for dl, g in ((jdl, gj), (jdl, gj2), (tdl, gt))]
        calls = [[], [], []]
        cur = [f[0] for f in fs]
        for k, (nm, s, sp) in enumerate(zip(names, scal, spaces)):
            jk, tk = fuzz_kernel(nm, sp, f"{trial}{k}")
            for i, kern in enumerate((jk, jk, tk)):
                calls[i].append((kern, fs[i][1], cur[i], s))
            cur = [f[1] for f in fs]
        jkm.Schedule(*calls[0])()
        jkm.Schedule(*calls[1]).fused(interpret=True)
        tkm.Schedule(*calls[2]).fused()
        msg = f"trial {trial}: {names} wrap={wrap} ndom={ndom} {gnx}x{gny}"
        for j in (0, 1):
            want = np.asarray(fs[j][1].gather_inner_data())
            np.testing.assert_allclose(fs[2][1].gather_inner_data(), want,
                                       err_msg=msg, **TOL)
        ran += 1
    assert ran >= 4


def test_fused_program_scratch_slot_matches_jax():
    """A written-before-read SCRATCH slot (b) streams read-only through
    the light loop; all slots equal the JAX fused program."""
    calls = lambda k, a, b, c: ((k.east_plus, b, a, 1.5), (k.double, a, b))
    fj, ft, sj, st_ = fused_pair(calls, halo=8)
    sj.fused_program(4, interpret=True)(scalars=[1.5])
    st_.fused_program(4)(scalars=[1.5])
    for x_j, x_t in zip(fj, ft):
        same(x_j, x_t)


def _multi_mask(km, k, a, b, c):
    fill = km.kernel(args=_args(km, [("GO_READWRITE", "GO_CT")]),
                     iterates_over=km.GO_ALL_PTS, name="bc_fill_all",
                     **({"cuda": "b = b() * T(0.5) + T(21.0);"}
                        if km is tkm else {}))(lambda b: b * 0.5 + 21.0)
    return ((k.east_plus, b, a, 0.0),     # b: interior mask write
            (k.east_plus, c, b, 0.0),     # stencil read of b
            (fill, b),                    # b: a SECOND (all-points) mask
            (k.incr, a))                  # a feeds forward


def test_fused_program_multi_mask_written_slot_is_carried():
    """The scratch rule needs ONE write mask: b, written under two
    masks, is carried; the port equals the JAX fused program and the
    plain schedule run three times."""
    gj, gt = grids(32, 32, 4, halo=8)
    fj, ft = chain_fields(gj), chain_fields(gt)
    gp = grids(32, 32, 4, halo=8)[1]
    fp = chain_fields(gp)
    jkm.Schedule(*_multi_mask(jkm, J, *fj)).fused_program(
        3, interpret=True)()
    tkm.Schedule(*_multi_mask(tkm, T, *ft)).fused_program(3)()
    plain = tkm.Schedule(*_multi_mask(tkm, T, *fp))
    for _ in range(3):
        plain()
    for x_j, x_t, x_p in zip(fj, ft, fp):
        same(x_j, x_t)
        np.testing.assert_allclose(x_t.gather_inner_data(),
                                   x_p.gather_inner_data(), **TOL)


def test_fused_program_readwrite_first_touch_is_carried():
    calls = lambda k, a, b, c: ((k.incr, a),)
    fj, ft, sj, st_ = fused_pair(calls, halo=8)
    for _ in range(3):
        sj()
    st_.fused_program(3)()
    same(fj[0], ft[0])


def test_fused_schedule_more_than_eight_masks():
    """Nine write masks: two packed code planes."""
    kerns = [twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")],
                  lambda out, x, k=k: (k + 1.0) * x,
                  lambda out, x, k=k: (k + 1.0) * x,
                  cuda=f"out = T({k + 1.0!r}) * x();", name=f"scale9_{k}")
             for k in range(9)]

    def fields9(g):
        dl = jdl if isinstance(g, jdl.Grid) else tdl
        a = chain_fields(g)[0]
        return (a,) + tuple(dl.Field(g, dl.T_POINTS) for _ in range(9))
    gj, gt = grids(32, 32, 4, halo=4)
    fj, ft = fields9(gj), fields9(gt)
    sj = jkm.Schedule(*[(k[0], o, fj[0]) for k, o in zip(kerns, fj[1:])])
    st_ = tkm.Schedule(*[(k[1], o, ft[0]) for k, o in zip(kerns, ft[1:])])
    assert len(st_._masks) == 9
    sj.fused(interpret=True)
    st_.fused()
    assert len(st_._fused_masks()) == 2
    for x_j, x_t in zip(fj[1:], ft[1:]):
        same(x_j, x_t)


def _level_fields(g, levels_vals=None):
    dl = jdl if isinstance(g, jdl.Grid) else tdl
    gny, gnx = g.global_ny, g.global_nx
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    return (dl.Field(g, dl.T_POINTS, init_global_data=vals),
            dl.Field(g, dl.T_POINTS, levels=3))


def test_fused_program_multilevel_scratch():
    """A levels=3 scratch slot (2D results broadcast to every level)
    rides the multi-step loop on the plain path."""
    spec3 = [("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT", (0, 11, 0))]
    j3, t3 = twin(spec3, lambda out3, x: jst.xp(x),
                  lambda out3, x: tst.xp(x), name="east_to_levels")
    jm, tm = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")],
                  lambda out, x3: x3.sum(axis=0) * 0.25,
                  lambda out, x3: x3.sum(dim=0) * 0.25, name="level_mean")
    gj, gt = grids(32, 32, 4, halo=8)
    (aj, wj), (at, wt) = _level_fields(gj), _level_fields(gt)
    jkm.Schedule((j3, wj, aj), (jm, aj, wj)).fused_program(
        3, interpret=True)()
    tkm.Schedule((t3, wt, at), (tm, at, wt)).fused_program(3)()
    same(aj, at)
    same(wj, wt)


def _jmom(u, v, eta, dt):
    p = jnp.cumsum(0.6 * eta, axis=0)
    return u - dt * (jst.xp(p) - p), v - dt * (jst.yp(p) - p)


def _jcont(eta, u, v, frc, dt):
    div = (u - jst.xm(u)) + (v - jst.ym(v))
    flux = jnp.flip(jnp.cumsum(jnp.flip(0.8 * div, 0), axis=0), 0)
    return eta - dt * flux + dt * frc


def _jtwin(spec, jfn, tkern):
    """The JAX twin of one of the port's level_schedules kernels."""
    jw = functools.wraps(jfn)(lambda *a: jfn(*a))
    return jkm.kernel(args=sc.args(jkm, spec), name=tkern._meta.name)(jw), \
        tkern


#: the JAX package's nlayer-style kernels (tests/test_schedule.py:609-709)
#: beside the port's (dl_esm_inf_tpu_torch/level_schedules.py), at any
#: level count
KMOM = _jtwin(sc.MOM_SPEC, _jmom, sc.mom3)
KCONT = _jtwin(sc.CONT_SPEC, _jcont, sc.cont3)
KSUM = _jtwin(sc.PAIR_SPEC, lambda out, x: x.sum(axis=0), sc.vsum)
KSET = _jtwin(sc.PAIR_SPEC, lambda out3, c2: 2.0 * c2, sc.set_all_levels)
KREL = _jtwin(sc.RELAX_SPEC, lambda e: 0.5 * (e + jnp.stack(
    [jst.xp(e[k]) for k in range(e.shape[0])])), sc.relax)
KWRONG = (None, sc.wrong_levels)


def _ml_fields(g, levels=3):
    """eta, u, v (levels), a read-only levels forcing, a 2D sum."""
    if isinstance(g, tdl.Grid):
        return sc.ml_fields(g, levels)
    g3 = 0.1 * np.random.default_rng(7).standard_normal(
        (levels, g.global_ny, g.global_nx))
    return (jdl.Field(g, jdl.T_POINTS, init_global_data=g3, levels=levels),
            jdl.Field(g, jdl.U_POINTS, levels=levels),
            jdl.Field(g, jdl.V_POINTS, levels=levels),
            jdl.Field(g, jdl.T_POINTS, init_global_data=0.01 * g3,
                      levels=levels),
            jdl.Field(g, jdl.T_POINTS))


def _ml_calls(i, e, u, v, f, c, wrap=lambda k: k):
    mom, cont, sum_ = (wrap(k[i]) for k in (KMOM, KCONT, KSUM))
    return sc.ml_calls(e, u, v, f, c, mom, cont, sum_)


def _bc_fields(g, levels=3):
    if isinstance(g, tdl.Grid):
        return sc.bc_fields(g, levels)
    c = jdl.Field(g, jdl.T_POINTS, init_global_data=np.random.default_rng(
        3).standard_normal((g.global_ny, g.global_nx)))
    return jdl.Field(g, jdl.T_POINTS, levels=levels), c


def _bc_calls(i, e, c, wrap=lambda k: k):
    return sc.bc_calls(e, c, wrap(KSET[i]), wrap(KREL[i]))


def test_fused_schedule_multilevel_matches_jax():
    """levels=3 fields fuse as 3 planes each: an nlayer-style sequence
    (cumsum pressure, reverse-cumsum flux, a read-only 3-level forcing,
    a 2D vertical sum), twice per schedule."""
    gj, gt = grids(32, 32, 4, halo=4)
    gjj = grids(32, 32, 4, halo=4)[0]
    fj, ft, fjj = _ml_fields(gj), _ml_fields(gt), _ml_fields(gjj)
    jkm.Schedule(*_ml_calls(0, *fj)).fused(interpret=True)
    jkm.Schedule(*_ml_calls(0, *fjj))()
    tkm.Schedule(*_ml_calls(1, *ft)).fused()
    for x_j, x_t, x_jj in zip(fj, ft, fjj):
        same(x_j, x_t)
        same(x_jj, x_t)


def test_fused_schedule_multilevel_2d_result_broadcasts():
    gj, gt = grids(32, 32, 4, halo=4)
    (ej, cj), (et, ct) = _bc_fields(gj), _bc_fields(gt)
    jkm.Schedule(*_bc_calls(0, ej, cj)).fused(interpret=True)
    tkm.Schedule(*_bc_calls(1, et, ct)).fused()
    same(ej, et)
    e3, c3 = _bc_fields(grids(32, 32, 4, halo=4)[1])
    with pytest.raises(ValueError, match="level planes"):
        tkm.Schedule((KWRONG[1], e3, c3)).fused()


# --- the derived point bodies, held through their replay ---------------------

def _replay_cases():
    """(label, kernel, levels per parameter: an int for a plane (0: 2D),
    "s" for a scalar) of every torch body a test schedule here uses."""
    out = []
    for nm in SHIFTS:
        for sp in (tkm.GO_INTERNAL_PTS, tkm.GO_ALL_PTS):
            out.append((f"fuzz {nm}", fuzz_kernel(nm, sp, "r")[1],
                        (0, 0, "s")))
    out += [("east_plus", T_EAST_PLUS, (0, 0, "s")),
            ("double", T_DOUBLE, (0, 0)), ("incr", T_INCR, (0,)),
            ("bc_fill_all", _multi_mask(tkm, T, None, None, None)[2][0],
             (0,))]
    for L in (3, 8):
        out += [(f"mom3 L={L}", KMOM[1], (L, L, L, "s")),
                (f"cont3 L={L}", KCONT[1], (L, L, L, L, "s")),
                (f"vsum L={L}", KSUM[1], (0, L)),
                (f"set_all_levels L={L}", KSET[1], (L, 0)),
                (f"relax L={L}", KREL[1], (L,))]
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_replay_equals_body_schedule_kernels(dtype):
    """Every kernel above: the replay of its record (shifts pushed down
    to the reads) equals its torch body bitwise on seeded planes."""
    rng = np.random.default_rng(23)
    for label, kern, levels in _replay_cases():
        blocks = [0.37 if lv == "s" else torch.tensor(
            rng.standard_normal(((lv,) if lv else ()) + (18, 22)),
            dtype=dtype) for lv in levels]
        got = tpt.replaying(kern)(*blocks)
        want = kern(*blocks)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), label


@pytest.mark.parametrize("levels", [3, 8])
def test_fused_multilevel_replayed_matches_jax(levels):
    """The nlayer-style chain and the 2D-broadcast chain at ``levels``
    levels, their bodies run as the replay of their records inside the
    plain fused tier: equal to the JAX fused tier (interpret) at 1e-12
    and to the port's plain fused tier bitwise."""
    gj, gt = grids(32, 32, 4, halo=4)
    gp = grids(32, 32, 4, halo=4)[1]
    fj, ft, fp = (_ml_fields(g, levels) for g in (gj, gt, gp))
    jkm.Schedule(*_ml_calls(0, *fj)).fused(interpret=True)
    tkm.Schedule(*_ml_calls(1, *ft, wrap=tpt.replaying)).fused()
    tkm.Schedule(*_ml_calls(1, *fp)).fused()
    for x_j, x_t, x_p in zip(fj, ft, fp):
        same(x_j, x_t)
        np.testing.assert_array_equal(x_t.gather_inner_data(),
                                      x_p.gather_inner_data())
    gj, gt = grids(32, 32, 4, halo=4)
    gp = grids(32, 32, 4, halo=4)[1]
    (ej, cj), (et, ct), (ep, cp) = (_bc_fields(g, levels)
                                    for g in (gj, gt, gp))
    jkm.Schedule(*_bc_calls(0, ej, cj)).fused_program(
        2, interpret=True)()
    tkm.Schedule(*_bc_calls(1, et, ct, tpt.replaying)).fused_program(2)()
    tkm.Schedule(*_bc_calls(1, ep, cp)).fused_program(2)()
    same(ej, et)
    np.testing.assert_array_equal(et.gather_inner_data(),
                                  ep.gather_inner_data())


# --- the CUDA generator and the CUDA-grid guards -----------------------------

def _generated(sched, repeats=1, nsteps=2):
    """The generated sources of a schedule's fused variants, as the
    fused tier on a CUDA grid would build them."""
    captured = []
    real = tss.generate

    def spy(*a, **kw):
        gen = real(*a, **kw)
        captured.append(gen)
        return gen
    grid = sched._grid
    dev, build = grid.device, tss.schedule_sweep.build
    grid.device = types.SimpleNamespace(type="cuda")
    tss.generate = spy
    tss.schedule_sweep.build = lambda gen: None      # no nvcc here
    try:
        sched._build_fused(repeats, nsteps=nsteps)
    finally:
        tss.generate = real
        tss.schedule_sweep.build = build
        grid.device = dev
    return captured


def test_generator_emits_the_psy_and_fuzz_schedules():
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    m = NemoLite2DPsy(34, 30, ndomains=4, halo_width=8, **CPU)
    for rep, ring in ((1, 3), (2, 5), (3, 7)):
        full, light = _generated(m._sched, repeats=rep)[:2]
        for gen in (full, light):
            assert gen.K == rep and gen.ring == ring
            assert '#include "stencil_sweep.cuh"' in gen.text
            assert "schedule_sweep_launch" in gen.text
            # the plan: 4 passes, 3 barriers between them and one that
            # ends each repeat (tests/test_torch_schedule_plan.py)
            assert gen.text.count("__syncthreads();") == 4
            assert gen.plan.barriers == 4 and all(gen.plan.in_place)
            for kname in ("next_sshu_code", "momentum_v_code",
                          "bc_flather_u_code", "copy_code"):
                assert kname in gen.text
            assert (gen.n_int, gen.n_codes, gen.n_scalars) == (1, 1, 20)
        # full: 8 state + 3 read-only planes; light: 3 carried state,
        # 5 scratch + 3 read-only
        assert (full.n_state, full.n_aux) == (8, 3)
        assert (light.n_state, light.n_aux) == (3, 8)
    # the same structure gives the same source, whatever the scalars
    again = _generated(m._sched, repeats=1)[0]
    assert again.name == _generated(m._sched, repeats=1)[0].name
    for trial, names, scal, spaces, wrap, gnx, gny, ndom, halo, vals in \
            _fuzz_cases():
        try:
            gt = grids(gnx, gny, ndom, halo=halo, wrap=wrap)[1]
        except ValueError:
            continue
        a, b, _ = chain_fields(gt, vals)
        calls, cur = [], a
        for k, (nm, s, sp) in enumerate(zip(names, scal, spaces)):
            calls.append((fuzz_kernel(nm, sp, f"g{trial}{k}")[1], b, cur, s))
            cur = b
        gen = _generated(tkm.Schedule(*calls), nsteps=1)[0]
        # each call after the first reads off-point the slot it writes:
        # staged, a barrier before it (it reads what the call before
        # wrote) and one inside it; one barrier ends the repeat
        assert gen.plan.in_place == (True,) + (False,) * (len(names) - 1)
        assert gen.plan.barriers == 2 * len(names) - 1
        assert gen.text.count("__syncthreads();") == len(names)
        assert SHIFTS[names[-1]][3] in gen.text


def test_fused_tier_on_a_cuda_grid_refuses_what_it_cannot_generate():
    """On a CUDA grid a kernel without a CUDA body and a levels=N field
    are generated (a derived body, level planes); what the tracer cannot
    derive raises while the schedule's sweep is built, before anything
    is compiled or launched: an operation outside its table names it, a
    read beyond the declared stencil is a ValueError, a wrong level
    count raises "level planes", a reduction argument
    NotImplementedError.  Nothing runs the plain version instead."""
    _, gt = grids(32, 32, 4, halo=4)
    a, b, _ = chain_fields(gt)
    _, no_cuda = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")],
                      lambda out, x: x, lambda out, x: x, name="no_cuda_body")
    before = tss.schedule_sweep.launches
    gen = _generated(tkm.Schedule((no_cuda, b, a)))[0]
    assert "no_cuda_body (derived)" in gen.text
    assert "sw_a0 = static_cast<T>" not in gen.text
    w3 = tdl.Field(gt, tdl.T_POINTS, levels=3)
    gen = _generated(tkm.Schedule((T_DOUBLE, w3, a)))[0]
    assert (gen.n_state, gen.n_aux) == (3, 1)
    assert "sweep::LevPut<T, G::WX, G::WC, 3> out" in gen.text
    gen = tss.generate(tkm.Schedule((no_cuda, b, a))._steps,
                       state_slots=[0], extra_slots=(), ro_slots=[1],
                       consts=(), n_masks=1, n_scalars=0, K=1, ring=0,
                       dtype=torch.float64)
    # ring 0, two float64 planes and the code: the widest window, whole
    assert "(derived)" in gen.text and gen.tile == (40, 96, 0, 96, 3)
    _, sine = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")],
                   lambda out, x: jnp.sin(x), lambda out, x: torch.sin(x),
                   name="sine")
    with pytest.raises(NotImplementedError, match="sine: torch.sin"):
        _generated(tkm.Schedule((sine, b, a)))
    _, reach = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT", (0, 11, 0))],
                    lambda out, x: jst.xp(jst.xp(x)),
                    lambda out, x: tst.xp(tst.xp(x)), name="reach")
    with pytest.raises(ValueError, match="reach: argument 1 .x. is read at "
                                         "offset .dj=0, di=2."):
        _generated(tkm.Schedule((reach, b, a)))
    with pytest.raises(ValueError, match="level planes"):
        _generated(tkm.Schedule((KWRONG[1], w3, a)))
    with pytest.raises(NotImplementedError, match="reduction"):
        _generated(tkm.Schedule((T_TOTAL, a)))
    assert tss.schedule_sweep.launches == before


def test_generator_emits_derived_and_level_sources():
    """The PSy schedule with every body derived has the hand-written
    schedule's planes; the nlayer-style schedule's levels take
    consecutive planes (state u, v, eta, the sum; the forcing read-only),
    on the tile the skeleton's rule gives for the planes, whose window
    fits a CTA."""
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    m = NemoLite2DPsy(34, 30, ndomains=4, halo_width=8, **CPU)
    hand = _generated(m._sched, repeats=2)
    m._sched = tkm.Schedule(*[(tpt.derived(k), *rest)
                              for k, *rest in m._calls()])
    derived = _generated(m._sched, repeats=2)
    for h, d in zip(hand, derived):
        assert (d.n_state, d.n_aux, d.n_int, d.n_codes, d.smem_bytes,
                d.tile) == (h.n_state, h.n_aux, h.n_int, h.n_codes,
                            h.smem_bytes, h.tile)
        assert d.text.count("(derived) (read depth") == 13
        assert h.text.count("(hand-written) (read depth") == 13
        assert d.name != h.name
    for levels, dtype in ((3, torch.float32), (3, torch.float64),
                          (8, torch.float32), (8, torch.float64)):
        g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                     tdl.BC_NONE), tdl.OFFSET_NE,
                     dtype=dtype, **CPU)
        g.decompose(32, 32, ndomains=4, halo_width=4)
        tdl.grid_init(g, 1.0, 1.0)
        sched = tkm.Schedule(*_ml_calls(1, *_ml_fields(g, levels)))
        ring = sched.fused_erosion(1)
        full, light = _generated(sched, nsteps=2)[:2]
        # full: u, v, eta and the 2D sum stream; light: the sum is scratch
        assert (full.n_state, full.n_aux) == (3 * levels + 1, levels)
        assert (light.n_state, light.n_aux) == (3 * levels, levels + 1)
        for gen in (full, light):
            bpp = (gen.n_state + gen.n_aux) * dtype.itemsize + 1
            assert gen.ring == ring == 4 and gen.tile == tsst.tile(4, bpp)
            assert gen.smem_bytes == bpp * gen.tile.wx * (
                gen.tile.ty + 2 * ring) <= 232448
            assert gen.text.count("(derived) (read depth") == 5
            assert "sweep::Ring<K, 4, 4>" in gen.text
        assert f"sweep::LevPut<T, G::WX, G::WC, {levels}>" in full.text


def test_tile_edge_follows_shared_memory():
    # 45 B per point (10 float32, 1 int32, 1 code plane), ring 4: a
    # 32-column window, 3 CTAs per SM
    shape, nbytes, cluster = tss.window_tile(10, 1, 1, 4, torch.float32)
    assert shape == (40, 24, 4, 32, 3) and nbytes == 48 * 32 * 45
    assert cluster == 1
    # 33 float64 planes: one CTA per SM, a 32-column window
    assert tss.window_tile(33, 0, 1, 4, torch.float64)[0] == (16, 24, 4,
                                                              32, 1)
    assert tss.window_tile(33, 0, 1, 8, torch.float64)[0] == (8, 16, 8,
                                                              32, 1)
    # 120 float64 planes at ring 8 exceed shared memory even on 8-cell
    # tiles: the cluster form's tile (ctas 0), its window's rows over 16
    # CTAs of a cluster (8-CTA clusters' windows overhead > 2.5)
    shape, nbytes, cluster = tss.window_tile(120, 0, 1, 8, torch.float64)
    assert (shape, cluster) == tsst.cluster_tile(8, 120 * 8 + 1) \
        == ((32, 48, 8, 64, 0), 16)
    assert nbytes == 48 * 64 * (120 * 8 + 1)
    # past the largest cluster: the scratch form's tile, its window in
    # global memory
    shape, nbytes, cluster = tss.window_tile(480, 0, 1, 8, torch.float64)
    assert (shape, cluster) == (tsst.scratch_tile(8), 0)
    assert shape == (8, 16, 8, 32, 0) and nbytes == 24 * 32 * (480 * 8 + 1)
    # the chain whose window first exceeds one CTA, generated in the
    # cluster form: a band of the window's rows in each CTA's shared
    # memory and a persistent launch of clusters
    L = _scratch_levels(4, torch.float64)
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE,
                 dtype=torch.float64, **CPU)
    g.decompose(32, 32, ndomains=4, halo_width=4)
    tdl.grid_init(g, 1.0, 1.0)
    for levels, form in ((L - 1, "shared"), (L, "cluster")):
        sched = tkm.Schedule(*_ml_calls(1, *_ml_fields(g, levels)))
        for gen in _generated(sched, nsteps=2)[:2]:
            assert gen.form == form, (levels, gen.tile)
            assert "extern __shared__" not in gen.text
            if form == "cluster":
                bpp = (gen.n_state + gen.n_aux) * 8 + gen.n_codes
                assert gen.tile == (20, 24, 4, 32, 0) and gen.cluster == 4
                assert gen.window_bytes == 28 * 32 * bpp
                assert gen.smem_bytes == 7 * 32 * bpp <= 232448
                assert "sweep::ClusterRing<K, 4, 4, " in gen.text
                assert "sweep::launch_cluster<Step>" in gen.text
                assert "scratch" not in gen.text
            else:
                assert "sweep::Ring<K, 4, 4>" in gen.text
                assert "scratch" not in gen.text
    # a window past the largest cluster (level_ends and shift, L + 1
    # float planes at ring 1), generated in the scratch form: no
    # shared-memory window and a persistent launch on a scratch buffer,
    # a CTA barrier at each of the plan's barriers
    L = 1
    while tss.window_tile(L + 1, 0, 1, 1, torch.float64)[2]:
        L += 1
    sched = tkm.Schedule(*sc.ends_calls(*sc.ends_fields(g, L)))
    [gen] = _generated(sched, nsteps=2)
    assert gen.form == "scratch" and gen.cluster == 0 and gen.ring == 1
    assert gen.tile == tsst.scratch_tile(1) and gen.smem_bytes == 0
    bpp = (gen.n_state + gen.n_aux) * 8 + gen.n_codes
    assert gen.window_bytes == 10 * 32 * bpp
    assert tsst.cluster_tile(1, bpp) is None
    assert "sweep::ScratchRing<K, 1, 1, 256>" in gen.text
    assert "sweep::launch_scratch<Step>" in gen.text
    assert "schedule_sweep_scratch_stride()" in gen.text
    assert "extern __shared__" not in gen.text and "cluster" not in gen.text
    assert sum(gen.plan.barrier_before) == 1
    assert gen.text.count("__syncthreads();") == 2


def _scratch_levels(ring, dtype):
    """The fewest levels whose chain (4L + 1 float planes, one code plane)
    does not fit one CTA at ``ring``: it takes the cluster form."""
    L = 1
    while tss.window_tile(4 * L + 1, 0, 1, ring, dtype)[0].ctas:
        L += 1
    return L


def test_scratch_levels_plain_tier_matches_jax():
    """The levels chain at the fewest levels past the shared-memory
    budget (29 at float64, ring 4), small grid, f64: the port's fused
    tier on the CPU (the generated kernel's plain version) against the
    JAX package's plain Schedule() at 1e-12."""
    L = _scratch_levels(4, torch.float64)
    assert L == 29
    gj, gt = grids(24, 20, 4, halo=4)
    fj, ft = _ml_fields(gj, L), _ml_fields(gt, L)
    jkm.Schedule(*_ml_calls(0, *fj))()
    sched = tkm.Schedule(*_ml_calls(1, *ft))
    assert sched.fused_erosion(1) == 4
    sched.fused()
    for x_j, x_t in zip(fj, ft):
        same(x_j, x_t, rtol=1e-12, atol=1e-12)


def test_generator_checks_shared_memory_and_names():
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    m = NemoLite2DPsy(34, 30, ndomains=1, halo_width=8, dtype=torch.float64,
                      **CPU)
    gens = _generated(m._sched, repeats=3)
    # f64 at ring 7: 11 float planes, tmask and one code plane, 93 B per
    # point: one CTA per SM, a 24 x 48 tile in a 38 x 64 window
    assert gens[0].tile == (24, 48, 8, 64, 1)
    assert gens[0].smem_bytes == 38 * 64 * (11 * 8 + 4 + 1) == 226176
    _, gt = grids(32, 32, 4, halo=4)
    a, b, _ = chain_fields(gt)
    _, bad = twin([("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")],
                  lambda out, sw_x: sw_x, lambda out, sw_x: sw_x,
                  cuda="out = sw_x();", name="bad_names")
    with pytest.raises(ValueError, match="sw_x"):
        _generated(tkm.Schedule((bad, b, a)))
