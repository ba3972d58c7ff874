"""The point tracer (dl_esm_inf_tpu_torch/ops/point_trace.py) on the CPU.

The fused schedule sweep on the card derives a kernel's CUDA point body
from its torch body.  A CUDA kernel has no interpret mode, so the
derivation is held here through its replay: the record of a body, its
shifts pushed down to the leaf reads, run on real blocks with the same
torch operations, equals the body BITWISE (seeded numpy inputs, float64
and float32):

* every kernel of the PSy flagship (``models/nemolite2d_psy.py``, whose
  physics is ``models/nemolite2d.py``'s), both branches of the one that
  branches on ``dx == dy``;
* a body that uses every operation of the tracer's table;
* the refusals: an operation outside the table names it, a read beyond
  the declared stencil is a ``ValueError``, control flow on a plane or a
  scalar taken to the host raises, a wrong level count raises "level
  planes".

The JAX comparisons of the schedules built on derived bodies are in
tests/test_torch_schedule.py; the printed CUDA runs in
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""
import gc
import math
import weakref

import numpy as np
import pytest
import torch

from dl_esm_inf_tpu_torch.api import kernel_meta as km
from dl_esm_inf_tpu_torch.models import nemolite2d_psy as psy
from dl_esm_inf_tpu_torch.ops import point_trace as pt
from dl_esm_inf_tpu_torch.ops import stencils as st

torch.set_num_threads(2)

DTYPES = [torch.float64, torch.float32]
SHAPE = (20, 24)
FULL = km.Stencil(111, 111, 111)


def _plane(rng, dtype, levels=0, lo=-1.0, hi=1.0):
    shape = ((levels,) if levels else ()) + SHAPE
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=dtype)


# --- the PSy flagship's kernels ------------------------------------------

_PSY = {}


def _psy_model(dtype):
    if dtype not in _PSY:
        _PSY[dtype] = psy.NemoLite2DPsy(34, 30, ndomains=4, halo_width=8,
                                        dtype=dtype, device="cpu")
    return _PSY[dtype]


def _psy_inputs(m, step, dtype, rng, dx, dy):
    """(specs, stencils, blocks) of one PSy call on seeded planes: the
    fields positive (depths, ssh near 0), tmask from {-1, 0, 1}."""
    specs, stencils, blocks = [], [], []
    sc = iter([0.5, 0.01, 1.5e-4, 1e-4, 9.81] * 4)
    for (kind, idx), a in zip(step["binding"], step["meta"].args):
        if kind == "r":
            continue
        if kind == "s":
            src, val = m._sched._scalar_src[idx]
            if a.element == km.GridProp.GRID_DX_CONST:
                val = dx
            elif a.element == km.GridProp.GRID_DY_CONST:
                val = dy
            elif src == "user":
                val = next(sc)
            specs.append(pt.ArgSpec(True))
            stencils.append(None)
            blocks.append(float(val))
            continue
        if kind == "c" and m._sched._consts[idx].dtype == torch.int32:
            b = torch.tensor(rng.integers(-1, 2, SHAPE), dtype=torch.int32)
        else:
            b = _plane(rng, dtype, lo=0.5, hi=2.0)
        specs.append(pt.ArgSpec(False, b.dtype, 0))
        stencils.append(a.stencil)
        blocks.append(b)
    return specs, stencils, blocks


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", range(13))
def test_psy_replay_equals_body(k, dtype):
    """Each of the 13 PSy calls: the replay equals the torch body
    bitwise, square cells and (the other branch of continuity_code)
    rectangular ones."""
    m = _psy_model(dtype)
    step = m._sched._steps[k]
    fn, meta = step["fn"], step["meta"]
    rng = np.random.default_rng(100 + k)
    for dx, dy in ((1000.0, 1000.0), (1000.0, 1500.0)):
        specs, stencils, blocks = _psy_inputs(m, step, dtype, rng, dx, dy)
        rec = pt.trace(fn, meta.name, specs, stencils)
        _same(pt.replay(rec, blocks), fn(*blocks))
    if meta.name == "continuity_code":
        assert len(rec.paths) == 2          # dx == dy, and not
        assert "if (" in pt.cuda_body(
            rec, [f"a{i}" for i in range(len(specs))], [("w", 0, dtype)])


def test_psy_derived_clones_trace_to_the_same_records():
    """derived() drops the hand-written body and keeps the torch body:
    its record is the original's."""
    m = _psy_model(torch.float64)
    for step in m._sched._steps:
        clone = pt.derived(step["fn"])
        assert clone._meta.cuda is None and step["meta"].cuda is not None
        assert clone._meta.args == step["meta"].args
        specs, stencils, _ = _psy_inputs(m, step, torch.float64,
                                         np.random.default_rng(0), 1.0, 1.0)
        a = pt.trace(step["fn"], step["meta"].name, specs, stencils)
        b = pt.trace(clone, step["meta"].name, specs, stencils)
        assert a.nodes == b.nodes and a.paths == b.paths


# --- the table of operations ---------------------------------------------

def _every_op(out, a, b, tm, e, s):
    """Every operation of pt.OPERATIONS once (a, b planes, tm int32, e
    levels, s a scalar)."""
    wet = (tm == 1).to(a.dtype)
    c = torch.where(a > b, a, b) + torch.where(tm != 0, 0.5, a)
    c = c + torch.zeros_like(a) - torch.full_like(a, 2.0) * torch.full(
        a.shape, s, dtype=a.dtype)
    c = c + torch.minimum(a, b) - torch.maximum(a, st.xp(b))
    c = c + torch.clamp(a, min=-0.5) + torch.clamp(b, max=0.25)
    c = c + torch.clamp(a, -0.3, 0.3) + torch.abs(b) - (-a)
    c = c + torch.sqrt(torch.abs(a) + 1.0) + 3.0 / (b * b + 1.0)
    c = c + (a / s) + (a / (b * b + 1.0)) + s / 4.0 * a + 7 * wet - 2
    c = c + (a >= b).to(a.dtype) + (a <= 0.5 * b).to(torch.float64).to(
        a.dtype) + torch.as_tensor(b, dtype=a.dtype)
    c = c * wet + st.shift(a, 1, -1) - st.ym(st.xm(b)) + torch.roll(
        a, (1, -1), (-2, -1))
    lev = torch.stack([e[0] + c, e[-1] * 2.0] + [e[1] - st.yp(c)] * (
        e.shape[0] - 2))
    lev = lev + torch.cumsum(e, dim=0) - torch.flip(e, (0,)) * 0.5
    col = e.sum(dim=0) + lev.sum(dim=0) * 0.25
    scal = 2.0 * s - s / 3.0 + (s * s - 1) + abs(-s)
    return c + col + scal, lev


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_operation_replays_bitwise(dtype):
    rng = np.random.default_rng(5)
    specs = [pt.ArgSpec(False, dtype), pt.ArgSpec(False, dtype),
             pt.ArgSpec(False, dtype), pt.ArgSpec(False, torch.int32),
             pt.ArgSpec(False, dtype, 3), pt.ArgSpec(True)]
    stencils = [None if s.scalar else FULL for s in specs]
    rec = pt.trace(_every_op, "every_op", specs, stencils)
    blocks = [_plane(rng, dtype), _plane(rng, dtype), _plane(rng, dtype),
              torch.tensor(rng.integers(-1, 2, SHAPE), dtype=torch.int32),
              _plane(rng, dtype, 3), 0.37]
    _same(pt.replay(rec, blocks), _every_op(*blocks))
    # the printer takes all of it: PyTorch's CUDA rewrites, level sums
    # in level order, the level writes
    body = pt.cuda_body(rec, [f"a{i}" for i in range(6)],
                        [("w", 0, dtype), ("e3", 3, dtype)])
    ct = {torch.float32: "float", torch.float64: "double"}[dtype]
    assert f"* ({ct}(1) / " in body          # tensor / scalar
    assert "pt::clamp_min(" in body and "pt::minimum(" in body
    assert "e3[2] = " in body and "w = " in body


def test_scalar_branches_fork_the_trace():
    """Python control flow on scalars: every branch is traced; the
    source chooses at run time, the replay by the scalars' values."""
    def body(out, a, s, t):
        if s > 0 and t == 2.0:
            return a * 2.0
        if s > 0:
            return a * 3.0
        return a - s

    specs = [pt.ArgSpec(False, torch.float64), pt.ArgSpec(False,
                                                          torch.float64),
             pt.ArgSpec(True), pt.ArgSpec(True)]
    rec = pt.trace(body, "branches", specs, [FULL, FULL, None, None])
    assert len(rec.paths) == 3
    a = _plane(np.random.default_rng(1), torch.float64)
    for s, t in ((1.0, 2.0), (1.0, 3.0), (-1.0, 2.0)):
        _same(pt.replay(rec, [a, a, s, t]), body(a, a, s, t))
    text = pt.cuda_body(rec, ["o", "x", "s", "t"], [("o", 0, torch.float64)])
    assert text.count("if (") == 2 and "} else {" in text


def test_trace_is_cached_and_keeps_no_kernel_alive():
    def make():
        def scale(out, x):
            return 2.0 * x
        return scale
    k = make()
    specs = [pt.ArgSpec(False, torch.float64)] * 2
    r1 = pt.trace(k, "scale", specs, [FULL, FULL])
    assert pt.trace(k, "scale", specs, [FULL, FULL]) is r1
    ref = weakref.ref(k)
    del k
    gc.collect()
    assert ref() is None


# --- refusals -------------------------------------------------------------

def _trace1(body, stencil=FULL, levels=0):
    specs = [pt.ArgSpec(False, torch.float64),
             pt.ArgSpec(False, torch.float64, levels), pt.ArgSpec(True)]
    return pt.trace(body, "refused", specs, [FULL, stencil, None])


@pytest.mark.parametrize("body, what", [
    (lambda out, a, s: torch.sin(a), "torch.sin"),
    (lambda out, a, s: torch.exp(a) + a, "torch.exp"),
    (lambda out, a, s: a ** 2, r"\*\*"),
    (lambda out, a, s: a.mean(), "Tensor.mean"),
    (lambda out, a, s: a & a, r"& \| \^ on a plane"),
    (lambda out, a, s: torch.ones_like(a), "torch.ones_like"),
    (lambda out, a, s: a * torch.tensor(2.0), "tensor constant"),
    (lambda out, a, s: a + float(s), r"float\(\)"),
    (lambda out, a, s: a + math.sin(s), "NaN constant"),
    (lambda out, a, s: torch.sum(a), "torch.sum"),
    (lambda out, a, s: a.sum(), "whole block"),
])
def test_operations_outside_the_table_raise_naming_them(body, what):
    with pytest.raises(NotImplementedError, match=what):
        _trace1(body)


def test_plane_control_flow_raises():
    def body(out, a, s):
        return a if a > 0 else -a
    with pytest.raises(ValueError, match="control flow"):
        _trace1(body)


def test_read_beyond_the_declared_stencil_raises():
    """xp(xp(a)) reads (0, 2) under an (0, 11, 0) stencil; a shifted
    intermediate counts at its composed offset."""
    east = km.Stencil(0, 11, 0)
    rec = _trace1(lambda out, a, s: st.xp(a) + a, east)
    assert pt.lower(rec, rec.paths[0])
    for body in (lambda out, a, s: st.xp(st.xp(a)),
                 lambda out, a, s: st.xp(st.yp(a) * 2.0),
                 lambda out, a, s: st.xm(a)):
        rec = _trace1(body, east)
        with pytest.raises(ValueError, match="beyond its declared stencil"):
            pt.lower(rec, rec.paths[0])
    # a 2-deep east stencil takes the composed (0, 2)
    rec = _trace1(lambda out, a, s: st.xp(st.xp(a) + a),
                  km.Stencil(0, 12, 0))
    reads = {i.attrs[2:] for i in pt.lower(rec, rec.paths[0])[0]
             if i.op == "read"}
    assert reads == {(0, 1), (0, 2)}


def test_levels_refusals_and_level_counts():
    with pytest.raises(NotImplementedError, match="along the levels"):
        _trace1(lambda out, a, s: torch.roll(a, 1, 0), levels=3)
    with pytest.raises(NotImplementedError, match="2D plane"):
        _trace1(lambda out, a, s: torch.cumsum(a, dim=0))
    rec = _trace1(lambda out, a, s: torch.stack([a[0], a[1]]), levels=3)
    with pytest.raises(ValueError, match="level planes"):
        pt.cuda_body(rec, ["o", "a", "s"], [("o", 3, torch.float64)])
    pt.cuda_body(rec, ["o", "a", "s"], [("o", 2, torch.float64)])
