"""Kernel schedules on ``levels=N`` fields, as the port's torch kernels.

The JAX package's nlayer-style chain (tests/test_schedule.py:609-709):
``mom3`` (pressure as a cumsum down the levels), ``cont3`` (a
reverse-cumsum flux), ``vsum`` (a 2D vertical sum), and the broadcast
pair ``set_all_levels`` (a 2D result for a levels=N slot) and ``relax``
(per-level shifts), at any level count; ``wrong_levels`` returns two
planes for any slot; ``level_ends`` folds the end levels of a read-only
levels=N field into a 2D one (hand-written: a body that does not grow
with N) and ``shift`` relaxes a 2D field towards its east neighbour.  No
other carries a CUDA body: on the card the fused tier derives them.  ``*_hw`` are the same kernels with hand-written point
bodies through the level accessor (``e(k, dj, di)``, ``e[k] = ...``),
following the torch bodies operation for operation.

Used by tests/test_torch_schedule.py (beside the JAX twins),
tests/test_torch_gpu.py and chip_smoke.py, and an example of metadata
kernels on ``levels=N`` fields.
"""
import functools

import numpy as np
import torch

from .api import kernel_meta as km
from .core.constants import T_POINTS, U_POINTS, V_POINTS
from .core.field import Field
from .ops import stencils as st

#: (access, element, stencil rows) per argument
MOM_SPEC = [("GO_READWRITE", "GO_CU"), ("GO_READWRITE", "GO_CV"),
            ("GO_READ", "GO_CT", (10, 11, 0)), ("GO_READ", "GO_R_SCALAR")]
CONT_SPEC = [("GO_READWRITE", "GO_CT"), ("GO_READ", "GO_CU", (0, 110, 0)),
             ("GO_READ", "GO_CV", (0, 10, 10)), ("GO_READ", "GO_CT"),
             ("GO_READ", "GO_R_SCALAR")]
PAIR_SPEC = [("GO_WRITE", "GO_CT"), ("GO_READ", "GO_CT")]
ENDS_SPEC = [("GO_READWRITE", "GO_CT"), ("GO_READ", "GO_CT")]
RELAX_SPEC = [("GO_READWRITE", "GO_CT", (0, 11, 0))]
DT = 0.05


def args(kmod, spec):
    """``spec`` as ``Arg``s of the metadata module ``kmod``."""
    out = []
    for acc, el, *sten in spec:
        out.append(kmod.Arg(getattr(kmod, acc), getattr(kmod, el),
                            kmod.Stencil(*sten[0]) if sten
                            else kmod.GO_POINTWISE))
    return out


def mom3_body(u, v, eta, dt):
    p = torch.cumsum(0.6 * eta, dim=0)
    return u - dt * (st.xp(p) - p), v - dt * (st.yp(p) - p)


def cont3_body(eta, u, v, frc, dt):
    div = (u - st.xm(u)) + (v - st.ym(v))
    flux = torch.flip(torch.cumsum(torch.flip(0.8 * div, (0,)), dim=0),
                      (0,))
    return eta - dt * flux + dt * frc


def vsum_body(out, x):
    return x.sum(dim=0)


def set_body(out3, c2):
    return 2.0 * c2


def ends_body(out, x):
    return 0.5 * out + 2.0 * x[0] + x[-1]


def relax_body(e):
    return 0.5 * (e + torch.stack([st.xp(e[k]) for k in range(e.shape[0])]))


def shift_body(a):
    return 0.5 * (a + st.xp(a))


_MOM_HW = """
T c = T(0), ce = T(0), cn = T(0);
for (int k = 0; k < eta.levels; ++k) {
  const T x = eta(k) * T(0.6), xe = eta(k, 0, 1) * T(0.6);
  const T xn = eta(k, 1, 0) * T(0.6);
  c = k ? c + x : x;
  ce = k ? ce + xe : xe;
  cn = k ? cn + xn : xn;
  u[k] = u(k) - (ce - c) * T(dt);
  v[k] = v(k) - (cn - c) * T(dt);
}
"""
_RELAX_HW = """
for (int k = 0; k < e.levels; ++k) e[k] = (e(k) + e(k, 0, 1)) * T(0.5);
"""

mom3 = km.kernel(args=args(km, MOM_SPEC), name="mom3")(mom3_body)
cont3 = km.kernel(args=args(km, CONT_SPEC), name="cont3")(cont3_body)
vsum = km.kernel(args=args(km, PAIR_SPEC), name="vsum")(vsum_body)
set_all_levels = km.kernel(args=args(km, PAIR_SPEC),
                           name="set_all_levels")(set_body)
relax = km.kernel(args=args(km, RELAX_SPEC), name="relax")(relax_body)
#: out = out / 2 + 2 x(0) + x(top): the end levels of a read-only
#: levels=N field folded into a 2D one, hand-written (a window of N + 1
#: planes, no stencil, a body that does not grow with N)
level_ends = km.kernel(
    args=args(km, ENDS_SPEC), name="level_ends",
    cuda="out = out() * T(0.5) + x(0) * T(2.0) + x(x.levels - 1);")(
    ends_body)
shift = km.kernel(args=args(km, RELAX_SPEC), name="shift")(shift_body)
wrong_levels = km.kernel(args=args(km, PAIR_SPEC), name="wrong_levels")(
    lambda out3, c2: torch.stack([c2, c2]))


def _hw(spec, name, cuda, body):
    @functools.wraps(body)
    def fn(*a):
        return body(*a)
    return km.kernel(args=args(km, spec), name=name, cuda=cuda)(fn)


mom3_hw = _hw(MOM_SPEC, "mom3_hw", _MOM_HW, mom3_body)
set_all_levels_hw = _hw(PAIR_SPEC, "set_all_levels_hw",
                        "out3 = c2() * T(2.0);", set_body)
relax_hw = _hw(RELAX_SPEC, "relax_hw", _RELAX_HW, relax_body)


def ml_fields(g, levels=3, seed=7):
    """eta, u, v (``levels``), a read-only levels forcing, a 2D sum."""
    g3 = 0.1 * np.random.default_rng(seed).standard_normal(
        (levels, g.global_ny, g.global_nx))
    return (Field(g, T_POINTS, init_global_data=g3, levels=levels),
            Field(g, U_POINTS, levels=levels),
            Field(g, V_POINTS, levels=levels),
            Field(g, T_POINTS, init_global_data=0.01 * g3,
                      levels=levels),
            Field(g, T_POINTS))


def ml_calls(e, u, v, f, c, mom=mom3, cont=cont3, sum_=vsum):
    """The chain, twice: (mom3, cont3, mom3, cont3, vsum)."""
    return ((mom, u, v, e, DT), (cont, e, u, v, f, DT),
            (mom, u, v, e, DT), (cont, e, u, v, f, DT), (sum_, c, e))


def bc_fields(g, levels=3, seed=3):
    c = Field(g, T_POINTS, init_global_data=np.random.default_rng(
        seed).standard_normal((g.global_ny, g.global_nx)))
    return Field(g, T_POINTS, levels=levels), c


def bc_calls(e, c, set_=set_all_levels, rel=relax):
    return ((set_, e, c), (rel, e))


def ends_fields(g, levels, seed=5):
    """The 2D field level_ends folds into and a read-only levels field."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((g.global_ny, g.global_nx))
    x = rng.standard_normal((levels, g.global_ny, g.global_nx))
    return (Field(g, T_POINTS, init_global_data=a),
            Field(g, T_POINTS, init_global_data=x, levels=levels))


def ends_calls(out, x):
    """level_ends then shift on its result: a pass that writes the 2D
    field, a barrier, a pass that reads it one cell east (ring 1); each
    step folds into the last."""
    return ((level_ends, out, x), (shift, out))
