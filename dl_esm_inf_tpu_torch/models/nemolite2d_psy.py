"""NEMOLite2D expressed purely through the PSyclone metadata API.

Counterpart of ``dl_esm_inf_tpu/models/nemolite2d_psy.py``.  The
reference library exists to serve PSyclone-generated GOcean layers:
clients write metadata-carrying kernels and PSyclone generates the loops
and halo exchanges.  This module is that client, written against the
port's live metadata runtime (:mod:`..api.kernel_meta`): every kernel of
the NEMOLite2D workflow (next_sshu/v, continuity, bc_ssh, momentum u/v,
bc_solid, bc_flather, the time-update copies) is declared with metadata
and bound into ONE :class:`~..api.kernel_meta.Schedule` per time step,
runnable three ways:

* one ``invoke`` per kernel (the PSyclone-compatibility tier);
* the schedule as plain PyTorch with statically planned exchanges
  (``Schedule()``);
* the whole step as ONE sweep after a single up-front exchange
  (``run(fused=True)``, ``Schedule.fused_program``): on the card a CUDA
  kernel generated from the schedule out of each kernel's CUDA body, on
  the CPU its plain version.

The physics is SHARED with :mod:`.nemolite2d` (``next_sshu``/``v``,
``continuity``, ``momentum_u``/``v``, ``bc_ssh``, ``bc_flather_u``/``v``,
``tidal_forcing_host``), so the production model pins this layer's
numerics.  Each kernel's CUDA body follows its torch body operation for
operation (the scalars folded in double where the torch body folds them
on the host), so on the card the generated kernel equals the plain
fused tier bitwise.  Wet/dry classification is derived inside each
kernel from the ``GO_GRID_MASK_T`` grid property (argument_mod.f90:85).
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.kernel_meta import (Arg, GO_ALL_PTS, GO_CT, GO_CU, GO_CV,
                               GO_EVERY, GO_R_SCALAR, GO_READ,
                               GO_READWRITE, GO_WRITE, GridProp,
                               Schedule, Stencil, kernel)
from ..core.constants import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, OFFSET_NE,
                              T_POINTS, U_POINTS, V_POINTS)
from ..core.field import Field
from ..core.grid import Grid, grid_init
from ..ops import stencils as st
from . import nemolite2d as nl

_E = Stencil(0, 11, 0)      # reads centre + East
_W = Stencil(0, 110, 0)     # reads centre + West
_N = Stencil(10, 10, 0)     # reads centre + North
_S = Stencil(0, 10, 10)     # reads centre + South
_FULL = Stencil(111, 111, 111)


def _wet_out(tm, dtype):
    return (tm == 1).to(dtype), (tm == -1).to(dtype)


@kernel(args=[Arg(GO_WRITE, GO_CU),
              Arg(GO_READ, GO_CT, _E),
              Arg(GO_READ, GridProp.GRID_MASK_T, _E)],
        name="next_sshu_code", cuda="""
const T tw = T(tmask() == 1), twe = T(tmask(0, 1) == 1);
const T s = sshn_t() * tw + sshn_t(0, 1) * twe;
sshn_u = s * (T(1) - T(0.5) * (tw * twe));
""")
def next_sshu_code(sshn_u, sshn_t, tmask):
    t_wet, _ = _wet_out(tmask, sshn_t.dtype)
    return nl.next_sshu(sshn_t, t_wet)


@kernel(args=[Arg(GO_WRITE, GO_CV),
              Arg(GO_READ, GO_CT, _N),
              Arg(GO_READ, GridProp.GRID_MASK_T, _N)],
        name="next_sshv_code", cuda="""
const T tw = T(tmask() == 1), twn = T(tmask(1, 0) == 1);
const T s = sshn_t() * tw + sshn_t(1, 0) * twn;
sshn_v = s * (T(1) - T(0.5) * (tw * twn));
""")
def next_sshv_code(sshn_v, sshn_t, tmask):
    t_wet, _ = _wet_out(tmask, sshn_t.dtype)
    return nl.next_sshv(sshn_t, t_wet)


@kernel(args=[Arg(GO_WRITE, GO_CT),
              Arg(GO_READ, GO_CT),
              Arg(GO_READ, GO_CU, _W), Arg(GO_READ, GO_CV, _S),
              Arg(GO_READ, GO_CU, _W), Arg(GO_READ, GO_CV, _S),
              Arg(GO_READ, GO_CU, _W), Arg(GO_READ, GO_CV, _S),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST),
              Arg(GO_READ, GridProp.GRID_MASK_T)],
        name="continuity_code", cuda="""
const T fx = (hu() + sshn_u()) * un();
const T fxw = (hu(0, -1) + sshn_u(0, -1)) * un(0, -1);
const T fy = (hv() + sshn_v()) * vn();
const T fys = (hv(-1, 0) + sshn_v(-1, 0)) * vn(-1, 0);
const T a = dx == dy
    ? sshn_t() - T(rdt / dx) * ((fx - fxw) + (fy - fys))
    : sshn_t() - (T(rdt / dx) * (fx - fxw) + T(rdt / dy) * (fy - fys));
ssha_t = tmask() == 1 ? a : sshn_t();
""")
def continuity_code(ssha_t, sshn_t, un, vn, sshn_u, sshn_v, hu, hv,
                    rdt, dx, dy, tmask):
    t_wet, _ = _wet_out(tmask, sshn_t.dtype)
    depu = hu + sshn_u
    depv = hv + sshn_v
    ssha = nl.continuity(sshn_t, un, vn, depu, depv, rdt=rdt, dx=dx, dy=dy)
    return torch.where(t_wet > 0, ssha, sshn_t)


@kernel(args=[Arg(GO_READWRITE, GO_CT),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_MASK_T, _FULL)],
        name="bc_ssh_code", cuda="""
const T o = ((T(tmask(0, 1) == -1) + T(tmask(0, -1) == -1))
             + T(tmask(1, 0) == -1)) + T(tmask(-1, 0) == -1);
const T bc = T(tmask() == 1) * (o < T(1) ? o : T(1));
ssha_t = bc > T(0) ? T(forcing) : ssha_t();
""")
def bc_ssh_code(ssha_t, forcing, tmask):
    t_wet, out_f = _wet_out(tmask, ssha_t.dtype)
    near_out = torch.clamp(st.xp(out_f) + st.xm(out_f) + st.yp(out_f)
                           + st.ym(out_f), max=1.0)
    return nl.bc_ssh(ssha_t, t_wet * near_out, forcing)


# momentum_u/v as point bodies: nl.momentum_u/v with the default
# (exact) reciprocal; the shifted intermediates are recomputed at the
# neighbour (the same operations, so the same rounding)
_MOMENTUM_U = """
const T c_adv_x = T(-0.5 * rdt / dx), c_vis_x = T(rdt * visc / (dx * dx));
const T c_adv_y = T(-0.25 * rdt / dy);
const T c_vis_y = T(0.5 * rdt * visc / (dy * dy));
const T c_cor = T(0.25 * rdt * fcor), c_hpg = T(-rdt * g / dx);
const T fric = T(1.0 / (1.0 + cbfr * rdt));
auto w_x = [&](int di) {            // at the west T centre
  const T u = un(0, di), umx = un(0, di - 1);
  const T su = u + umx;
  const T udw = su > T(0) ? umx : u;
  return (c_adv_x * (su * udw) + c_vis_x * (u - umx))
         * (ht(0, di) + sshn_t(0, di));
};
auto depv = [&](int dj, int di) { return hv(dj, di) + sshn_v(dj, di); };
auto wv_at = [&](int dj) { return vn(dj, 0) + vn(dj, 1); };
auto w_y = [&](int dj) {            // at the NE F corner
  const T wv = wv_at(dj);
  const T dep_f2 = depv(dj, 0) + depv(dj, 1);
  const T u = un(dj, 0), upy = un(dj + 1, 0);
  const T udn = wv > T(0) ? u : upy;
  return (c_adv_y * (wv * udn) + c_vis_y * (upy - u)) * dep_f2;
};
const T dep_u = hu() + sshn_u();
const T term_x = w_x(1) - w_x(0);
const T term_y = w_y(0) - w_y(-1);
const T corhpg = (c_cor * (wv_at(0) + wv_at(-1))
                  + c_hpg * (ssha_t(0, 1) - ssha_t())) * dep_u;
const T rd = T(1) / dep_u;
ua = (un() + (term_x + term_y + corhpg) * rd) * fric;
"""

_MOMENTUM_V = """
const T c_adv_y = T(-0.5 * rdt / dy), c_vis_y = T(rdt * visc / (dy * dy));
const T c_adv_x = T(-0.25 * rdt / dx);
const T c_vis_x = T(0.5 * rdt * visc / (dx * dx));
const T c_cor = T(-0.25 * rdt * fcor), c_hpg = T(-rdt * g / dy);
const T fric = T(1.0 / (1.0 + cbfr * rdt));
auto w_y = [&](int dj) {            // at the south T centre
  const T v = vn(dj, 0), vmy = vn(dj - 1, 0);
  const T sv = v + vmy;
  const T vds = sv > T(0) ? vmy : v;
  return (c_adv_y * (sv * vds) + c_vis_y * (v - vmy))
         * (ht(dj, 0) + sshn_t(dj, 0));
};
auto depu = [&](int dj, int di) { return hu(dj, di) + sshn_u(dj, di); };
auto wu_at = [&](int di) { return un(0, di) + un(1, di); };
auto w_x = [&](int di) {            // at the NE F corner
  const T wu = wu_at(di);
  const T dep_f2 = depu(0, di) + depu(1, di);
  const T v = vn(0, di), xpv = vn(0, di + 1);
  const T vde = wu > T(0) ? v : xpv;
  return (c_adv_x * (wu * vde) + c_vis_x * (xpv - v)) * dep_f2;
};
const T dep_v = hv() + sshn_v();
const T term_y = w_y(1) - w_y(0);
const T term_x = w_x(0) - w_x(-1);
const T corhpg = (c_cor * (wu_at(0) + wu_at(-1))
                  + c_hpg * (ssha_t(1, 0) - ssha_t())) * dep_v;
const T rd = T(1) / dep_v;
va = (vn() + (term_y + term_x + corhpg) * rd) * fric;
"""


@kernel(args=[Arg(GO_WRITE, GO_CU),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _E), Arg(GO_READ, GO_CT, _E),
              Arg(GO_READ, GO_CU), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CU), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _E),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST)],
        name="momentum_u_code", cuda=_MOMENTUM_U)
def momentum_u_code(ua, un, vn, sshn_t, ssha_t, sshn_u, sshn_v,
                    hu, hv, ht, rdt, visc, cbfr, fcor, g, dx, dy):
    # every Params field the momentum maths reads comes from the caller
    # (a partial Params would mix the default g into the pressure
    # gradient while the Flather BCs use the user's)
    p = nl.Params(rdt=rdt, cbfr=cbfr, visc=visc, g=g)
    return nl.momentum_u(un, vn, sshn_t, ssha_t, sshn_u, ht, hu,
                         hv + sshn_v, p=p, dx=dx, dy=dy, fcor=fcor)


@kernel(args=[Arg(GO_WRITE, GO_CV),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _N), Arg(GO_READ, GO_CT, _N),
              Arg(GO_READ, GO_CV), Arg(GO_READ, GO_CU, _FULL),
              Arg(GO_READ, GO_CV), Arg(GO_READ, GO_CU, _FULL),
              Arg(GO_READ, GO_CT, _N),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST)],
        name="momentum_v_code", cuda=_MOMENTUM_V)
def momentum_v_code(va, un, vn, sshn_t, ssha_t, sshn_v, sshn_u,
                    hv, hu, ht, rdt, visc, cbfr, fcor, g, dx, dy):
    p = nl.Params(rdt=rdt, cbfr=cbfr, visc=visc, g=g)
    return nl.momentum_v(un, vn, sshn_t, ssha_t, sshn_v, ht, hv,
                         hu + sshn_u, p=p, dx=dx, dy=dy, fcor=fcor)


@kernel(args=[Arg(GO_READWRITE, GO_CU),
              Arg(GO_READ, GridProp.GRID_MASK_T, _E)],
        name="bc_solid_u_code", cuda="""
ua = T(tmask() == 1) * T(tmask(0, 1) == 1) > T(0) ? ua() : T(0);
""")
def bc_solid_u_code(ua, tmask):
    t_wet, _ = _wet_out(tmask, ua.dtype)
    return torch.where(t_wet * st.xp(t_wet) > 0, ua, torch.zeros_like(ua))


@kernel(args=[Arg(GO_READWRITE, GO_CV),
              Arg(GO_READ, GridProp.GRID_MASK_T, _N)],
        name="bc_solid_v_code", cuda="""
va = T(tmask() == 1) * T(tmask(1, 0) == 1) > T(0) ? va() : T(0);
""")
def bc_solid_v_code(va, tmask):
    t_wet, _ = _wet_out(tmask, va.dtype)
    return torch.where(t_wet * st.yp(t_wet) > 0, va, torch.zeros_like(va))


# Flather: torch computes g / max(h, 1e-3) as reciprocal(max(h, 1e-3))
# times g (Tensor.__rtruediv__)
@kernel(args=[Arg(GO_READWRITE, GO_CU),
              Arg(GO_READ, GO_CU), Arg(GO_READ, GO_CU),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_MASK_T, _E)],
        name="bc_flather_u_code", cuda="""
const T fl = T(tmask() == 1) * T(tmask(0, 1) == -1)
             + T(tmask() == -1) * T(tmask(0, 1) == 1);
const T h = hu() < T(1e-3) ? T(1e-3) : hu();
ua = fl > T(0) ? -sweep::sqrt_t((T(1) / h) * T(g)) * sshn_u() : ua();
""")
def bc_flather_u_code(ua, sshn_u, hu, g, tmask):
    t_wet, out_f = _wet_out(tmask, ua.dtype)
    flather_u = t_wet * st.xp(out_f) + out_f * st.xp(t_wet)
    return nl.bc_flather_u(ua, sshn_u, hu, flather_u, nl.Params(g=g))


@kernel(args=[Arg(GO_READWRITE, GO_CV),
              Arg(GO_READ, GO_CV), Arg(GO_READ, GO_CV),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_MASK_T, _N)],
        name="bc_flather_v_code", cuda="""
const T fl = T(tmask() == 1) * T(tmask(1, 0) == -1)
             + T(tmask() == -1) * T(tmask(1, 0) == 1);
const T h = hv() < T(1e-3) ? T(1e-3) : hv();
va = fl > T(0) ? -sweep::sqrt_t((T(1) / h) * T(g)) * sshn_v() : va();
""")
def bc_flather_v_code(va, sshn_v, hv, g, tmask):
    t_wet, out_f = _wet_out(tmask, va.dtype)
    flather_v = t_wet * st.yp(out_f) + out_f * st.yp(t_wet)
    return nl.bc_flather_v(va, sshn_v, hv, flather_v, nl.Params(g=g))


@kernel(args=[Arg(GO_WRITE, GO_EVERY), Arg(GO_READ, GO_EVERY)],
        iterates_over=GO_ALL_PTS, name="copy_code", cuda="dst = src();")
def copy_code(dst, src):
    """The time-update field copy (the reference app's copy kernel,
    infrastructure_mod.f90:13-41)."""
    return src


class NemoLite2DPsy:
    """The flagship assembled from metadata kernels + one Schedule.

    ``halo_width`` must cover the schedule's dataflow erosion for the
    fused tier (``Schedule.fused_erosion``: 3 for one sequence, +2 per
    further repeat; ``halo_width=8`` allows ``repeats=3``); the plain
    tiers need only 1.  ``device=None`` is the card."""

    def __init__(self, gnx: int, gny: int, params: nl.Params = nl.Params(),
                 depth: float = 100.0, halo_width: int = 5,
                 ndomains=None, dtype=None, device=None):
        grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE),
                    OFFSET_NE, dtype=dtype, device=device)
        grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
        grid_init(grid, 1000.0, 1000.0, nl.default_tmask(gnx, gny, True))
        self.grid = grid
        self.p = params
        self.depth = float(depth)
        self.fcor = float(2.0 * params.omega * np.sin(50.0 * params.d2r))
        F = lambda pts: Field(grid, pts)  # noqa: E731
        self.sshn_t, self.ssha_t = F(T_POINTS), F(T_POINTS)
        self.sshn_u, self.sshn_v = F(U_POINTS), F(V_POINTS)
        self.un, self.vn = F(U_POINTS), F(V_POINTS)
        self.ua, self.va = F(U_POINTS), F(V_POINTS)
        self.ht = F(T_POINTS)
        self.hu, self.hv = F(U_POINTS), F(V_POINTS)
        for f in (self.ht, self.hu, self.hv):
            f.data = torch.full(grid.array_shape, self.depth,
                                dtype=grid.dtype, device=grid.device)
        self._sched = Schedule(*self._calls())
        self._step = 0

    def _calls(self):
        """The step's kernel calls, in order (the Schedule's argument)."""
        p, fc = self.p, self.fcor
        mom_sc = (p.rdt, p.visc, p.cbfr, fc, p.g)
        return (
            (next_sshu_code, self.sshn_u, self.sshn_t),
            (next_sshv_code, self.sshn_v, self.sshn_t),
            (continuity_code, self.ssha_t, self.sshn_t, self.un,
             self.vn, self.sshn_u, self.sshn_v, self.hu, self.hv,
             p.rdt),
            (bc_ssh_code, self.ssha_t, 0.0),
            (momentum_u_code, self.ua, self.un, self.vn, self.sshn_t,
             self.ssha_t, self.sshn_u, self.sshn_v, self.hu, self.hv,
             self.ht, *mom_sc),
            (momentum_v_code, self.va, self.un, self.vn, self.sshn_t,
             self.ssha_t, self.sshn_v, self.sshn_u, self.hv, self.hu,
             self.ht, *mom_sc),
            (bc_solid_u_code, self.ua),
            (bc_solid_v_code, self.va),
            (bc_flather_u_code, self.ua, self.sshn_u, self.hu, p.g),
            (bc_flather_v_code, self.va, self.sshn_v, self.hv, p.g),
            (copy_code, self.sshn_t, self.ssha_t),
            (copy_code, self.un, self.ua),
            (copy_code, self.vn, self.va),
        )

    def _scalars_at(self, step: int):
        """User-scalar vector for one step (forcing varies with time)."""
        p, fc = self.p, self.fcor
        forcing = nl.tidal_forcing_host((step + 1) * p.rdt, p)
        mom = [p.rdt, p.visc, p.cbfr, fc, p.g]
        return [p.rdt, forcing, *mom, *mom, p.g, p.g]

    def set_initial_ssh(self, eta0) -> None:
        f = Field(self.grid, T_POINTS, init_global_data=eta0)
        self.sshn_t.data = f.data

    def run(self, nsteps: int, *, fused: bool = False) -> None:
        """Advance ``nsteps`` steps: as the plain schedule, or with
        ``fused=True`` through the whole-run fused program (one launch of
        the generated kernel per step on the card), the per-step forcing
        bound up front."""
        if fused:
            runp = self._sched.fused_program(nsteps)
            runp(scalars=[self._scalars_at(self._step + k)
                          for k in range(nsteps)])
            self._step += nsteps
            return
        for _ in range(nsteps):
            self._sched(self._scalars_at(self._step))
            self._step += 1

    def gather(self) -> dict:
        return {"sshn": self.sshn_t.gather_inner_data(),
                "un": self.un.gather_inner_data(),
                "vn": self.vn.gather_inner_data()}
