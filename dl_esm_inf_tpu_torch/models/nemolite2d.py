"""NEMOLite2D-class nonlinear shallow-water solver, the flagship model.

Counterpart of ``dl_esm_inf_tpu/models/nemolite2d.py``: free surface and
depth-integrated momentum on the Arakawa-C grid (NE offset), with the
kernel set of the NEMOLite2D GOcean benchmark — continuity, momentum_u/v
(flux-form donor-cell advection, horizontal viscosity, f-plane Coriolis,
pressure gradient, semi-implicit bottom friction), boundary kernels
(prescribed-ssh forcing, solid walls via the T mask, Flather radiation
on open boundaries) and the field-update/next kernels.

Wetness and boundary classification come from the T mask (1 wet,
0 dry/solid, -1 open sea outside the modelled domain):

* solid faces  — between a wet and a dry (0) cell: velocity 0;
* open faces   — between wet and outside (-1): Flather radiation;
* ssh forcing  — wet cells adjacent to an outside cell.

The physics (:func:`step_math`) is written once as plain tensor code,
op for op in the JAX package's order.  The fused path
(``build(fused=True)``, the JAX package's ``pallas=True``) advances K
steps per halo exchange through :mod:`..ops.fused_step`: on a CUDA
tensor that is the hand-written sweep kernel, on a CPU tensor its plain
version.  With ``enable_fast_path(K, transport="fused")`` the exchange
moves inside the sweep.  Steps run eagerly; there is no ``jit``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import layout
from ..core.constants import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, OFFSET_NE,
                              T_POINTS, U_POINTS, V_POINTS)
from ..core.field import Field
from ..core.grid import Grid, grid_init
from ..core import kinds
from ..ops import stencils as st
from ..ops.adjoint import checkpointed_fori
from ..ops.fastpath import (enable_fast_path, fast_path_grid_args,
                            set_steps_per_exchange)
from ..ops.fused_step import KMAX, fused_step_reference, make_fused_step
from ..parallel.halo import exchange_multi, exchange_multi_fn


@dataclass(frozen=True)
class Params:
    rdt: float = 20.0          # time step (s)
    cbfr: float = 0.00015      # bottom friction coefficient
    visc: float = 0.1          # horizontal viscosity (m^2/s)
    g: float = 9.81
    omega: float = 7.292116e-5  # Earth rotation (rad/s)
    d2r: float = np.pi / 180.0
    amp: float = 0.1           # open-boundary ssh forcing amplitude (m)
    tide_period: float = 12.42 * 3600.0


# ---------------------------------------------------------------------------
# Kernels (block-level tensor functions)
# ---------------------------------------------------------------------------

def continuity(sshn_t, un, vn, depu, depv, *, rdt, dx, dy):
    """ssha_t: divergence of depth-integrated fluxes onto T cells.

    Flux through the east U face of T cell (ji) is dep_u*un*dy at U[ji];
    the west face is U[ji-1] (NE offset).  Square cells with static
    scale factors share one prefactor."""
    fx = depu * un
    fy = depv * vn
    if (isinstance(dx, (int, float)) and isinstance(dy, (int, float))
            and dx == dy):
        return sshn_t - (rdt / dx) * ((fx - st.xm(fx))
                                      + (fy - st.ym(fy)))
    return sshn_t - ((rdt / dx) * (fx - st.xm(fx))
                     + (rdt / dy) * (fy - st.ym(fy)))


def momentum_u(un, vn, sshn_t, ssha_t, sshn_u, ht, hu, depv, *, p: Params,
               dx, dy, fcor, recip=None, dep_u=None, z=None, fric=None):
    """ua at U faces: advection + viscosity + Coriolis + pressure
    gradient + semi-implicit bottom friction.

    Advection is flux-form donor-cell upwind: mass fluxes at the T
    centres / F corners surrounding the U face carry the upstream u
    value.  Each face-flux pair is computed once at its donor-side site
    and the opposite face obtained by shifting the result; the depth
    factor multiplies the advection+viscosity sum once."""
    if dep_u is None:
        dep_u = hu + sshn_u                   # total depth at U
    if z is None:
        z = ht + sshn_t                       # total depth at (west) T

    # x direction: everything lives at the west T centre
    umx = st.xm(un)
    su = un + umx                             # 2*m_w / z (donor sign)
    u_dw = torch.where(su > 0, umx, un)       # donor u (z > 0 where wet)
    w_x = ((-0.5 * p.rdt / dx) * (su * u_dw)
           + (p.rdt * p.visc / (dx * dx)) * (un - umx)) * z
    term_x = st.xp(w_x) - w_x                 # rdt*(adv_x + vis_x)

    # y direction: everything lives at the NE F corner
    wv = vn + st.xp(vn)                       # 2 * corner-interp v
    dep_f2 = depv + st.xp(depv)               # 2 * F-corner depth
    upy = st.yp(un)
    u_dn = torch.where(wv > 0, un, upy)       # donor u (dep_f > 0)
    w_y = ((-0.25 * p.rdt / dy) * (wv * u_dn)
           + (0.5 * p.rdt * p.visc / (dy * dy)) * (upy - un)) * dep_f2
    term_y = w_y - st.ym(w_y)                 # rdt*(adv_y + vis_y)

    # Coriolis (f-plane, 4-point average) + pressure gradient on the NEW
    # ssh (forward-backward scheme); both carry the same dep_u factor
    corhpg = ((0.25 * p.rdt * fcor) * (wv + st.ym(wv))
              + (-p.rdt * p.g / dx) * (st.xp(ssha_t) - ssha_t)) * dep_u

    # time update with semi-implicit linear bottom friction
    rd = recip(dep_u) if recip is not None else 1.0 / dep_u
    if fric is None:
        fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    ua = (un + (term_x + term_y + corhpg) * rd) * fric
    return ua


def momentum_v(un, vn, sshn_t, ssha_t, sshn_v, ht, hv, depu, *, p: Params,
               dx, dy, fcor, recip=None, dep_v=None, z=None, fric=None):
    """Mirror of :func:`momentum_u`."""
    if dep_v is None:
        dep_v = hv + sshn_v
    if z is None:
        z = ht + sshn_t                       # total depth at (south) T

    # y direction: everything lives at the south T centre
    vmy = st.ym(vn)
    sv = vn + vmy                             # 2*m_s / z (donor sign)
    v_ds = torch.where(sv > 0, vmy, vn)
    w_y = ((-0.5 * p.rdt / dy) * (sv * v_ds)
           + (p.rdt * p.visc / (dy * dy)) * (vn - vmy)) * z
    term_y = st.yp(w_y) - w_y

    # x direction: everything lives at the NE F corner
    wu = un + st.yp(un)                       # 2 * corner-interp u
    dep_f2 = depu + st.yp(depu)               # 2 * F-corner depth
    xpv = st.xp(vn)
    v_de = torch.where(wu > 0, vn, xpv)       # donor v (dep_f > 0)
    w_x = ((-0.25 * p.rdt / dx) * (wu * v_de)
           + (0.5 * p.rdt * p.visc / (dx * dx)) * (xpv - vn)) * dep_f2
    term_x = w_x - st.xm(w_x)

    corhpg = ((-0.25 * p.rdt * fcor) * (wu + st.xm(wu))
              + (-p.rdt * p.g / dy) * (st.yp(ssha_t) - ssha_t)) * dep_v

    rd = recip(dep_v) if recip is not None else 1.0 / dep_v
    if fric is None:
        fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    va = (vn + (term_y + term_x + corhpg) * rd) * fric
    return va


def tidal_forcing(rtime, p: Params):
    """The bc_ssh amplitude at model time ``rtime`` (a tensor, in the
    working dtype)."""
    return p.amp * torch.sin(2.0 * math.pi * rtime / p.tide_period)


def tidal_forcing_host(rtime: float, p: Params) -> float:
    """Host-side (NumPy) twin of :func:`tidal_forcing`.  ONE formula,
    two evaluators: change them together."""
    return float(p.amp * np.sin(2.0 * np.pi * rtime / p.tide_period))


def bc_ssh(ssha_t, bc_cells, forcing):
    """Prescribed ssh at open-boundary wet cells (bc_ssh tidal forcing);
    ``forcing`` is the scalar boundary value."""
    return torch.where(bc_cells > 0, forcing, ssha_t)


def bc_flather_u(ua, sshn_u, hu, flather_u, p: Params):
    """Flather radiation: u = u_ext +/- sqrt(g/h) (ssh - ssh_ext), with
    zero external state."""
    hu = torch.as_tensor(hu, dtype=ua.dtype, device=ua.device)
    flath = -torch.sqrt(p.g / torch.clamp(hu, min=1e-3)) * sshn_u
    return torch.where(flather_u > 0, flath, ua)


def bc_flather_v(va, sshn_v, hv, flather_v, p: Params):
    hv = torch.as_tensor(hv, dtype=va.dtype, device=va.device)
    flath = -torch.sqrt(p.g / torch.clamp(hv, min=1e-3)) * sshn_v
    return torch.where(flather_v > 0, flath, va)


def next_sshu(sshn_t, t_wet, u_wet=None):
    """T ssh onto U faces: the mean of the wet neighbours.  The
    wet-neighbour count is 2 exactly where the face is wet, else <= 1,
    so the weight is ``1 - u_wet/2``."""
    sw = sshn_t * t_wet
    s = sw + st.xp(sw)
    if u_wet is None:
        u_wet = t_wet * st.xp(t_wet)
    return s * (1.0 - 0.5 * u_wet)


def next_sshv(sshn_t, t_wet, v_wet=None):
    sw = sshn_t * t_wet
    s = sw + st.yp(sw)
    if v_wet is None:
        v_wet = t_wet * st.yp(t_wet)
    return s * (1.0 - 0.5 * v_wet)


def derive_masks(tmask, dtype):
    """The six 0/1 float masks of the step, from the integer tmask."""
    t_wet = (tmask == 1).to(dtype)
    out_f = (tmask == -1).to(dtype)
    u_wet = t_wet * st.xp(t_wet)
    v_wet = t_wet * st.yp(t_wet)
    near_out = torch.clamp(
        st.xp(out_f) + st.xm(out_f) + st.yp(out_f) + st.ym(out_f), max=1.0)
    bc_cells = t_wet * near_out
    # wet and outside are mutually exclusive, so the sums stay 0/1
    flather_u = t_wet * st.xp(out_f) + out_f * st.xp(t_wet)
    flather_v = t_wet * st.yp(out_f) + out_f * st.yp(t_wet)
    return (t_wet, u_wet, v_wet, bc_cells, flather_u, flather_v)


def encode_masks(tmask) -> torch.Tensor:
    """Pack the six masks into one int8 bitfield (bit k = mask k of
    :func:`derive_masks`): one byte per point instead of six planes."""
    return st.pack_mask_bits(derive_masks(tmask, torch.float32))


def decode_masks(codes, dtype):
    """Unpack :func:`encode_masks`."""
    return st.unpack_mask_bits(codes, 6, dtype)


class StepPrep(NamedTuple):
    """Time-invariant quantities hoisted out of the sub-step loop:
    decoded masks, their booleans and weights, the depth bases and the
    Flather coefficients."""
    t_wet: object
    u_wet: object
    v_wet: object
    wet_b: object       # t_wet > 0
    cw: object          # t_wet * (rdt/dx) on square cells, else None
    bc_b: object        # bc_cells > 0
    flu_b: object       # flather_u > 0
    flv_b: object
    wu: object          # 1 - u_wet/2: next_sshu wet-neighbour weight
    wv: object          # 1 - v_wet/2
    fu: object          # u_wet / (1 + cbfr*rdt): masked friction factor
    fv: object
    ht: object          # T/U/V depth bases (0-d tensors or planes)
    hu: object
    hv: object
    cu: object          # -sqrt(g / max(hu, 1e-3)): Flather coefficient
    cv: object


def _is_square(dx, dy) -> bool:
    return (isinstance(dx, (int, float)) and isinstance(dy, (int, float))
            and dx == dy)


def make_prep(mask_codes, depth, p: Params, dtype, masks=None,
              dx=None, dy=None) -> StepPrep:
    """Build the hoisted sub-step constants (see :class:`StepPrep`).

    ``depth`` is a scalar (flat bathymetry), a T-point plane, or a
    pre-derived (ht, hu, hv) tuple.  Square cells (``dx == dy``, static)
    also hoist the continuity wet prefactor ``cw``."""
    if masks is None:
        masks = decode_masks(mask_codes, dtype)
    t_wet, u_wet, v_wet, bc_cells, flather_u, flather_v = masks
    if isinstance(depth, tuple):
        ht, hu, hv = depth
    elif not isinstance(depth, torch.Tensor) or depth.dim() == 0:
        ht = hu = hv = torch.as_tensor(depth, dtype=dtype,
                                       device=t_wet.device)
    else:
        ht = depth
        hu = st.avg_x(ht)
        hv = st.avg_y(ht)
    cu = -torch.sqrt(p.g / torch.clamp(hu, min=1e-3))
    cv = -torch.sqrt(p.g / torch.clamp(hv, min=1e-3))
    fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    cw = (p.rdt / dx) * t_wet if _is_square(dx, dy) else None
    return StepPrep(t_wet, u_wet, v_wet,
                    t_wet > 0, cw, bc_cells > 0, flather_u > 0,
                    flather_v > 0,
                    1.0 - 0.5 * u_wet, 1.0 - 0.5 * v_wet,
                    fric * u_wet, fric * v_wet,
                    ht, hu, hv, cu, cv)


def _recip_exact(x):
    return 1.0 / x


def _recip_fast(x):
    """One Newton step ``r * (2 - x r)`` on the reciprocal: the JAX
    package's fast reciprocal, whose ``r`` is the hardware's approximate
    one.  Here ``r`` is exact, which makes this the plain version of the
    ``compute_fast`` variant kernel (``csrc/nemolite2d_variants.cu``,
    ``rcp.approx.ftz.f32``); the two differ by the approximation's last
    bits."""
    r = 1.0 / x
    return r * (2.0 - x * r)


def step_math(sshn_t, un, vn, mask_codes, p: Params, dx, dy, fcor, depth,
              forcing, exch_mid=None, recip=_recip_exact, masks=None,
              prep: StepPrep | None = None):
    """One complete NEMOLite2D step as a pure stencil chain.

    Total input reach is 2 cells, so with fresh depth-2 halos the chain
    needs no mid-step communication (``exch_mid=None``).  ``forcing`` is
    the bc_ssh value (a Python float or 0-d tensor).  ``masks``/``prep``
    optionally supply the decoded masks / hoisted constants
    (:func:`make_prep`) so multi-step callers pay for them once."""
    dtype = sshn_t.dtype
    pr = prep if prep is not None else make_prep(mask_codes, depth, p,
                                                 dtype, masks=masks,
                                                 dx=dx, dy=dy)
    ht, hu, hv = pr.ht, pr.hu, pr.hv

    # U/V-face ssh from the freshly exchanged T ssh (next_sshu/v with the
    # wet-neighbour weights hoisted)
    sw = sshn_t * pr.t_wet
    sshn_u = (sw + st.xp(sw)) * pr.wu
    sshn_v = (sw + st.yp(sw)) * pr.wv

    depu = hu + sshn_u
    depv = hv + sshn_v
    z = ht + sshn_t

    if pr.cw is not None:
        # square cells: the wet-cell select folds into the prefactor
        # (cw is exactly rdt/dx at wet cells and 0 at dry ones)
        fx = depu * un
        fy = depv * vn
        ssha_t = sshn_t - pr.cw * ((fx - st.xm(fx)) + (fy - st.ym(fy)))
    else:
        ssha_t = continuity(sshn_t, un, vn, depu, depv,
                            rdt=p.rdt, dx=dx, dy=dy)
        ssha_t = torch.where(pr.wet_b, ssha_t, sshn_t)
    ssha_t = torch.where(pr.bc_b, float(forcing), ssha_t)

    if exch_mid is not None:
        ssha_t = exch_mid(ssha_t)

    ua = momentum_u(un, vn, sshn_t, ssha_t, sshn_u, ht, hu, depv,
                    p=p, dx=dx, dy=dy, fcor=fcor, recip=recip,
                    dep_u=depu, z=z, fric=pr.fu)
    va = momentum_v(un, vn, sshn_t, ssha_t, sshn_v, ht, hv, depu,
                    p=p, dx=dx, dy=dy, fcor=fcor, recip=recip,
                    dep_v=depv, z=z, fric=pr.fv)
    ua = torch.where(pr.flu_b, pr.cu * sshn_u, ua)
    va = torch.where(pr.flv_b, pr.cv * sshn_v, va)

    return ssha_t, ua, va


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def default_tmask(gnx: int, gny: int, open_north: bool = True) -> np.ndarray:
    """Closed basin with solid walls; optionally an open (Flather/forced)
    boundary along the north edge."""
    t = np.ones((gny, gnx), dtype=np.int32)
    t[0, :] = 0
    t[:, 0] = 0
    t[:, -1] = 0
    t[-1, :] = -1 if open_north else 0
    return t


class NemoLite2D:
    """Nonlinear SW solver bound to a grid; the framework's flagship."""

    def __init__(self, grid: Grid, params: Params = Params(),
                 depth: "float | np.ndarray" = 100.0):
        self.grid = grid
        self.p = params
        dtype = grid.dtype

        self.sshn_t = Field(grid, T_POINTS)
        self.sshn_u = Field(grid, U_POINTS)
        self.sshn_v = Field(grid, V_POINTS)
        self.un = Field(grid, U_POINTS)
        self.vn = Field(grid, V_POINTS)
        # Bathymetry: a scalar is the flat fast path; a global (gny, gnx)
        # T-point array is scattered with edge replication (halo cells
        # hold the true neighbour values, padding stays positive).
        if np.ndim(depth) == 0:
            self.depth = float(depth)
            self._ht = None
        else:
            self.depth = None
            arr = np.asarray(depth, dtype=kinds.np_dtype(dtype))
            if arr.min() <= 0:
                raise ValueError("bathymetry must be positive everywhere")
            self._ht = grid.block_tensor(
                layout.stack_global(grid.decomp, arr, mode="edge"),
                dtype=dtype)

        # One int8 mask code per point is the only per-point constant the
        # step reads; padding and beyond-domain cells are forced dry so
        # they stay inert.
        valid = grid.block_tensor(self._valid_cell_mask())
        tm = torch.where(valid, grid.tmask, 0).to(torch.int8)
        self._tmask_i8 = tm
        self._mask_codes = encode_masks(tm).contiguous()
        self._t_wet = (tm == 1).to(dtype)
        # Coriolis: f-plane scalar from the constant latitude (50 N)
        self._fcor = float(2.0 * params.omega * np.sin(50.0 * params.d2r))
        self._istep0 = 0
        #: advance with the fused sweep (the CUDA kernel on a CUDA grid)
        self.use_fused = False
        self._sweep_K = 1
        #: halo transport of the fused sweep: "ppermute" (the exchange
        #: around the kernel) or "fused" (the exchange inside it)
        self._transport = "ppermute"
        self._fused_cache = {}
        #: the overlapped step's side stream (made on its first CUDA use)
        self._side_stream = None

    def _valid_cell_mask(self) -> np.ndarray:
        """Cells representing a real global cell (internal, or a halo
        cell whose global index is inside the domain)."""
        d = self.grid.decomp
        gx = layout.global_x_index(d)
        gy = layout.global_y_index(d)
        mx = (gx >= 0) & (gx < d.global_nx)
        my = (gy >= 0) & (gy < d.global_ny)
        return my[:, None] & mx[None, :]

    # ------------------------------------------------------------------
    def enable_fast_path(self, steps_per_sweep: int = 1,
                         transport: str = "ppermute") -> None:
        """Switch the step to the fused sweep (the JAX package's
        ``enable_pallas``).  Needs a depth-2K halo: the kernel has no
        mid-step exchange, so the whole K-step chain must fit the halo
        (``build(halo_width=2*steps_per_sweep)``).

        ``transport="ppermute"`` (or its old name ``"plain"``) exchanges
        the state before each sweep; ``"fused"`` moves that exchange
        inside the sweep (the JAX package's remote-DMA transport): on a
        CUDA grid the kernel reads each staged state point from where the
        exchange would have put it, in the same launch.  It exchanges the
        full halo depth, as the JAX package does.  Across ranks it needs
        one tile per rank (several raise ``ValueError``), and each sweep
        exchanges with the neighbouring ranks through peer memory
        (``csrc/nemolite2d_sweep_rdma.cu``; on the CPU the protocol's plain
        version).  Of the JAX package's
        guards for it the port keeps those that protect the semantics
        (the K steps fit the halo, one state dtype, the block is the
        spec's); the TPU's 8-row and 128-lane alignment, ``2*depth`` within
        a landing block and tiles at least as deep as the halo (against an
        in-flight DMA overlapping its own send rows) describe remote DMA
        between devices and do not apply to one launch over one array."""
        if transport == "plain":
            transport = "ppermute"
        if transport not in ("ppermute", "fused"):
            raise ValueError(f"unknown transport {transport!r}")
        prev = (self.use_fused, self._sweep_K, self._transport)
        self._fused_cache.clear()
        try:
            enable_fast_path(self, reach=2, kmax=KMAX,
                             steps_per_sweep=steps_per_sweep)
            self._transport = transport
            self._make_fused(self._sweep_K)       # fail fast on bad configs
        except Exception:
            # leave the model as it was, not half-configured
            self.use_fused, self._sweep_K, self._transport = prev
            self._fused_cache.clear()
            raise

    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        """Communication avoidance on the plain path: K chained
        ``step_math`` calls per depth-2K exchange."""
        set_steps_per_exchange(self, reach=2,
                               steps_per_sweep=steps_per_sweep)

    def _make_fused(self, K: int):
        """The fused K-step sweep for this model's configuration."""
        if K not in self._fused_cache:
            ly, lx = self.grid.array_shape
            self._fused_cache[K] = make_fused_step(
                ly, lx, self.grid.dtype, self.p, self.grid.dx, self.grid.dy,
                self._fcor, self.depth if self._ht is None else 0.0,
                steps_per_sweep=K, variable_bathy=self._ht is not None,
                exchange_spec=(self.grid.halo_spec if self._in_sweep_exchange
                               else None))
        return self._fused_cache[K]

    def _make_plain_sweep(self, K: int):
        """The same K-step chain on the plain path (the JAX package's
        ``_make_jnp_sweep``)."""
        return functools.partial(
            fused_step_reference, p=self.p, dx=self.grid.dx, dy=self.grid.dy,
            fcor=self._fcor, depth=self.depth if self._ht is None else 0.0)

    @property
    def _in_sweep_exchange(self) -> bool:
        """The fused sweep exchanges the state itself."""
        return self.use_fused and self._transport == "fused"

    @property
    def _field_transport(self) -> str:
        """The transport of the model's own field exchanges: with the
        exchange in the sweep, the exchange kernel, so that on the card
        nothing of the model runs the plain exchange."""
        return "remote_dma" if self._in_sweep_exchange else "ppermute"

    # ------------------------------------------------------------------
    def set_initial_ssh(self, ssh_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(ssh_global), mode="zeros",
                                      dtype=kinds.np_dtype(self.grid.dtype))
        self.sshn_t.set_data(stacked)
        self.sshn_t.halo_exchange(1, transport=self._field_transport)
        self._sync_face_ssh()

    def _sync_face_ssh(self) -> None:
        self.sshn_u.data = next_sshu(self.sshn_t.data, self._t_wet)
        self.sshn_v.data = next_sshv(self.sshn_t.data, self._t_wet)

    def forcing_series(self, istep0: int, nsteps: int) -> list:
        """bc_ssh values of steps istep0+1 .. istep0+nsteps, evaluated
        once on the host in the working dtype: the model time of step
        ``i`` is ``(istep0 + 1 + i)`` cast to the working dtype, times
        rdt.  The kernel takes them as launch arguments."""
        steps = torch.arange(istep0 + 1, istep0 + 1 + nsteps,
                             dtype=torch.int64)
        wdt = self.grid.dtype
        rtime = steps.to(wdt) * self.p.rdt
        return tidal_forcing(rtime, self.p).to(wdt).tolist()

    # ------------------------------------------------------------------
    def _block_step(self, exch, forcing, sshn_t, un, vn, mask_codes,
                    dep=None):
        """One step after a depth-min(halo, 2) exchange (inside the K=1
        sweep with the fused transport); ``forcing`` is this step's
        bc_ssh value."""
        p = self.p
        dx, dy = self.grid.dx, self.grid.dy
        h = self.grid.halo_spec.halo
        if dep is None:
            dep = self.depth
        if not self._in_sweep_exchange:
            sshn_t, un, vn = exch((sshn_t, un, vn))
        if self.use_fused:
            return self._make_fused(1)(sshn_t, un, vn, mask_codes, [forcing],
                                       ht=dep if self._ht is not None
                                       else None)
        # With halo width 1 the new surface must cross tile seams between
        # continuity and momentum; with halo >= 2 the whole step is one
        # communication-free stencil chain.
        exch_mid = (lambda a: exch((a,))[0]) if h < 2 else None
        return step_math(sshn_t, un, vn, mask_codes, p, dx, dy, self._fcor,
                         dep, forcing, exch_mid=exch_mid)

    def _block_sweep(self, exch, fused, forcing, sshn_t, un, vn,
                     mask_codes, dep=None):
        """K steps after ONE depth-2K exchange (temporal blocking);
        ``forcing`` holds the K sub-steps' bc_ssh values.  With the fused
        transport the sweep exchanges and ``exch`` is skipped."""
        if not self._in_sweep_exchange:
            sshn_t, un, vn = exch((sshn_t, un, vn))
        return fused(sshn_t, un, vn, mask_codes, forcing,
                     ht=dep if self._ht is not None else None)

    def step_program(self, nsteps: int, overlap: bool = False,
                     remat_chunk: int | None = None):
        """The schedule of ``nsteps`` steps as a callable
        ``prog(istep0, state, mask_codes[, ht]) -> state``:
        ``nsteps // K`` sweeps of K steps, each after one depth-2K
        exchange, then ``nsteps % K`` single steps.

        ``remat_chunk`` checkpoints the loop for bounded-memory reverse
        mode (:func:`..ops.adjoint.checkpointed_fori`); it needs the
        plain path with one step per exchange (the kernels have no
        backward).  Forward values are bitwise unchanged.

        ``overlap=True`` runs one step at a time with the halo exchange
        overlapped by the interior's compute (:meth:`_block_step_overlap`;
        one tile per rank, halo >= 2, K = 1); internal points are bitwise
        the non-overlapped step's."""
        if remat_chunk is not None and (self.use_fused
                                        or self._sweep_K > 1):
            raise ValueError(
                "remat_chunk needs the plain differentiable path: build "
                "the flagship without fused/steps_per_sweep")
        spec = self.grid.halo_spec
        if overlap:
            if self._in_sweep_exchange:
                raise ValueError(
                    "overlap mode is redundant with transport='fused' (the "
                    "sweep already exchanges inside the kernel) and would "
                    "exchange twice")
            if spec.repx > 1 or spec.repy > 1:
                raise NotImplementedError(
                    "overlap mode supports one tile per rank")
            if spec.halo < 2:
                raise ValueError("overlap mode needs halo_width >= 2")
            if spec.tile_nx < 8 or spec.tile_ny < 8:
                raise ValueError("overlap mode needs tiles >= 8x8")
            if self._sweep_K > 1:
                raise ValueError(
                    "overlap mode runs one step at a time; rebuild with "
                    "steps_per_sweep=1 (temporal blocking already "
                    "amortises the exchange it would overlap)")
            return self._overlap_program(nsteps, remat_chunk)
        exch = exchange_multi_fn(spec, depth=min(spec.halo, 2) or 1)
        K = self._sweep_K
        if K > 1 and nsteps >= K:
            fusedK = (self._make_fused(K) if self.use_fused
                      else self._make_plain_sweep(K))
            exchK = exchange_multi_fn(spec, depth=2 * K)
        have_ht = self._ht is not None

        def prog(istep0, state, mask_codes, *bathy):
            dep = bathy[0] if have_ht else None
            forcing = self.forcing_series(istep0, nsteps)
            base = 0
            if K > 1 and nsteps >= K:
                for j in range(nsteps // K):
                    state = self._block_sweep(
                        exchK, fusedK, forcing[j * K: (j + 1) * K], *state,
                        mask_codes, dep=dep)
                base = (nsteps // K) * K
            # the single steps; with remat_chunk, all of them (K = 1)
            return checkpointed_fori(
                nsteps - base, lambda i, s: self._block_step(
                    exch, forcing[base + i], *s, mask_codes, dep=dep),
                state, remat_chunk)
        return prog

    def _block_step_overlap(self, forcing, sshn_t, un, vn, mask_codes,
                            dep=None):
        """One step with the exchange overlapped by the interior's
        compute (the JAX package's ``_block_step_overlap``).

        The interior is computed from the STALE block (the un-exchanged
        state) while the block is exchanged: on the card it runs on a
        side stream, so the exchange on the current stream (across
        ranks, its strips staged to the host) does not queue behind it.
        Only four 8-wide bands, the cells within stencil reach of a
        halo, are then recomputed from the exchanged block by the plain
        step and pasted over the interior's result at ``[2, B-2)`` of
        each band.  Each point's arithmetic is the non-overlapped step's,
        so internal points are bitwise equal to it; halo cells differ
        (the plain step computes them).  With ``use_fused`` the interior
        is the K=1 sweep kernel."""
        spec = self.grid.halo_spec
        h = spec.halo
        w, hgt = spec.tile_nx, spec.tile_ny
        B = 8                                   # band slice thickness
        ht = dep if self._ht is not None else None

        def run(s, u, v, c, ht=None):
            # variable bathymetry: face depths derived per (sub-)block;
            # band edges polluted by the average's wrap lie outside the
            # pasted rows, like the state's rolls
            dd = ((ht, st.avg_x(ht), st.avg_y(ht)) if ht is not None
                  else self.depth)
            return step_math(s, u, v, c, self.p, self.grid.dx, self.grid.dy,
                             self._fcor, dd, forcing, exch_mid=None)

        def interior():
            if self.use_fused:
                return list(self._make_fused(1)(sshn_t, un, vn, mask_codes,
                                                [forcing], ht=ht))
            return list(run(sshn_t, un, vn, mask_codes, ht=ht))

        def exchange():
            with torch.profiler.record_function("nemolite2d.overlap_exchange"):
                return exchange_multi((sshn_t, un, vn), spec, depth=2)

        dev = sshn_t.device
        if dev.type == "cuda":
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(dev)
            main, side = torch.cuda.current_stream(dev), self._side_stream
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = interior()
            fresh = exchange()
            main.wait_stream(side)
            for t in out:               # made on the side stream, used here
                t.record_stream(main)
        else:
            out = interior()
            fresh = exchange()

        def paste(sl, tgt, src):
            band = run(*(f[sl] for f in fresh), mask_codes[sl],
                       ht=None if ht is None else ht[sl])
            for k in range(3):
                # the interior's outputs are fresh tensors no operation
                # saved for its backward, so the bands write them in place
                out[k][tgt] = band[k][src]

        inner, every = slice(2, B - 2), slice(None)
        for r0 in (h - 2, h + hgt - (B - 2)):      # south, north rows
            paste((slice(r0, r0 + B), every),
                  (slice(r0 + 2, r0 + B - 2), every), (inner, every))
        for c0 in (h - 2, h + w - (B - 2)):        # west, east columns
            paste((every, slice(c0, c0 + B)),
                  (every, slice(c0 + 2, c0 + B - 2)), (every, inner))
        return tuple(out)

    def _overlap_program(self, nsteps: int, remat_chunk: int | None):
        """``step_program(nsteps, overlap=True)``: one overlapped step at
        a time (checkpointed with ``remat_chunk``)."""
        have_ht = self._ht is not None

        def prog(istep0, state, mask_codes, *bathy):
            dep = bathy[0] if have_ht else None
            forcing = self.forcing_series(istep0, nsteps)
            return checkpointed_fori(
                nsteps, lambda i, s: self._block_step_overlap(
                    forcing[i], *s, mask_codes, dep=dep),
                state, remat_chunk)
        return prog

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        state = (self.sshn_t.data, self.un.data, self.vn.data)
        bathy = (self._ht,) if self._ht is not None else ()
        out = prog(self._istep0, state, self._mask_codes, *bathy)
        self.sshn_t.data, self.un.data, self.vn.data = out
        self._istep0 += nsteps
        # keep the derived U/V-face ssh fields in sync for API users
        self.sshn_t.halo_exchange(1, transport=self._field_transport)
        self._sync_face_ssh()

    @property
    def bathymetry(self):
        """T-point depth: the stacked plane (variable bathymetry) or the
        flat scalar."""
        return self._ht if self._ht is not None else self.depth

    # ------------------------------------------------------------------
    def checksums(self) -> dict:
        return {"sshn": self.sshn_t.checksum(), "un": self.un.checksum(),
                "vn": self.vn.checksum()}

    def gather(self) -> dict:
        return {"sshn": self.sshn_t.gather_inner_data(),
                "un": self.un.gather_inner_data(),
                "vn": self.vn.gather_inner_data()}


def build(gnx: int = 256, gny: int = 256, ndomains=None,
          params: Params = Params(), depth: float = 100.0,
          open_north: bool = True, dtype=None,
          halo_width: int = 1, fused: bool = False,
          steps_per_sweep: int = 1, device=None) -> NemoLite2D:
    """Convenience constructor: grid + tmask + model on ``device``
    (default: the card).

    ``fused=True`` (the JAX package's ``pallas=True``) advances with the
    fused sweep: the CUDA kernel for a CUDA device, its plain version on
    the CPU.  ``steps_per_sweep=K`` adds temporal blocking: K steps per
    pass and per depth-2K halo exchange (with ``fused=False``, K chained
    plain steps per exchange).  ``halo_width=2`` alone selects the
    deep-halo one-exchange-per-step chain.  ``depth`` is a scalar (flat
    bathymetry) or a global (gny, gnx) T-point array."""
    halo_width = fast_path_grid_args(fused, steps_per_sweep, 2, halo_width)
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    grid_init(grid, 1000.0, 1000.0, default_tmask(gnx, gny, open_north))
    model = NemoLite2D(grid, params, depth)
    if fused:
        model.enable_fast_path(steps_per_sweep=steps_per_sweep)
    elif steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def main(argv=None):
    """CLI demo: ``python -m dl_esm_inf_tpu_torch.models.nemolite2d
    [N] [steps] [device] [hist.nc]`` runs the flagship on an N x N domain
    (258 by default) on ``device`` (``cuda`` by default; ``cpu`` runs the
    plain version of the same schedule) and prints per-field checksums
    every report interval and the rate after the first interval.  The
    optional fourth argument writes a NetCDF history file: one ssh/u/v
    record per report interval (the JAX package's third argument)."""
    import sys
    import time as _time

    from .gravity_wave import gaussian_eta

    args = list(argv if argv is not None else sys.argv[1:])
    n = int(args[0]) if args else 258
    nsteps = int(args[1]) if len(args) > 1 else 100
    device = torch.device(args[2] if len(args) > 2 else "cuda")
    hist_path = args[3] if len(args) > 3 else None
    m = build(n, n, fused=True, steps_per_sweep=4, device=device)
    if nsteps < 1:
        print("nothing to do (nsteps < 1)")
        return
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    hist = None
    if hist_path:
        from ..utils.io import NetCDFTimeSeries
        hist = NetCDFTimeSeries(
            hist_path, {"ssh": m.sshn_t, "u": m.un, "v": m.vn},
            global_attrs={"title": f"nemolite2d {n}x{n}"})
    report = max(1, nsteps // 5)
    done = 0
    warmed = False
    dt_total = 0.0
    timed_steps = 0
    while done < nsteps:
        todo = min(report, nsteps - done)
        t0 = _time.perf_counter()
        m.run(todo)
        done += todo
        cs = m.checksums()               # host readback = device fence
        dtc = _time.perf_counter() - t0
        if todo == report:
            if warmed:
                timed_steps += todo
                dt_total += dtc
            else:
                warmed = True
        print(f"step {done:6d}  " +
              "  ".join(f"{k}={v:.10E}" for k, v in cs.items()), flush=True)
        if hist is not None:
            hist.append(time=done * m.p.rdt)
    if hist is not None:
        hist.close()
        print(f"history written to {hist_path}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if timed_steps:
        rate = n * n * timed_steps / dt_total / 1e6
        print(f"{nsteps} steps of {n}x{n}; {timed_steps} timed in "
              f"{dt_total:.3f}s ({rate:.1f} Mpt/s after the first "
              f"interval, host clock) [device={where}, fused=True]")
    else:
        print(f"{nsteps} steps of {n}x{n} done (too few full intervals to "
              f"time) [device={where}, fused=True]")


if __name__ == "__main__":
    main()
