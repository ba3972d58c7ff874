"""Linear gravity-wave shallow-water model.

Counterpart of ``dl_esm_inf_tpu/models/gravity_wave.py``: the smallest
end-to-end client of the framework.  Forward-backward time stepping on
the Arakawa-C grid with NE offset:

    u^{n+1}   = u^n - g dt (eta^n_{i+1} - eta^n_i)/dx          on U faces
    v^{n+1}   = v^n - g dt (eta^n_{j+1} - eta^n_j)/dy          on V faces
    eta^{n+1} = eta^n - H dt [ (u^{n+1}_i - u^{n+1}_{i-1})/dx
                             + (v^{n+1}_j - v^{n+1}_{j-1})/dy ] on T points

Solid walls come from the T mask alone: a face is wet only if both
adjacent T points are wet.  The step (:meth:`GravityWaveModel._step_math`)
is plain tensor code in the JAX package's order; ``build(fused=True)``
advances K steps per halo exchange through the hand-written kernel
``csrc/gravity_wave_sweep.cu`` on a CUDA grid, and through K chained
plain steps on the CPU (:mod:`..ops.stencil_sweep`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds, layout
from ..core.constants import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, OFFSET_NE,
                              T_POINTS, U_POINTS, V_POINTS)
from ..core.field import Field
from ..core.grid import Grid, grid_init
from ..ops import stencils as st
from ..ops.fastpath import SweepClient, fast_path_grid_args
from ..ops.stencil_sweep import StencilSweepKernel

#: the process's one wrapper of the gravity-wave sweep kernel
gravity_wave_sweep = StencilSweepKernel("gravity_wave_sweep", n_state=3,
                                        has_code=True)


def default_tmask(gnx: int, gny: int) -> np.ndarray:
    """All-wet domain with a one-cell land ring (solid walls)."""
    t = np.ones((gny, gnx), dtype=np.int32)
    t[0, :] = t[-1, :] = 0
    t[:, 0] = t[:, -1] = 0
    return t


def gaussian_eta(gnx: int, gny: int, amp: float = 1.0,
                 width: float = 0.1) -> np.ndarray:
    """Initial sea-surface bump in the domain centre."""
    x = (np.arange(gnx) - gnx / 2) / gnx
    y = (np.arange(gny) - gny / 2) / gny
    r2 = x[None, :] ** 2 + y[:, None] ** 2
    return amp * np.exp(-r2 / (2 * width ** 2))


def wet_update_masks(grid: Grid, dtype):
    """``(t_upd, u_wet, v_wet)`` update masks on the grid's device.

    ``t_upd`` is the geometric update mask: wet T cells representing a
    real global cell, INCLUDING in-domain shard-halo cells, so halo
    cells evolve exactly like their interior twins (the sweep recomputes
    them).  A U/V face is wet only if both adjacent T points are."""
    tm = grid.tmask
    wet_t = tm == 1
    d = grid.decomp
    gx = layout.global_x_index(d)
    gy = layout.global_y_index(d)
    geo = grid.block_tensor(((gy >= 0) & (gy < d.global_ny))[:, None]
                            & ((gx >= 0) & (gx < d.global_nx))[None, :])
    return ((wet_t & geo).to(dtype),
            (wet_t & (st.xp(tm) == 1)).to(dtype),
            (wet_t & (st.yp(tm) == 1)).to(dtype))


class GravityWaveModel(SweepClient):
    """eta/u/v fields on a grid, advanced eagerly."""

    sweep_kernel = gravity_wave_sweep
    _fields = ("eta", "u", "v")

    def __init__(self, grid: Grid, dt: float, g: float = 9.81,
                 depth: float = 100.0):
        self.grid = grid
        self.dt = float(dt)
        self.g = float(g)
        self.depth = float(depth)

        self.eta = Field(grid, T_POINTS)
        self.u = Field(grid, U_POINTS)
        self.v = Field(grid, V_POINTS)

        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            grid, grid.dtype)
        # the 3-bit code the kernel reads: 1 B/pt instead of three planes
        self._mask_codes = st.pack_mask_bits(
            (self._t_upd, self._u_wet, self._v_wet)).contiguous()
        self._step_aux = (self._t_upd, self._u_wet, self._v_wet)
        self._sweep_aux = (self._mask_codes,)
        self._init_fast_path()

    def set_initial_eta(self, eta_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(eta_global), mode="zeros",
                                      dtype=kinds.np_dtype(self.grid.dtype))
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    def _step_math(self, eta, u, v, t_upd, u_wet, v_wet):
        """One forward-backward step on a block (total reach 1)."""
        g, H, dt = self.g, self.depth, self.dt
        dx, dy = self.grid.dx, self.grid.dy
        u_new = (u - g * dt * st.ddx(eta, dx)) * u_wet
        v_new = (v - g * dt * st.ddy(eta, dy)) * v_wet
        div = st.ddx_back(u_new, dx) + st.ddy_back(v_new, dy)
        eta_new = torch.where(t_upd > 0, eta - H * dt * div, eta)
        return eta_new, u_new, v_new

    def _prepare(self, aux):
        return st.unpack_mask_bits(aux[0], 3, self.grid.dtype)

    def kernel_constants(self) -> list[float]:
        """The kernel's scalars, folded as the plain step's Python
        scalars are (``g * dt * x`` is ``(g*dt) * x``)."""
        return [self.g * self.dt, self.depth * self.dt, self.grid.dx,
                self.grid.dy]

    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}


def build(gnx: int = 256, gny: int = 256, ndomains=None, dt: float = 0.05,
          g: float = 9.81, depth: float = 10.0, dx: float = 1.0,
          dy: float = 1.0, tmask=None, dtype=None, halo_width: int = 1,
          fused: bool = False, steps_per_sweep: int = 1,
          device=None) -> GravityWaveModel:
    """Grid + land-ring tmask + model on ``device`` (default: the card).

    ``fused=True`` (the JAX package's ``pallas=True``) advances with the
    fused sweep; ``steps_per_sweep=K`` (up to 8) adds temporal blocking,
    K steps per depth-K halo exchange (with ``fused=False``, K chained
    plain steps per exchange)."""
    halo_width = fast_path_grid_args(fused, steps_per_sweep, 1, halo_width)
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    grid_init(grid, dx, dy, default_tmask(gnx, gny) if tmask is None
              else tmask)
    model = GravityWaveModel(grid, dt=dt, g=g, depth=depth)
    if fused:
        model.enable_fast_path(steps_per_sweep=steps_per_sweep)
    elif steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta0: np.ndarray, tmask: np.ndarray, dx: float,
                     dy: float, dt: float, nsteps: int, g: float = 9.81,
                     depth: float = 100.0) -> dict:
    """Independent NumPy transcription (explicit slicing, fp64) on plain
    global arrays with no halos."""
    eta = eta0.astype(np.float64).copy()
    u = np.zeros_like(eta)
    v = np.zeros_like(eta)
    wet = tmask == 1
    u_wet = np.zeros_like(eta)
    u_wet[:, :-1] = (wet[:, :-1] & wet[:, 1:]).astype(np.float64)
    v_wet = np.zeros_like(eta)
    v_wet[:-1, :] = (wet[:-1, :] & wet[1:, :]).astype(np.float64)

    for _ in range(nsteps):
        un = u.copy()
        vn = v.copy()
        un[:, :-1] = u[:, :-1] - g * dt * (eta[:, 1:] - eta[:, :-1]) / dx
        un *= u_wet
        vn[:-1, :] = v[:-1, :] - g * dt * (eta[1:, :] - eta[:-1, :]) / dy
        vn *= v_wet
        div = np.zeros_like(eta)
        div[:, 0] += un[:, 0] / dx
        div[:, 1:] += (un[:, 1:] - un[:, :-1]) / dx
        div[0, :] += vn[0, :] / dy
        div[1:, :] += (vn[1:, :] - vn[:-1, :]) / dy
        eta = np.where(wet, eta - depth * dt * div, eta)
        u, v = un, vn
    return {"eta": eta, "u": u, "v": v}
