"""Two-layer linear shallow-water model (baroclinic demonstrator).

Counterpart of ``dl_esm_inf_tpu/models/twolayer.py``: two stacked fluid
layers on the Arakawa-C grid (NE offset) carrying a fast barotropic and
a slow baroclinic mode.  The state is SIX fields (eta1, eta2, u1, v1,
u2, v2), the sweep's many-plane case.  Linearised layered equations
(flat bottom, f = 0, forward-backward):

    P1 = g*eta1                      (upper-layer pressure / rho)
    P2 = g*eta1 + gp*eta2            (gp = reduced gravity)
    du_i/dt = -dP_i/dx,   dv_i/dt = -dP_i/dy       on U/V faces
    deta1/dt = -[H1 div(u1) + H2 div(u2)]          (surface)
    deta2/dt = -H2 div(u2)                         (interface)

Solid walls come from the T mask exactly as in the gravity-wave model.
``build(fused=True)`` advances K steps per depth-K exchange through
``csrc/twolayer_sweep.cu`` on a CUDA grid, and through K chained plain
steps on the CPU.
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
from .gravity_wave import (default_tmask, gaussian_eta,  # noqa: F401
                           wet_update_masks)

#: the process's one wrapper of the two-layer sweep kernel
twolayer_sweep = StencilSweepKernel("twolayer_sweep", n_state=6,
                                    has_code=True)


class TwoLayerModel(SweepClient):
    """eta1/eta2 + per-layer velocities, advanced eagerly."""

    sweep_kernel = twolayer_sweep
    _fields = ("eta1", "eta2", "u1", "v1", "u2", "v2")

    def __init__(self, grid: Grid, dt: float, g: float = 9.81,
                 gp: float = 0.02, h1: float = 20.0, h2: float = 80.0):
        self.grid = grid
        self.dt, self.g, self.gp = float(dt), float(g), float(gp)
        self.h1, self.h2 = float(h1), float(h2)

        self.eta1 = Field(grid, T_POINTS)
        self.eta2 = Field(grid, T_POINTS)
        self.u1 = Field(grid, U_POINTS)
        self.v1 = Field(grid, V_POINTS)
        self.u2 = Field(grid, U_POINTS)
        self.v2 = Field(grid, V_POINTS)

        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            grid, grid.dtype)
        self._mask_codes = st.pack_mask_bits(
            (self._t_upd, self._u_wet, self._v_wet)).contiguous()
        self._step_aux = (self._t_upd, self._u_wet, self._v_wet)
        self._sweep_aux = (self._mask_codes,)
        self._init_fast_path()

    def set_initial(self, eta1_global=None, eta2_global=None) -> None:
        for fld, arr in ((self.eta1, eta1_global), (self.eta2, eta2_global)):
            if arr is None:
                continue
            fld.set_data(layout.stack_global(
                self.grid.decomp, np.asarray(arr), mode="zeros",
                dtype=kinds.np_dtype(fld.dtype)))
            fld.halo_exchange(1)

    def _step_math(self, eta1, eta2, u1, v1, u2, v2, t_upd, u_wet, v_wet):
        """One forward-backward step on a block (total reach 1)."""
        g, gp, H1, H2, dt = self.g, self.gp, self.h1, self.h2, self.dt
        dx, dy = self.grid.dx, self.grid.dy
        p1 = g * eta1
        p2 = g * eta1 + gp * eta2
        u1n = (u1 - dt * st.ddx(p1, dx)) * u_wet
        v1n = (v1 - dt * st.ddy(p1, dy)) * v_wet
        u2n = (u2 - dt * st.ddx(p2, dx)) * u_wet
        v2n = (v2 - dt * st.ddy(p2, dy)) * v_wet
        div1 = st.ddx_back(u1n, dx) + st.ddy_back(v1n, dy)
        div2 = st.ddx_back(u2n, dx) + st.ddy_back(v2n, dy)
        eta1n = torch.where(t_upd > 0,
                            eta1 - dt * (H1 * div1 + H2 * div2), eta1)
        eta2n = torch.where(t_upd > 0, eta2 - dt * H2 * div2, eta2)
        return eta1n, eta2n, u1n, v1n, u2n, v2n

    def _prepare(self, aux):
        return st.unpack_mask_bits(aux[0], 3, self.grid.dtype)

    def kernel_constants(self) -> list[float]:
        """The kernel's scalars, folded as the plain step's Python
        scalars are (``dt * H2 * x`` is ``(dt*H2) * x``)."""
        return [self.g, self.gp, self.dt, self.h1, self.h2,
                self.dt * self.h2, self.grid.dx, self.grid.dy]

    def checksums(self) -> dict:
        return {"eta1": self.eta1.checksum(), "eta2": self.eta2.checksum()}


def build(gnx: int = 128, gny: int = 128, ndomains=None, dt: float = 0.02,
          tmask=None, halo_width: int = 1, fused: bool = False,
          steps_per_sweep: int = 1, dtype=None, device=None,
          **kw) -> TwoLayerModel:
    """Walled grid (dx = dy = 1) + model on ``device`` (default: the card);
    ``fused``/``steps_per_sweep`` as in :func:`.gravity_wave.build`."""
    halo_width = fast_path_grid_args(fused, steps_per_sweep, 1, halo_width)
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    grid_init(grid, 1.0, 1.0, default_tmask(gnx, gny) if tmask is None
              else tmask)
    model = TwoLayerModel(grid, dt=dt, **kw)
    if fused:
        model.enable_fast_path(steps_per_sweep=steps_per_sweep)
    elif steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta1_0, eta2_0, tmask, dx, dy, dt, nsteps,
                     g: float = 9.81, gp: float = 0.02,
                     h1: float = 20.0, h2: float = 80.0) -> dict:
    """Independent NumPy transcription (the land ring keeps the faces at
    the wrap dry)."""
    wet_t = (tmask == 1).astype(np.float64)
    u_wet = wet_t * np.roll(wet_t, -1, axis=1)
    v_wet = wet_t * np.roll(wet_t, -1, axis=0)
    e1 = eta1_0.astype(np.float64).copy()
    e2 = eta2_0.astype(np.float64).copy()
    u1 = np.zeros_like(e1)
    v1 = np.zeros_like(e1)
    u2 = np.zeros_like(e1)
    v2 = np.zeros_like(e1)
    xp = lambda a: np.roll(a, -1, axis=1)  # noqa: E731
    xm = lambda a: np.roll(a, 1, axis=1)   # noqa: E731
    ym = lambda a: np.roll(a, 1, axis=0)   # noqa: E731
    yp = lambda a: np.roll(a, -1, axis=0)  # noqa: E731
    for _ in range(nsteps):
        p1 = g * e1
        p2 = g * e1 + gp * e2
        u1 = (u1 - dt * (xp(p1) - p1) / dx) * u_wet
        v1 = (v1 - dt * (yp(p1) - p1) / dy) * v_wet
        u2 = (u2 - dt * (xp(p2) - p2) / dx) * u_wet
        v2 = (v2 - dt * (yp(p2) - p2) / dy) * v_wet
        div1 = (u1 - xm(u1)) / dx + (v1 - ym(v1)) / dy
        div2 = (u2 - xm(u2)) / dx + (v2 - ym(v2)) / dy
        e1 = np.where(wet_t > 0, e1 - dt * (h1 * div1 + h2 * div2), e1)
        e2 = np.where(wet_t > 0, e2 - dt * h2 * div2, e2)
    return {"eta1": e1, "eta2": e2, "u1": u1, "v1": v1,
            "u2": u2, "v2": v2}
