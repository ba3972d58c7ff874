"""'Shallow'-style rotating shallow-water model: SW offset + periodic BCs.

Counterpart of ``dl_esm_inf_tpu/models/shallow.py``: the reference's
second client family, with the SW staggering convention (U west of T,
V south of T) and doubly-periodic boundaries.  Linear rotating shallow
water (f-plane) on the C grid, forward-backward in the gravity terms,
explicit in Coriolis:

    u^{n+1}   = u^n + f v̄ dt - g dt (eta_i - eta_{i-1})/dx
    v^{n+1}   = v^n - f ū dt - g dt (eta_j - eta_{j-1})/dy
    eta^{n+1} = eta - H dt [(u_{i+1}-u_i)/dx + (v_{j+1}-v_j)/dy]

The periodic wrap rides the halo exchange (wrap pairs in the exchange);
no boundary code exists anywhere in the model, and no masks: the domain
is all wet.  ``build(fused=True)`` advances K steps per depth-K exchange
through ``csrc/shallow_sweep.cu`` on a CUDA grid, and through K chained
plain steps on the CPU.
"""
from __future__ import annotations

import numpy as np

from ..core import kinds, layout
from ..core.constants import (ARAKAWA_C, BC_NONE, BC_PERIODIC, OFFSET_SW,
                              T_POINTS, U_POINTS, V_POINTS)
from ..core.field import Field
from ..core.grid import Grid, grid_init
from ..ops import stencils as st
from ..ops.fastpath import SweepClient, fast_path_grid_args
from ..ops.stencil_sweep import StencilSweepKernel, reciprocal

#: the process's one wrapper of the shallow sweep kernel
shallow_sweep = StencilSweepKernel("shallow_sweep", n_state=3)


class ShallowModel(SweepClient):
    """Doubly-periodic rotating SW on the SW-offset C grid."""

    sweep_kernel = shallow_sweep
    _fields = ("eta", "u", "v")

    def __init__(self, grid: Grid, dt: float, g: float = 9.81,
                 depth: float = 100.0, f0: float = 1.0e-4):
        if grid.offset != OFFSET_SW:
            raise ValueError("ShallowModel expects the SW offset convention")
        if not (grid.wrap_x and grid.wrap_y):
            raise ValueError("ShallowModel expects doubly-periodic BCs")
        self.grid = grid
        self.dt, self.g, self.depth, self.f0 = (float(dt), float(g),
                                                float(depth), float(f0))
        self.eta = Field(grid, T_POINTS)
        self.u = Field(grid, U_POINTS)
        self.v = Field(grid, V_POINTS)
        self._step_aux = ()
        self._sweep_aux = ()
        self._init_fast_path()

    def set_initial_eta(self, eta_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(eta_global), mode="zeros",
                                      dtype=kinds.np_dtype(self.grid.dtype))
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    def _step_math(self, eta, u, v):
        """One step on a block (total reach 1; no masks, so halo cells
        evolve exactly like their interior twins)."""
        g, H, dt, f = self.g, self.depth, self.dt, self.f0
        dx, dy = self.grid.dx, self.grid.dy
        # SW offset: U_i sits between T_{i-1} and T_i; V_j between
        # T_{j-1} and T_j.  Coriolis velocities interpolated to the
        # opposite points.
        v_at_u = 0.25 * (v + st.xm(v) + st.yp(v) + st.yp(st.xm(v)))
        u_at_v = 0.25 * (u + st.ym(u) + st.xp(u) + st.xp(st.ym(u)))
        u_new = u + f * dt * v_at_u - g * dt * st.ddx_back(eta, dx)
        v_new = v - f * dt * u_at_v - g * dt * st.ddy_back(eta, dy)
        eta_new = eta - H * dt * (st.ddx(u_new, dx) + st.ddy(v_new, dy))
        return eta_new, u_new, v_new

    def _prepare(self, aux):
        return ()

    def kernel_constants(self) -> list[float]:
        """The kernel's scalars, folded as the plain step's Python
        scalars are; the spacings as the reciprocals PyTorch multiplies by
        on the card."""
        dt = self.grid.dtype
        return [self.f0 * self.dt, self.g * self.dt, self.depth * self.dt,
                reciprocal(self.grid.dx, dt), reciprocal(self.grid.dy, dt)]

    def checksums(self) -> dict:
        return {k: getattr(self, k).checksum() for k in self._fields}


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.01,
          halo_width: int = 1, fused: bool = False,
          steps_per_sweep: int = 1, dtype=None, device=None,
          **kw) -> ShallowModel:
    """Doubly-periodic SW-offset grid (all wet, dx = dy = 1) + model on
    ``device`` (default: the card); ``fused``/``steps_per_sweep`` as in
    :func:`.gravity_wave.build`."""
    halo_width = fast_path_grid_args(fused, steps_per_sweep, 1, halo_width)
    grid = Grid(ARAKAWA_C, (BC_PERIODIC, BC_PERIODIC, BC_NONE), OFFSET_SW,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    grid_init(grid, 1.0, 1.0)
    model = ShallowModel(grid, dt=dt, **kw)
    if fused:
        model.enable_fast_path(steps_per_sweep=steps_per_sweep)
    elif steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta0: np.ndarray, dt: float, nsteps: int,
                     dx: float = 1.0, dy: float = 1.0, g: float = 9.81,
                     depth: float = 100.0, f0: float = 1.0e-4) -> dict:
    """Independent NumPy transcription using np.roll periodic wrap."""
    eta = eta0.astype(np.float64).copy()
    u = np.zeros_like(eta)
    v = np.zeros_like(eta)
    xm = lambda a: np.roll(a, 1, axis=1)   # noqa: E731
    xp = lambda a: np.roll(a, -1, axis=1)  # noqa: E731
    ym = lambda a: np.roll(a, 1, axis=0)   # noqa: E731
    yp = lambda a: np.roll(a, -1, axis=0)  # noqa: E731
    for _ in range(nsteps):
        v_at_u = 0.25 * (v + xm(v) + yp(v) + yp(xm(v)))
        u_at_v = 0.25 * (u + ym(u) + xp(u) + xp(ym(u)))
        un = u + f0 * dt * v_at_u - g * dt * (eta - xm(eta)) / dx
        vn = v - f0 * dt * u_at_v - g * dt * (eta - ym(eta)) / dy
        eta = eta - depth * dt * ((xp(un) - un) / dx + (yp(vn) - vn) / dy)
        u, v = un, vn
    return {"eta": eta, "u": u, "v": v}
