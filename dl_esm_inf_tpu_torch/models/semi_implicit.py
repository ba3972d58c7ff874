"""Semi-implicit (theta-method) free-surface gravity-wave model.

Counterpart of ``dl_esm_inf_tpu/models/semi_implicit.py``: an elliptic
solve inside the time step.  The fast gravity-wave terms are implicit,
so the time step is not CFL-limited by sqrt(g*H); each step solves a
Helmholtz problem for the new surface elevation with ``ops/solvers.py``
(CG with Jacobi preconditioning, or the dot-free Chebyshev iteration).

Discretisation (theta in [0.5, 1]; 0.5 = Crank-Nicolson, 1.0 = backward
Euler)::

    u' = u - g dt d/dx(theta eta' + (1-theta) eta)        on U faces
    v' = v - g dt d/dy(theta eta' + (1-theta) eta)        on V faces
    eta' = eta - H dt div(theta (u',v') + (1-theta) (u,v)) on T points

Eliminating (u', v') gives::

    (I + lam*L) eta' = eta - H dt div(u,v)
                       + g H theta (1-theta) dt^2 Lm eta

with ``lam_x = g H (theta dt)^2 / dx^2`` and ``L = -Lm`` the masked
5-point Laplacian whose faces conduct only between wet in-domain cells.
The step runs eagerly on the grid's device; the solver's tolerance test
reads one scalar per CG iteration.
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
from ..ops.adjoint import checkpointed_fori
from ..ops.solvers import (chebyshev_block, chebyshev_iterations,
                           default_tol, helmholtz_coefficients,
                           make_helmholtz_matvec, pcg_block, pcg_solve)
from ..parallel import halo as halo_mod
from ..parallel.collectives import masked_sum
from ..parallel.halo import exchange_multi_fn
from .gravity_wave import (default_tmask, gaussian_eta,  # noqa: F401
                           wet_update_masks)


class SemiImplicitModel:
    """eta/u/v fields advanced by implicit steps."""

    _fields = ("eta", "u", "v")

    def __init__(self, grid: Grid, dt: float, theta: float = 0.5,
                 g: float = 9.81, depth=100.0, tol: float | None = None,
                 maxiter: int | None = None, differentiable: bool = False,
                 solver: str = "cg", open_north: bool = False,
                 bc_amp: float = 0.0, bc_omega: float = 0.0):
        """``solver="chebyshev"`` uses the dot-free iteration
        (``ops/solvers.chebyshev_block``): a static iteration count to
        the eigenvalue-bound worst case instead of stopping at the
        measured residual.

        ``open_north=True`` makes the northmost wet row a radiative
        (Flather) open boundary with external elevation
        ``bc_amp * cos(bc_omega * t)``, solved implicitly: the
        theta-implicit part of the boundary flux couples a boundary cell
        only to itself, so it lands on the operator diagonal (SPD
        preserved) while the explicit part and the external elevation
        ride the rhs.

        ``differentiable=True`` swaps the in-step CG for
        :func:`..ops.solvers.pcg_solve`: reverse mode flows through the
        implicit step by the adjoint (same symmetric) solve instead of
        recording the iterations.  The iteration count is then not
        available (``run`` reports 0).

        Across ranks each rank holds its block of tiles, and the solver's
        dot products are all-reduced (:func:`..ops.solvers.pcg_block`),
        in the adjoint solve too; autograd crosses the exchange between
        ranks (:mod:`..parallel.halo`)."""
        if not 0.5 <= theta <= 1.0:
            raise ValueError(f"theta must be in [0.5, 1], got {theta}"
                             " (below 0.5 the scheme is unstable)")
        if solver not in ("cg", "chebyshev"):
            raise ValueError(f"solver must be 'cg' or 'chebyshev', "
                             f"got {solver!r}")
        if differentiable and solver != "cg":
            raise ValueError("differentiable=True requires solver='cg' "
                             "(the adjoint linear solve)")
        self.solver = solver
        self.differentiable = bool(differentiable)
        self.grid = grid
        self.dt = float(dt)
        self.theta = float(theta)
        self.g = float(g)
        self.tol = float(tol if tol is not None else default_tol(grid.dtype))
        d = grid.decomp
        self._user_maxiter = maxiter is not None
        self.maxiter = int(maxiter if maxiter is not None
                           else 4 * (d.global_nx + d.global_ny))

        self.eta = Field(grid, T_POINTS)
        self.u = Field(grid, U_POINTS)
        self.v = Field(grid, V_POINTS)

        dtype = self.eta.dtype
        npdt = kinds.np_dtype(dtype)
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(grid, dtype)
        self.open_north = bool(open_north)
        self.bc_amp = float(bc_amp)
        self.bc_omega = float(bc_omega)
        self._istep0 = 0
        if self.open_north:
            if grid.halo_spec.wrap_y:
                raise ValueError("open_north is incompatible with a "
                                 "periodic y boundary")
            # wet & strict in-domain & north row, from the host tmask
            gy = layout.global_y_index(d)
            gx = layout.global_x_index(d)
            geo = (((gy >= 0) & (gy < d.global_ny))[:, None]
                   & ((gx >= 0) & (gx < d.global_nx))[None, :])
            obc = ((grid._tmask_np == 1) & geo
                   & (gy == d.global_ny - 1)[:, None])
            self._obc = grid.block_tensor(obc.astype(npdt))
            # the boundary face (NE offset: v_j sits above T_j) is not
            # driven by the interior momentum update: its value is the
            # Flather velocity, set after each solve
            self._v_wet = self._v_wet * (1.0 - self._obc)
        else:
            self._obc = torch.zeros_like(self._t_upd)

        # depth: scalar (flat) or global (gny, gnx) T-point bathymetry.
        # Face depths are the NE-offset mean of adjacent T depths; the
        # Helmholtz face couplings are built from the same face depths
        # the continuity flux uses (operator/rhs consistency).
        scale = g * (self.theta * dt) ** 2
        if np.ndim(depth) == 0:
            self.depth = float(depth)
            hu_g = hv_g = None
            lam_x = scale * self.depth / grid.dx ** 2
            lam_y = scale * self.depth / grid.dy ** 2
            hmax = self.depth
        else:
            ht = np.asarray(depth, dtype=npdt)
            if ht.shape != (d.global_ny, d.global_nx):
                raise ValueError(
                    f"depth array must be (gny, gnx) = "
                    f"({d.global_ny}, {d.global_nx}), got {ht.shape}")
            if (ht <= 0).any():
                raise ValueError("depth must be positive everywhere "
                                 "(mask land with the tmask, not H<=0)")
            self.depth = ht
            hu_g = ht.copy()
            hu_g[:, :-1] = 0.5 * (ht[:, :-1] + ht[:, 1:])
            hv_g = ht.copy()
            hv_g[:-1, :] = 0.5 * (ht[:-1, :] + ht[1:, :])
            lam_x = scale * hu_g / grid.dx ** 2
            lam_y = scale * hv_g / grid.dy ** 2
            hmax = float(ht.max())
        self._lam_bounds = (1.0, 1.0 + 4.0 * scale * hmax
                            * (1.0 / grid.dx ** 2 + 1.0 / grid.dy ** 2))
        diag_extra = None
        if self.open_north:
            # theta-implicit Flather: rc = theta*dt*sqrt(g*H_b)/dy on the
            # open row (H_b = the boundary v-face depth); the same value
            # is recomputed in-step from hv for the rhs terms
            hb_row = (np.full(d.global_nx, self.depth) if hu_g is None
                      else hv_g[-1, :])
            rc_g = np.zeros((d.global_ny, d.global_nx))
            rc_g[-1, :] = self.theta * dt * np.sqrt(g * hb_row) / grid.dy
            diag_extra = rc_g
            # Chebyshev's upper eigenvalue bound gains the largest
            # radiation diagonal (Gershgorin)
            self._lam_bounds = (self._lam_bounds[0],
                                self._lam_bounds[1] + float(rc_g.max()))
        self._coeffs = helmholtz_coefficients(grid, lam_x, lam_y,
                                              diag_extra=diag_extra)
        self._inv_diag = 1.0 / self._coeffs[4]
        self._weight = grid.region_mask(dtype=dtype)
        if hu_g is None:
            full = np.full((d.global_ny, d.global_nx), self.depth,
                           dtype=npdt)
            self._hu = self._hv = grid.scatter_exchanged(full)
        else:
            self._hu = grid.scatter_exchanged(hu_g)
            self._hv = grid.scatter_exchanged(hv_g)

    # ------------------------------------------------------------------
    def set_initial_eta(self, eta_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(eta_global), mode="zeros",
                                      dtype=kinds.np_dtype(self.eta.dtype))
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    # ------------------------------------------------------------------
    def _block_step(self, istep: int, eta, u, v):
        """One implicit step on the stacked blocks: exchange, rhs,
        Helmholtz solve, velocity update.  Returns ``(eta, u, v,
        solver_iterations)``."""
        grid = self.grid
        spec = grid.halo_spec
        g, dt, th = self.g, self.dt, self.theta
        dx, dy = grid.dx, grid.dy
        e, w, n, s, diag = self._coeffs
        hu, hv, obc = self._hu, self._hv, self._obc
        mv = make_helmholtz_matvec(spec, e, w, n, s, diag)

        eta, u, v = exchange_multi_fn(spec, depth=1)((eta, u, v))
        # flux-form continuity with face depths, and the theta cross-term
        # through the operator's own face coefficients.  The open-boundary
        # face is excluded from the interior fluxes (its theta-implicit
        # Flather flux lives on the operator diagonal + rhs terms below);
        # (e+w+n+s), not (diag-1), keeps the radiation diagonal out of
        # the Laplacian cross-term.
        v_int = v * (1.0 - obc)
        div_h = st.ddx_back(hu * u, dx) + st.ddy_back(hv * v_int, dy)
        lsum = e + w + n + s
        lm = (e * st.xp(eta) + w * st.xm(eta) + n * st.yp(eta)
              + s * st.ym(eta) - lsum * eta)
        rhs = eta - dt * div_h + ((1.0 - th) / th) * lm
        if self.open_north:
            # eta_ext at t^{n+1}, in the working dtype; rc recomputed from
            # hv equals the diagonal extra built into the operator
            rt1 = torch.tensor(float(istep + 1), dtype=eta.dtype) * dt
            eta_ext1 = float(self.bc_amp * torch.cos(self.bc_omega * rt1))
            rc = obc * (th * dt / dy) * torch.sqrt(g * hv)
            rhs = rhs + rc * eta_ext1 \
                - obc * (dt / dy) * hv * (1.0 - th) * v
        rhs = torch.where(self._t_upd > 0, rhs, eta)
        if self.solver == "chebyshev":
            lmin, lmax = self._lam_bounds
            # run to the static error bound: the CG-sized default maxiter
            # would silently truncate a stiff (large-dt) solve; only an
            # explicit maxiter caps the fixed-count iteration
            k = chebyshev_iterations(lmin, lmax, self.tol)
            if self._user_maxiter:
                k = min(k, self.maxiter)
            sol = chebyshev_block(rhs, eta, matvec=mv, lam_min=lmin,
                                  lam_max=lmax, niters=k)
        elif self.differentiable:
            sol = pcg_solve(mv, rhs, self._weight, tol=self.tol,
                            maxiter=self.maxiter, inv_diag=self._inv_diag,
                            x0=eta, constants=self._coeffs)
            k = 0
        else:
            sol, k, _rel = pcg_block(mv, rhs, eta, self._weight,
                                     tol=self.tol, maxiter=self.maxiter,
                                     inv_diag=self._inv_diag)
        eta_new = halo_mod.exchange(torch.where(self._t_upd > 0, sol, eta),
                                    spec, 1)
        eta_mix = th * eta_new + (1.0 - th) * eta
        u_new = self._u_wet * (u - g * dt * st.ddx(eta_mix, dx))
        v_new = self._v_wet * (v - g * dt * st.ddy(eta_mix, dy))
        if self.open_north:
            # the stored boundary-face velocity IS the Flather value at
            # t^{n+1} (v_wet is zeroed on that face); the next step's
            # explicit flux term reads it back
            v_new = v_new + obc * torch.sqrt(g / hv) * (eta_new - eta_ext1)
        return eta_new, u_new, v_new, k

    def step_program(self, nsteps: int = 1, remat_chunk: int | None = None):
        """``prog(istep0, eta, u, v) -> (eta, u, v, iterations)``
        advancing ``nsteps`` implicit steps; ``iterations`` is the total
        solver iteration count.

        ``remat_chunk`` checkpoints the loop for bounded-memory reverse
        mode (:func:`..ops.adjoint.checkpointed_fori`).  The trade is
        steeper here: the backward pass re-runs each step's forward
        solve (recomputation) besides the adjoint solve of
        ``differentiable=True``."""
        def prog(istep0, eta, u, v):
            def one(i, carry):
                eta, u, v, its = carry
                eta, u, v, k = self._block_step(istep0 + i, eta, u, v)
                return eta, u, v, its + k

            return checkpointed_fori(nsteps, one, (eta, u, v, 0),
                                     remat_chunk)
        return prog

    def run(self, nsteps: int) -> dict:
        eta, u, v, its = self.step_program(nsteps)(
            self._istep0, self.eta.data, self.u.data, self.v.data)
        self.eta.data, self.u.data, self.v.data = eta, u, v
        self._istep0 += nsteps
        return {"cg_iterations": int(its),
                "cg_iterations_per_step": int(its) / max(nsteps, 1)}

    # ------------------------------------------------------------------
    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}

    def mass(self) -> float:
        """Total surface elevation over wet cells (conserved by the
        scheme up to solver tolerance: no-flux walls telescope)."""
        return masked_sum(self.eta.data, self._weight * self._t_upd)

    def gather(self) -> dict:
        return {"eta": self.eta.gather_inner_data(),
                "u": self.u.gather_inner_data(),
                "v": self.v.gather_inner_data()}


def build(gnx: int = 128, gny: int = 128, ndomains=None, dt: float = 1.0,
          theta: float = 0.5, g: float = 9.81, depth=10.0, dx: float = 1.0,
          dy: float = 1.0, tmask=None, dtype=None, tol: float | None = None,
          maxiter=None, differentiable: bool = False, solver: str = "cg",
          open_north: bool = False, bc_amp: float = 0.0,
          bc_omega: float = 0.0, device=None) -> SemiImplicitModel:
    """Grid + land-ring tmask + model on ``device`` (default: the card;
    ``open_north=True`` leaves the north edge wet: a radiative Flather
    boundary)."""
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=1)
    if tmask is None:
        tmask = default_tmask(gnx, gny)
        if open_north:
            tmask = tmask.copy()
            tmask[-1, 1:-1] = 1
    grid_init(grid, dx, dy, tmask)
    return SemiImplicitModel(grid, dt=dt, theta=theta, g=g, depth=depth,
                             tol=tol, maxiter=maxiter,
                             differentiable=differentiable, solver=solver,
                             open_north=open_north, bc_amp=bc_amp,
                             bc_omega=bc_omega)


def _main(argv=None):
    """CLI demo: ``python -m dl_esm_inf_tpu_torch.models.semi_implicit
    [N [steps [dt [solver [device]]]]]`` (``device`` is ``cuda`` by
    default); runs far beyond the explicit CFL limit and reports the
    step rate, solver iterations and mass conservation."""
    import sys
    import time

    args = list(sys.argv[1:] if argv is None else argv)
    N = int(args[0]) if args else 128
    nsteps = int(args[1]) if len(args) > 1 else 50
    dt = float(args[2]) if len(args) > 2 else 2.0
    solver = args[3] if len(args) > 3 else "cg"
    device = torch.device(args[4] if len(args) > 4 else "cuda")
    depth = 10.0
    cfl = (9.81 * depth) ** 0.5 * dt
    print(f"semi-implicit SW: {N}x{N}, dt={dt} (wave CFL ~ {cfl:.1f}),"
          f" theta=0.5, solver={solver}")
    m = build(N, N, dt=dt, depth=depth, solver=solver, device=device)
    m.set_initial_eta(gaussian_eta(N, N, amp=0.5))
    m.run(1)                             # warm-up (allocator, clocks)
    m0 = m.mass()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    info = m.run(nsteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    g = m.gather()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{nsteps} steps in {wall:.2f}s "
          f"({wall / nsteps * 1e3:.1f} ms/step, host clock, "
          f"{info['cg_iterations_per_step']:.0f} solver its/step) "
          f"[device={where}, {m.grid.dtype}]")
    print(f"max |eta| = {float(abs(g['eta']).max()):.4f}  "
          f"mass drift = {abs(m.mass() - m0) / max(abs(m0), 1e-30):.2e}")


if __name__ == "__main__":
    _main()
