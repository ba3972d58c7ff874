"""Passive tracer transport: flux-form advection-diffusion on the C grid.

Counterpart of ``dl_esm_inf_tpu/models/tracer.py``: the standalone
:class:`TracerModel` and :class:`CoupledTracer`, a tracer advected
online by the evolving flagship flow.  Finite-volume flux form with the tmask
philosophy throughout (a face is wet only if both adjacent T cells
are), so land is a no-flux wall and tracer mass is conserved to
roundoff.  Two advection schemes:

* ``scheme="upwind"`` — donor-cell (stencil reach 1);
* ``scheme="vanleer"`` — MUSCL reconstruction with the van Leer limiter
  (reach 2): second order in smooth regions, TVD, donor-cell where the
  far-upwind neighbour is dry.

Diffusion is the masked-gradient Laplacian ``div(kappa wet grad C)``.
Velocities are prescribed and steady (faces; masked at build), halo-
exchanged once to FULL halo depth, so the temporal-blocking sweep
recomputes halo cells exactly like their interior twins.
``build(fused=True)`` advances K steps per depth-K*reach exchange
through ``csrc/tracer_sweep.cu`` on a CUDA grid, and through K chained
plain steps on the CPU.  :class:`CoupledTracer` runs the plain path
only, as in the JAX package.
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
from ..ops.fastpath import SweepClient, fast_path_grid_args
from ..ops.stencil_sweep import StencilSweepKernel, march_threads, tile
from ..parallel.collectives import masked_sum
from ..parallel.halo import exchange_multi_fn
from .gravity_wave import gaussian_eta, wet_update_masks

#: the process's one wrapper of the tracer sweep kernel; variant 0 is
#: upwind (K <= 8), 1 is van Leer (K <= 4)
tracer_sweep = StencilSweepKernel("tracer_sweep", n_state=1, n_aux=2,
                                  has_code=True, kmax=(8, 4))

_SCHEMES = ("upwind", "vanleer")

#: the kernel's column march: warps an SM and rows of a row strip
#: (csrc/tracer_sweep.cu: kWarps, kRows)
MARCH_WARPS = 40
MARCH_ROWS = 2


def kernel_shape(scheme: str, dtype, K: int):
    """``(shape, threads)``: the kernel's tile and window and its threads a
    CTA for ``scheme`` at ``dtype`` and K, the skeleton's rule with the
    march's widths (:func:`..ops.stencil_sweep.tile` with ``march``) for a
    ring of K * reach and a window of c, u, v, the next c and the code."""
    ring = K * (1 if scheme == "upwind" else 2)
    shape = tile(ring, 4 * torch.empty((), dtype=dtype).element_size() + 1,
                 march=True)
    return shape, march_threads(shape, ring, MARCH_WARPS, MARCH_ROWS)


def _van_leer(r):
    """phi(r) = (r + |r|) / (1 + |r|) — smooth TVD limiter."""
    return (r + torch.abs(r)) / (1.0 + torch.abs(r))


def face_values_x(c, t_upd, u, scheme: str):
    """Tracer reconstruction at U faces (face i between T_i and
    T_{i+1}, NE offset)."""
    up = c
    dn = st.xp(c)
    if scheme == "upwind":
        return torch.where(u > 0, up, dn)
    dc = dn - up                       # real face difference
    safe = torch.where(dc == 0, torch.ones_like(dc), dc)
    # u > 0: upwind cell i, far-upwind i-1;  u < 0: mirrored
    r_pos = (up - st.xm(c)) / safe
    r_neg = (st.xp(dn) - dn) / safe
    corr_pos = 0.5 * _van_leer(r_pos) * dc * st.xm(t_upd)
    corr_neg = 0.5 * _van_leer(r_neg) * dc * st.xp(st.xp(t_upd))
    return torch.where(u > 0, up + corr_pos, dn - corr_neg)


def face_values_y(c, t_upd, v, scheme: str):
    up = c
    dn = st.yp(c)
    if scheme == "upwind":
        return torch.where(v > 0, up, dn)
    dc = dn - up
    safe = torch.where(dc == 0, torch.ones_like(dc), dc)
    r_pos = (up - st.ym(c)) / safe
    r_neg = (st.yp(dn) - dn) / safe
    corr_pos = 0.5 * _van_leer(r_pos) * dc * st.ym(t_upd)
    corr_neg = 0.5 * _van_leer(r_neg) * dc * st.yp(st.yp(t_upd))
    return torch.where(v > 0, up + corr_pos, dn - corr_neg)


def tracer_step(c, u, v, t_upd, u_wet, v_wet, *, dx, dy, dt, kappa,
                scheme):
    """One conservative flux-form step (reach 1 upwind / 2 vanleer)."""
    fx = u * face_values_x(c, t_upd, u, scheme)
    fy = v * face_values_y(c, t_upd, v, scheme)
    tend = -(st.ddx_back(fx, dx) + st.ddy_back(fy, dy))
    if kappa:
        gx = st.ddx(c, dx) * u_wet
        gy = st.ddy(c, dy) * v_wet
        tend = tend + kappa * (st.ddx_back(gx, dx)
                               + st.ddy_back(gy, dy))
    return torch.where(t_upd > 0, c + dt * tend, c)


class TracerModel(SweepClient):
    """Tracer C on T points advected by steady face velocities."""

    sweep_kernel = tracer_sweep
    _fields = ("c",)

    def __init__(self, grid: Grid, dt: float, u, v,
                 kappa: float = 0.0, scheme: str = "vanleer"):
        if scheme not in _SCHEMES:
            raise ValueError(f"scheme must be 'upwind' or 'vanleer', "
                             f"got {scheme!r}")
        self.grid = grid
        self.dt = float(dt)
        self.kappa = float(kappa)
        self.scheme = scheme
        self.reach = 1 if scheme == "upwind" else 2
        self._variant = _SCHEMES.index(scheme)
        if grid.halo_spec.halo < self.reach:
            raise ValueError(
                f"scheme={scheme!r} has stencil reach {self.reach} and "
                f"needs halo_width >= {self.reach}, got "
                f"{grid.halo_spec.halo} (build() sets this when "
                "halo_width is left None)")

        self.c = Field(grid, T_POINTS)
        dtype = grid.dtype
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(grid, dtype)
        self._mask_codes = st.pack_mask_bits(
            (self._t_upd, self._u_wet, self._v_wet)).contiguous()

        # steady velocities: mask at the faces, exchange to FULL halo
        # depth once (the sweep needs them valid like the masks)
        d = grid.decomp
        npdt = kinds.np_dtype(dtype)
        faces = []
        for vel, pts, wet in ((u, U_POINTS, self._u_wet),
                              (v, V_POINTS, self._v_wet)):
            f = Field(grid, pts, init_global_data=np.broadcast_to(
                np.asarray(vel, npdt), (d.global_ny, d.global_nx)))
            f.halo_exchange(d.halo)
            faces.append((f.data * wet).contiguous())
        self._u, self._v = faces
        self._step_aux = (self._u, self._v, self._t_upd, self._u_wet,
                          self._v_wet)
        self._sweep_aux = (self._u, self._v, self._mask_codes)
        self._init_fast_path()

    def set_initial_tracer(self, c_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(c_global), mode="zeros",
                                      dtype=kinds.np_dtype(self.grid.dtype))
        self.c.set_data(stacked)
        self.c.halo_exchange(1)

    def _step_math(self, c, u, v, t_upd, u_wet, v_wet):
        """One conservative step on a block (reach 1 or 2)."""
        return (tracer_step(c, u, v, t_upd, u_wet, v_wet,
                            dx=self.grid.dx, dy=self.grid.dy,
                            dt=self.dt, kappa=self.kappa,
                            scheme=self.scheme),)

    def _prepare(self, aux):
        u, v, codes = aux
        return (u, v) + st.unpack_mask_bits(codes, 3, self.grid.dtype)

    def kernel_constants(self) -> list[float]:
        """dx, dy, dt, kappa and the diffusion flag (the plain step's
        ``if kappa:``)."""
        return [self.grid.dx, self.grid.dy, self.dt, self.kappa,
                1.0 if self.kappa else 0.0]

    def mass(self) -> float:
        """Total tracer over wet internal cells (conserved exactly: flux
        form with no-flux walls telescopes)."""
        w = self.grid.region_mask(dtype=self.grid.dtype)
        return masked_sum(self.c.data, w * self._t_upd)

    def checksums(self) -> dict:
        return {"c": self.c.checksum()}


class CoupledTracer:
    """Passive tracer advected ONLINE by the evolving flagship flow (the
    age/plume-tracer workflow): NEMOLite2D dynamics and tracer transport
    advance together, with one coalesced 4-field depth-2 halo exchange a
    step.

    The tracer advects with the START-of-step velocities (first-order
    operator splitting): they are freshly exchanged and so valid one ring
    into the halo, where the just-computed end-of-step velocities are
    not.  The flow is untouched: the coupled flagship trajectory equals a
    plain flagship run bitwise, and tracer mass is conserved as in the
    standalone model.  Plain path only (the JAX package's too)."""

    def __init__(self, flagship, kappa: float = 0.0,
                 scheme: str = "vanleer"):
        from .nemolite2d import NemoLite2D
        if not isinstance(flagship, NemoLite2D):
            raise TypeError("CoupledTracer rides a NemoLite2D model, "
                            f"got {type(flagship).__name__}")
        if flagship.use_fused or flagship._sweep_K > 1:
            raise ValueError(
                "CoupledTracer wraps the plain path: build the flagship "
                "without fused/steps_per_sweep")
        if scheme not in _SCHEMES:
            raise ValueError(f"scheme must be 'upwind' or 'vanleer', "
                             f"got {scheme!r}")
        reach = 1 if scheme == "upwind" else 2
        h = flagship.grid.halo_spec.halo
        if h < 2 or h < reach:
            raise ValueError(
                "CoupledTracer needs halo_width >= 2 (the flagship's "
                "communication-free reach-2 chain) and >= the tracer "
                f"scheme's reach; got {h}")
        self.flagship = flagship
        self.grid = flagship.grid
        self.kappa = float(kappa)
        self.scheme = scheme
        self.c = Field(self.grid, T_POINTS)
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            self.grid, self.grid.dtype)

    set_initial_tracer = TracerModel.set_initial_tracer
    mass = TracerModel.mass

    @property
    def _istep0(self) -> int:
        """The coupled clock is the flagship's (the ensemble reads it to
        continue the tidal forcing)."""
        return self.flagship._istep0

    def _step(self, exch, forcing, ssh, un, vn, c, dep):
        """One coupled step after one exchange of the four fields (works
        on blocks with leading axes: an ensemble's members)."""
        from . import nemolite2d as nl
        fs = self.flagship
        dx, dy = self.grid.dx, self.grid.dy
        ssh, un, vn, c = exch((ssh, un, vn, c))
        ssh2, un2, vn2 = nl.step_math(ssh, un, vn, fs._mask_codes, fs.p,
                                      dx, dy, fs._fcor, dep, forcing)
        c2 = tracer_step(c, un * self._u_wet, vn * self._v_wet,
                         self._t_upd, self._u_wet, self._v_wet, dx=dx,
                         dy=dy, dt=fs.p.rdt, kappa=self.kappa,
                         scheme=self.scheme)
        return ssh2, un2, vn2, c2

    def step_program(self, nsteps: int = 1,
                     remat_chunk: int | None = None):
        """``prog(istep0, (ssh, un, vn, c)[, ht]) -> (ssh, un, vn, c)``
        advancing ``nsteps`` coupled steps; the tidal forcing of step i
        is the flagship's at its clock ``istep0 + i``.  ``remat_chunk``
        checkpoints the loop for reverse mode (source inversion through
        the evolving flow)."""
        fs = self.flagship
        exch = exchange_multi_fn(self.grid.halo_spec, depth=2)

        def prog(istep0, state, *bathy):
            dep = bathy[0] if bathy else fs.depth
            forcing = fs.forcing_series(istep0, nsteps)

            def one(i, s):
                return self._step(exch, forcing[i], *s, dep)

            return checkpointed_fori(nsteps, one, state, remat_chunk)
        return prog

    def run(self, nsteps: int) -> None:
        fs = self.flagship
        bathy = (fs._ht,) if fs._ht is not None else ()
        out = self.step_program(nsteps)(
            fs._istep0, (fs.sshn_t.data, fs.un.data, fs.vn.data,
                         self.c.data), *bathy)
        fs.sshn_t.data, fs.un.data, fs.vn.data, self.c.data = out
        fs._istep0 += nsteps
        # keep the flagship's U/V-face ssh in sync, as its own run does
        fs.sshn_t.halo_exchange(1, transport=fs._field_transport)
        fs._sync_face_ssh()

    def gather(self) -> dict:
        out = self.flagship.gather()
        out["c"] = self.c.gather_inner_data()
        return out


def streamfunction_velocities(psi: np.ndarray, dx: float = 1.0,
                              dy: float = 1.0):
    """Discretely divergence-free face velocities from a streamfunction
    at F points (psi[j, i] = NE corner of T[j, i]):

        u[j, i] = -(psi[j, i] - psi[j-1, i]) / dy
        v[j, i] =  (psi[j, i] - psi[j, i-1]) / dx

    The C-grid divergence of these telescopes to zero exactly.
    """
    psi = np.asarray(psi, float)
    u = -(psi - np.roll(psi, 1, axis=0)) / dy
    v = (psi - np.roll(psi, 1, axis=1)) / dx
    return u, v


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.1,
          u=0.2, v=0.1, kappa: float = 0.0, scheme: str = "vanleer",
          tmask: np.ndarray | None = None, halo_width: int | None = None,
          dx: float = 1.0, dy: float = 1.0, fused: bool = False,
          steps_per_sweep: int = 1, dtype=None,
          device=None) -> TracerModel:
    """Tracer model on a walled domain (one-cell land ring by default)
    on ``device`` (default: the card).

    ``u``/``v`` are scalars or global face arrays; ``halo_width``
    defaults to the scheme's stencil reach (2 for vanleer);
    ``fused``/``steps_per_sweep`` as in :func:`.gravity_wave.build`
    (K <= 8 upwind, K <= 4 vanleer)."""
    if scheme not in _SCHEMES:
        raise ValueError(f"scheme must be 'upwind' or 'vanleer', "
                         f"got {scheme!r}")
    reach = 1 if scheme == "upwind" else 2
    halo_width = fast_path_grid_args(
        fused, steps_per_sweep, reach,
        reach if halo_width is None else halo_width)
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    if tmask is None:
        tmask = np.ones((gny, gnx), dtype=np.int32)
        tmask[0, :] = tmask[-1, :] = 0
        tmask[:, 0] = tmask[:, -1] = 0
    grid_init(grid, dx, dy, tmask=tmask)
    model = TracerModel(grid, dt=dt, u=u, v=v, kappa=kappa, scheme=scheme)
    if fused:
        model.enable_fast_path(steps_per_sweep=steps_per_sweep)
    elif steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(c0: np.ndarray, tmask: np.ndarray, u, v, dt: float,
                     nsteps: int, dx: float = 1.0, dy: float = 1.0,
                     kappa: float = 0.0,
                     scheme: str = "vanleer") -> np.ndarray:
    """Independent NumPy transcription (np.roll shifts, f64)."""
    c = c0.astype(np.float64).copy()
    wet = (np.asarray(tmask) == 1)
    xp = lambda a: np.roll(a, -1, 1)  # noqa: E731
    xm = lambda a: np.roll(a, 1, 1)   # noqa: E731
    yp = lambda a: np.roll(a, -1, 0)  # noqa: E731
    ym = lambda a: np.roll(a, 1, 0)   # noqa: E731
    t_upd = wet.astype(float)
    u_wet = (wet & (xp(wet))).astype(float)
    v_wet = (wet & (yp(wet))).astype(float)
    uf = np.broadcast_to(np.asarray(u, float), c.shape) * u_wet
    vf = np.broadcast_to(np.asarray(v, float), c.shape) * v_wet

    def vl(r):
        return (r + np.abs(r)) / (1.0 + np.abs(r))

    for _ in range(nsteps):
        if scheme == "upwind":
            cfx = np.where(uf > 0, c, xp(c))
            cfy = np.where(vf > 0, c, yp(c))
        else:
            dcx = xp(c) - c
            sx = np.where(dcx == 0, 1.0, dcx)
            cfx = np.where(
                uf > 0,
                c + 0.5 * vl((c - xm(c)) / sx) * dcx * xm(t_upd),
                xp(c) - 0.5 * vl((xp(xp(c)) - xp(c)) / sx) * dcx
                * xp(xp(t_upd)))
            dcy = yp(c) - c
            sy = np.where(dcy == 0, 1.0, dcy)
            cfy = np.where(
                vf > 0,
                c + 0.5 * vl((c - ym(c)) / sy) * dcy * ym(t_upd),
                yp(c) - 0.5 * vl((yp(yp(c)) - yp(c)) / sy) * dcy
                * yp(yp(t_upd)))
        fx = uf * cfx
        fy = vf * cfy
        tend = -((fx - xm(fx)) / dx + (fy - ym(fy)) / dy)
        if kappa:
            gx = (xp(c) - c) / dx * u_wet
            gy = (yp(c) - c) / dy * v_wet
            tend = tend + kappa * ((gx - xm(gx)) / dx
                                   + (gy - ym(gy)) / dy)
        c = np.where(wet, c + dt * tend, c)
    return c


def _main(argv=None):
    """CLI demo: ``python -m dl_esm_inf_tpu_torch.models.tracer
    [N [steps [scheme [device]]]]`` — a blob in a rotating gyre on the
    fused path (K = 4 van Leer, 8 upwind; ``device`` is ``cuda`` by
    default, ``cpu`` runs the kernel's plain version); reports the
    rate, the mass drift and the TVD range bound."""
    import sys
    import time

    args = list(sys.argv[1:] if argv is None else argv)
    N = int(args[0]) if args else 128
    nsteps = int(args[1]) if len(args) > 1 else 200
    scheme = args[2] if len(args) > 2 else "vanleer"
    device = torch.device(args[3] if len(args) > 3 else "cuda")
    x = (np.arange(N) - N / 2 + 0.5) / N
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    u, v = streamfunction_velocities(psi)
    print(f"tracer transport: {N}x{N}, {scheme}, rotating gyre "
          f"(max |u| = {max(abs(u).max(), abs(v).max()):.3f})")
    K = 8 if scheme == "upwind" else 4
    m = build(N, N, dt=0.5, u=u, v=v, kappa=0.02, scheme=scheme,
              fused=True, steps_per_sweep=K, device=device)
    c0 = gaussian_eta(N, N, amp=1.0, width=0.08)
    m.set_initial_tracer(c0)
    m.run(nsteps)                        # warm-up (kernel build, clocks)
    m.set_initial_tracer(c0)
    m0 = m.mass()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    m.run(nsteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    c = m.gather()["c"]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{nsteps} steps in {wall:.3f}s "
          f"({N * N * nsteps / wall / 1e6:.0f} Mpt/s, host clock) "
          f"[device={where}, {m.grid.dtype}, fused=True, K={K}]")
    print(f"range [{c.min():.2e}, {c.max():.4f}]  "
          f"mass drift = {abs(m.mass() - m0) / max(abs(m0), 1e-30):.2e}")


if __name__ == "__main__":
    _main()
