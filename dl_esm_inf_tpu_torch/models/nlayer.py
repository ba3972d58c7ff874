"""N-layer linear stacked shallow-water model (multi-level client).

Counterpart of ``dl_esm_inf_tpu/models/nlayer.py``: the two-layer model
generalised to any number of stacked fluid layers, on multi-level
fields (``Field(levels=N)``) whose level axis rides one halo exchange
per step.

Linearised layered equations (flat bottom, f=0, forward-backward),
``eta[k]`` the displacement of the interface ABOVE layer k (eta[0] is
the free surface), ``H[k]`` the rest thicknesses, reduced gravities
``gp[k]`` across each interior interface:

    P[k]      = g*eta[0] + sum_{j=1..k} gp[j]*eta[j]   (cumsum over k)
    du[k]/dt  = -dP[k]/dx,   dv[k]/dt = -dP[k]/dy      (on U/V faces)
    deta[k]/dt = -sum_{j=k..N-1} H[j]*div(u[j])        (reverse cumsum)

For N=2 this is models/twolayer.py.  ``build(fused=True)`` advances K
steps per depth-K exchange: the 3N level planes are flattened once
around the sweep loop onto the sweep's state, through the hand-written
kernel ``csrc/nlayer_sweep.cu`` on a CUDA grid and through its plain
version (:meth:`NLayerModel._layer_step` K times) on the CPU.

On the card a CTA stages its tile's window of all 3L planes in shared
memory, so the layer count is bounded by the 227 KiB a block may use:
:func:`kernel_tile` gives the tile per (L, dtype, K): for L <= 4 (the
compiled variants) the skeleton's tile rule
(:func:`..ops.stencil_sweep.tile`), beyond the largest square of 32, 16
and 8 cells that holds the window; it raises above what the 8-cell tile
holds (at float64, K=8: 16 layers) or above
:data:`KERNEL_MAX_LAYERS`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, OFFSET_NE,
                              T_POINTS, U_POINTS, V_POINTS)
from ..core.field import Field
from ..core.grid import Grid, grid_init
from ..ops import stencils as st
from ..ops.fastpath import SweepClient, fast_path_grid_args
from ..ops.stencil_sweep import RING, StencilSweepKernel, tile
from .gravity_wave import (default_tmask, gaussian_eta,  # noqa: F401
                           wet_update_masks)

#: the layer counts compiled into the CUDA kernel, on the skeleton's
#: tiles (f64, K=8, 4 layers: 48x20 tiles in a 64x36 window of 12 planes
#: and the code, 218 KiB of the 227 KiB a block may use)
COMPILED_LAYERS = 4
#: the most layers the kernel takes (its launch's parameter block holds
#: 3L plane pointers each way and the weights); the shared memory may
#: allow fewer (:func:`kernel_tile`)
KERNEL_MAX_LAYERS = 32
#: the tile edges of the run-time layer variants 4, 5, 6
MANY_TILES = (32, 16, 8)
#: shared memory a block may use on an H100 (sm_90), and the static
#: shared memory of the run-time layer variants (plane pointers, weights)
SMEM_LIMIT = 232448
_MANY_STATIC = 2048

#: the process's one wrapper of the N-layer sweep kernel; variant
#: ``L - 1`` takes L = 1..4 layers (3L state planes), variants 4, 5, 6
#: any 4 < L <= KERNEL_MAX_LAYERS on 32-, 16- and 8-cell tiles
nlayer_sweep = StencilSweepKernel(
    "nlayer_sweep", has_code=True,
    n_state=tuple(3 * L for L in range(1, COMPILED_LAYERS + 1))
    + (range(3 * (COMPILED_LAYERS + 1), 3 * KERNEL_MAX_LAYERS + 1, 3),)
    * len(MANY_TILES),
    kmax=(RING,) * (COMPILED_LAYERS + len(MANY_TILES)))


def window_bytes(layers: int, dtype, K: int, tile: int) -> int:
    """Shared memory of one CTA's window in the run-time layer variants:
    3L planes of ``(tile + 2K)^2`` points and the code byte per point."""
    w = (tile + 2 * K) ** 2
    return 3 * layers * w * dtype.itemsize + w


def kernel_tile(layers: int, dtype, K: int) -> tuple[int, int]:
    """The kernel's tile ``(rows, columns)`` for ``layers`` at ``dtype``
    and K: the skeleton's tile rule for the compiled L <= 4 (3L planes and
    the code, ring K), else the largest square of :data:`MANY_TILES` whose
    window fits the shared memory a block may use.  Raises ValueError
    where none does, or above :data:`KERNEL_MAX_LAYERS`."""
    if layers > KERNEL_MAX_LAYERS:
        raise ValueError(
            f"the CUDA N-layer sweep takes at most {KERNEL_MAX_LAYERS} "
            f"layers (its launch's parameter block), got {layers}")
    if layers <= COMPILED_LAYERS:
        shape = tile(K, 3 * layers * dtype.itemsize + 1)
        return shape.ty, shape.tx
    budget = SMEM_LIMIT - _MANY_STATIC
    for edge in MANY_TILES:
        if window_bytes(layers, dtype, K, edge) <= budget:
            return edge, edge
    fits = max((n for n in range(1, layers)
                if window_bytes(n, dtype, K, MANY_TILES[-1]) <= budget),
               default=0)
    raise ValueError(
        f"{layers} layers at {dtype} and K={K} do not fit the shared "
        f"memory budget of a block (227 KiB, {budget} B for the window): "
        f"even an {MANY_TILES[-1]}-cell tile stages "
        f"{window_bytes(layers, dtype, K, MANY_TILES[-1])} B; at most "
        f"{fits} layers fit")


def kernel_variant(layers: int, dtype, K: int) -> int:
    """The kernel variant that takes ``layers`` at ``dtype`` and K."""
    edge = kernel_tile(layers, dtype, K)[0]
    if layers <= COMPILED_LAYERS:
        return layers - 1
    return COMPILED_LAYERS + MANY_TILES.index(edge)


class NLayerModel(SweepClient):
    """eta/u/v as (layers, ny, nx) multi-level fields, advanced eagerly."""

    sweep_kernel = nlayer_sweep
    _fields = ("eta", "u", "v")

    def __init__(self, grid: Grid, dt: float, layers: int = 3,
                 g: float = 9.81, gp=0.02, thickness=None):
        if layers < 1:
            raise ValueError(f"layers must be >= 1, got {layers}")
        self.grid = grid
        self.layers = L = int(layers)
        self.dt, self.g = float(dt), float(g)
        gp = np.broadcast_to(np.asarray(gp, np.float64),
                             (max(L - 1, 1),)).copy()
        #: pressure weights per interface: g above layer 0, reduced
        #: gravities across the interior interfaces
        self._pw = np.concatenate(([g], gp[: L - 1]))
        if thickness is None:
            thickness = np.full(L, 100.0 / L)
        self._H = np.broadcast_to(np.asarray(thickness, np.float64),
                                  (L,)).copy()
        if np.any(self._H <= 0):
            raise ValueError("layer thicknesses must be positive")

        self.eta = Field(grid, T_POINTS, levels=L)
        self.u = Field(grid, U_POINTS, levels=L)
        self.v = Field(grid, V_POINTS, levels=L)

        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            grid, grid.dtype)
        self._mask_codes = st.pack_mask_bits(
            (self._t_upd, self._u_wet, self._v_wet)).contiguous()
        self._step_aux = (self._t_upd, self._u_wet, self._v_wet)
        self._sweep_aux = (self._mask_codes,)
        self._init_fast_path()

    # ------------------------------------------------------------------
    def set_initial(self, eta_global=None) -> None:
        """``eta_global``: (layers, gny, gnx) interface displacements."""
        if eta_global is None:
            return
        g = np.asarray(eta_global)
        d = self.grid.decomp
        want = (self.layers, d.global_ny, d.global_nx)
        if g.shape != want:
            raise ValueError(
                f"set_initial expects eta of shape {want}, got {g.shape}")
        self.eta.set_data(self.eta._stack(g))
        self.eta.halo_exchange(1)

    # ------------------------------------------------------------------
    def _step_math(self, eta, u, v, t_upd, u_wet, v_wet):
        """One forward-backward step on (layers, ly, lx) blocks; the
        level couplings are cumulative sums along the level axis."""
        dt = self.dt
        dx, dy = self.grid.dx, self.grid.dy
        pw = torch.as_tensor(self._pw, dtype=eta.dtype,
                             device=eta.device)[:, None, None]
        H = torch.as_tensor(self._H, dtype=eta.dtype,
                            device=eta.device)[:, None, None]
        # layer pressures: cumulative sum down the stack
        p = torch.cumsum(pw * eta, dim=-3)
        un = (u - dt * st.ddx(p, dx)) * u_wet
        vn = (v - dt * st.ddy(p, dy)) * v_wet
        div = st.ddx_back(un, dx) + st.ddy_back(vn, dy)
        # each interface moves with the transport of every layer below
        # it: reverse cumulative sum
        flux = torch.flip(torch.cumsum(torch.flip(H * div, (-3,)), dim=-3),
                          (-3,))
        etan = torch.where(t_upd > 0, eta - dt * flux, eta)
        return etan, un, vn

    def _layer_step(self, etas, us, vs, t_upd, u_wet, v_wet):
        """The same step on per-layer 2D planes (the sweep kernel's form:
        a Python unroll over layers, no level axis)."""
        L = self.layers
        dt = self.dt
        dx, dy = self.grid.dx, self.grid.dy
        pk = None
        new_us, new_vs, divs = [], [], []
        for k in range(L):
            contrib = float(self._pw[k]) * etas[k]
            pk = contrib if pk is None else pk + contrib
            un = (us[k] - dt * st.ddx(pk, dx)) * u_wet
            vn = (vs[k] - dt * st.ddy(pk, dy)) * v_wet
            new_us.append(un)
            new_vs.append(vn)
            divs.append(st.ddx_back(un, dx) + st.ddy_back(vn, dy))
        acc = None
        new_etas = [None] * L
        for k in range(L - 1, -1, -1):
            contrib = float(self._H[k]) * divs[k]
            acc = contrib if acc is None else acc + contrib
            new_etas[k] = torch.where(t_upd > 0, etas[k] - dt * acc, etas[k])
        return tuple(new_etas) + tuple(new_us) + tuple(new_vs)

    # ------------------------------------------------------------------
    def enable_fast_path(self, steps_per_sweep: int = 1) -> None:
        """Switch to the fused 3L-plane sweep (the JAX package's
        ``enable_pallas``); needs ``halo_width >= K``.  On a CUDA grid
        the layers must fit the kernel (:func:`kernel_tile`); more raise
        here, and nothing falls back to the plain version."""
        if self.grid.device.type != "cpu":
            kernel_tile(self.layers, self.grid.dtype, int(steps_per_sweep))
        super().enable_fast_path(steps_per_sweep)

    def _kernel_variant(self, K: int) -> int:
        """The kernel variant for K; on a CPU grid, where the plain
        version takes any L, layers the kernel cannot take get none (-1,
        which the wrapper refuses for a tensor off the CPU)."""
        try:
            return kernel_variant(self.layers, self.grid.dtype, K)
        except ValueError:
            if self.grid.device.type != "cpu":
                raise
            return -1

    def _sweep_step(self, *planes):
        """:meth:`_layer_step` on the sweep's flat state, the 3L planes
        (etas, us, vs) followed by the decoded masks: the kernel's plain
        version is this step K times."""
        L = self.layers
        return self._layer_step(planes[:L], planes[L:2 * L],
                                planes[2 * L:3 * L], *planes[3 * L:])

    def _prepare(self, aux):
        return st.unpack_mask_bits(aux[0], 3, self.grid.dtype)

    def kernel_constants(self) -> list[float]:
        """The kernel's scalars: dt, dx, dy, the layer count, then the
        pressure weights and thicknesses, zero-padded to
        KERNEL_MAX_LAYERS each."""
        pw = np.zeros(KERNEL_MAX_LAYERS)
        H = np.zeros(KERNEL_MAX_LAYERS)
        n = min(self.layers, KERNEL_MAX_LAYERS)
        pw[:n], H[:n] = self._pw[:n], self._H[:n]
        return [self.dt, self.grid.dx, self.grid.dy, float(self.layers),
                *pw.tolist(), *H.tolist()]

    def _to_planes(self, state):
        """(eta, u, v) level tensors -> the 3L planes (etas, us, vs)."""
        return tuple(f[k] for f in state for k in range(self.layers))

    def _from_planes(self, planes):
        L = self.layers
        return tuple(torch.stack(planes[i * L:(i + 1) * L])
                     for i in range(3))

    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.02,
          layers: int = 3, tmask=None, halo_width: int = 1,
          fused: bool = False, steps_per_sweep: int = 1, dtype=None,
          device=None, **kw) -> NLayerModel:
    """Walled grid (dx = dy = 1) + model on ``device`` (default: the card);
    ``fused``/``steps_per_sweep`` as in :func:`.gravity_wave.build`."""
    halo_width = fast_path_grid_args(fused, steps_per_sweep, 1, halo_width)
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    grid_init(grid, 1.0, 1.0, default_tmask(gnx, gny) if tmask is None
              else tmask)
    model = NLayerModel(grid, dt=dt, layers=layers, **kw)
    if fused:
        model.enable_fast_path(steps_per_sweep=steps_per_sweep)
    elif steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta0, tmask, dx, dy, dt, nsteps, g: float = 9.81,
                     gp=0.02, thickness=None) -> dict:
    """Independent NumPy transcription: explicit per-layer Python loops
    (no cumsum, no level vectorisation) over explicit rolls."""
    eta0 = np.asarray(eta0, np.float64)
    layers = eta0.shape[0]
    pw = np.concatenate(([g], np.broadcast_to(
        np.asarray(gp, np.float64), (max(layers - 1, 1),))[: layers - 1]))
    H = (np.full(layers, 100.0 / layers) if thickness is None
         else np.broadcast_to(np.asarray(thickness, np.float64), (layers,)))
    wet_t = (tmask == 1).astype(np.float64)
    u_wet = wet_t * np.roll(wet_t, -1, axis=1)
    v_wet = wet_t * np.roll(wet_t, -1, axis=0)
    e = eta0.copy()
    u = np.zeros_like(e)
    v = np.zeros_like(e)
    xp = lambda a: np.roll(a, -1, axis=1)  # noqa: E731
    xm = lambda a: np.roll(a, 1, axis=1)   # noqa: E731
    yp = lambda a: np.roll(a, -1, axis=0)  # noqa: E731
    ym = lambda a: np.roll(a, 1, axis=0)   # noqa: E731
    for _ in range(nsteps):
        pk = np.zeros_like(e[0])
        divs = []
        for k in range(layers):
            pk = pk + pw[k] * e[k]
            u[k] = (u[k] - dt * (xp(pk) - pk) / dx) * u_wet
            v[k] = (v[k] - dt * (yp(pk) - pk) / dy) * v_wet
            divs.append((u[k] - xm(u[k])) / dx + (v[k] - ym(v[k])) / dy)
        acc = np.zeros_like(e[0])
        for k in range(layers - 1, -1, -1):
            acc = acc + H[k] * divs[k]
            e[k] = np.where(wet_t > 0, e[k] - dt * acc, e[k])
    return {"eta": e, "u": u, "v": v}
