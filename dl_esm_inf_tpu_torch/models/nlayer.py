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
steps per depth-K exchange: the sweep's state is the three (N, ny, nx)
level blocks as they are, advanced by the hand-written kernel
``csrc/nlayer_sweep.cu`` on a CUDA grid and by its plain version
(:meth:`NLayerModel._layer_step` K times) on the CPU.

On the card a CTA stages its tile's window of all 3L planes in shared
memory, so the layer count is bounded only by the 227 KiB a block may
use: :func:`kernel_tile` gives the tile per (L, dtype, K), the
skeleton's tile rule with the column march's widths
(:func:`..ops.stencil_sweep.tile` with ``march=True``) for 3L planes and
the code, ring K, and beyond :data:`COMPILED_LAYERS` the weights beside
the window; it raises where no window fits one CTA (float32, K=8: above
33 layers; float64, K=8: above 16).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.constants import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, OFFSET_NE,
                              T_POINTS, U_POINTS, V_POINTS)
from ..core.field import Field
from ..core.grid import Grid, grid_init
from ..ops import stencils as st
from ..ops.fastpath import SweepClient, fast_path_grid_args
from ..ops.stencil_sweep import (RING, StencilSweepKernel,
                                 stencil_sweep_reference, tile)
from .gravity_wave import (default_tmask, gaussian_eta,  # noqa: F401
                           wet_update_masks)

#: the layer counts compiled into the CUDA kernel's march (the pressures
#: and v of the row below in registers); more take the layer count at
#: run time
COMPILED_LAYERS = 8
#: shared memory a block may use on an H100 (sm_90)
SMEM_LIMIT = 232448


def _bpp(layers: int, dtype) -> int:
    """Shared bytes per window point: 3L planes and the code byte."""
    return 3 * layers * dtype.itemsize + 1


def weight_bytes(layers: int, dtype) -> int:
    """Shared memory beside the window: the run-time variant's weights
    (pw and H in the planes' type, rounded up to 16 bytes); the compiled
    march keeps them in registers."""
    if layers <= COMPILED_LAYERS:
        return 0
    return -(-2 * layers * dtype.itemsize // 16) * 16


def _rule(layers: int, dtype, K: int):
    return tile(K, _bpp(layers, dtype), march=True,
                extra=weight_bytes(layers, dtype))


def kernel_shape(layers: int, dtype, K: int):
    """The kernel's window (:class:`..ops.stencil_sweep.Shape`) for
    ``layers`` at ``dtype`` and K: the skeleton's tile rule with the
    march's widths, for 3L planes and the code (ring K) and the weights
    beside them (:func:`weight_bytes`).  Raises ValueError, naming the
    budget and the most layers that fit, where no window fits the shared
    memory a block may use."""
    shape = _rule(layers, dtype, K)
    if shape is not None:
        return shape
    fits = 0
    while _rule(fits + 1, dtype, K) is not None:
        fits += 1
    raise ValueError(
        f"{layers} layers at {dtype} and K={K} do not fit the shared "
        f"memory budget of a block (227 KiB, {SMEM_LIMIT} B): even an "
        f"8-cell tile's window of {3 * layers} planes does not; at most "
        f"{fits} layers fit")


def kernel_tile(layers: int, dtype, K: int) -> tuple[int, int]:
    """The kernel's tile ``(rows, columns)`` (:func:`kernel_shape`)."""
    shape = kernel_shape(layers, dtype, K)
    return shape.ty, shape.tx


class NLayerSweepKernel(StencilSweepKernel):
    """ctypes wrapper of ``csrc/nlayer_sweep.cu``: K sub-steps on the three
    (L, ny, nx) level blocks eta, u, v (contiguous CUDA tensors of one
    float dtype), with the (ny, nx) int8 mask code and the weights
    (pw[0..L), H[0..L) in the planes' dtype); the outputs are three new
    level blocks.  The layer count is the blocks'; the kernel takes every
    L whose window fits a CTA (:func:`kernel_tile`).  ``launches`` counts
    the launches this wrapper has made."""

    _ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                 ctypes.c_int, ctypes.c_void_p]

    def __init__(self):
        super().__init__("nlayer_sweep", n_state=3, has_code=True,
                         kmax=(RING,))

    def _check_blocks(self, state, code, weights, consts, K):
        if len(state) != 3:
            raise ValueError(f"{self.name}: expected 3 level blocks (eta, "
                             f"u, v), got {len(state)}")
        if not 1 <= K <= self.kmax[0]:
            raise ValueError(f"{self.name} takes 1..{self.kmax[0]} "
                             f"sub-steps, got {K}")
        ref = state[0]
        if ref.device.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got "
                             f"{ref.device}")
        if ref.dtype not in self._DTYPE_CODES:
            raise TypeError(f"{self.name} takes float32/float64 planes, "
                            f"got {ref.dtype}")
        if ref.dim() != 3:
            raise ValueError(f"expected (L, ly, lx) level blocks, got "
                             f"{tuple(ref.shape)}")
        L = ref.shape[0]
        if len(consts) > 3 and consts[3] != L:
            raise ValueError(f"{self.name}: the constants give "
                             f"{consts[3]:g} layers, the blocks {L}")
        named = ([(f"state[{i}]", t, ref.dtype, ref.shape)
                  for i, t in enumerate(state)]
                 + [("mask_codes", code, torch.int8, ref.shape[1:]),
                    ("weights", weights, ref.dtype, (2 * L,))])
        for name, t, dt, shape in named:
            if t.device != ref.device or t.dtype != dt or t.shape != shape:
                raise ValueError(
                    f"{name}: expected {dt} {tuple(shape)} on {ref.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        kernel_shape(L, ref.dtype, K)

    def __call__(self, state, code, weights, *, consts, K: int):
        """Advance the level blocks ``state`` by K steps; returns new
        blocks."""
        state = tuple(state)
        self._check_blocks(state, code, weights, consts, K)
        self.build()
        if len(consts) != self._nconsts:
            raise ValueError(f"{self.name}: expected {self._nconsts} "
                             f"constants, got {len(consts)}")
        out = tuple(torch.empty_like(s) for s in state)

        def ptrs(ts):
            return (ctypes.c_void_p * 3)(*(t.data_ptr() for t in ts))
        _, ny, nx = state[0].shape
        err = self._fn(self._DTYPE_CODES[state[0].dtype], K, ptrs(state),
                       ptrs(out), weights.data_ptr(), code.data_ptr(), ny,
                       nx, (ctypes.c_double * len(consts))(*consts),
                       len(consts),
                       torch.cuda.current_stream(state[0].device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out

    def threads(self, dtype, layers: int, K: int) -> int:
        """Threads a CTA the kernel launches with for ``layers`` layers of
        ``dtype`` and K (0 where no window fits), as the library plans
        its launch; builds the library."""
        fn = self.build().lib.nlayer_sweep_threads
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return fn(self._DTYPE_CODES[dtype], layers, K)


#: the process's one wrapper of the N-layer sweep kernel
nlayer_sweep = NLayerSweepKernel()


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
        self._weights = {}
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
        """Switch to the fused sweep of the level blocks (the JAX package's
        ``enable_pallas``); needs ``halo_width >= K``.  On a CUDA grid
        the layers must fit the kernel (:func:`kernel_tile`); more raise
        here, and nothing falls back to the plain version."""
        if self.grid.device.type != "cpu":
            kernel_tile(self.layers, self.grid.dtype, int(steps_per_sweep))
        super().enable_fast_path(steps_per_sweep)

    def _sweep_step(self, eta, u, v, *masks):
        """:meth:`_layer_step` on the sweep's state, the three (L, ly, lx)
        level blocks, followed by the decoded masks: the kernel's plain
        version is this step K times."""
        out = self._layer_step(eta.unbind(0), u.unbind(0), v.unbind(0),
                               *masks)
        L = self.layers
        return tuple(torch.stack(out[i * L:(i + 1) * L]) for i in range(3))

    def _prepare(self, aux):
        return st.unpack_mask_bits(aux[0], 3, self.grid.dtype)

    def kernel_constants(self) -> list[float]:
        """The kernel's scalars: dt, dx, dy and the layer count (the
        weights go in :meth:`kernel_weights`).

        The kernel multiplies by 1/dx and 1/dy rounded in the planes'
        dtype, because PyTorch's CUDA division of a tensor by a Python
        scalar (``st.ddx(pk, dx)`` in :meth:`_layer_step`) is that
        product; the CPU's plain version divides, which is the same only
        where dx and dy are powers of two.  The card test
        ``test_nlayer_kernel_other_spacings`` (tests/test_torch_gpu.py)
        holds the kernel bitwise to the plain version at spacings 0.7 x
        1.3 and fails if a PyTorch version divides instead."""
        return [self.dt, self.grid.dx, self.grid.dy, float(self.layers)]

    def kernel_weights(self, like: torch.Tensor) -> torch.Tensor:
        """pw[0..L) then H[0..L), in the dtype and on the device of
        ``like`` (rounded once from double, as the plain step rounds
        them), made once per dtype and device."""
        key = (like.dtype, like.device)
        if key not in self._weights:
            self._weights[key] = torch.tensor(
                np.concatenate([self._pw, self._H]), dtype=like.dtype,
                device=like.device)
        return self._weights[key]

    def _make_sweep(self, K: int):
        """The fused K-step sweep on the level blocks: the CUDA kernel
        for CUDA tensors, its plain version for CPU tensors."""
        if K not in self._sweep_cache:
            consts = self.kernel_constants()

            def sweep(state, aux):
                if state[0].device.type == "cpu":
                    return stencil_sweep_reference(
                        self._sweep_step, K, state, self._prepare(aux))
                return nlayer_sweep(state, aux[0],
                                    self.kernel_weights(state[0]),
                                    consts=consts, K=K)
            self._sweep_cache[K] = sweep
        return self._sweep_cache[K]

    def step_program(self, nsteps: int, remat_chunk: int | None = None):
        """The K-step schedule of :class:`SweepClient`; the N-layer model
        has no checkpointed loop (the JAX package's ``step_program``
        takes no ``remat_chunk``), so a ``remat_chunk`` raises."""
        if remat_chunk is not None:
            raise TypeError("the N-layer model's step_program takes no "
                            "remat_chunk (it has no checkpointed loop)")
        return super().step_program(nsteps)

    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.02,
          layers: int = 3, tmask=None, halo_width: int = 1,
          fused: bool = False, steps_per_sweep: int = 1, dtype=None,
          device=None, dx: float = 1.0, dy: float = 1.0,
          **kw) -> NLayerModel:
    """Walled grid (spacings dx, dy; the JAX package's build takes 1)
    + model on ``device`` (default: the card); ``fused``/
    ``steps_per_sweep`` as in :func:`.gravity_wave.build`."""
    halo_width = fast_path_grid_args(fused, steps_per_sweep, 1, halo_width)
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                dtype=dtype, device=device)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    grid_init(grid, dx, dy, default_tmask(gnx, gny) if tmask is None
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
