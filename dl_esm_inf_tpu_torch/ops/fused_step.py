"""The fused NEMOLite2D sweep: K whole steps per pass over memory.

Counterpart of ``dl_esm_inf_tpu/ops/pallas_step.py::make_fused_step``.
:func:`make_fused_step` returns ``fused(sshn, un, vn, mask_codes,
forcing, ht=None) -> (ssha, ua, va)`` for one stacked ``(ly, lx)``
block, advancing ``K = len(forcing)`` steps after one depth-2K halo
exchange, with flat bathymetry or the T-point depth plane ``ht``.  With
an ``exchange_spec`` the sweep does that exchange itself, at the full
halo depth (the JAX package's fused transport).  What runs depends only
on where the tensors lie:

* a CUDA tensor launches the hand-written kernel
  ``csrc/nemolite2d_sweep.cu`` through :data:`nemolite2d_sweep`
  (built with ``nvcc`` at first use, see :mod:`.cuda_build`), or raises;
* a CPU tensor runs the kernel's plain PyTorch version: the exchange
  of :mod:`..parallel.halo` where the sweep has one, then
  :func:`fused_step_reference`, K chained
  :func:`..models.nemolite2d.step_math` calls on the whole block with
  the hoisted constants built once (the JAX package's
  ``_make_jnp_sweep``).

Cells within 2K of the block edge hold finite values of no meaning in
both versions (the plain one wraps its shifts around the block, the
kernel clamps its reads to the block); they are halo or padding cells,
which the next exchange overwrites or the masks keep inert.
"""
from __future__ import annotations

import ctypes

import torch

from . import stencils as st
from ..parallel.halo import HaloSpec, exchange_multi
from ..parallel.halo_kernel import remap_args

#: the kernel's ceiling on sub-steps per sweep (its ring is 2K cells)
KMAX = 4


def fused_step_reference(sshn, un, vn, mask_codes, forcing, *, p, dx, dy,
                         fcor, depth, ht=None):
    """K = len(forcing) chained steps on the whole block (plain
    PyTorch).  ``depth`` is the flat bathymetry, ignored when the T-point
    plane ``ht`` is given."""
    from ..models.nemolite2d import make_prep, step_math
    dep = (ht, st.avg_x(ht), st.avg_y(ht)) if ht is not None else depth
    prep = make_prep(mask_codes, dep, p, sshn.dtype, dx=dx, dy=dy)
    s = (sshn, un, vn)
    for f in forcing:
        s = step_math(*s, mask_codes, p, dx, dy, fcor, dep, forcing=f,
                      exch_mid=None, prep=prep)
    return s


def kernel_constants(p, dx: float, dy: float, fcor: float, depth: float,
                     dtype: torch.dtype) -> list[float]:
    """The kernel's scalar prefactors, folded on the host in double in
    the grouping of ``momentum_u``/``momentum_v``/``make_prep`` (the
    kernel casts each once to the working type, as the plain version's
    Python scalars are).  Depth-derived values (ht, hu, hv, cu, cv) are
    computed by ``make_prep`` itself in the working dtype, so the two
    versions share them exactly; the variable-depth kernel derives them
    per point and reads only ``g`` of them."""
    from ..models.nemolite2d import make_prep
    pr = make_prep(torch.zeros((1, 1), dtype=torch.int8), depth, p, dtype,
                   dx=dx, dy=dy)
    return [
        p.rdt / dx,                              # cw = (rdt/dx) * t_wet
        1.0 / (1.0 + p.cbfr * p.rdt),            # fric
        float(pr.ht), float(pr.hu), float(pr.hv),
        float(pr.cu), float(pr.cv),
        # momentum_u
        -0.5 * p.rdt / dx, p.rdt * p.visc / (dx * dx),
        -0.25 * p.rdt / dy, 0.5 * p.rdt * p.visc / (dy * dy),
        0.25 * p.rdt * fcor, -p.rdt * p.g / dx,
        # momentum_v
        -0.5 * p.rdt / dy, p.rdt * p.visc / (dy * dy),
        -0.25 * p.rdt / dx, 0.5 * p.rdt * p.visc / (dx * dx),
        -0.25 * p.rdt * fcor, -p.rdt * p.g / dy,
        p.g,
    ]


class SweepKernel:
    """ctypes wrapper of ``csrc/nemolite2d_sweep.cu``.

    ``launches`` counts the kernel launches this wrapper has made (and
    nothing else); callers may reset it."""

    _DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

    def __init__(self):
        self.launches = 0
        self._fn = None

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from .cuda_build import load_library
        built = load_library("nemolite2d_sweep", ("nemolite2d_sweep.cu",))
        if self._fn is None:
            fn = built.lib.nemo_sweep_launch
            fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 8
                           + [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            nconst = built.lib.nemo_sweep_num_consts
            nconst.argtypes = []
            nconst.restype = ctypes.c_int
            self._nconsts = nconst()
            self._fn = fn
        return built

    def __call__(self, sshn, un, vn, codes, consts, forcing, ht=None,
                 exchange: HaloSpec | None = None):
        """One sweep; ``ht`` selects the variable-depth variant and
        ``exchange`` the one that exchanges the state at the spec's full
        halo depth while it stages it."""
        K = len(forcing)
        if not 1 <= K <= KMAX:
            raise ValueError(f"the sweep kernel takes 1..{KMAX} sub-steps, "
                             f"got {K}")
        dev = sshn.device
        if dev.type != "cuda":
            raise ValueError(f"the sweep kernel needs CUDA tensors, got {dev}")
        if sshn.dtype not in self._DTYPE_CODES:
            raise TypeError(f"the sweep kernel takes float32/float64 state, "
                            f"got {sshn.dtype}")
        if sshn.dim() != 2:
            raise ValueError(f"expected (ly, lx) planes, got {sshn.shape}")
        planes = [("sshn", sshn, sshn.dtype), ("un", un, sshn.dtype),
                  ("vn", vn, sshn.dtype), ("mask_codes", codes, torch.int8)]
        if ht is not None:
            planes.append(("ht", ht, sshn.dtype))
        for name, t, dt in planes[1:]:
            if t.device != dev or t.dtype != dt or t.shape != sshn.shape:
                raise ValueError(
                    f"{name}: expected {dt} {tuple(sshn.shape)} on {dev}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        for name, t, _ in planes:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        remap = None
        if exchange is not None:
            if exchange.array_shape != tuple(sshn.shape):
                raise ValueError(f"exchange spec block {exchange.array_shape}"
                                 f" != sweep block {tuple(sshn.shape)}")
            remap = remap_args(exchange, exchange.halo)
        self.build()
        vals = list(consts) + [float(f) for f in forcing] + [0.0] * (KMAX - K)
        if len(vals) != self._nconsts:
            raise ValueError(f"expected {self._nconsts - KMAX} constants, "
                             f"got {len(consts)}")
        ssha = torch.empty_like(sshn)
        ua = torch.empty_like(un)
        va = torch.empty_like(vn)
        ny, nx = sshn.shape
        err = self._fn(self._DTYPE_CODES[sshn.dtype], K, sshn.data_ptr(),
                       un.data_ptr(), vn.data_ptr(), codes.data_ptr(),
                       None if ht is None else ht.data_ptr(),
                       ssha.data_ptr(), ua.data_ptr(), va.data_ptr(), ny, nx,
                       (ctypes.c_double * len(vals))(*vals), len(vals),
                       remap, 0 if remap is None else len(remap),
                       torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"nemolite2d sweep kernel launch failed: "
                               f"CUDA error {err}")
        self.launches += 1
        return ssha, ua, va


#: the process's one wrapper of the NEMOLite2D sweep kernel
nemolite2d_sweep = SweepKernel()


def make_fused_step(ly: int, lx: int, dtype, p, dx: float, dy: float,
                    fcor: float, depth: float, steps_per_sweep: int = 1,
                    variable_bathy: bool = False,
                    exchange_spec: HaloSpec | None = None):
    """Build the fused K-step callable for ``(ly, lx)`` blocks:
    ``fused(sshn, un, vn, mask_codes_i8, forcing, ht=None)`` with
    ``len(forcing) == steps_per_sweep``; ``ht`` is the T-point depth
    plane when ``variable_bathy`` (``depth`` is then ignored).

    ``exchange_spec``: the sweep exchanges the state (not ``ht`` or the
    mask codes, which do not change) at the spec's full halo depth before
    its K steps, as the JAX package's fused transport does: the caller
    does not exchange.  The block is the spec's whole stacked array, the
    K steps must fit its halo (``2K <= halo``) and the three state planes
    share one dtype.

    The CUDA kernel covers the square-cell (``dx == dy``) configuration
    that ``build`` makes; on CUDA tensors other cells raise
    ``NotImplementedError``."""
    K = int(steps_per_sweep)
    if not 1 <= K <= KMAX:
        raise ValueError(f"steps_per_sweep must be in [1, {KMAX}], got {K}")
    ex = exchange_spec
    if ex is not None:
        if ex.array_shape != (ly, lx):
            raise ValueError(f"exchange_spec block {ex.array_shape} != "
                             f"sweep block {(ly, lx)}")
        if 2 * K > ex.halo:
            raise ValueError(f"fused exchange needs halo >= the whole-sweep "
                             f"erosion {2 * K}, spec has {ex.halo}")
    consts = None

    def fused(sshn, un, vn, mask_codes_i8, forcing, ht=None):
        nonlocal consts
        if len(forcing) != K:
            raise ValueError(f"expected {K} forcing values, got "
                             f"{len(forcing)}")
        if tuple(sshn.shape) != (ly, lx) or sshn.dtype != dtype:
            raise ValueError(f"expected ({ly}, {lx}) {dtype} blocks, got "
                             f"{tuple(sshn.shape)} {sshn.dtype}")
        if ex is not None and not un.dtype == vn.dtype == sshn.dtype:
            raise ValueError("fused exchange requires uniform state dtypes; "
                             "use the ppermute transport for mixed-dtype "
                             "state")
        if variable_bathy and ht is None:
            raise ValueError("variable_bathy: pass the depth plane ht")
        ht = ht if variable_bathy else None
        if sshn.device.type == "cpu":
            if ex is not None:
                sshn, un, vn = exchange_multi((sshn, un, vn), ex, ex.halo)
            return fused_step_reference(
                sshn, un, vn, mask_codes_i8, forcing, p=p, dx=dx, dy=dy,
                fcor=fcor, depth=depth, ht=ht)
        if dx != dy:
            raise NotImplementedError(
                "the CUDA sweep kernel implements the square-cell path "
                f"(dx == dy); got dx={dx}, dy={dy}")
        if consts is None:
            consts = kernel_constants(p, dx, dy, fcor, depth, sshn.dtype)
        return nemolite2d_sweep(sshn, un, vn, mask_codes_i8, consts, forcing,
                                ht=ht, exchange=ex)

    return fused
