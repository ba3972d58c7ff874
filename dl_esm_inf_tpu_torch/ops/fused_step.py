"""The fused NEMOLite2D sweep: K whole steps per pass over memory.

Counterpart of ``dl_esm_inf_tpu/ops/pallas_step.py::make_fused_step``.
:func:`make_fused_step` returns ``fused(sshn, un, vn, mask_codes,
forcing, ht=None) -> (ssha, ua, va)`` for one stacked ``(ly, lx)``
block, advancing ``K = len(forcing)`` steps after one depth-2K halo
exchange, with flat bathymetry or the T-point depth plane ``ht``.  With
an ``exchange_spec`` the sweep does that exchange itself, at the full
halo depth (the JAX package's fused transport); across ranks, one tile
per rank, that exchange is the remote-DMA protocol of
:mod:`..parallel.rdma` between the ranks' blocks.  What runs depends only on where the tensors
lie:

* a CUDA tensor launches the hand-written kernel
  ``csrc/nemolite2d_sweep.cu`` through :data:`nemolite2d_sweep` (across
  ranks ``csrc/nemolite2d_sweep_rdma.cu`` through
  :data:`nemolite2d_sweep_rdma`), built with ``nvcc`` at first use (see
  :mod:`.cuda_build`), or raises;
* a CPU tensor runs the kernel's plain PyTorch version: the exchange
  of :mod:`..parallel.halo` where the sweep has one (across ranks the
  protocol simulated over the gathered blocks,
  :func:`..parallel.rdma.exchange` on collective id 2), then
  :func:`fused_step_reference`, K chained
  :func:`..models.nemolite2d.step_math` calls on the whole block with
  the hoisted constants built once (the JAX package's
  ``_make_jnp_sweep``).

Cells within 2K of the block edge hold finite values of no meaning in
both versions (the plain one wraps its shifts around the block, the
kernel clamps its reads to the block); they are halo or padding cells,
which the next exchange overwrites or the masks keep inert.

:func:`make_variant` is the kernel-variant microbench's counterpart of
``scripts/kbench.py::make_variant``: the production sweep's memory floor
(``dma``) and compute floor (``compute``, ``compute_fast``), as the
kernel ``csrc/nemolite2d_variants.cu`` on CUDA tensors and as their
plain versions (:func:`variant_dma_reference`,
:func:`variant_compute_reference`) on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import stencils as st
from ..parallel import environment as env
from ..parallel import rdma
from ..parallel.halo import HaloSpec, _check_rank_layout, exchange_multi
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
    the grouping of ``continuity``/``momentum_u``/``momentum_v``/
    ``make_prep`` (the kernel casts each once to the working type, as the
    plain version's Python scalars are).  Depth-derived values (ht, hu,
    hv, cu, cv) are computed by ``make_prep`` itself in the working
    dtype, so the two versions share them exactly; the variable-depth
    kernel derives them per point and reads only ``g`` of them.  The
    rectangular flag selects the continuity order of ``step_math`` for
    ``dx != dy``."""
    from ..models.nemolite2d import _is_square, make_prep
    pr = make_prep(torch.zeros((1, 1), dtype=torch.int8), depth, p, dtype,
                   dx=dx, dy=dy)
    return [
        p.rdt / dx,                              # cw = (rdt/dx) * t_wet
        p.rdt / dy,                              # rectangular cells
        0.0 if _is_square(dx, dy) else 1.0,      # rect
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


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _check_inputs(what: str, K: int, sshn, un, vn, codes, extra=()):
    """Raise unless the planes are what the kernels take: contiguous
    ``(ly, lx)`` CUDA planes of one float dtype (and the int8 code), and
    1..KMAX sub-steps."""
    if not 1 <= K <= KMAX:
        raise ValueError(f"{what} takes 1..{KMAX} sub-steps, got {K}")
    dev = sshn.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if sshn.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32/float64 state, got "
                        f"{sshn.dtype}")
    if sshn.dim() != 2:
        raise ValueError(f"expected (ly, lx) planes, got {sshn.shape}")
    planes = [("sshn", sshn, sshn.dtype), ("un", un, sshn.dtype),
              ("vn", vn, sshn.dtype), ("mask_codes", codes, torch.int8),
              *extra]
    for name, t, dt in planes[1:]:
        if t.device != dev or t.dtype != dt or t.shape != sshn.shape:
            raise ValueError(
                f"{name}: expected {dt} {tuple(sshn.shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t, _ in planes:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_consts(consts, forcing, n: int) -> list[float]:
    """The launch's constants: the host-folded prefactors, then the K
    sub-steps' forcing padded to KMAX."""
    vals = (list(consts) + [float(f) for f in forcing]
            + [0.0] * (KMAX - len(forcing)))
    if len(vals) != n:
        raise ValueError(f"expected {n - KMAX} constants, got {len(consts)}")
    return vals


class SweepKernel:
    """ctypes wrapper of ``csrc/nemolite2d_sweep.cu``.

    ``launches`` counts the kernel launches this wrapper has made (and
    nothing else); callers may reset it."""

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
        extra = [] if ht is None else [("ht", ht, sshn.dtype)]
        _check_inputs("the sweep kernel", K, sshn, un, vn, codes, extra)
        dev = sshn.device
        remap = None
        if exchange is not None:
            if exchange.array_shape != tuple(sshn.shape):
                raise ValueError(f"exchange spec block {exchange.array_shape}"
                                 f" != sweep block {tuple(sshn.shape)}")
            remap = remap_args(exchange, exchange.halo)
        self.build()
        vals = _launch_consts(consts, forcing, self._nconsts)
        ssha = torch.empty_like(sshn)
        ua = torch.empty_like(un)
        va = torch.empty_like(vn)
        ny, nx = sshn.shape
        err = self._fn(_DTYPE_CODES[sshn.dtype], K, sshn.data_ptr(),
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


class SweepRdmaKernel:
    """ctypes wrapper of ``csrc/nemolite2d_sweep_rdma.cu``: the sweep
    with the exchange between ranks before it (one tile per rank).

    Each call exchanges the state with the neighbouring ranks through
    their windows of collective id 2 (the windows, and the host-side
    check of each call's one hand-off within the exchange's budget, are
    :data:`..parallel.rdma.halo_exchange_rdma`'s) into a staging block,
    then advances K steps.  ``launches`` counts the calls that launched
    (send, signals, waits, merge and sweep are one call, nothing else);
    callers may reset it."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from .cuda_build import load_library
        built = load_library("nemolite2d_sweep_rdma",
                             ("nemolite2d_sweep_rdma.cu",), driver=True)
        if self._fn is None:
            lib = built.lib
            vp, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.nemo_sweep_rdma_launch
            fn.argtypes = ([i, i] + [vp] * 9 + [i, i,
                           ctypes.POINTER(ctypes.c_double), i,
                           ctypes.POINTER(vp),
                           ctypes.POINTER(ctypes.c_longlong), i, vp, vp])
            fn.restype = i
            for name in ("nemo_sweep_rdma_num_consts",
                         "nemo_sweep_rdma_num_geo_ints"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            if lib.nemo_sweep_rdma_num_geo_ints() != rdma.GEO_INTS:
                raise RuntimeError("libnemolite2d_sweep_rdma's geometry "
                                   "does not match rdma.py's")
            self._nconsts = lib.nemo_sweep_rdma_num_consts()
            self._fn = fn
        return built

    def __call__(self, sshn, un, vn, codes, consts, forcing, spec: HaloSpec,
                 ht=None):
        """One sweep of this rank's block after the exchange at the
        spec's full halo depth; collective (every rank calls it)."""
        K = len(forcing)
        extra = [] if ht is None else [("ht", ht, sshn.dtype)]
        _check_inputs("the rdma sweep kernel", K, sshn, un, vn, codes, extra)
        if spec.array_shape != tuple(sshn.shape):
            raise ValueError(f"exchange spec block {spec.array_shape} != "
                             f"sweep block {tuple(sshn.shape)}")
        rdma._check_one_tile(spec)
        _check_rank_layout(spec)
        self.build()
        ex = rdma.halo_exchange_rdma
        win = ex.window(spec, sshn.dtype, (3,), sshn.device,
                        rdma.COLLECTIVE_ID_SWEEP)
        geo, wins, event = ex.protocol_args(win, spec.halo, 3)
        vals = _launch_consts(consts, forcing, self._nconsts)
        xs = torch.empty((3,) + tuple(sshn.shape), dtype=sshn.dtype,
                         device=sshn.device)
        ssha = torch.empty_like(sshn)
        ua = torch.empty_like(un)
        va = torch.empty_like(vn)
        ny, nx = sshn.shape
        stream = torch.cuda.current_stream(sshn.device).cuda_stream
        err = self._fn(_DTYPE_CODES[sshn.dtype], K, sshn.data_ptr(),
                       un.data_ptr(), vn.data_ptr(), codes.data_ptr(),
                       None if ht is None else ht.data_ptr(), xs.data_ptr(),
                       ssha.data_ptr(), ua.data_ptr(), va.data_ptr(), ny, nx,
                       (ctypes.c_double * len(vals))(*vals), len(vals), wins,
                       geo, len(geo), event, stream)
        ex.launched(win, err, "the rdma sweep")
        self.launches += 1
        ex.finish(win, f"the rdma sweep on rank {env.get_rank()}")
        return ssha, ua, va


#: the process's one wrapper of the sweep with the exchange between ranks
nemolite2d_sweep_rdma = SweepRdmaKernel()


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
    does not exchange.  The block is the spec's whole stacked array (this
    rank's block), the K steps must fit its halo (``2K <= halo``) and the
    three state planes share one dtype.  Across ranks the spec must hold
    one tile per rank, as the remote-DMA exchange requires; the sweep is
    then collective.

    Square (``dx == dy``) and rectangular cells both run on the kernel,
    each in the continuity order of :func:`step_math`."""
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
        if ex.num_ranks > 1 and (ex.repx > 1 or ex.repy > 1):
            raise ValueError(
                f"the fused transport across ranks needs one tile per rank "
                f"(the remote-DMA exchange's rule); this decomposition has "
                f"{ex.repy}x{ex.repx} tiles per rank: decompose into one "
                f"tile per rank or use the ppermute transport")
    across = ex is not None and ex.num_ranks > 1
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
            if across:
                sshn, un, vn = rdma.exchange(
                    torch.stack((sshn, un, vn)), ex, ex.halo,
                    cid=rdma.COLLECTIVE_ID_SWEEP).unbind(0)
            elif ex is not None:
                sshn, un, vn = exchange_multi((sshn, un, vn), ex, ex.halo)
            return fused_step_reference(
                sshn, un, vn, mask_codes_i8, forcing, p=p, dx=dx, dy=dy,
                fcor=fcor, depth=depth, ht=ht)
        if consts is None:
            consts = kernel_constants(p, dx, dy, fcor, depth, sshn.dtype)
        if across:
            return nemolite2d_sweep_rdma(sshn, un, vn, mask_codes_i8, consts,
                                         forcing, ex, ht=ht)
        return nemolite2d_sweep(sshn, un, vn, mask_codes_i8, consts, forcing,
                                ht=ht, exchange=ex)

    return fused


# ---------------------------------------------------------------------------
# The kernel-variant microbench (scripts/kbench.py make_variant)
# ---------------------------------------------------------------------------

#: an H100 SM's shared memory, the runtime's reserve per CTA, the largest
#: tile edge in y, the row strips of a CTA and, by K (index K - 1), the
#: CTAs that must share an SM: the tile rule's inputs
#: (csrc/nemolite2d_step.cuh: kSmemPerSM, kSmemReserve, kTileYMax,
#: kRowStrips, kCtasPerSM)
SMEM_PER_SM = 233472
SMEM_RESERVE = 1024
TILE_Y_MAX = 64
ROW_STRIPS = 2
CTAS_PER_SM = (4, 4, 3, 3)
#: columns a warp owns (kOwned)
OWNED_COLUMNS = 29


def smem_budget(K: int) -> int:
    """Shared memory one CTA may take at K sub-steps so that
    ``CTAS_PER_SM[K - 1]`` CTAs share an SM."""
    return SMEM_PER_SM // CTAS_PER_SM[K - 1] - SMEM_RESERVE


class Tile(NamedTuple):
    """A flagship kernel's tile: ``ty x tx`` output points per CTA, the
    CTA's dynamic shared memory and threads."""
    ty: int
    tx: int
    smem_bytes: int
    threads: int


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def tile(dtype, K: int, ht: bool = False) -> Tile:
    """The tile of the flagship kernels (the sweep, across ranks, the
    variants) at ``dtype`` with K sub-steps, flat (``ht`` False) or
    variable depth: the mirror of csrc/nemolite2d_step.cuh ``Tile``.

    64 columns at float32, 32 at float64; the window (the tile and a ring
    of 2K) is staged as 6 planes of the state and the next state (7 with
    the depth), rows padded to 16-byte copies, and the code plane; ``ty``
    is the largest multiple of 4 up to TILE_Y_MAX whose window fits
    :func:`smem_budget`, so that ``CTAS_PER_SM[K - 1]`` CTAs share an SM.
    The CTA has ROW_STRIPS rows of warps, each warp owning OWNED_COLUMNS
    columns."""
    es = torch.empty((), dtype=dtype).element_size()
    R = 2 * K
    tx = 64 if es == 4 else 32
    wx = tx + 2 * R
    v = 16 // es
    off = (v - R % v) % v
    px = _round_up(off + wx, v)
    offc = (16 - R % 16) % 16
    pc = _round_up(offc + wx, 16)
    row = (7 if ht else 6) * px * es + pc
    ty = TILE_Y_MAX
    while ty > 4 and (ty + 2 * R) * row > smem_budget(K):
        ty -= 4
    col_strips = -(-(wx - 2) // OWNED_COLUMNS)
    return Tile(ty, tx, (ty + 2 * R) * row, 32 * col_strips * ROW_STRIPS)


#: what make_variant's modes run: the production sweep, a variant of
#: csrc/nemolite2d_variants.cu, or nothing (``tight`` only records a TPU
#: rule)
VARIANT_MODES = ("prod", "full", "unroll", "dma", "compute", "compute_fast",
                 "tight")


def variant_dma_reference(sshn, un, vn, mask_codes, forcing):
    """Plain version of the ``dma`` variant: ``x + f_0 + ... + f_{K-1}``
    on each state plane, summed in that order, behind the select on the
    code value 127 (never taken) that keeps the kernel's code loads."""
    never = mask_codes == 127
    zero = torch.zeros((), dtype=sshn.dtype, device=sshn.device)
    s = (sshn, un, vn)
    for f in forcing:
        s = tuple(torch.where(never, zero, x + f) for x in s)
    return s


def _tile_windows(a, K: int, t: Tile):
    """Every tile's staged window, ``(ntiles, ty + 4K, tx + 4K)``: the
    tile ``t`` with its ring of 2K cells, reads clamped to the block edge
    (the kernels' staging); and the tile counts ``(nty, ntx)``."""
    ly, lx = a.shape
    R = 2 * K
    nty, ntx = -(-ly // t.ty), -(-lx // t.tx)
    ry = (torch.arange(nty, device=a.device)[:, None] * t.ty - R
          + torch.arange(t.ty + 2 * R, device=a.device)).clamp_(0, ly - 1)
    rx = (torch.arange(ntx, device=a.device)[:, None] * t.tx - R
          + torch.arange(t.tx + 2 * R, device=a.device)).clamp_(0, lx - 1)
    win = a[ry[:, None, :, None], rx[None, :, None, :]]
    return (win.reshape(nty * ntx, t.ty + 2 * R, t.tx + 2 * R),
            (nty, ntx))


def _untile(win, K: int, t: Tile, nty: int, ntx: int, ly: int, lx: int):
    """The tiles (window centres) put back into the ``(ly, lx)`` block."""
    R = 2 * K
    c = (win[:, R:R + t.ty, R:R + t.tx]
         .reshape(nty, ntx, t.ty, t.tx))
    return (c.permute(0, 2, 1, 3).reshape(nty * t.ty, ntx * t.tx)
            [:ly, :lx].contiguous())


def _inset(wy: int, wx: int, r: int, device):
    """The points at least ``r`` cells inside a ``wy x wx`` window."""
    iy = torch.arange(wy, device=device)
    ix = torch.arange(wx, device=device)
    return (((iy >= r) & (iy < wy - r))[:, None]
            & ((ix >= r) & (ix < wx - r))[None, :])


def variant_compute_reference(sshn, un, vn, mask_codes, forcing, reps=1, *,
                              p, dx, dy, fcor, depth, fast=False):
    """Plain version of the ``compute``/``compute_fast`` variants: every
    tile's window (:func:`tile` at the state's dtype, flat depth) staged
    as the kernel stages it, then ``reps`` passes of the K sub-steps
    (:func:`step_math` on the window, kept on the kernel's shrinking
    regions: continuity 2k+1 and momentum 2k+2 cells inside), each
    feeding its output back.  As in the kernel, each sub-step writes the
    new state into scratch planes, which start as copies of the staged
    state and keep their values outside the regions, and then the state
    and the scratch planes swap.  ``fast`` takes :func:`_recip_fast` for
    the two ``1/dep`` divisions: an exact reciprocal and one Newton step,
    where the kernel starts the step from the hardware's approximate
    reciprocal."""
    from ..models.nemolite2d import (_recip_exact, _recip_fast, make_prep,
                                     step_math)
    K = len(forcing)
    ly, lx = sshn.shape
    t = tile(sshn.dtype, K)
    codes, (nty, ntx) = _tile_windows(mask_codes, K, t)
    ssh, u, v = (_tile_windows(a, K, t)[0] for a in (sshn, un, vn))
    s_ssh, s_u, s_v = ssh.clone(), u.clone(), v.clone()
    prep = make_prep(codes, depth, p, sshn.dtype, dx=dx, dy=dy)
    recip = _recip_fast if fast else _recip_exact
    wy, wx, dev = t.ty + 4 * K, t.tx + 4 * K, sshn.device
    regions = [(_inset(wy, wx, 2 * k + 1, dev),
                _inset(wy, wx, 2 * k + 2, dev)) for k in range(K)]
    for _ in range(reps):
        for (ra, rb), f in zip(regions, forcing):
            a, ua, va = step_math(ssh, u, v, codes, p, dx, dy, fcor, depth,
                                  f, recip=recip, prep=prep)
            s_ssh = torch.where(ra, a, s_ssh)
            s_u = torch.where(rb, ua, s_u)
            s_v = torch.where(rb, va, s_v)
            ssh, s_ssh = s_ssh, ssh
            u, s_u = s_u, u
            v, s_v = s_v, v
    return tuple(_untile(w, K, t, nty, ntx, ly, lx) for w in (ssh, u, v))


class VariantKernel:
    """ctypes wrapper of one mode of ``csrc/nemolite2d_variants.cu``
    (``dma``, ``compute`` or ``compute_fast``).

    ``launches`` counts the kernel launches this wrapper has made (and
    nothing else); callers may reset it."""

    _MODES = {"dma": 0, "compute": 1, "compute_fast": 2}

    def __init__(self, mode: str):
        self.mode = mode
        self.launches = 0
        self._fn = None

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from .cuda_build import load_library
        built = load_library("nemolite2d_variants",
                             ("nemolite2d_variants.cu",))
        if self._fn is None:
            fn = built.lib.nemo_variant_launch
            fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                           + [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            nconst = built.lib.nemo_variant_num_consts
            nconst.argtypes = []
            nconst.restype = ctypes.c_int
            self._nconsts = nconst()
            self._fn = fn
        return built

    def __call__(self, sshn, un, vn, codes, consts, forcing, reps=1):
        """One launch: K = len(forcing) sub-steps, ``reps`` passes of
        them for the compute modes (``dma`` takes 1)."""
        what = f"the {self.mode} variant kernel"
        _check_inputs(what, len(forcing), sshn, un, vn, codes)
        if reps < 1 or (self.mode == "dma" and reps != 1):
            raise ValueError(f"{what}: reps must be >= 1 (1 for dma), got "
                             f"{reps}")
        if self.mode == "compute_fast" and sshn.dtype != torch.float32:
            raise TypeError(f"{what} is float32 only, got {sshn.dtype}")
        self.build()
        vals = _launch_consts(consts, forcing, self._nconsts)
        ssha = torch.empty_like(sshn)
        ua = torch.empty_like(un)
        va = torch.empty_like(vn)
        ny, nx = sshn.shape
        err = self._fn(self._MODES[self.mode], _DTYPE_CODES[sshn.dtype],
                       len(forcing), sshn.data_ptr(), un.data_ptr(),
                       vn.data_ptr(), codes.data_ptr(), ssha.data_ptr(),
                       ua.data_ptr(), va.data_ptr(), ny, nx,
                       (ctypes.c_double * len(vals))(*vals), len(vals), reps,
                       torch.cuda.current_stream(sshn.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")
        self.launches += 1
        return ssha, ua, va


#: the process's wrappers of the three variant kernels, one per mode
variant_dma = VariantKernel("dma")
variant_compute = VariantKernel("compute")
variant_compute_fast = VariantKernel("compute_fast")
VARIANT_KERNELS = {k.mode: k for k in (variant_dma, variant_compute,
                                        variant_compute_fast)}


def make_variant(ly: int, lx: int, dtype, p, dx: float, dy: float,
                 fcor: float, depth: float, steps_per_sweep: int = 1,
                 mode: str = "dma"):
    """Build one mode of the kernel-variant microbench for ``(ly, lx)``
    blocks (the counterpart of scripts/kbench.py ``make_variant``):
    ``var(sshn, un, vn, mask_codes_i8, forcing, reps=1) -> (ssha, ua,
    va)`` with ``len(forcing) == steps_per_sweep``, flat depth.

    * ``prod`` (and ``full``, ``unroll``, the TPU's two pipeline
      schedules of the same step): the production sweep,
      :func:`make_fused_step`;
    * ``dma``: the production sweep's loads and stores with a copy for
      the compute (:func:`variant_dma_reference`);
    * ``compute`` / ``compute_fast``: ``reps`` passes of the K sub-steps
      on resident windows, no memory traffic per pass
      (:func:`variant_compute_reference`); ``compute_fast`` is float32
      only;
    * ``tight`` raises: it records a rule of the TPU compiler.

    On CUDA tensors the variants launch ``csrc/nemolite2d_variants.cu``
    (or raise); on CPU tensors they run their plain versions."""
    K = int(steps_per_sweep)
    if not 1 <= K <= KMAX:
        raise ValueError(f"steps_per_sweep must be in [1, {KMAX}], got {K}")
    if mode == "tight":
        raise ValueError(
            "mode 'tight' records a Mosaic rule, not a variant: a TPU "
            "window's rows come in multiples of 8, so Mosaic rejects the "
            "(TY+4)-row window and the production ring is 8 rows; a CUDA "
            "window has no such alignment, so there is nothing to measure")
    if mode not in VARIANT_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{VARIANT_MODES}")
    if mode == "compute_fast" and dtype != torch.float32:
        raise ValueError(f"compute_fast is float32 only (the approximate "
                         f"reciprocal is rcp.approx.f32), got {dtype}")
    if mode in ("prod", "full", "unroll"):
        fused = make_fused_step(ly, lx, dtype, p, dx, dy, fcor, depth,
                                steps_per_sweep=K)

        def prod(sshn, un, vn, mask_codes_i8, forcing, reps=1):
            if reps != 1:
                raise ValueError("reps applies to the compute modes")
            return fused(sshn, un, vn, mask_codes_i8, forcing)
        return prod

    kern = VARIANT_KERNELS[mode]
    consts = None

    def var(sshn, un, vn, mask_codes_i8, forcing, reps=1):
        nonlocal consts
        if len(forcing) != K:
            raise ValueError(f"expected {K} forcing values, got "
                             f"{len(forcing)}")
        if tuple(sshn.shape) != (ly, lx) or sshn.dtype != dtype:
            raise ValueError(f"expected ({ly}, {lx}) {dtype} blocks, got "
                             f"{tuple(sshn.shape)} {sshn.dtype}")
        if reps < 1 or (mode == "dma" and reps != 1):
            raise ValueError(f"reps must be >= 1 (1 for dma), got {reps}")
        if sshn.device.type == "cpu":
            if mode == "dma":
                return variant_dma_reference(sshn, un, vn, mask_codes_i8,
                                             forcing)
            return variant_compute_reference(
                sshn, un, vn, mask_codes_i8, forcing, reps, p=p, dx=dx,
                dy=dy, fcor=fcor, depth=depth, fast=mode == "compute_fast")
        if consts is None:
            consts = kernel_constants(p, dx, dy, fcor, depth, sshn.dtype)
        return kern(sshn, un, vn, mask_codes_i8, consts, forcing, reps=reps)

    return var
