"""The temporal-blocked stencil sweep of the client models.

Counterpart of ``dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep``
without the fused exchange: K applications of a model's one-step
function per pass over memory, after one halo exchange of depth
``K * reach``.  :func:`make_sweep` returns ``sweep(state, aux) ->
state`` for one stacked block; what runs depends only on where the
tensors lie:

* a CPU tensor runs :func:`stencil_sweep_reference`, the kernels' plain
  PyTorch version: the model's step applied K times on the whole block
  (the JAX package's jnp sweep schedule);
* a CUDA tensor launches the model's hand-written kernel
  ``csrc/<name>.cu`` (built on the shared skeleton
  ``csrc/stencil_sweep.cuh``) through a :class:`StencilSweepKernel`, or
  raises.

Cells within ``K * reach`` of the block edge hold finite values of no
meaning in both versions (the plain one wraps its shifts around the
block, the kernel clamps its reads to the block); they are halo or
padding cells, which the next exchange overwrites or the masks keep
inert.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

#: the kernels' ceiling on ring cells per side, K * reach (as the JAX
#: package's window ring)
RING = 8

#: the skeleton's tile rule (csrc/stencil_sweep.cuh: kSmemPerSM,
#: kSmemReserve, kCtasPerSM, kTileYMax, kTileYMin, kMaxOverhead,
#: kWindowX, kSquares): an H100 SM's shared memory and the runtime's
#: reserve per CTA, the CTAs that should share an SM, the tile's most and
#: least rows, the ring overhead (window area over tile area, in
#: 1/1024ths) above which fewer CTAs per SM are tried, the window widths
#: and the square tiles
SMEM_PER_SM = 233472
SMEM_RESERVE = 1024
CTAS_PER_SM = 3
TILE_Y_MAX = 40
TILE_Y_MIN = 8
MAX_OVERHEAD = 2560
WINDOW_X = (96, 64, 32)
SQUARES = (32, 16, 8)
#: the march's owned columns of a warp (kMarchLanes)
MARCH_LANES = 31
#: the scratch form's window columns (kScratchWX)
SCRATCH_WX = 32
#: the cluster form's cluster sizes, smallest first (kClusters; none of 2
#: CTAs: a window two CTAs hold within MAX_OVERHEAD, one CTA holds on an
#: 8-cell square)
CLUSTERS = (4, 8, 16)


class Shape(NamedTuple):
    """A skeleton sweep's tile and window: ``ty x tx`` output points,
    ``rl`` window columns left of the tile, ``wx`` window columns, and
    the CTAs per SM the rule aimed at."""
    ty: int
    tx: int
    rl: int
    wx: int
    ctas: int

    def window_bytes(self, ring: int, bpp: int) -> int:
        """Shared memory of the window: ``ty + 2 ring`` rows of ``wx``
        points of ``bpp`` bytes."""
        return (self.ty + 2 * ring) * self.wx * bpp


def _overhead(s: Shape, ring: int) -> int:
    return (s.ty + 2 * ring) * s.wx * 1024 // (s.ty * s.tx)


def march_width(ring: int, n: int) -> int:
    """The march's window width for ``n`` column strips (the header's
    ``march_width``): the tile's columns, a multiple of 4, and the ring
    on both sides less one column fill ``n`` strips of MARCH_LANES."""
    tx = (MARCH_LANES * n - 2 * ring + 1) // 4 * 4
    rl = -(-ring // 4) * 4
    return -(-(rl + tx + ring) // 4) * 4


def march_threads(s: Shape, ring: int, warps: int, rows: int) -> int:
    """The march's threads a CTA (the header's ``march_threads``): the
    column strips of MARCH_LANES owned lanes that the tile's columns and
    the ring less one column need, times row strips of about ``rows``
    window rows, at most ``warps`` warps over the ``s.ctas`` CTAs of an
    SM (at least one row strip)."""
    nx = -(-(s.tx + 2 * ring - 1) // MARCH_LANES)
    want = -(-(s.ty + 2 * ring) // rows)
    most = warps // s.ctas // nx
    return 32 * nx * (want if want < most else most if most > 1 else 1)


def tile(ring: int, bpp: int, wx: int = 0, ty_max: int = TILE_Y_MAX,
         march: bool = False, extra: int = 0) -> Shape | None:
    """The skeleton's tile for a ring of ``ring`` cells and ``bpp``
    shared bytes per window point (every staged and scratch plane), a
    window width fixed by the kernel (``wx``; 0: the rule's) and a most
    rows: the mirror of csrc/stencil_sweep.cuh ``pick_shape``.  With
    ``march``, the widths are the column march's (:func:`march_width`
    of 3, 2, 1 strips, and the squares only at one CTA per SM);
    ``extra`` bytes per CTA sit beside the window.  None where no window
    fits a CTA.

    For ``CTAS_PER_SM`` CTAs per SM down to one: each width of
    WINDOW_X (or ``wx``) with ``rl`` = the ring rounded up to 4 and the
    tile's columns what leaves at least the ring on the right, rounded
    down to 4, gets the tallest tile (a multiple of 4 from TILE_Y_MIN
    to ``ty_max``) whose window fits the CTA's share of the SM, and the
    least ring overhead wins (where no width fits, among the SQUARES
    with the ring on every side); it is taken if its overhead is at most
    MAX_OVERHEAD or at one CTA per SM."""
    rl = -(-ring // 4) * 4
    widths = ((wx,) if wx else tuple(march_width(ring, n) for n in (3, 2, 1))
              if march else WINDOW_X)
    for c in range(CTAS_PER_SM, 0, -1):
        budget = SMEM_PER_SM // c - SMEM_RESERVE - extra
        cands = []
        for w in widths:
            tx = (w - rl - ring) // 4 * 4
            ty = ty_max
            while ty >= TILE_Y_MIN and (ty + 2 * ring) * w * bpp > budget:
                ty -= 4
            if tx >= 8 and ty >= TILE_Y_MIN:
                cands.append(Shape(ty, tx, rl, w, c))
        for e in (() if wx or cands or (march and c > 1) else SQUARES):
            if (e + 2 * ring) ** 2 * bpp <= budget:
                cands.append(Shape(e, e, ring, e + 2 * ring, c))
        best = None
        for s in cands:          # the first of equal overheads, as the header
            if best is None or _overhead(s, ring) < _overhead(best, ring):
                best = s
        if best is not None and (c == 1 or _overhead(best, ring)
                                 <= MAX_OVERHEAD):
            return best
    return None


def scratch_tile(ring: int) -> Shape:
    """The scratch form's tile for ``ring`` (the header's
    ``scratch_shape``): 8 rows, a 32-column window with the ring rounded
    up to 4 on its left and at least the ring on its right; ``ctas`` 0,
    as its CTA count is set at launch."""
    rl = -(-ring // 4) * 4
    return Shape(TILE_Y_MIN, (SCRATCH_WX - rl - ring) // 4 * 4, rl,
                 SCRATCH_WX, 0)


def cluster_tile(ring: int, bpp: int,
                 ty_max: int = TILE_Y_MAX) -> tuple[Shape, int] | None:
    """``(shape, cluster)``: the cluster form's tile (the header's
    ``cluster_shape``) for a window of ``bpp`` bytes per point and
    ``ring``, split by rows over the ``cluster`` CTAs of a thread-block
    cluster, one CTA an SM, each holding :func:`band_rows` of its rows;
    ``ctas`` 0, as its CTA count is set at launch.  None
    where no cluster holds a window of TILE_Y_MIN tile rows.

    For each of CLUSTERS, smallest first: each width of WINDOW_X gets the
    tallest tile (a multiple of 4 from TILE_Y_MIN to ``ty_max``) whose
    window rows the cluster's CTAs hold, and the least ring overhead wins
    (the first of equal ones); it is taken if its overhead is at most
    MAX_OVERHEAD or at the largest cluster."""
    rl = -(-ring // 4) * 4
    budget = SMEM_PER_SM - SMEM_RESERVE
    for c in CLUSTERS:
        best = None
        for w in WINDOW_X:
            tx = (w - rl - ring) // 4 * 4
            rows = c * (budget // (w * bpp))
            ty = ty_max
            while ty >= TILE_Y_MIN and ty + 2 * ring > rows:
                ty -= 4
            if tx >= 8 and ty >= TILE_Y_MIN:
                s = Shape(ty, tx, rl, w, 0)
                if best is None or _overhead(s, ring) < _overhead(best, ring):
                    best = s
        if best is not None and (c == CLUSTERS[-1] or _overhead(best, ring)
                                 <= MAX_OVERHEAD):
            return best, c
    return None


def band_rows(shape: Shape, ring: int, cluster: int) -> int:
    """The window rows one CTA of the cluster form holds (the header's
    ``ClusterGeom::BR``)."""
    return -(-(shape.ty + 2 * ring) // cluster)


def reciprocal(x: float, dtype) -> float:
    """``1 / x`` rounded once in ``dtype``: the factor PyTorch's CUDA
    ``tensor / x`` (``x`` a Python scalar) multiplies by, which its host
    code computes before the launch."""
    return float(torch.ones((), dtype=dtype) / torch.tensor(x, dtype=dtype))


def stencil_sweep_reference(step_fn, K: int, state, aux=(), scalars=None):
    """``step_fn(*state, *aux) -> state`` applied K times (plain
    PyTorch).  With ``scalars`` (K rows of per-sub-step scalars, the JAX
    sweep's SMEM scalars), sub-step k calls
    ``step_fn(*state, *aux, *scalars[k])``."""
    s = tuple(state)
    for k in range(K):
        extra = () if scalars is None else tuple(scalars[k])
        s = tuple(step_fn(*s, *aux, *extra))
    return s


class StencilSweepKernel:
    """ctypes wrapper of one client kernel, ``csrc/<name>.cu``.

    The kernel takes ``n_state`` float planes in and out, ``n_aux``
    float aux planes and, with ``has_code``, the int8 mask code, all
    contiguous ``(ny, nx)`` CUDA tensors of one float dtype.
    ``kmax[variant]`` is its ceiling on K; a kernel whose variants take
    different plane counts gives ``n_state`` per variant (a tuple), where
    a variant that takes several counts gives them as a ``range``.
    ``launches`` counts the kernel launches this wrapper has made (and
    nothing else); callers may reset it."""

    _DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
    #: ``<name>_launch``'s arguments: dtype code, K, variant, in, out,
    #: aux, code, ny, nx, consts, their count, stream
    _ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                 ctypes.c_int, ctypes.c_void_p]

    def __init__(self, name: str, *, n_state: int, n_aux: int = 0,
                 has_code: bool = False, kmax=(RING,)):
        self.name = name
        self.source = f"{name}.cu"
        self.n_state = n_state
        self.n_aux = n_aux
        self.has_code = has_code
        self.kmax = tuple(kmax)
        self.launches = 0
        self._fn = None
        self._nconsts = None

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from .cuda_build import load_library
        built = load_library(self.name, (self.source,))
        if self._fn is None:
            fn = getattr(built.lib, f"{self.name}_launch")
            fn.argtypes = self._ARGTYPES
            fn.restype = ctypes.c_int
            nconst = getattr(built.lib, f"{self.name}_num_consts")
            nconst.argtypes = []
            nconst.restype = ctypes.c_int
            self._nconsts = nconst()
            self._fn = fn
        return built

    def _check(self, state, aux, code, K, variant):
        if not 0 <= variant < len(self.kmax):
            raise ValueError(f"{self.name}: no variant {variant} (takes "
                             f"0..{len(self.kmax) - 1})")
        n_state = (self.n_state[variant] if isinstance(self.n_state, tuple)
                   else self.n_state)
        counts = n_state if isinstance(n_state, range) else (n_state,)
        if len(state) not in counts or len(aux) != self.n_aux:
            want = (f"{n_state.start}..{n_state[-1]} (step {n_state.step})"
                    if isinstance(n_state, range) else n_state)
            raise ValueError(
                f"{self.name}: expected {want} state and "
                f"{self.n_aux} aux planes, got {len(state)} and {len(aux)}")
        if (code is None) == self.has_code:
            raise ValueError(f"{self.name}: the mask code is "
                             f"{'required' if self.has_code else 'not taken'}")
        if not 1 <= K <= self.kmax[variant]:
            raise ValueError(f"{self.name} takes 1..{self.kmax[variant]} "
                             f"sub-steps, got {K}")
        ref = state[0]
        if ref.device.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got "
                             f"{ref.device}")
        if ref.dtype not in self._DTYPE_CODES:
            raise TypeError(f"{self.name} takes float32/float64 planes, "
                            f"got {ref.dtype}")
        if ref.dim() != 2:
            raise ValueError(f"expected (ly, lx) planes, got "
                             f"{tuple(ref.shape)}")
        named = ([(f"state[{i}]", t, ref.dtype) for i, t in enumerate(state)]
                 + [(f"aux[{i}]", t, ref.dtype) for i, t in enumerate(aux)]
                 + ([("mask_codes", code, torch.int8)] if self.has_code
                    else []))
        for name, t, dt in named:
            if t.device != ref.device or t.dtype != dt or t.shape != ref.shape:
                raise ValueError(
                    f"{name}: expected {dt} {tuple(ref.shape)} on "
                    f"{ref.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    def __call__(self, state, aux=(), code=None, *, consts, K: int,
                 variant: int = 0):
        """Advance ``state`` by K steps; returns new tensors."""
        state, aux = tuple(state), tuple(aux)
        self._check(state, aux, code, K, variant)
        self.build()
        if len(consts) != self._nconsts:
            raise ValueError(f"{self.name}: expected {self._nconsts} "
                             f"constants, got {len(consts)}")
        out = tuple(torch.empty_like(s) for s in state)

        def ptrs(ts):
            return (ctypes.c_void_p * max(len(ts), 1))(
                *(t.data_ptr() for t in ts))
        ny, nx = state[0].shape
        dev = state[0].device
        err = self._fn(self._DTYPE_CODES[state[0].dtype], K, variant,
                       ptrs(state), ptrs(out), ptrs(aux),
                       code.data_ptr() if code is not None else None, ny, nx,
                       (ctypes.c_double * len(consts))(*consts), len(consts),
                       torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out


def make_sweep(kernel: StencilSweepKernel, step_fn, *, K: int, consts,
               prepare, variant: int = 0):
    """``sweep(state, aux) -> state``: K steps of ``step_fn`` on one
    stacked block.  ``aux`` holds the kernel's float aux planes and then,
    if it takes one, the int8 mask code (the JAX sweep's aux);
    ``prepare(aux)`` turns them into the plain step's trailing
    arguments (decoded masks)."""
    consts = [float(c) for c in consts]

    def sweep(state, aux):
        if state[0].device.type == "cpu":
            return stencil_sweep_reference(step_fn, K, state, prepare(aux))
        planes = tuple(aux[:kernel.n_aux])
        code = aux[kernel.n_aux] if kernel.has_code else None
        return kernel(state, planes, code, consts=consts, K=K,
                      variant=variant)
    return sweep
