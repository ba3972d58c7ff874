"""The halo exchange between ranks through peer memory, with its fence.

Counterpart of ``dl_esm_inf_tpu/parallel/rdma.py`` (the shared pieces
of the TPU's remote-DMA transports) and of the multi-device path of
``dl_esm_inf_tpu/parallel/halo_pallas.py::make_block_exchange``.  With
one tile per rank, :func:`exchange` refreshes a rank's halo ring by
writing its edge strips straight into its neighbours' memory:

* a CUDA block launches the hand-written kernel
  ``csrc/halo_exchange_rdma.cu`` through :data:`halo_exchange_rdma` (built
  with ``nvcc`` at first use), or raises;
* a CPU block runs the kernel's plain version, :func:`exchange_reference`:
  the same protocol simulated in one process over every rank's block
  (gathered through the process group), with :class:`FenceModel` for
  the counting semaphores.

The flagship's fused transport across ranks
(``csrc/nemolite2d_sweep_rdma.cu``, wrapped by
:mod:`..ops.fused_step`) runs the same protocol on the state's three
planes at the full halo depth, on collective id
:data:`COLLECTIVE_ID_SWEEP` and a window of its own; its plain version is
:func:`exchange` with that id on the stacked planes.

The protocol (``halo_pallas.py:114-261``): a whole-block copy; the entry
barrier on the kernel's collective id; then per phase (x, then y) the
readiness fence, the edge strips written into the neighbours' landing
buffers, a delivery signal, a wait for this rank's own deliveries, and
the merge where the rank has a neighbour.  Neighbours are wrap-indexed on
every axis that exchanges, so every rank signals and waits the same
counts; a walled edge merges nothing.

**The fence** (``csrc/rdma_fence.cuh``, mirrored by :class:`FenceModel`):
per-(phase, direction) counting semaphores, where each wait consumes
exactly one signal.  A wait can only be satisfied by a signal of its own
phase and direction, and counts persist across calls, so a fast peer one
or two calls ahead is buffered.  Every wait on the card is bounded by a
budget (:data:`BUDGET_S`); one that runs out makes the wrapper
raise.

**The windows.**  Each rank allocates, once per ``(collective id, spec,
dtype, lead, device)``, one window with ``cudaMalloc`` (the slots, a status pair and
four landing buffers sized for the halo width), exports it with
``cudaIpcGetMemHandle``, exchanges the handles with
``dist.all_gather_object`` and opens its neighbours' (:func:`window`).
:func:`close_windows` closes them; :func:`..environment.finalise` calls
it after a barrier, before the process group goes.  The collective id
in the key keeps a sweep's signals and a standalone exchange's apart:
neither can consume the other's, whatever order they run in.  IPC needs
the peers
on one card or on cards with peer access; only one card was available to
test it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from . import environment as env
from .halo import HaloSpec, _check_depth, _check_rank_layout

# Distinct per-kernel barrier ids: kernels that may interleave between
# ranks must not share one.
COLLECTIVE_ID_EXCHANGE = 1   # this module's exchange
COLLECTIVE_ID_SWEEP = 2      # the fused-transport sweep across ranks

#: the slot layout of a window (csrc/rdma_fence.cuh)
SLOT_READY, SLOT_DELIVERED, SLOT_BARRIER = 0, 4, 8
NUM_SLOTS = 16
#: the geometry array rdma_exchange_launch takes (RdmaGeo)
GEO_INTS = 18

#: how long a wait on the card may spin before the exchange raises: long
#: enough for a peer that is still importing or building its kernels
BUDGET_S = 120.0

_ELEM_BYTES = {torch.float32: 4, torch.int32: 4, torch.float64: 8}
_ALIGN = 256


def ready_slot(phase: int, direction: int) -> int:
    return SLOT_READY + 2 * phase + direction


def delivered_slot(phase: int, direction: int) -> int:
    return SLOT_DELIVERED + 2 * phase + direction


def barrier_slot(cid: int) -> int:
    return SLOT_BARRIER + cid


class FenceModel:
    """The plain version of the fence: one counter per (rank, slot).
    :meth:`signal` adds; :meth:`try_wait` consumes one signal and returns
    True, or returns False where the kernel's wait would block."""

    def __init__(self):
        self.counts: dict[tuple[int, int], int] = {}
        self.events = 0       # signals and consumed waits so far

    def signal(self, rank: int, slot: int, n: int = 1) -> None:
        self.counts[rank, slot] = self.counts.get((rank, slot), 0) + n
        self.events += 1

    def try_wait(self, rank: int, slot: int) -> bool:
        if self.counts.get((rank, slot), 0) < 1:
            return False
        self.counts[rank, slot] -= 1
        self.events += 1
        return True


@dataclass(frozen=True)
class Neighbours:
    """A rank's exchange neighbours, wrap-indexed on both axes."""
    east: int
    west: int
    north: int
    south: int


def neighbours(spec: HaloSpec, rank: int) -> Neighbours:
    iy, ix = spec.rank_coords(rank)
    return Neighbours(east=spec.rank_at(iy, ix + 1),
                      west=spec.rank_at(iy, ix - 1),
                      north=spec.rank_at(iy + 1, ix),
                      south=spec.rank_at(iy - 1, ix))


def _phases(spec: HaloSpec) -> tuple[bool, bool]:
    return (spec.nprocx > 1 or spec.wrap_x, spec.nprocy > 1 or spec.wrap_y)


def _has(spec: HaloSpec, rank: int) -> tuple[bool, bool, bool, bool]:
    """(has_w, has_e, has_s, has_n) of a one-tile rank."""
    iy, ix = spec.rank_coords(rank)
    return (ix > 0 or spec.wrap_x, ix < spec.nprocx - 1 or spec.wrap_x,
            iy > 0 or spec.wrap_y, iy < spec.nprocy - 1 or spec.wrap_y)


def _check_one_tile(spec: HaloSpec) -> None:
    if spec.repx > 1 or spec.repy > 1:
        raise NotImplementedError(
            "the remote-DMA transport supports one tile per device; "
            "over-decomposed grids use the ppermute exchange")


# ---------------------------------------------------------------------------
# The plain version: the protocol simulated over every rank's block
# ---------------------------------------------------------------------------

class _Landing:
    """Landing buffers of the simulation, keyed (rank, phase, direction).
    A write over a strip its owner has not read yet is a protocol fault
    and raises."""

    def __init__(self):
        self.bufs: dict[tuple[int, int, int], torch.Tensor] = {}

    def put(self, key, strip: torch.Tensor) -> None:
        if key in self.bufs:
            raise RuntimeError(f"landing buffer {key} overwritten before "
                               "its rank read it: the fence let a peer in "
                               "early")
        self.bufs[key] = strip.clone()

    def take(self, key) -> torch.Tensor:
        return self.bufs.pop(key)


def _rank_protocol(rank, out, spec, depth, fence, land, cid):
    """One rank's exchange, step by step: a generator that yields where
    the kernel would spin on a wait the fence cannot grant yet."""
    h, d = spec.halo, depth
    w, hgt = spec.tile_nx, spec.tile_ny
    nb = neighbours(spec, rank)
    do_x, do_y = _phases(spec)
    has_w, has_e, has_s, has_n = _has(spec, rank)

    def wait(slot):
        while not fence.try_wait(rank, slot):
            yield

    peers = (([nb.east, nb.west] if do_x else [])
             + ([nb.north, nb.south] if do_y else []))
    for p in peers:
        fence.signal(p, barrier_slot(cid))
    for _ in peers:
        yield from wait(barrier_slot(cid))

    for phase, on, plus, minus, has_minus, has_plus, cut in (
            (0, do_x, nb.east, nb.west, has_w, has_e,
             lambda a, b: (..., slice(None), slice(a, b))),
            (1, do_y, nb.north, nb.south, has_s, has_n,
             lambda a, b: (..., slice(a, b), slice(None)))):
        if not on:
            continue
        t = w if phase == 0 else hgt
        # the readiness fence: both neighbours' landing buffers are free
        fence.signal(plus, ready_slot(phase, 1))
        fence.signal(minus, ready_slot(phase, 0))
        for direction in (0, 1):
            yield from wait(ready_slot(phase, direction))
        land.put((plus, phase, 0), out[cut(h + t - d, h + t)])
        land.put((minus, phase, 1), out[cut(h, h + d)])
        fence.signal(plus, delivered_slot(phase, 0))
        fence.signal(minus, delivered_slot(phase, 1))
        for direction in (0, 1):
            yield from wait(delivered_slot(phase, direction))
        from_minus = land.take((rank, phase, 0))
        from_plus = land.take((rank, phase, 1))
        if has_minus:
            out[cut(h - d, h)] = from_minus
        if has_plus:
            out[cut(h + t, h + t + d)] = from_plus


def exchange_reference(blocks, spec: HaloSpec, depth: int,
                       order=None,
                       cid: int = COLLECTIVE_ID_EXCHANGE) -> list:
    """The exchange of :func:`exchange` for every rank at once: ``blocks``
    is the list of the ranks' one-tile blocks (``(..., local_ny,
    local_nx)``, rank order), and the result their exchanged copies.  The
    ranks' protocols run interleaved, one step each in turn (``order``, a
    list of ranks, sets the turn order and may repeat a rank to run it
    ahead), over a fresh :class:`FenceModel`, with the entry barrier on
    collective id ``cid``.  A protocol that can make no progress
    raises."""
    _check_depth(spec, depth)
    _check_one_tile(spec)
    if len(blocks) != spec.num_ranks:
        raise ValueError(f"expected {spec.num_ranks} blocks, got "
                         f"{len(blocks)}")
    fence, land = FenceModel(), _Landing()
    outs = [b.clone() for b in blocks]
    live = {r: _rank_protocol(r, outs[r], spec, depth, fence, land, cid)
            for r in range(spec.num_ranks)}
    order = list(range(spec.num_ranks)) if order is None else list(order)
    while live:
        before = fence.events
        for r in order:
            if r in live:
                try:
                    next(live[r])
                except StopIteration:
                    del live[r]
        if live and fence.events == before:
            raise RuntimeError(
                f"the exchange protocol is stuck: ranks {sorted(live)} "
                "wait on signals nobody sends")
    return outs


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@dataclass
class Window:
    """This rank's window for one ``(spec, dtype, lead)`` and the opened
    windows of its neighbours (device pointers as ints)."""
    ptr: int
    land_x: int
    land_y: int
    land_x_bytes: int
    land_y_bytes: int
    peers: dict = field(default_factory=dict)     # rank -> pointer
    opened: list = field(default_factory=list)    # pointers to close
    broken: str = ""


def _layout(spec: HaloSpec, elem: int, lead: tuple) -> tuple[int, ...]:
    """(land_x offset, land_y offset, one x buffer, one y buffer, total
    bytes) of a window sized for the halo width."""
    nlead = 1
    for n in lead:
        nlead *= n
    header = _align(NUM_SLOTS * 4 + 2 * 4)
    bx = _align(nlead * spec.local_ny * spec.halo * elem)
    by = _align(nlead * spec.halo * spec.local_nx * elem)
    return header, header + 2 * bx, bx, by, header + 2 * bx + 2 * by


class RdmaExchangeKernel:
    """ctypes wrapper of ``csrc/halo_exchange_rdma.cu`` and the keeper of
    this process's windows (the fused-transport sweep's too).

    ``launches`` counts the exchanges this wrapper has launched (the
    block copy and the protocol kernel, one per call; nothing else);
    callers may reset it."""

    source = "halo_exchange_rdma.cu"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._windows: dict[tuple, Window] = {}

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from ..ops.cuda_build import load_library
        built = load_library("halo_exchange_rdma", (self.source,))
        if self._lib is None:
            lib = built.lib
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            pvp = ctypes.POINTER(ctypes.c_void_p)
            for name, args in (
                    ("rdma_alloc", [i, ll, pvp, vp]),
                    ("rdma_open", [i, vp, pvp]),
                    ("rdma_close", [vp]),
                    ("rdma_free", [vp]),
                    ("rdma_read_status", [vp, ctypes.POINTER(i), vp]),
                    ("rdma_exchange_launch",
                     [i, vp, vp, pvp, ctypes.POINTER(ll), i,
                      ctypes.c_ulonglong, vp]),
                    ("rdma_handle_bytes", []), ("rdma_num_geo_ints", []),
                    ("rdma_num_slots", [])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = i
            if (lib.rdma_num_slots(), lib.rdma_num_geo_ints()) != (
                    NUM_SLOTS, GEO_INTS):
                raise RuntimeError("libhalo_exchange_rdma's window layout "
                                   "does not match rdma.py's")
            self._lib = lib
        return built

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} failed: CUDA error {err}")

    def window(self, spec: HaloSpec, dtype, lead: tuple,
               device: torch.device,
               cid: int = COLLECTIVE_ID_EXCHANGE) -> Window:
        """This rank's window for ``(spec, dtype, lead)`` on ``device``
        and the kernel of collective id ``cid``, with its neighbours'
        opened; made on first use, which is collective (every rank calls
        it, in the same order)."""
        key = (cid, spec, dtype, lead, device)
        if key in self._windows:
            return self._windows[key]
        self.build()
        lib, rank = self._lib, env.get_rank()
        ox, oy, bx, by, total = _layout(spec, _ELEM_BYTES[dtype], lead)
        dev = device.index if device.index is not None else \
            torch.cuda.current_device()
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.rdma_handle_bytes())
        self._check(lib.rdma_alloc(dev, total, ctypes.byref(ptr), handle),
                    "allocating the exchange window")
        win = Window(ptr.value, ox, oy, bx, by)
        self._windows[key] = win
        handles = [None] * env.get_num_ranks()
        dist.all_gather_object(handles, handle.raw)
        nb = neighbours(spec, rank)
        for peer in {nb.east, nb.west, nb.north, nb.south}:
            if peer == rank:
                win.peers[peer] = win.ptr
                continue
            pp = ctypes.c_void_p()
            self._check(lib.rdma_open(dev, handles[peer], ctypes.byref(pp)),
                        f"opening rank {peer}'s exchange window")
            win.peers[peer] = pp.value
            win.opened.append(pp.value)
        return win

    def close_windows(self) -> None:
        """Close the neighbours' windows and free this rank's."""
        for win in self._windows.values():
            for p in win.opened:
                self._check(self._lib.rdma_close(p), "closing a peer window")
            self._check(self._lib.rdma_free(win.ptr), "freeing a window")
        self._windows.clear()

    def protocol_args(self, win: Window, spec: HaloSpec, depth: int,
                      nlead: int, cid: int):
        """The protocol's geometry (``RdmaGeo`` of
        ``csrc/rdma_protocol.cuh``) and the five window pointers (mine,
        east, west, north, south) for this rank, as C arrays."""
        nb = neighbours(spec, env.get_rank())
        do_x, do_y = _phases(spec)
        has = _has(spec, env.get_rank())
        geo = (nlead, spec.local_ny, spec.local_nx, spec.halo, depth,
               spec.tile_nx, spec.tile_ny, int(do_x), int(do_y),
               *(int(b) for b in has), cid,
               win.land_x, win.land_y, win.land_x_bytes, win.land_y_bytes)
        wins = (ctypes.c_void_p * 5)(win.ptr, win.peers[nb.east],
                                     win.peers[nb.west], win.peers[nb.north],
                                     win.peers[nb.south])
        return (ctypes.c_longlong * len(geo))(*geo), wins

    def check_status(self, win: Window, stream: int, what: str) -> None:
        """Wait for ``stream`` and raise if a wait of any launch so far on
        ``win`` ran out of its budget; the window is then unusable."""
        status = (ctypes.c_int * 2)()
        self._check(self._lib.rdma_read_status(win.ptr, status, stream),
                    f"reading the {what} status")
        if status[0] != 0:
            win.broken = (f"a wait on slot {status[1]} ran out of its "
                          f"{BUDGET_S} s budget")
            raise RuntimeError(f"{what} on rank {env.get_rank()}: "
                               f"{win.broken} (a peer is dead or stalled)")

    def __call__(self, data: torch.Tensor, spec: HaloSpec,
                 depth: int, cid: int = COLLECTIVE_ID_EXCHANGE
                 ) -> torch.Tensor:
        if data.device.type != "cuda":
            raise ValueError(f"the rdma exchange kernel needs a CUDA tensor, "
                             f"got {data.device}")
        if data.dtype not in _ELEM_BYTES:
            raise TypeError(f"the rdma exchange kernel takes float32/float64/"
                            f"int32 blocks, got {data.dtype}")
        if data.dim() < 2 or tuple(data.shape[-2:]) != spec.array_shape:
            raise ValueError(f"expected (..., {spec.array_shape[0]}, "
                             f"{spec.array_shape[1]}) blocks, got "
                             f"{tuple(data.shape)}")
        if not data.is_contiguous():
            raise ValueError("the exchanged block must be contiguous")
        _check_depth(spec, depth)
        _check_one_tile(spec)
        _check_rank_layout(spec)
        lead = tuple(data.shape[:-2])
        win = self.window(spec, data.dtype, lead, data.device, cid)
        if win.broken:
            raise RuntimeError(f"this exchange window is unusable: "
                               f"{win.broken}")
        nlead = data.numel() // (spec.local_ny * spec.local_nx)
        geo, wins = self.protocol_args(win, spec, depth, nlead, cid)
        out = torch.empty_like(data)
        stream = torch.cuda.current_stream(data.device).cuda_stream
        self._check(self._lib.rdma_exchange_launch(
            _ELEM_BYTES[data.dtype], data.data_ptr(), out.data_ptr(),
            wins, geo, len(geo), int(BUDGET_S * 1e9), stream),
            "the rdma exchange kernel launch")
        self.launches += 1
        self.check_status(win, stream, "rdma exchange")
        return out


#: the process's one wrapper of the rdma exchange kernel
halo_exchange_rdma = RdmaExchangeKernel()


def close_windows() -> None:
    """Close every exchange window of this process (see
    :func:`..environment.finalise`)."""
    halo_exchange_rdma.close_windows()


def exchange(data: torch.Tensor, spec: HaloSpec, depth: int = 1, *,
             cid: int = COLLECTIVE_ID_EXCHANGE) -> torch.Tensor:
    """Refresh the halo ring of this rank's one-tile block: the kernel on
    a CUDA tensor, its plain version (:func:`exchange_reference` over the
    gathered blocks) on a CPU tensor; the entry barrier on collective id
    ``cid``.  Collective."""
    _check_depth(spec, depth)
    _check_one_tile(spec)
    _check_rank_layout(spec)
    if data.device.type == "cpu":
        blocks = [torch.empty_like(data) for _ in range(spec.num_ranks)]
        dist.all_gather(blocks, data.contiguous())
        return exchange_reference(blocks, spec, depth,
                                  cid=cid)[env.get_rank()]
    return halo_exchange_rdma(data, spec, depth, cid)
