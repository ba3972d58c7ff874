"""The halo exchange between ranks through peer memory, with its fence.

Counterpart of ``dl_esm_inf_tpu/parallel/rdma.py`` (the shared pieces
of the TPU's remote-DMA transports) and of the multi-device path of
``dl_esm_inf_tpu/parallel/halo_pallas.py::make_block_exchange``.  With
one tile per rank, :func:`exchange` refreshes a rank's halo ring by
writing its edge strips straight into its neighbours' memory:

* a CUDA block launches the hand-written kernels of
  ``csrc/halo_exchange_rdma.cu`` through :data:`halo_exchange_rdma`
  (built with ``nvcc`` at first use), or raises;
* a CPU block runs their plain version, :func:`exchange_reference`: the
  same protocol simulated in one process over every rank's block
  (gathered through the process group), with :class:`FenceModel` for
  the slots and :class:`_Landing` for the landing buffers.

The flagship's fused transport across ranks
(``csrc/nemolite2d_sweep_rdma.cu``, wrapped by
:mod:`..ops.fused_step`) runs the same protocol on the state's three
planes at the full halo depth, on a window of collective id
:data:`COLLECTIVE_ID_SWEEP`; its plain version is :func:`exchange` on
the stacked planes.

**The protocol** (``csrc/rdma_protocol.cuh``): one phase and one
hand-off per call.  Call ``n`` of a window (counted on the host, from 1):
the block copy and, into each neighbour's landing buffer of parity
``n % 2``, the rank's x strips (every row) to E and W, its full-width y
rows to N and S and its corner blocks to the diagonal peers; a signal
``n`` to each neighbour; one wait per neighbour for ``n``; the merge
where the rank has that neighbour (a y row over an x strip, a corner
over a y row, so that the result equals the TPU's x-then-y sequencing
bitwise).  Neighbours are wrap-indexed on every axis that exchanges, and
the directions that exchange (:func:`active_directions`) are the same on
every rank.

* No entry barrier: the TPU's fence semaphores are kernel scratch, valid
  only while the peer runs the same kernel; these windows outlive every
  call.
* No readiness fence: the landings are double-buffered by call parity.
  A rank writes a peer's parity-``p`` buffer in call ``n + 2`` only after
  its own call ``n + 1`` wait, which the peer's call ``n + 1`` signal
  satisfies; the peer sends that signal after its call ``n`` merge, so
  the buffer was read.  With one buffer (``buffers=1`` in the plain
  model) a fast rank overwrites a strip not yet read, and
  :class:`_Landing` raises.

**The wait is off the SMs**: a stream memory operation
(``cuStreamWaitValue32`` GEQ on this rank's monotonic delivered slot, one
per direction, signalled by ``cuStreamWriteValue32``), so a card
time-sliced between the ranks' processes switches to the peer at once
(``csrc/rdma_fence.cuh``).  A stream wait has no deadline, so the
wrapper bounds it on the host, against the window's events (one per
call parity, recorded after the waits): a call returns once its
predecessor's waits have passed, polling for at most :data:`BUDGET_S`,
so the next call's send is already queued when this one's merge runs;
the newest call is checked by the next one, by
:meth:`RdmaExchangeKernel.settle` (which :func:`close_windows` runs),
or by a watchdog thread.  A wait still pending past the budget is
released (this rank writes the awaited count itself, so the stream
drains), the window is marked unusable, and the wrapper raises, naming
the slot and the peer.

**The windows.**  Each rank allocates, once per ``(collective id, spec,
dtype, lead, device)``, one window with ``cudaMalloc`` (the slots, then
two landing buffers per direction sized for the halo width), exports it
with ``cudaIpcGetMemHandle``, exchanges the handles with
``dist.all_gather_object`` and opens its neighbours' (:meth:`window`).
:func:`close_windows` closes them; :func:`..environment.finalise` calls
it after a barrier, before the process group goes.  The collective id
in the key keeps a sweep's slots and a standalone exchange's apart.
IPC needs the peers on one card or on cards with peer access; only one
card was available to test it.
"""
from __future__ import annotations

import ctypes
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from . import environment as env
from .halo import HaloSpec, _check_depth, _check_rank_layout

# Distinct windows per kernel: kernels that may interleave between ranks
# must not share one.
COLLECTIVE_ID_EXCHANGE = 1   # this module's exchange
COLLECTIVE_ID_SWEEP = 2      # the fused-transport sweep across ranks
COLLECTIVE_ID_SEAM = 3       # the seams' strips (parallel/seam.py)

#: the slot layout of a window (csrc/rdma_fence.cuh; slot 4 is the spin
#: ping-pong's, which only the kernel names)
SLOT_READY, SLOT_PING_VALUE, SLOT_DELIVERED = 0, 5, 8
NUM_SLOTS = 16
#: the geometry array the launches take (RdmaGeo)
GEO_INTS = 29

#: the directions of a neighbour in the rank grid as (dy, dx), in the
#: kernels' order (csrc/rdma_protocol.cuh)
DIRECTIONS = ((0, -1), (0, 1), (-1, 0), (1, 0),
              (-1, -1), (-1, 1), (1, -1), (1, 1))
DIRECTION_NAMES = ("west", "east", "south", "north",
                   "south-west", "south-east", "north-west", "north-east")

#: how long a call may wait for its neighbours before the exchange
#: raises: long enough for a peer that is still importing or building its
#: kernels
BUDGET_S = 120.0

_ELEM_BYTES = {torch.float32: 4, torch.int32: 4, torch.float64: 8}
_ALIGN = 256
_NOT_READY = 600              # cudaErrorNotReady

#: the clock of the host-side budget (tests replace it)
_clock = time.monotonic


def await_done(done, budget_s: float) -> bool:
    """Poll ``done()`` until it is true (returns True) or ``budget_s``
    seconds of :data:`_clock` pass first (returns False): the bound of a
    wait that blocks a stream and has no deadline of its own."""
    deadline = _clock() + budget_s
    while not done():
        if _clock() > deadline:
            return False
    return True


def ready_slot(phase: int, direction: int) -> int:
    """A counting slot of the fence oracles."""
    return SLOT_READY + 2 * phase + direction


def delivered_slot(direction: int) -> int:
    """The monotonic slot the neighbour in ``direction`` signals."""
    return SLOT_DELIVERED + direction


def opposite(direction: int) -> int:
    dy, dx = DIRECTIONS[direction]
    return DIRECTIONS.index((-dy, -dx))


class FenceModel:
    """The plain version of the fence's slots, per (rank, slot): counting
    ones (:meth:`signal` adds, :meth:`try_wait` consumes one signal or
    returns False where the kernel's wait would block) for the oracles,
    and monotonic ones (:meth:`write`, :meth:`reached`) for the exchange.
    ``trace`` lists ``(rank, "signal" | "wait", slot)`` of the monotonic
    ones, the wait when it passes; :meth:`handoffs` counts a rank's
    hand-offs in it."""

    def __init__(self):
        self.counts: dict[tuple[int, int], int] = {}
        self.values: dict[tuple[int, int], int] = {}
        self.events = 0       # signals, writes and passed waits so far
        self.trace: list[tuple[int, str, int]] = []

    def signal(self, rank: int, slot: int, n: int = 1) -> None:
        self.counts[rank, slot] = self.counts.get((rank, slot), 0) + n
        self.events += 1

    def try_wait(self, rank: int, slot: int) -> bool:
        if self.counts.get((rank, slot), 0) < 1:
            return False
        self.counts[rank, slot] -= 1
        self.events += 1
        return True

    def write(self, rank: int, slot: int, value: int, by: int) -> None:
        """Rank ``by`` writes ``value`` into ``rank``'s monotonic
        ``slot`` (``cuStreamWriteValue32``); a value below the slot's is a
        protocol fault and raises."""
        if value < self.values.get((rank, slot), 0):
            raise RuntimeError(f"rank {by} wrote {value} over "
                               f"{self.values[rank, slot]} in rank {rank}'s "
                               f"slot {slot}")
        self.values[rank, slot] = value
        self.events += 1
        self.trace.append((by, "signal", slot))

    def reached(self, rank: int, slot: int, value: int) -> bool:
        """Whether ``rank``'s wait for ``slot >= value``
        (``cuStreamWaitValue32`` GEQ) passes."""
        if self.values.get((rank, slot), 0) < value:
            return False
        self.events += 1
        self.trace.append((rank, "wait", slot))
        return True

    def handoffs(self, rank: int) -> int:
        """The hand-offs of ``rank`` so far: runs of passed waits."""
        kinds = [k for r, k, _ in self.trace if r == rank]
        return sum(1 for i, k in enumerate(kinds)
                   if k == "wait" and (i == 0 or kinds[i - 1] != "wait"))


def neighbours(spec: HaloSpec, rank: int) -> tuple[int, ...]:
    """A rank's neighbours by direction (:data:`DIRECTIONS`),
    wrap-indexed on both axes."""
    iy, ix = spec.rank_coords(rank)
    return tuple(spec.rank_at(iy + dy, ix + dx) for dy, dx in DIRECTIONS)


def active_directions(spec: HaloSpec) -> tuple[int, ...]:
    """The directions that exchange, the same on every rank: W and E
    where x exchanges, S and N where y does, the diagonals where both
    do."""
    do_x = spec.nprocx > 1 or spec.wrap_x
    do_y = spec.nprocy > 1 or spec.wrap_y
    return tuple(d for d, (dy, dx) in enumerate(DIRECTIONS)
                 if (dx == 0 or do_x) and (dy == 0 or do_y))


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
    """Landing buffers of the simulation, keyed (rank, parity,
    direction).  A write over a strip its owner has not read yet is a
    protocol fault and raises."""

    def __init__(self):
        self.bufs: dict[tuple[int, int, int], torch.Tensor] = {}

    def put(self, key, strip: torch.Tensor) -> None:
        if key in self.bufs:
            raise RuntimeError(f"landing buffer {key} overwritten before "
                               "its rank read it: a peer ran a call ahead "
                               "into a buffer still in use")
        self.bufs[key] = strip.clone()

    def take(self, key) -> torch.Tensor:
        return self.bufs.pop(key)


def _cut(interior: int, h: int, d: int, side: int, send: bool) -> slice:
    """Rows (or columns) of a strip along one axis: all of them where the
    direction does not move on it (``side`` 0), else the ``d`` interior
    lines at ``side``'s edge (``send``) or the ``d`` halo lines beyond
    it."""
    if side == 0:
        return slice(None)
    if send:
        a = h + interior - d if side > 0 else h
    else:
        a = h + interior if side > 0 else h - d
    return slice(a, a + d)


def _rank_protocol(rank, out, spec, depth, fence, land, call, buffers=2):
    """Call ``call`` (from 1) of one rank's exchange on ``out``, step by
    step: a generator that yields where the stream would block on its
    wait.  ``buffers``: landing buffers per direction (2: by call
    parity; 1 shows why one is not enough)."""
    h, d = spec.halo, depth
    w, hgt = spec.tile_nx, spec.tile_ny
    nb = neighbours(spec, rank)
    active = active_directions(spec)
    has_w, has_e, has_s, has_n = _has(spec, rank)
    has_x = {-1: has_w, 0: True, 1: has_e}
    has_y = {-1: has_s, 0: True, 1: has_n}
    parity = call % buffers

    def rect(direction, send):
        dy, dx = DIRECTIONS[direction]
        return (..., _cut(hgt, h, d, dy, send), _cut(w, h, d, dx, send))

    # send: every strip from the block as it came in, then the signals
    for o in active:
        land.put((nb[o], parity, opposite(o)), out[rect(o, True)])
    for o in active:
        fence.write(nb[o], delivered_slot(opposite(o)), call, by=rank)
    # the one hand-off: a wait per neighbour
    for direction in active:
        while not fence.reached(rank, delivered_slot(direction), call):
            yield
    # merge: x strips, then y rows, then corners, each over the last
    for direction in active:
        strip = land.take((rank, parity, direction))
        dy, dx = DIRECTIONS[direction]
        if has_y[dy] and has_x[dx]:
            out[rect(direction, False)] = strip


def exchange_reference(blocks, spec: HaloSpec, depth: int,
                       order=None, fence: FenceModel | None = None) -> list:
    """The exchange of :func:`exchange` for every rank at once: ``blocks``
    is the list of the ranks' one-tile blocks (``(..., local_ny,
    local_nx)``, rank order), and the result their exchanged copies.  The
    ranks' protocols run interleaved, one step each in turn (``order``, a
    list of ranks, sets the turn order and may repeat a rank to run it
    ahead), as the first call over a fresh :class:`FenceModel` (or
    ``fence``, which then holds the call's trace).  A protocol that can
    make no progress raises."""
    _check_depth(spec, depth)
    _check_one_tile(spec)
    if len(blocks) != spec.num_ranks:
        raise ValueError(f"expected {spec.num_ranks} blocks, got "
                         f"{len(blocks)}")
    fence = FenceModel() if fence is None else fence
    land = _Landing()
    outs = [b.clone() for b in blocks]
    live = {r: _rank_protocol(r, outs[r], spec, depth, fence, land, 1)
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
    land: tuple           # byte offset of landing[direction][parity 0]
    land_bytes: tuple     # bytes of one landing buffer per direction
    spec: HaloSpec
    device: int
    events: tuple = ()    # by call parity: recorded after the call's waits
    peers: dict = field(default_factory=dict)     # rank -> pointer
    opened: list = field(default_factory=list)    # pointers to close
    broken: str = ""
    calls: int = 0            # exchange calls so far (monotonic)
    checked: int = 0          # calls whose waits are known to have passed
    issued_at: float = 0.0    # _clock() when the newest call was enqueued
    stream_pings: int = 0     # stream ping-pong rounds so far (monotonic)


def _layout(spec: HaloSpec, elem: int, lead: tuple):
    """(landing offsets, landing bytes, total bytes) of a window sized
    for the halo width: the slots, then two buffers per direction."""
    nlead = 1
    for n in lead:
        nlead *= n
    h = spec.halo
    offsets, sizes = [], []
    at = _align(NUM_SLOTS * 4)
    for dy, dx in DIRECTIONS:
        rows = spec.local_ny if dy == 0 else h
        cols = spec.local_nx if dx == 0 else h
        size = _align(nlead * rows * cols * elem)
        offsets.append(at)
        sizes.append(size)
        at += 2 * size
    return tuple(offsets), tuple(sizes), at


#: how often the watchdog looks for a call whose waits outlived BUDGET_S
WATCH_S = 1.0


class RdmaExchangeKernel:
    """ctypes wrapper of ``csrc/halo_exchange_rdma.cu`` and the keeper of
    this process's windows (the fused-transport sweep's too).

    A call enqueues its work and returns once its predecessor on the
    window has passed its waits (:meth:`finish`), so that the next call's
    send is queued before this one's merge runs: a time-sliced card then
    runs one rank's merge and next send without a context switch between
    them.  The newest call's waits are checked by the next call on the
    window, by :meth:`settle`, or by a watchdog thread every
    :data:`WATCH_S`; whichever finds one pending past :data:`BUDGET_S`
    releases it and marks the window unusable, and the wrapper raises,
    naming the slot, there or at the window's next use.

    ``launches`` counts the exchanges this wrapper has launched (the send
    kernel, the stream signals and waits and the merge kernel, one per
    call; nothing else); callers may reset it."""

    source = "halo_exchange_rdma.cu"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._windows: dict[tuple, Window] = {}
        self._lock = threading.RLock()
        self._watchdog = None

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from ..ops.cuda_build import load_library
        built = load_library("halo_exchange_rdma", (self.source,),
                             driver=True)
        if self._lib is None:
            lib = built.lib
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            pvp = ctypes.POINTER(ctypes.c_void_p)
            for name, args in (
                    ("rdma_alloc", [i, ll, pvp, vp]),
                    ("rdma_open", [i, vp, pvp]),
                    ("rdma_close", [vp]),
                    ("rdma_free", [vp]),
                    ("rdma_event_create", [pvp]),
                    ("rdma_event_query", [vp]),
                    ("rdma_event_destroy", [vp]),
                    ("rdma_read_slots",
                     [i, vp, ctypes.POINTER(ctypes.c_uint)]),
                    ("rdma_release", [i, vp, i, ctypes.c_uint]),
                    ("rdma_exchange_launch",
                     [i, vp, vp, pvp, ctypes.POINTER(ll), i, vp, vp]),
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
            kind = ("CUDA driver error" if err < 0 else "CUDA error")
            raise RuntimeError(f"{what} failed: {kind} {abs(err)}")

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
        land, land_bytes, total = _layout(spec, _ELEM_BYTES[dtype], lead)
        dev = device.index if device.index is not None else \
            torch.cuda.current_device()
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.rdma_handle_bytes())
        self._check(lib.rdma_alloc(dev, total, ctypes.byref(ptr), handle),
                    "allocating the exchange window")
        events = []
        for _ in range(2):
            ev = ctypes.c_void_p()
            self._check(lib.rdma_event_create(ctypes.byref(ev)),
                        "creating the window's events")
            events.append(ev.value)
        win = Window(ptr.value, land, land_bytes, spec, dev, tuple(events))
        with self._lock:
            self._windows[key] = win
        handles = [None] * env.get_num_ranks()
        dist.all_gather_object(handles, handle.raw)
        for peer in set(neighbours(spec, rank)):
            if peer == rank:
                win.peers[peer] = win.ptr
                continue
            pp = ctypes.c_void_p()
            self._check(lib.rdma_open(dev, handles[peer], ctypes.byref(pp)),
                        f"opening rank {peer}'s exchange window")
            win.peers[peer] = pp.value
            win.opened.append(pp.value)
        if self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watch, name="rdma-watchdog", daemon=True)
            self._watchdog.start()
        return win

    def close_windows(self) -> None:
        """Check every window's last call (:meth:`settle`), then close
        the neighbours' windows and free this rank's."""
        try:
            self.settle()
        finally:
            with self._lock:
                for win in self._windows.values():
                    for p in win.opened:
                        self._check(self._lib.rdma_close(p),
                                    "closing a peer window")
                    for ev in win.events:
                        self._check(self._lib.rdma_event_destroy(ev),
                                    "destroying a window's event")
                    self._check(self._lib.rdma_free(win.ptr),
                                "freeing a window")
                self._windows.clear()

    def protocol_args(self, win: Window, depth: int, nlead: int):
        """The next call on ``win``, counted here: its geometry
        (``RdmaGeo`` of ``csrc/rdma_protocol.cuh``), its window pointers
        (mine, then the neighbours' by direction) as C arrays, and the
        event it records after its waits."""
        if win.broken:
            raise RuntimeError(f"this exchange window is unusable: "
                               f"{win.broken}")
        spec = win.spec
        win.calls += 1
        rank = env.get_rank()
        mask = sum(1 << d for d in active_directions(spec))
        geo = (nlead, spec.local_ny, spec.local_nx, spec.halo, depth,
               spec.tile_nx, spec.tile_ny,
               *(int(b) for b in _has(spec, rank)), mask, win.calls,
               *win.land, *win.land_bytes)
        wins = (ctypes.c_void_p * 9)(
            win.ptr, *(win.peers[p] for p in neighbours(spec, rank)))
        return ((ctypes.c_longlong * len(geo))(*geo), wins,
                win.events[win.calls % 2])

    def launched(self, win: Window, err: int, what: str) -> None:
        """After a launch: raise if it failed (the window is then out of
        step with its peers), else note when it was enqueued."""
        if err != 0:
            win.broken = f"call {win.calls} failed to launch"
            self._check(err, what)
        win.issued_at = _clock()

    def _passed(self, win: Window, call: int) -> bool:
        err = self._lib.rdma_event_query(win.events[call % 2])
        if err not in (0, _NOT_READY):
            self._check(err, "querying an exchange event")
        return err == 0

    def finish(self, win: Window, what: str, upto: int | None = None):
        """Check on the host that the window's calls up to ``upto``
        (default: all but the newest) have passed their waits, polling
        each for at most :data:`BUDGET_S`; raise if one has not, or if
        the window has become unusable."""
        upto = win.calls - 1 if upto is None else upto
        while win.checked < upto and not win.broken:
            call = win.checked + 1
            if not await_done(lambda: self._passed(win, call), BUDGET_S):
                self._expire(win, call)
            elif not win.broken:
                win.checked = call
        if win.broken:
            raise RuntimeError(f"{what}: {win.broken} (a peer is dead or "
                               "stalled)")

    def settle(self) -> None:
        """:meth:`finish` every window's calls, the newest included."""
        for win in list(self._windows.values()):
            self.finish(win, f"rdma exchange on rank {env.get_rank()}",
                        upto=win.calls)

    def _expire(self, win: Window, call: int) -> None:
        """``call`` is still waiting past its budget: name the slots it
        waits on, release every slot the enqueued calls wait on (this rank
        writes the awaited count itself, so the stream drains), and mark
        the window unusable."""
        with self._lock:
            if win.broken:
                return
            slots = (ctypes.c_uint * NUM_SLOTS)()
            self._check(self._lib.rdma_read_slots(win.device, win.ptr,
                                                  slots),
                        "reading the window's slots")
            nb = neighbours(win.spec, env.get_rank())
            dirs = active_directions(win.spec)
            late = [d for d in dirs
                    if (slots[delivered_slot(d)] - call) & 0x80000000]
            for d in dirs:
                if (slots[delivered_slot(d)] - win.calls) & 0x80000000:
                    self.release(win, delivered_slot(d), win.calls)
            names = ", ".join(f"slot {delivered_slot(d)} (the "
                              f"{DIRECTION_NAMES[d]} neighbour, rank "
                              f"{nb[d]})" for d in late)
            win.broken = (f"call {call}'s wait on {names} was still pending "
                          f"after its {BUDGET_S} s budget")

    def release(self, win: Window, slot: int, value: int) -> None:
        """Write ``value`` into this rank's ``slot`` from a stream of its
        own: a stream wait on it that no peer will satisfy drains."""
        self._check(self._lib.rdma_release(win.device, win.ptr, slot,
                                           value & 0xFFFFFFFF),
                    f"releasing slot {slot}")

    def watch_once(self) -> None:
        """One look of the watchdog: expire the oldest unchecked call of
        each window whose newest call was enqueued more than
        :data:`BUDGET_S` ago and has not passed its waits."""
        with self._lock:
            for win in self._windows.values():
                if (win.broken or win.checked >= win.calls
                        or _clock() - win.issued_at <= BUDGET_S):
                    continue
                call = win.checked + 1
                if self._passed(win, call):
                    win.checked = call
                else:
                    self._expire(win, call)

    def _watch(self) -> None:
        while True:
            time.sleep(WATCH_S)
            self.watch_once()

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
        nlead = data.numel() // (spec.local_ny * spec.local_nx)
        geo, wins, event = self.protocol_args(win, depth, nlead)
        out = torch.empty_like(data)
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = self._lib.rdma_exchange_launch(
            _ELEM_BYTES[data.dtype], data.data_ptr(), out.data_ptr(),
            wins, geo, len(geo), event, stream)
        self.launched(win, err, "the rdma exchange")
        self.launches += 1
        self.finish(win, f"the rdma exchange on rank {env.get_rank()}")
        return out


#: the process's one wrapper of the rdma exchange kernel
halo_exchange_rdma = RdmaExchangeKernel()


def close_windows() -> None:
    """Check every window's last call, then close every exchange window
    of this process (see :func:`..environment.finalise`)."""
    halo_exchange_rdma.close_windows()


def exchange(data: torch.Tensor, spec: HaloSpec, depth: int = 1, *,
             cid: int = COLLECTIVE_ID_EXCHANGE) -> torch.Tensor:
    """Refresh the halo ring of this rank's one-tile block: the kernel on
    a CUDA tensor, on the window of collective id ``cid``; its plain
    version (:func:`exchange_reference` over the gathered blocks) on a
    CPU tensor.  Collective."""
    _check_depth(spec, depth)
    _check_one_tile(spec)
    _check_rank_layout(spec)
    if data.device.type == "cpu":
        blocks = [torch.empty_like(data) for _ in range(spec.num_ranks)]
        dist.all_gather(blocks, data.contiguous())
        return exchange_reference(blocks, spec, depth)[env.get_rank()]
    return halo_exchange_rdma(data, spec, depth, cid)
