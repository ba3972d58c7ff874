"""The seams between ranks, card to card: the strips of the plain exchange
through peer-memory windows.

The JAX package moves the strips that cross a rank seam with
``lax.ppermute`` (``dl_esm_inf_tpu/parallel/halo.py:176, :193``), device
to device.  The port's :func:`.halo._send_recv` moves them with one of
two transports, the same on every rank of a gang
(:func:`.environment.seam_transport`):

* ``"gloo"``: through host memory (a CUDA strip is staged through the
  host), the only transport of CPU strips;
* ``"peer"``: card to card, by this module: each strip is copied straight
  into a landing buffer in the receiving rank's memory, opened through
  CUDA IPC, and the receiver's stream waits for it off the SMs
  (``csrc/seam_transport.cu``, on the fence of ``csrc/rdma_fence.cuh``).
  Nothing moves through the host and the host never waits on the data.

The default is ``"peer"`` for CUDA strips where every pair of ranks is
on one host and on one card or on cards with peer access
(:func:`choose_seam_transport`), else ``"gloo"``; a gang may ask for one
(:func:`.environment.set_seam_transport`), and asking for ``"peer"``
where the layout cannot give it raises.  Nothing falls back to gloo
inside a call: a window that fails to allocate, open or deliver raises.

**Edges and counts.**  A strip's *edge* is (sender, receiver, tag,
shape, dtype).  Both of its ranks count its messages (:class:`Counts`,
from 1), just as gloo matches a pair's messages by tag in order, so two
ranks agree on an edge's count however their other edges are used.  The
receiver holds, per edge, a monotonic delivered slot and two landing
buffers, by the count's parity.  Message ``n``: the sender copies the
strip into the buffer of parity ``n % 2`` and writes ``n`` into the slot
(``cuStreamWriteValue32``, which fences the copy first); the receiver's
stream waits for the slot to reach ``n`` (``cuStreamWaitValue32``), then
copies the buffer out.

**Why two buffers are enough** (the argument of :mod:`.rdma`'s
protocol).  A batch that sends to a peer also receives from it (the
strip transfer of :class:`.halo._Transfer` does both on every rank, and
:meth:`Counts.plan` refuses a batch that does not), and every rank issues
its batches in the same collective order on one stream.  So a rank
writes a peer's parity ``p`` again (message ``n + 2``) only after its
stream waited for a strip the peer sent in the batch of message ``n +
1``, which the peer's stream enqueued after the copy-out of message
``n``.  With one buffer (``buffers=1`` in :func:`seam_reference`) a fast
rank overwrites a strip not yet read, and :class:`.rdma._Landing`
raises.

**Windows.**  The device side of the edges a batch uses for the first
time is made then: the receiver allocates one window for its new edges
(``cudaMalloc``: the slots, then two buffers per edge; ``rdma_alloc``
of ``csrc/halo_exchange_rdma.cu``) and sends its handle and offsets to
each sender over gloo, which opens it (``rdma_open``,
``cudaIpcMemLazyEnablePeerAccess``).  That hand-shake is pairwise, not
collective: two ranks always agree that an edge is new (its first
message), while a gang need not agree on a whole batch (a middle rank of
a walled and of a periodic row of ranks reuses edges where an end rank
makes new ones).  The host's bound on the waits is keyed by the batch's
signature (:func:`window_key`, collective id
:data:`.rdma.COLLECTIVE_ID_SEAM`): its two events, by call parity,
recorded after the waits, polled for :data:`.rdma.BUDGET_S` before the
event is recorded again, and a watchdog thread for the newest call, as
:class:`.rdma.RdmaExchangeKernel` does.  A wait still pending past the
budget releases this rank's slots, marks every window unusable and
raises, naming the slot and the peer.  :func:`close_windows`
(:func:`.environment.finalise`) closes them.

:func:`seam_reference` is the protocol's plain version: every rank of a
gang simulated in one process, over :class:`.rdma.FenceModel` and
:class:`.rdma._Landing`.
"""
from __future__ import annotations

import ctypes
import socket
import struct
import threading
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from . import environment as env
from . import rdma
from .rdma import (BUDGET_S, COLLECTIVE_ID_SEAM, NUM_SLOTS, FenceModel,
                   _align, _Landing)

#: the transports of a strip that crosses a rank seam
TRANSPORTS = ("peer", "gloo")

#: gloo tags of the hand-shake that opens a new edge (its strip's tag
#: added)
HANDSHAKE_TAG = 1 << 16
#: the hand-shake's int64s: slot index, landing offset, bytes, buffer
#: stride, then the 64-byte IPC handle
_HANDLE_INTS = 8
HANDSHAKE_INTS = 4 + _HANDLE_INTS


# ---------------------------------------------------------------------------
# The choice of transport
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Card:
    """Where a rank's strips live: its host, its card's UUID and the
    UUIDs of the cards that card reaches by peer access."""
    host: str
    uuid: str
    access: frozenset = frozenset()


def card_of(device: torch.device) -> Card:
    """This process's :class:`Card` for the CUDA ``device``."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()

    def uuid(i):
        return str(torch.cuda.get_device_properties(i).uuid)
    return Card(socket.gethostname(), uuid(idx), frozenset(
        uuid(j) for j in range(torch.cuda.device_count())
        if j != idx and torch.cuda.can_device_access_peer(idx, j)))


def reaches(a: Card, b: Card) -> bool:
    """Whether the ranks on ``a`` and ``b`` can open each other's memory:
    one host, and one card or cards with peer access both ways."""
    return a.host == b.host and (a.uuid == b.uuid or (
        b.uuid in a.access and a.uuid in b.access))


def choose_seam_transport(device_type: str, cards,
                          requested: str | None = None) -> str:
    """The transport of a gang's seams: ``"gloo"`` for CPU strips (any
    request); for CUDA strips ``requested``, or by default ``"peer"``
    where every pair of the ranks' ``cards`` (rank order) reaches each
    other and ``"gloo"`` where one does not.  Every pair, not only the
    neighbours of one decomposition: the choice holds for the gang.
    Asking for ``"peer"`` where a pair does not reach raises, naming both
    ranks' cards."""
    if requested not in (None, *TRANSPORTS):
        raise ValueError(f"seam transport {requested!r}: expected one of "
                         f"{TRANSPORTS}")
    if device_type != "cuda" or requested == "gloo":
        return "gloo"
    cards = list(cards)
    for a in range(len(cards)):
        for b in range(a + 1, len(cards)):
            if reaches(cards[a], cards[b]):
                continue
            if requested == "peer":
                ca, cb = cards[a], cards[b]
                raise RuntimeError(
                    f"seam transport 'peer': rank {a} (card {ca.uuid} on "
                    f"{ca.host}) and rank {b} (card {cb.uuid} on {cb.host})"
                    " cannot open each other's memory: they need one host "
                    "and one card, or cards with peer access")
            return "gloo"
    return "peer"


def gather_cards(device: torch.device) -> list:
    """Every rank's :class:`Card`, rank order.  Collective."""
    cards = [None] * env.get_num_ranks()
    dist.all_gather_object(cards, card_of(device))
    return cards


# ---------------------------------------------------------------------------
# Edges, counts and the window key (the transport and its plain version)
# ---------------------------------------------------------------------------

def _active(batch) -> list:
    """``(tensor, peer, tag)`` of a batch's active entries."""
    return [(t, peer, tag) for t, peer, active, tag in batch if active]


def edge(src: int, dst: int, tag: int, t: torch.Tensor) -> tuple:
    """The edge of a strip: sender, receiver, tag, shape, dtype."""
    return (src, dst, tag, tuple(t.shape), t.dtype)


def window_key(sends, recvs, device) -> tuple:
    """The window of a batch (active entries, ``(tensor, peer, tag)``):
    :data:`.rdma.COLLECTIVE_ID_SEAM`, then the batch's signature: each
    send's and receive's peer, tag, shape and dtype, and the device."""
    def sig(batch):
        return tuple((peer, tag, tuple(t.shape), t.dtype)
                     for t, peer, tag in batch)
    return (COLLECTIVE_ID_SEAM, sig(sends), sig(recvs), device)


class Counts:
    """One rank's messages so far on each edge, sent and received."""

    def __init__(self):
        self.n: dict[tuple, int] = {}

    def plan(self, rank: int, sends, recvs) -> tuple[list, list]:
        """``(edge, n)`` of each active send and receive of a batch
        (``(tensor, peer, tag)`` each), counted.  A batch that sends to a
        peer must receive from it too (the reuse of the landings rests
        on it): one that does not raises."""
        lone = {p for _, p, _ in sends} - {p for _, p, _ in recvs}
        if lone:
            raise ValueError(f"rank {rank}'s batch sends to rank(s) "
                             f"{sorted(lone)} without receiving from them")
        out = []
        for batch, mine in ((sends, True), (recvs, False)):
            got = []
            for t, peer, tag in batch:
                e = edge(rank, peer, tag, t) if mine else \
                    edge(peer, rank, tag, t)
                n = self.n[e] = self.n.get(e, 0) + 1
                got.append((e, n))
            out.append(got)
        return out[0], out[1]


# ---------------------------------------------------------------------------
# The plain version: every rank of a gang simulated in one process
# ---------------------------------------------------------------------------

def _rank_batch(rank, sends, recvs, counts, fence, land, buffers):
    """One batch of one rank, step by step: a generator that yields where
    the stream would block on a wait."""
    ps, pr = counts.plan(rank, sends, recvs)
    for (t, peer, _), (e, n) in zip(sends, ps):
        land.put((peer, n % buffers, e), t)
        fence.write(peer, e, n, by=rank)
    for e, n in pr:
        while not fence.reached(rank, e, n):
            yield
    for (t, _, _), (e, n) in zip(recvs, pr):
        t.copy_(land.take((rank, n % buffers, e)))


class _Stopped(BaseException):
    """Ends a simulated rank's thread when the simulation stops."""


class _Turns:
    """The simulated ranks' threads, run one at a time: a rank runs until
    its stream would block, or its program ends, then hands the turn
    back."""

    def __init__(self, nranks: int):
        self.cv = threading.Condition()
        self.turn = None
        self.stopped = False
        self.done = [False] * nranks
        self.errors = [None] * nranks
        self.results = [None] * nranks

    def _wait_turn(self, rank):
        self.cv.wait_for(lambda: self.turn == rank or self.stopped)
        if self.stopped:
            raise _Stopped

    def pause(self, rank):
        """Rank ``rank``'s thread: hand the turn back, wait for the next."""
        with self.cv:
            self.turn = None
            self.cv.notify_all()
            self._wait_turn(rank)

    def run(self, rank, nranks, program, send_recv):
        sim = env.simulated
        sim.rank, sim.ranks, sim.send_recv = rank, nranks, send_recv
        try:
            with self.cv:
                self._wait_turn(rank)
            self.results[rank] = program()
        except _Stopped:
            pass
        except BaseException as err:  # handed to the caller
            self.errors[rank] = err
        finally:
            with self.cv:
                self.done[rank] = True
                self.turn = None
                self.cv.notify_all()

    def give(self, rank):
        """The caller's thread: let ``rank`` run its turn."""
        with self.cv:
            self.turn = rank
            self.cv.notify_all()
            self.cv.wait_for(lambda: self.turn is None)

    def stop(self):
        with self.cv:
            self.stopped = True
            self.cv.notify_all()


def seam_reference(programs, order=None, buffers: int = 2,
                   fence: FenceModel | None = None) -> list:
    """Run ``programs[r]()`` as rank ``r`` of a gang of ``len(programs)``
    ranks simulated in this process, and return their results in rank
    order.  Each runs in a thread of its own, in which
    :func:`.environment.get_rank` and ``get_num_ranks`` give the
    simulated gang's, and every strip transfer of :func:`.halo._send_recv`
    runs the seam protocol of ``"peer"`` over one :class:`.rdma.FenceModel`
    (``fence``, which then holds the trace) and one :class:`.rdma._Landing`
    (``buffers`` landing buffers per edge: 2 by parity; 1 shows why one
    is not enough).  The ranks take turns (``order``, a list of ranks,
    may repeat one to run it ahead); a turn lasts until the rank's
    stream would block on a wait or its program ends.  A rank that
    raises stops the gang and its error is raised here; ranks that can
    make no progress raise."""
    nranks = len(programs)
    fence = FenceModel() if fence is None else fence
    land = _Landing()
    turns = _Turns(nranks)
    counts = [Counts() for _ in range(nranks)]

    def send_recv_of(rank):
        def send_recv(sends, recvs):
            for _ in _rank_batch(rank, _active(sends), _active(recvs),
                                 counts[rank], fence, land, buffers):
                turns.pause(rank)
        return send_recv

    threads = [threading.Thread(
        target=turns.run, args=(r, nranks, programs[r], send_recv_of(r)),
        name=f"seam-rank-{r}", daemon=True) for r in range(nranks)]
    for th in threads:
        th.start()
    order = list(range(nranks)) if order is None else list(order)
    live = set(range(nranks))
    try:
        while live:
            before = (fence.events, len(live))
            for r in order:
                if r not in live:
                    continue
                turns.give(r)
                if turns.errors[r] is not None:
                    raise turns.errors[r]
                if turns.done[r]:
                    live.discard(r)
            if live and (fence.events, len(live)) == before:
                raise RuntimeError(f"the seam protocol is stuck: ranks "
                                   f"{sorted(live)} wait on strips nobody "
                                   "sends")
    finally:
        turns.stop()
        for th in threads:
            th.join()
    return turns.results


# ---------------------------------------------------------------------------
# The transport on the card
# ---------------------------------------------------------------------------

def _plane(t: torch.Tensor):
    """``(pointer, row pitch, row width, rows)`` in bytes where ``t`` is
    rows of one contiguous run each at one pitch (a strip of a stacked
    block is), else None."""
    es = t.element_size()
    dims = [(s, st) for s, st in zip(t.shape, t.stride()) if s != 1]
    run, i = 1, len(dims)
    while i > 0 and dims[i - 1][1] == run:
        run *= dims[i - 1][0]
        i -= 1
    if i == len(dims) and dims:
        return None
    if i == 0:
        return t.data_ptr(), run * es, run * es, 1
    height, pitch = dims[i - 1]
    for s, st in reversed(dims[:i - 1]):
        if st != pitch * height:
            return None
        height *= s
    if pitch < run:
        return None
    return t.data_ptr(), pitch * es, run * es, height


@dataclass
class _Area:
    """An edge's device side: its slot and its parity-0 landing buffer
    (device pointers), the buffer's bytes and the stride to parity 1;
    on the receiver also its window's allocation, the slot's index there
    and the card."""
    slot: int
    land: int
    nbytes: int
    stride: int
    base: int = 0
    index: int = 0
    device: int = 0


@dataclass
class SeamWindow:
    """The host's bound on one batch signature's waits
    (:func:`window_key`): its events by call parity and its calls, as
    :class:`.rdma.Window` keeps them, and the receives each of the last
    two calls waits on."""
    key: tuple
    device: int
    events: tuple
    calls: int = 0
    checked: int = 0
    issued_at: float = 0.0
    broken: str = ""
    waits: dict = field(default_factory=dict)   # call parity -> [(edge, n)]


class SeamTransport(rdma.RdmaExchangeKernel):
    """The ``"peer"`` transport of this process: ``csrc/seam_transport.cu``
    through ctypes, on the windows, events, budget and watchdog of
    :class:`.rdma.RdmaExchangeKernel` (whose library allocates, opens,
    reads and releases the windows).  ``batches`` counts the batches it
    has enqueued (one ``seam_batch`` call each; nothing else); callers
    may reset it."""

    #: this transport's source; ``source`` stays the windows' library's
    seam_source = "seam_transport.cu"

    def __init__(self):
        super().__init__()
        self.batches = 0
        self.counts = Counts()
        self._seam = None
        self._recv: dict[tuple, _Area] = {}
        self._send: dict[tuple, _Area] = {}
        self._allocs: list[int] = []
        self._opened: dict[bytes, int] = {}
        self._streams: dict[int, torch.cuda.Stream] = {}

    def build(self):
        """Build (once) and bind both libraries; returns the seam's
        BuiltLibrary."""
        from ..ops.cuda_build import load_library
        super().build()
        built = load_library("seam_transport", (self.seam_source,),
                             driver=True)
        if self._seam is None:
            lib = built.lib
            i, vp = ctypes.c_int, ctypes.c_void_p
            pll = ctypes.POINTER(ctypes.c_longlong)
            lib.seam_batch.argtypes = [i, i, pll, i, pll, vp, vp]
            for fn in (lib.seam_batch, lib.seam_send_fields,
                       lib.seam_recv_fields):
                fn.restype = i
            if (lib.seam_send_fields(), lib.seam_recv_fields()) != (7, 7):
                raise RuntimeError("libseam_transport's fields do not "
                                   "match seam.py's")
            self._seam = lib
        return built

    def _open_edges(self, rank, sends, recvs, ps, pr, dev: int) -> None:
        """The device side of the batch's new edges: one window of this
        rank's for its new receives, its handle sent to each sender, the
        senders' windows opened; pairwise over gloo."""
        new_r = [(t, p, tag, e) for (t, p, tag), (e, _) in zip(recvs, pr)
                 if e not in self._recv]
        new_s = [(t, p, tag, e) for (t, p, tag), (e, _) in zip(sends, ps)
                 if e not in self._send]
        if not new_r and not new_s:
            return
        if len(new_r) > NUM_SLOTS:
            raise ValueError(f"a batch of {len(new_r)} new receives: at "
                             f"most {NUM_SLOTS}")
        lib, ops = self._lib, []
        if new_r:
            at, areas = _align(NUM_SLOTS * 4), []
            for t, _, _, _ in new_r:
                nbytes = t.numel() * t.element_size()
                areas.append((at, nbytes, _align(nbytes)))
                at += 2 * _align(nbytes)
            ptr = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(lib.rdma_handle_bytes())
            self._check(lib.rdma_alloc(dev, at, ctypes.byref(ptr), handle),
                        "allocating a seam window")
            base = ptr.value
            self._allocs.append(base)
            ints = struct.unpack(f"{_HANDLE_INTS}q", handle.raw)
            for k, ((t, peer, tag, e), (off, nbytes, stride)) in enumerate(
                    zip(new_r, areas)):
                self._recv[e] = _Area(base + 4 * k, base + off, nbytes,
                                      stride, base, k, dev)
                msg = torch.tensor([k, off, nbytes, stride, *ints],
                                   dtype=torch.int64)
                ops.append(dist.P2POp(dist.isend, msg, peer,
                                      tag=HANDSHAKE_TAG + tag))
        got = []
        for t, peer, tag, e in new_s:
            buf = torch.empty(HANDSHAKE_INTS, dtype=torch.int64)
            ops.append(dist.P2POp(dist.irecv, buf, peer,
                                  tag=HANDSHAKE_TAG + tag))
            got.append((t, peer, e, buf))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for t, peer, e, buf in got:
            k, off, nbytes, stride, *ints = buf.tolist()
            if nbytes != t.numel() * t.element_size():
                raise RuntimeError(
                    f"rank {peer} receives {nbytes} bytes for a "
                    f"{tuple(t.shape)} {t.dtype} strip rank {rank} sends "
                    f"with tag {e[2]}")
            handle = struct.pack(f"{_HANDLE_INTS}q", *ints)
            if handle not in self._opened:
                pp = ctypes.c_void_p()
                self._check(lib.rdma_open(dev, handle, ctypes.byref(pp)),
                            f"opening rank {peer}'s seam window")
                self._opened[handle] = pp.value
            pp = self._opened[handle]
            self._send[e] = _Area(pp + 4 * k, pp + off, nbytes, stride)

    def _window(self, key, dev: int) -> SeamWindow:
        win = self._windows.get(key)
        if win is not None:
            return win
        events = []
        for _ in range(2):
            ev = ctypes.c_void_p()
            self._check(self._lib.rdma_event_create(ctypes.byref(ev)),
                        "creating a seam window's events")
            events.append(ev.value)
        win = SeamWindow(key, dev, tuple(events))
        with self._lock:
            self._windows[key] = win
        if self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watch, name="seam-watchdog", daemon=True)
            self._watchdog.start()
        return win

    def __call__(self, sends, recvs) -> None:
        """One batch of strips, ``(tensor, peer, active, tag)`` each, as
        :func:`.halo._send_recv` takes it; receives are written into
        their tensors, on the current stream.  Collective as gloo's
        point-to-point messages are: every send has its receive."""
        sends, recvs = _active(sends), _active(recvs)
        if not sends and not recvs:
            return
        device = (sends or recvs)[0][0].device
        if any(t.device != device for t, _, _ in sends + recvs):
            raise ValueError("a batch's strips must lie on one card")
        outs = [_plane(t) for t, _, _ in recvs]
        if None in outs:
            raise ValueError(
                "a received strip must be rows at one pitch, got strides "
                f"{[t.stride() for t, _, _ in recvs]}")
        if self._seam is None:
            self.build()
        dev = device.index if device.index is not None else \
            torch.cuda.current_device()
        rank = env.get_rank()
        key = window_key(sends, recvs, device)
        win = self._windows.get(key)
        if win is not None and win.broken:
            raise RuntimeError(f"this seam window is unusable: {win.broken}")
        ps, pr = self.counts.plan(rank, sends, recvs)
        self._open_edges(rank, sends, recvs, ps, pr, dev)
        win = self._window(key, dev)
        stream = torch.cuda.current_stream(device)
        last = self._streams.get(dev)
        if last is not None and last != stream:
            stream.wait_stream(last)     # one stream order for the seams
        self._streams[dev] = stream
        keep = []
        send = (ctypes.c_longlong * (7 * len(sends)))()
        for j, ((t, _, _), (e, n)) in enumerate(zip(sends, ps)):
            plane = _plane(t)
            if plane is None:
                keep.append(t.contiguous())
                plane = _plane(keep[-1])
            a = self._send[e]
            send[7 * j: 7 * j + 7] = (*plane, a.land + n % 2 * a.stride,
                                      a.slot, n & 0xFFFFFFFF)
        recv = (ctypes.c_longlong * (7 * len(recvs)))()
        for j, (plane, (e, n)) in enumerate(zip(outs, pr)):
            a = self._recv[e]
            recv[7 * j: 7 * j + 7] = (a.slot, n & 0xFFFFFFFF,
                                      a.land + n % 2 * a.stride, *plane)
        win.calls += 1
        self.finish(win, f"the seam transfer on rank {rank}",
                    upto=win.calls - 2)
        win.waits[win.calls % 2] = pr
        err = self._seam.seam_batch(dev, len(sends), send, len(recvs), recv,
                                    win.events[win.calls % 2],
                                    stream.cuda_stream)
        self.launched(win, err, "the seam transfer")
        self.batches += 1

    def settle(self) -> None:
        """Check on the host that every window's calls, the newest
        included, have passed their waits."""
        for win in list(self._windows.values()):
            self.finish(win, f"the seam transfer on rank {env.get_rank()}",
                        upto=win.calls)

    def _slot_value(self, a: _Area) -> int:
        slots = (ctypes.c_uint * NUM_SLOTS)()
        self._check(self._lib.rdma_read_slots(a.device, a.base, slots),
                    "reading a seam window's slots")
        return slots[a.index]

    def _expire(self, win: SeamWindow, call: int) -> None:
        """``call`` is still waiting past its budget: name the slots it
        waits on, release every slot of this rank's that a stream may be
        waiting on (this rank writes the awaited count itself, so the
        stream drains), and mark every window unusable: the gang's
        transfers are out of step."""
        with self._lock:
            if win.broken:
                return
            late = [(e, n) for e, n in win.waits.get(call % 2, ())
                    if (self._slot_value(self._recv[e]) - n) & 0x80000000]
            for e, a in self._recv.items():
                n = self.counts.n.get(e, 0)
                if (self._slot_value(a) - n) & 0x80000000:
                    self._check(self._lib.rdma_release(
                        a.device, a.base, a.index, n & 0xFFFFFFFF),
                        f"releasing seam slot {a.index}")
            names = ", ".join(
                f"slot {self._recv[e].index} of window "
                f"{self._recv[e].base:#x} (the {e[3]} {e[4]} strip rank "
                f"{e[0]} sends with tag {e[2]}, message {n})"
                for e, n in late)
            msg = (f"call {call}'s wait on {names or 'its strips'} was still "
                   f"pending after its {BUDGET_S} s budget")
            for w in self._windows.values():
                w.broken = w.broken or msg

    def close_windows(self) -> None:
        """Check every window's last call (:meth:`settle`), then close the
        peers' windows and free this rank's; the counts start again."""
        try:
            self.settle()
        finally:
            with self._lock:
                lib = self._lib
                for p in self._opened.values():
                    self._check(lib.rdma_close(p), "closing a peer window")
                for win in self._windows.values():
                    for ev in win.events:
                        self._check(lib.rdma_event_destroy(ev),
                                    "destroying a seam window's event")
                for base in self._allocs:
                    self._check(lib.rdma_free(base),
                                "freeing a seam window")
                self._windows.clear()
                self._opened.clear()
                self._allocs.clear()
                self._recv.clear()
                self._send.clear()
                self._streams.clear()
                self.counts = Counts()


#: the process's one ``"peer"`` transport
peer_seams = SeamTransport()


def close_windows() -> None:
    """Check the last transfers, then close every seam window of this
    process (see :func:`.environment.finalise`)."""
    peer_seams.close_windows()
