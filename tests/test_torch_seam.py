"""The port's seam transport between ranks (dl_esm_inf_tpu_torch/parallel/
seam.py) on the CPU: the choice of transport from the ranks' layout, the
protocol's plain version (every rank of a gang simulated in one process,
``seam_reference``) against the JAX package's single-process exchange,
bitwise at float64, with a skewed rank, with one landing buffer instead
of two, and the host's bookkeeping: window keys, edge counts, the strips
as 2-D copies, and the budget on a wait that never passes.  The copies
and stream waits themselves run on the card only (chip_smoke.py,
tests/test_torch_gpu.py); no gang runs here.
"""
import threading

import numpy as np
import pytest
import torch

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.parallel import halo as jhalo

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.parallel import environment as tenv
from dl_esm_inf_tpu_torch.parallel import halo as thalo
from dl_esm_inf_tpu_torch.parallel import rdma as trdma
from dl_esm_inf_tpu_torch.parallel import seam
from dl_esm_inf_tpu_torch.parallel.halo import HaloSpec

torch.set_num_threads(2)

WALLED = (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL, jdl.BC_NONE)
PERIODIC = (jdl.BC_PERIODIC, jdl.BC_PERIODIC, jdl.BC_NONE)


# --- the choice of transport --------------------------------------------

def _card(host, uuid, *access):
    return seam.Card(host, uuid, frozenset(access))


CHOICES = {
    "cpu": ("cpu", [_card("h", "a"), _card("h", "a")], "gloo"),
    "one card": ("cuda", [_card("h", "a"), _card("h", "a")], "peer"),
    "cards with access": ("cuda", [_card("h", "a", "b"),
                                   _card("h", "b", "a")], "peer"),
    "cards without access": ("cuda", [_card("h", "a"), _card("h", "b")],
                             "gloo"),
    "access one way": ("cuda", [_card("h", "a", "b"), _card("h", "b")],
                       "gloo"),
    "two hosts": ("cuda", [_card("h", "a"), _card("g", "a")], "gloo"),
    "one pair of three": ("cuda", [_card("h", "a"), _card("h", "a"),
                                   _card("h", "b")], "gloo"),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_default_transport_follows_the_layout(case):
    """The default is a pure function of the ranks' hosts, cards, peer
    access and the strips' device: peer only where every pair of ranks
    can open each other's memory, and never for CPU strips; asking for
    gloo always gives gloo, and asking for peer on the CPU moves CPU
    strips by gloo."""
    device_type, cards, want = CHOICES[case]
    assert seam.choose_seam_transport(device_type, cards) == want
    assert seam.choose_seam_transport(device_type, cards, "gloo") == "gloo"
    if want == "peer" or device_type == "cpu":
        assert seam.choose_seam_transport(device_type, cards,
                                          "peer") == want


@pytest.mark.parametrize("case", ["cards without access", "two hosts",
                                  "one pair of three"])
def test_asking_for_peer_where_the_layout_cannot_raises(case):
    """Asking for peer where a pair of ranks cannot open each other's
    memory raises, naming both ranks and their cards; a name that is no
    transport raises."""
    device_type, cards, _ = CHOICES[case]
    bad = next((a, b) for a in range(len(cards))
               for b in range(a + 1, len(cards))
               if not seam.reaches(cards[a], cards[b]))
    a, b = bad
    with pytest.raises(RuntimeError, match=(
            rf"rank {a} \(card {cards[a].uuid} on {cards[a].host}\) and "
            rf"rank {b} \(card {cards[b].uuid} on {cards[b].host}\)")):
        seam.choose_seam_transport(device_type, cards, "peer")
    with pytest.raises(ValueError, match="expected one of"):
        seam.choose_seam_transport(device_type, cards, "nccl")


def test_set_seam_transport_in_one_process(monkeypatch):
    """In one process the gang's transport is what was set (CPU strips
    move by gloo whatever it is); an unknown name raises."""
    monkeypatch.setitem(tenv._seam, "name", None)
    assert tenv.seam_transport() is None
    assert tenv.seam_transport_for(torch.device("cpu")) == "gloo"
    tenv.set_seam_transport("peer")
    assert tenv.seam_transport() == "peer"
    assert tenv.seam_transport_for(torch.device("cpu")) == "gloo"
    tenv.set_seam_transport("gloo")
    assert tenv.seam_transport() == "gloo"
    with pytest.raises(ValueError, match="expected one of"):
        tenv.set_seam_transport("host")
    assert tenv.seam_transport() == "gloo"


# --- the protocol's plain version against the JAX exchange --------------

def _grids(ranks, tiles, wrap, halo):
    """(the port's spec of ``ranks`` = (x, y) ranks of ``tiles`` tiles
    each, the JAX package's grid of the same tiles in one process)."""
    px, py = ranks[0] * tiles[0], ranks[1] * tiles[1]
    base = max(halo, 5)
    gnx, gny = base * px + (0 if wrap else 1), base * py + (0 if wrap else 1)
    bcs = PERIODIC if wrap else WALLED
    gj = jdl.Grid(jdl.ARAKAWA_C, bcs, jdl.OFFSET_NE)
    gj.decompose(gnx, gny, ndomainx=px, ndomainy=py, halo_width=halo)
    jdl.grid_init(gj, 1.0, 1.0)
    gt = tdl.Grid(tdl.ARAKAWA_C, bcs, tdl.OFFSET_NE, device="cpu")
    gt.decompose(gnx, gny, ndomainx=px, ndomainy=py, halo_width=halo)
    spec = HaloSpec(**{**gt.halo_spec.__dict__, "repx": tiles[0],
                       "repy": tiles[1]})
    assert (spec.ranks_x, spec.ranks_y) == tuple(ranks)
    return spec, gj


def _split(a, spec):
    """Whole stacked array -> the ranks' blocks, rank order."""
    ly, lx = spec.array_shape
    return [a[..., iy * ly: (iy + 1) * ly, ix * lx: (ix + 1) * lx]
            for iy, ix in (spec.rank_coords(r)
                           for r in range(spec.num_ranks))]


def _join(blocks, spec):
    rows = [torch.cat(blocks[iy * spec.ranks_x: (iy + 1) * spec.ranks_x],
                      dim=-1) for iy in range(spec.ranks_y)]
    return torch.cat(rows, dim=-2)


def _exchanges(spec, blocks, depth):
    """Each rank's program: the port's plain exchange of its block."""
    return [lambda b=b: thalo.exchange(b, spec, depth) for b in blocks]


#: (rank grid, tiles per rank), x by y
RANK_TILES = [((2, 1), (1, 2)), ((2, 1), (2, 2)), ((1, 2), (2, 1)),
              ((1, 2), (2, 2)), ((2, 2), (2, 1)), ((2, 2), (1, 2))]


@pytest.mark.parametrize("wrap", [False, True], ids=["walled", "periodic"])
@pytest.mark.parametrize("ranks,tiles", RANK_TILES, ids=str)
def test_seam_reference_matches_jax_exchange(ranks, tiles, wrap):
    """Every rank's exchange of its block over the simulated seam
    protocol equals the JAX package's single-process exchange of the
    whole stacked array, bitwise at float64, at depth 1 and at the halo,
    with every strip of a seam crossing it and one signal per strip."""
    halo = 2
    spec, gj = _grids(ranks, tiles, wrap, halo)
    for depth in (1, halo):
        a = np.random.default_rng(depth).standard_normal(
            spec.global_array_shape)
        want = np.asarray(jhalo.exchange(a, gj.mesh, gj.halo_spec, depth))
        fence = trdma.FenceModel()
        got = seam.seam_reference(
            _exchanges(spec, _split(torch.from_numpy(a), spec), depth),
            fence=fence)
        np.testing.assert_array_equal(_join(got, spec).numpy(), want,
                                      err_msg=str(depth))
        signals = [t for t in fence.trace if t[1] == "signal"]
        waits = [t for t in fence.trace if t[1] == "wait"]
        assert len(signals) == len(waits) > 0


def test_seam_reference_with_a_skewed_rank():
    """Three exchanges a rank on a periodic 2x2 rank grid, one rank given
    five turns for each of the others': it finishes an exchange while
    another rank has not finished the one before, no landing buffer is
    overwritten unread, and every exchange equals the run without skew
    and the single-process exchange of the whole array."""
    spec, _ = _grids((2, 2), (2, 1), True, 2)
    whole = HaloSpec(**{**spec.__dict__, "repx": spec.nprocx,
                        "repy": spec.nprocy})
    inputs = [torch.from_numpy(np.random.default_rng(10 + c).standard_normal(
        spec.global_array_shape)) for c in range(3)]
    fast, lock = 2, threading.Lock()

    def run(order):
        done, lead = [0] * spec.num_ranks, [0]

        def program(r):
            outs = []
            for a in inputs:
                outs.append(thalo.exchange(_split(a, spec)[r], spec, 2))
                with lock:
                    done[r] += 1
                    if r == fast:
                        lead[0] = max(lead[0], done[r] - min(done))
            return outs
        res = seam.seam_reference(
            [lambda r=r: program(r) for r in range(spec.num_ranks)],
            order=order)
        return res, lead[0]
    plain, _ = run(None)
    skewed, lead = run([fast] * 5 + [r for r in range(4) if r != fast])
    assert lead >= 1
    for c, a in enumerate(inputs):
        got = _join([skewed[r][c] for r in range(4)], spec)
        assert torch.equal(got, _join([plain[r][c] for r in range(4)], spec))
        assert torch.equal(got, thalo.exchange(a, whole, 2)), c


def test_seam_reference_with_one_buffer_is_caught():
    """With one landing buffer per edge instead of two (the count's
    parity dropped), the skewed rank's next exchange overwrites a strip
    its neighbour has not read yet: the simulation raises.  The same
    turns with two buffers run through."""
    spec, _ = _grids((2, 1), (1, 2), True, 2)
    blocks = _split(torch.zeros(spec.global_array_shape), spec)

    def programs():
        return [lambda b=b: [thalo.exchange(b, spec, 2) for _ in range(3)]
                for b in blocks]
    seam.seam_reference(programs(), order=[0] * 5 + [1])
    with pytest.raises(RuntimeError, match="overwritten"):
        seam.seam_reference(programs(), order=[0] * 5 + [1], buffers=1)


def test_seam_reference_faults_raise():
    """A rank that never sends leaves its neighbours stuck, which raises;
    so does a batch that sends to a rank without receiving from it (the
    reuse of the landings rests on every batch doing both)."""
    spec, _ = _grids((2, 1), (1, 2), False, 2)
    blocks = _split(torch.zeros(spec.global_array_shape), spec)
    with pytest.raises(RuntimeError, match=r"stuck: ranks \[0\]"):
        seam.seam_reference([lambda: thalo.exchange(blocks[0], spec, 1),
                             lambda: None])
    strip = torch.zeros(2, 3)
    with pytest.raises(ValueError, match=r"sends to rank\(s\) \[1\] "
                                         "without receiving"):
        seam.seam_reference([
            lambda: thalo._send_recv([(strip, 1, True, 0)], []),
            lambda: thalo._send_recv([], [(torch.zeros(2, 3), 0, True, 0)])])


# --- the host's bookkeeping ---------------------------------------------

def test_window_key_and_edge_counts():
    """A batch's window key is its signature (peers, tags, shapes, dtype)
    and device under the seam's collective id: the same batch finds the
    same key, any change of signature a new one; each edge counts its
    messages from 1, and a new shape is a new edge."""
    s = torch.zeros(3, 4)
    cpu = torch.device("cpu")
    key = seam.window_key([(s, 1, 0)], [(s, 1, 1)], cpu)
    assert key[0] == trdma.COLLECTIVE_ID_SEAM == 3
    assert key == seam.window_key([(s.clone(), 1, 0)], [(s, 1, 1)], cpu)
    for sends, recvs, device in (
            ([(torch.zeros(3, 5), 1, 0)], [(s, 1, 1)], cpu),
            ([(s.double(), 1, 0)], [(s, 1, 1)], cpu),
            ([(s, 1, 1)], [(s, 1, 1)], cpu),
            ([(s, 2, 0)], [(s, 1, 1)], cpu),
            ([(s, 1, 0)], [(s, 1, 1)], torch.device("meta"))):
        assert seam.window_key(sends, recvs, device) != key
    counts = seam.Counts()
    for n in (1, 2):
        ps, pr = counts.plan(0, [(s, 1, 0)], [(s, 1, 1)])
        assert ps == [(seam.edge(0, 1, 0, s), n)]
        assert pr == [(seam.edge(1, 0, 1, s), n)]
    ps, _ = counts.plan(0, [(torch.zeros(3, 5), 1, 0)], [(s, 1, 1)])
    assert ps[0][1] == 1


def test_strips_move_as_two_dimensional_copies():
    """A strip of a stacked block (an x strip: rows of d columns at the
    block's pitch; a y strip: whole rows) is one 2-D copy read straight
    from the block; a view that is not rows at one pitch is not."""
    # (G, ry, ly, rx, lx)
    blk = torch.zeros(3, 2, 6, 2, 10, dtype=torch.float64)
    es = 8
    x = blk[..., 1:2, 7:10]                        # d = 3 columns
    ptr, pitch, width, rows = seam._plane(x)
    assert (ptr, pitch, width, rows) == (x.data_ptr(), 20 * es, 3 * es,
                                         3 * 2 * 6)
    y = blk[:, 1:2, 4:6]                           # 2 full-width rows
    assert seam._plane(y)[1:] == (2 * 6 * 20 * es, 2 * 20 * es, 3)
    assert seam._plane(blk)[1:] == (blk.numel() * es, blk.numel() * es, 1)
    assert seam._plane(blk[..., ::2]) is None
    assert seam._plane(blk.transpose(-1, -2)) is None


def test_seam_wait_budget_raises_naming_the_slot(monkeypatch):
    """The host's bound on the seam's stream waits, with a clock that
    jumps and a library whose events never complete: a batch whose wait
    on a strip is still pending past BUDGET_S (checked before its event
    is recorded again, or by the watchdog) releases every slot of this
    rank's below its count, marks every window unusable and raises,
    naming the slot, the window and the rank that sends the strip."""
    s = torch.zeros(8, 4)
    e_from1 = seam.edge(1, 0, 0, s)
    e_from2 = seam.edge(2, 0, 1, s)

    class Lib:
        done = True

        def __init__(self):
            self.released = []

        def rdma_event_query(self, event):
            return 0 if self.done else 600

        def rdma_read_slots(self, device, ptr, out):
            out[0], out[1] = 2, 3            # edge 0 stuck at 2 of 3
            return 0

        def rdma_release(self, device, ptr, slot, value):
            self.released.append((slot, value))
            return 0

    def transport():
        t = seam.SeamTransport()
        t._lib = Lib()
        t._recv = {e_from1: seam._Area(0x1000, 0x1100, 128, 256, 0x1000,
                                       0, 0),
                   e_from2: seam._Area(0x1004, 0x1300, 128, 256, 0x1000,
                                       1, 0)}
        t.counts.n = {e_from1: 3, e_from2: 3}
        win = seam.SeamWindow("key", 0, (5, 6), calls=3, checked=1)
        win.waits = {0: [(e_from1, 2), (e_from2, 2)],
                     1: [(e_from1, 3), (e_from2, 3)]}
        other = seam.SeamWindow("other", 0, (7, 8))
        t._windows = {"key": win, "other": other}
        return t, win, other

    clock = iter(np.arange(0.0, 1e6, 50.0))
    monkeypatch.setattr(trdma, "_clock", lambda: next(clock))
    monkeypatch.setattr(tenv, "get_rank", lambda: 0)
    t, win, _ = transport()
    t.finish(win, "the seam transfer")     # call 2 passed; 3 is newest
    assert (win.checked, win.broken, t._lib.released) == (2, "", [])
    for check in ("finish", "watchdog"):
        t, win, other = transport()
        t._lib.done, win.checked = False, 2
        if check == "finish":
            with pytest.raises(RuntimeError, match=(
                    r"call 3's wait on slot 0 of window 0x1000 \(the "
                    r"\(8, 4\) torch.float32 strip rank 1 sends with tag "
                    r"0, message 3\) was still pending")):
                t.finish(win, "the seam transfer", upto=win.calls)
        else:
            win.issued_at = -1e5                 # enqueued long ago
            t.watch_once()
            assert "rank 1 sends with tag 0" in win.broken
        # the stuck slot is released to its count, so the stream drains;
        # every window of the gang is unusable
        assert t._lib.released == [(0, 3)]
        assert other.broken == win.broken != ""
