"""Adversarial oracles of the readiness fence, on one card.

Counterpart of ``scripts/fence_oracle.py``.  The fence of :mod:`.rdma`
(``csrc/rdma_fence.cuh``) is the code that the exchange between ranks
trusts for ordering; these oracles attack its two load-bearing
properties with signals to self on one card (the same fenced atomics
that signal a peer):

* **positive**: counting buffers multi-call skew.  Every (phase,
  direction) slot is signalled for two calls up front, then two in-order
  rounds of waits guard the writes ``o = x + row + 1``; the output must
  equal that bitwise.
* **negative**: a wait can only be satisfied by its own (phase,
  direction).  Every other slot is signalled, then [0, 0] is waited on
  with a short budget: it must time out.  An implementation that aliases
  the slots completes.
* **control**: the same kernel with [0, 0] signalled too must complete,
  so the negative's time-out is the fence and not a dead kernel.

On the card the kernels are ``csrc/fence_oracle.cu`` (:data:`fence_oracle`);
on the CPU the oracles run on :class:`.rdma.FenceModel`, the fence's
plain version.  :func:`pingpong_us` times one fence round trip between
two ranks, :func:`stream_pingpong_us` one with the wait off the SMs
(stream memory operations: the stream blocks in the card's front end).

    python -m dl_esm_inf_tpu_torch.parallel.fence_oracle [cuda|cpu]
"""
from __future__ import annotations

import ctypes
import sys
import time

import numpy as np
import torch

from .rdma import NUM_SLOTS, FenceModel, ready_slot

ROWS, COLS = 8, 128
#: the negative oracle's budget: far above a satisfiable wait's time, far
#: below anything a user would wait for
NEGATIVE_BUDGET_S = 0.2
POSITIVE_BUDGET_S = 10.0
PINGPONG_BUDGET_S = 60.0


def oracle_input() -> np.ndarray:
    return np.arange(ROWS * COLS, dtype=np.float32).reshape(ROWS, COLS)


def oracle_want(x: np.ndarray) -> np.ndarray:
    return x + np.arange(1, ROWS + 1, dtype=np.float32)[:, None]


# --- the plain versions ------------------------------------------------------

def positive_reference(x: torch.Tensor) -> torch.Tensor:
    """The positive oracle on :class:`.rdma.FenceModel`: raises if a wait
    would block."""
    fence, o = FenceModel(), torch.zeros_like(x)
    for slot in range(4):
        fence.signal(0, slot, 2)
    for rnd in (0, 1):
        for phase in (0, 1):
            for direction in (0, 1):
                if not fence.try_wait(0, ready_slot(phase, direction)):
                    raise RuntimeError(f"positive oracle: round {rnd} wait "
                                       f"[{phase}, {direction}] would block")
            for k in (0, 1):
                row = 4 * rnd + 2 * phase + k
                o[row] = x[row] + float(row + 1)
    return o


def wait00_reference(x: torch.Tensor, signal_mask: int):
    """``(o, completed)`` of the negative (mask 0b1110) or control (0b1111)
    oracle on :class:`.rdma.FenceModel`."""
    fence, o = FenceModel(), x.clone()
    for slot in range(4):
        if signal_mask & (1 << slot):
            fence.signal(0, slot)
    done = fence.try_wait(0, ready_slot(0, 0))
    if done:
        o[0] = -1.0
    return o, done


# --- the kernels ---------------------------------------------------------------

class FenceOracleKernel:
    """ctypes wrapper of ``csrc/fence_oracle.cu``.  ``launches`` counts
    the kernel launches this wrapper has made (and nothing else)."""

    source = "fence_oracle.cu"

    def __init__(self):
        self.launches = 0
        self._lib = None

    def build(self):
        from ..ops.cuda_build import load_library
        built = load_library("fence_oracle", (self.source,), driver=True)
        if self._lib is None:
            vp, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
            lib = built.lib
            for name, args in (
                    ("fence_positive_launch", [vp, vp, vp, vp, u64, vp]),
                    ("fence_wait00_launch", [vp, vp, vp, vp, i, u64, vp]),
                    ("fence_pingpong_launch",
                     [vp, vp, i, i, vp, vp, u64, vp]),
                    ("fence_stream_pingpong_launch",
                     [vp, vp, ctypes.c_uint, i, i, vp]),
                    ("fence_stream_memops_attribute",
                     [i, ctypes.POINTER(i)])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = i
            self._lib = lib
        return built

    @staticmethod
    def _check_input(x: torch.Tensor) -> None:
        if (x.device.type != "cuda" or x.dtype != torch.float32
                or tuple(x.shape) != (ROWS, COLS) or not x.is_contiguous()):
            raise ValueError(f"the fence oracles take a contiguous "
                             f"({ROWS}, {COLS}) float32 CUDA tensor")

    def _launch(self, name, *args):
        self.build()
        err = getattr(self._lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUDA error {err}")
        self.launches += 1

    def positive(self, x: torch.Tensor):
        """``(o, status)`` of the positive oracle; status is [0, 0] when
        every wait was satisfied."""
        self._check_input(x)
        o = torch.zeros_like(x)
        slots = torch.zeros(NUM_SLOTS, dtype=torch.int32, device=x.device)
        status = torch.zeros(2, dtype=torch.int32, device=x.device)
        self._launch("fence_positive_launch", x.data_ptr(), o.data_ptr(),
                     slots.data_ptr(), status.data_ptr(),
                     int(POSITIVE_BUDGET_S * 1e9),
                     torch.cuda.current_stream(x.device).cuda_stream)
        return o, status.tolist()

    def wait00(self, x: torch.Tensor, signal_mask: int,
               budget_s: float = NEGATIVE_BUDGET_S):
        """``(o, completed, seconds)``: the negative or control oracle,
        and how long its launch took."""
        self._check_input(x)
        o = torch.empty_like(x)
        slots = torch.zeros(NUM_SLOTS, dtype=torch.int32, device=x.device)
        status = torch.zeros(2, dtype=torch.int32, device=x.device)
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        self._launch("fence_wait00_launch", x.data_ptr(), o.data_ptr(),
                     slots.data_ptr(), status.data_ptr(), signal_mask,
                     int(budget_s * 1e9),
                     torch.cuda.current_stream(x.device).cuda_stream)
        st = status.tolist()          # waits for the kernel
        return o, st[0] == 0, time.perf_counter() - t0

    def pingpong(self, mine: int, peer: int, rounds: int, leader: bool,
                 device: torch.device, budget_s: float):
        """``(status, times)``: ``rounds`` fence round trips between this
        rank's window slots ``mine`` and a peer's opened ``peer``."""
        status = torch.zeros(2, dtype=torch.int32, device=device)
        times = torch.zeros(2, dtype=torch.int64, device=device)
        self._launch("fence_pingpong_launch", mine, peer, rounds, int(leader),
                     status.data_ptr(), times.data_ptr(), int(budget_s * 1e9),
                     torch.cuda.current_stream(device).cuda_stream)
        return status.tolist(), times.tolist()

    def stream_pingpong(self, mine: int, peer: int, first: int, rounds: int,
                        leader: bool, stream: int) -> None:
        """Enqueue rounds ``first + 1 .. first + rounds`` of the stream
        ping-pong on ``stream`` (no kernel: not counted as a launch)."""
        self.build()
        err = self._lib.fence_stream_pingpong_launch(
            mine, peer, first & 0xFFFFFFFF, rounds, int(leader), stream)
        if err != 0:
            raise RuntimeError(f"the stream ping-pong failed: CUDA driver "
                               f"error {err}")

    def stream_memops(self, device: torch.device) -> int:
        """The card's CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1, or
        -CUresult where the driver does not answer it."""
        self.build()
        value = ctypes.c_int(-1)
        err = self._lib.fence_stream_memops_attribute(
            device.index or 0, ctypes.byref(value))
        return value.value if err == 0 else -err


#: the process's one wrapper of the oracle kernels
fence_oracle = FenceOracleKernel()


NEGATIVE_MASK = 0b1110      # every slot but [0, 0]
CONTROL_MASK = 0b1111


def run_oracles(device) -> dict:
    """The three oracles on ``device`` (the kernels on a CUDA device, the
    plain versions on the CPU); raises on the first that fails.  Returns
    what they showed."""
    dev = torch.device(device)
    x = torch.from_numpy(oracle_input()).to(dev)
    want = torch.from_numpy(oracle_want(oracle_input())).to(dev)
    if dev.type == "cuda":
        o, status = fence_oracle.positive(x)
        if status != [0, 0]:
            raise AssertionError(f"positive oracle: a wait timed out "
                                 f"(status {status})")
        neg, neg_done, neg_s = fence_oracle.wait00(x, NEGATIVE_MASK)
        ctl, ctl_done, ctl_s = fence_oracle.wait00(x, CONTROL_MASK)
    else:
        o = positive_reference(x)
        neg, neg_done = wait00_reference(x, NEGATIVE_MASK)
        ctl, ctl_done = wait00_reference(x, CONTROL_MASK)
        neg_s = ctl_s = None
    if not torch.equal(o, want):
        raise AssertionError("positive oracle: output != x + row + 1")
    if neg_done or not torch.equal(neg, x):
        raise AssertionError("negative oracle: the [0, 0] wait was released "
                             "by other slots' signals (aliasing)")
    ctl_want = x.clone()
    ctl_want[0] = -1.0
    if not ctl_done or not torch.equal(ctl, ctl_want):
        raise AssertionError("control oracle: the signalled [0, 0] wait did "
                             "not complete")
    return {"positive": True, "negative_timed_out": True,
            "control_completed": True, "negative_s": neg_s,
            "control_s": ctl_s}


def pingpong_us(win, peer_rank: int, rounds: int, device) -> float:
    """µs per fence round trip between this rank and ``peer_rank`` (two
    ranks, one leader each way), on this rank's exchange ``win``dow
    (:meth:`.rdma.RdmaExchangeKernel.window`), timed by the leader's
    ``%globaltimer`` between its first and last round.  Collective
    between the two ranks; the leader is the lower rank."""
    from . import environment as env
    leader = env.get_rank() < peer_rank
    mine = win.ptr
    peer = win.peers[peer_rank]
    status, times = fence_oracle.pingpong(mine, peer, rounds, leader,
                                          torch.device(device),
                                          PINGPONG_BUDGET_S)
    if status != [0, 0]:
        raise RuntimeError(f"fence ping-pong: slot {status[1]} timed out")
    return (times[1] - times[0]) / (rounds - 1) / 1e3


def stream_pingpong_us(win, peer_rank: int, rounds: int, device) -> float:
    """µs per round trip of :func:`pingpong_us`'s exchange with the wait
    off the SMs: stream memory operations on the monotonic slot
    ``SLOT_PING_VALUE`` of the same windows, timed by CUDA events on the
    leader's stream after its first round.  Every wait is bounded by
    :data:`PINGPONG_BUDGET_S` on the host: one still pending then is
    released and raises."""
    from . import environment as env
    from .rdma import SLOT_PING_VALUE, await_done, halo_exchange_rdma
    dev = torch.device(device)
    leader = env.get_rank() < peer_rank
    stream = torch.cuda.current_stream(dev)
    first = win.stream_pings
    win.stream_pings += rounds
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    args = (win.ptr, win.peers[peer_rank])
    fence_oracle.stream_pingpong(*args, first, 1, leader, stream.cuda_stream)
    start.record(stream)
    fence_oracle.stream_pingpong(*args, first + 1, rounds - 1, leader,
                                 stream.cuda_stream)
    end.record(stream)
    if not await_done(end.query, PINGPONG_BUDGET_S):
        halo_exchange_rdma.release(win, SLOT_PING_VALUE, first + rounds)
        torch.cuda.synchronize(dev)
        raise RuntimeError(f"stream ping-pong: slot {SLOT_PING_VALUE} "
                           f"still pending after {PINGPONG_BUDGET_S} s")
    return start.elapsed_time(end) * 1e3 / (rounds - 1)


def main(argv=None) -> dict:
    args = list(argv if argv is not None else sys.argv[1:])
    device = args[0] if args else "cuda"
    res = run_oracles(device)
    where = (torch.cuda.get_device_name(torch.device(device))
             if torch.device(device).type == "cuda" else "cpu (FenceModel)")
    print(f"fence POSITIVE oracle  OK (2-call burst skew consumed in order; "
          f"bitwise) [{where}]", flush=True)
    neg = (f" after {res['negative_s'] * 1e3:.1f} ms"
           if res["negative_s"] is not None else "")
    ctl = (f" in {res['control_s'] * 1e3:.3f} ms"
           if res["control_s"] is not None else "")
    print(f"fence NEGATIVE oracle  OK ([0, 0] wait timed out{neg} with "
          f"every other slot signalled)", flush=True)
    print(f"fence CONTROL oracle   OK ([0, 0] signalled: completed{ctl})",
          flush=True)
    print("ALL FENCE ORACLES PASS", flush=True)
    return res


if __name__ == "__main__":
    main()
