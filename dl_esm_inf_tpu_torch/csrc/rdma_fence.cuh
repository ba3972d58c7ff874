// The readiness fence and the entry barrier between ranks: counting
// semaphores in device memory that peers signal through CUDA IPC.
//
// Replaces the semaphore half of the TPU transports,
// dl_esm_inf_tpu/parallel/rdma.py::entry_barrier and make_fence (the
// pieces scripts/fence_oracle.py attacks).  A rank's window (allocated by
// halo_exchange_rdma.cu with cudaMalloc, exported with
// cudaIpcGetMemHandle and opened by its neighbours) starts with
// kNumSlots unsigned counters:
//
//   ready[phase][dir]      kSlotReady + 2*phase + dir
//   delivered[phase][dir]  kSlotDelivered + 2*phase + dir
//   barrier[cid]           kSlotBarrier + cid   (one per collective id)
//   ping                   kSlotPing            (the round-trip probe)
//
// followed by a status word pair.  dir 0 is signalled by my plus-side
// peer (east, north), dir 1 by my minus-side peer (west, south): a
// wait can only ever be satisfied by a signal of its own phase and
// direction, so a skewed neighbour's y-phase (or next-call x-phase)
// signal cannot release an x-phase wait early.
//
// * signal: __threadfence_system() (this thread's earlier stores
//   become visible to every other process first), then a system-scope
//   atomic add on the peer's slot.
// * wait: consumes exactly one signal: a system-scope compare-and-swap
//   that decrements only a positive count.  Counts persist across calls
//   and are never reset: counting is what buffers a fast peer one or
//   two calls ahead.
// * Every wait is bounded by a %globaltimer deadline (the card has no
//   watchdog for a spinning kernel).  A wait that runs out returns false;
//   the caller writes the status word and stops, and the host wrapper
//   raises.
//
// What bounds it: latency, not bytes.  A signal is one fenced atomic to
// another process's memory; a wait spins on it.  Two ranks on one card
// without MPS are time-sliced, so a wait for a peer that is not resident
// lasts until the scheduler switches contexts.
#pragma once

#include <cuda_runtime.h>

constexpr int kSlotReady = 0;
constexpr int kSlotDelivered = 4;
constexpr int kSlotBarrier = 8;
constexpr int kSlotPing = 12;
constexpr int kNumSlots = 16;
// the status pair after the slots: {code, slot}; 0 = ok, 1 = a wait ran
// out of budget on `slot`
constexpr int kStatusTimeout = 1;

__device__ inline unsigned long long fence_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ inline void fence_signal(unsigned* peer_slots, int slot) {
  __threadfence_system();
  atomicAdd_system(peer_slots + slot, 1u);
}

// Consume one signal of `slot`; false if `deadline` (globaltimer ns)
// passes first.  The trailing fence orders the caller's later reads
// (of data the signaller stored before signalling) after the consume.
__device__ inline bool fence_wait(unsigned* slots, int slot,
                                  unsigned long long deadline) {
  unsigned* p = slots + slot;
  for (;;) {
    const unsigned v = *reinterpret_cast<volatile unsigned*>(p);
    if (v > 0u && atomicCAS_system(p, v, v - 1u) == v) {
      __threadfence_system();
      return true;
    }
    if (fence_clock() > deadline) return false;
    __nanosleep(64);
  }
}

// Record a failed wait in the status pair (one thread).
__device__ inline void fence_fail(int* status, int slot) {
  status[1] = slot;
  status[0] = kStatusTimeout;
  __threadfence_system();
}

// Entry barrier (rdma.py: entry_barrier): signal every peer's barrier
// slot of this collective id, then wait for one signal per peer.  The
// peer list is wrap-indexed and may repeat a rank.
__device__ inline bool fence_entry_barrier(unsigned* mine,
                                           unsigned* const* peers,
                                           int npeers, int cid,
                                           unsigned long long deadline,
                                           int* status) {
  const int slot = kSlotBarrier + cid;
  for (int i = 0; i < npeers; ++i) fence_signal(peers[i], slot);
  for (int i = 0; i < npeers; ++i) {
    if (!fence_wait(mine, slot, deadline)) {
      fence_fail(status, slot);
      return false;
    }
  }
  return true;
}

// The per-(phase, direction) readiness fence (rdma.py: make_fence): I
// will write into both neighbours' landing buffers, so each must tell me
// it is ready.  I signal plus's [phase, 1] and minus's [phase, 0], then
// consume one signal from each of my own [phase, 0] and [phase, 1].
__device__ inline bool fence_phase(unsigned* mine, unsigned* plus,
                                   unsigned* minus, int phase,
                                   unsigned long long deadline,
                                   int* status) {
  fence_signal(plus, kSlotReady + 2 * phase + 1);
  fence_signal(minus, kSlotReady + 2 * phase + 0);
  for (int dir = 0; dir < 2; ++dir) {
    if (!fence_wait(mine, kSlotReady + 2 * phase + dir, deadline)) {
      fence_fail(status, kSlotReady + 2 * phase + dir);
      return false;
    }
  }
  return true;
}
