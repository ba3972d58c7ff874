// The fence between ranks: slots in device memory that peers write
// through CUDA IPC, in two kinds.
//
// Replaces the semaphore half of the TPU transports,
// dl_esm_inf_tpu/parallel/rdma.py::make_fence (the piece
// scripts/fence_oracle.py attacks).  A rank's window (allocated by
// halo_exchange_rdma.cu with cudaMalloc, exported with
// cudaIpcGetMemHandle and opened by its neighbours) starts with
// kNumSlots unsigned slots:
//
//   ready[phase][dir]  kSlotReady + 2*phase + dir  (the oracles' semaphores)
//   ping               kSlotPing        (the spin round-trip probe)
//   ping_value         kSlotPingValue   (the stream round-trip probe)
//   delivered[dir]     kSlotDelivered + dir, dir one of the 8 directions
//                      of rdma_protocol.cuh (the exchange's hand-off)
//
// * The exchange (rdma_protocol.cuh) waits off the SMs, with stream
//   memory operations on monotonic slots (stream_signal / stream_wait
//   below): a delivered slot holds the number of the last call whose
//   strip its one writer, the peer in that direction, has delivered.  On
//   a card time-sliced between processes, a stream blocked on a wait
//   lets the scheduler switch to the peer's context at once; a kernel
//   spinning on a counter keeps the card to the end of its slice.
// * The counting semaphore (fence_signal / fence_wait), which the
//   exchange no longer uses, stays for the fence oracles
//   (fence_oracle.cu) and the spin round-trip probe:
//   - signal: __threadfence_system() (this thread's earlier stores
//     become visible to every other process first), then a system-scope
//     atomic add on the peer's slot;
//   - wait: consumes exactly one signal, by a system-scope compare-and-
//     swap that decrements only a positive count; counts persist, so a
//     fast signaller is buffered;
//   - every wait is bounded by a %globaltimer deadline (the card has no
//     watchdog for a spinning kernel); one that runs out returns false
//     and the caller writes its status pair {kStatusTimeout, slot}.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

constexpr int kSlotReady = 0;
constexpr int kSlotPing = 4;
constexpr int kSlotPingValue = 5;
constexpr int kSlotDelivered = 8;
constexpr int kNumSlots = 16;
// a status pair {code, slot}: 0 = ok, 1 = a wait ran out of budget on `slot`
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

// The wait off the SMs: stream memory operations of the CUDA driver API
// (the library links -lcuda).  A signal writes `value` into a slot after
// the stream's earlier work (the default flag fences that work's writes
// first, as __threadfence_system does); a wait blocks the stream in the
// card's front end, not in a kernel, until the slot holds at least
// `value` (CU_STREAM_WAIT_VALUE_GEQ compares modulo 2^32).  A slot that
// is waited on this way holds a monotonic count and has one writer.  The
// wait has no deadline of its own: the host bounds it (rdma.py).
inline CUresult stream_signal(cudaStream_t s, unsigned* slot,
                              unsigned value) {
  return cuStreamWriteValue32(s, reinterpret_cast<CUdeviceptr>(slot), value,
                              CU_STREAM_WRITE_VALUE_DEFAULT);
}

inline CUresult stream_wait(cudaStream_t s, unsigned* slot,
                            unsigned value) {
  return cuStreamWaitValue32(s, reinterpret_cast<CUdeviceptr>(slot), value,
                             CU_STREAM_WAIT_VALUE_GEQ);
}
