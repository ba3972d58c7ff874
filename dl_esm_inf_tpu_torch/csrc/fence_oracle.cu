// Adversarial oracles of the counting fence (rdma_fence.cuh) on one card,
// and the fence's round trip between two ranks, spinning in a kernel and
// with the wait off the SMs (the exchange's hand-off).
//
// Replaces the TPU kernel scripts/fence_oracle.py::_build (its
// pallas_call over an (8, 128) float32 tile and a REGULAR((2, 2))
// semaphore scratch), which attacks dl_esm_inf_tpu/parallel/rdma.py's
// fence with signals to self: the same fence_signal / fence_wait that
// signal a peer, on this rank's own slots.  One CTA, one thread per
// column; thread 0 signals and waits.
//
// * positive: every (phase, direction) slot is signalled for two calls
//   up front (the worst legal skew: a fast peer two fences ahead), then
//   two in-order rounds of waits each guard the writes o = x + row + 1 of
//   their rows.  Mis-accounting times out or corrupts o.
// * wait_00: signal the slots in `signal_mask` (bit 2*phase + dir), then
//   wait on [0, 0] with a short budget; on success row 0 of o becomes -1.
//   The negative oracle signals every other slot and must time out (an
//   implementation that aliases the slots completes); the control also
//   signals [0, 0] and must complete, so the negative's time-out is the
//   fence and not a dead kernel.
// * pingpong: `rounds` fence round trips with a peer rank's window: the
//   leader signals and then waits, the follower waits and then signals;
//   the leader's globaltimer after the first and after the last round
//   give the time of one round trip.
// * stream pingpong: the same round trips with the wait off the SMs:
//   stream_signal / stream_wait (rdma_fence.cuh) on the monotonic slot
//   kSlotPingValue, enqueued on the caller's stream; no kernel runs.  The
//   wrapper times it with CUDA events on the leader's stream.
//
// What bounds it: latency (a fenced system-scope atomic, and a spin on a
// counter); the oracle tile's 8 KiB of bytes take nanoseconds.
#include <cuda_runtime.h>

#include "rdma_fence.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;

__global__ void __launch_bounds__(kCols)
fence_positive_kernel(const float* __restrict__ x, float* __restrict__ o,
                      unsigned* slots, int* status,
                      unsigned long long budget_ns) {
  __shared__ int ok;
  const int c = threadIdx.x;
  const unsigned long long deadline = fence_clock() + budget_ns;
  if (c == 0) {
    ok = 1;
    for (int s = 0; s < 4; ++s) {
      fence_signal(slots, kSlotReady + s);
      fence_signal(slots, kSlotReady + s);
    }
  }
  __syncthreads();
  for (int rnd = 0; rnd < 2; ++rnd) {
    for (int phase = 0; phase < 2; ++phase) {
      if (c == 0) {
        for (int dir = 0; dir < 2 && ok; ++dir) {
          const int slot = kSlotReady + 2 * phase + dir;
          if (!fence_wait(slots, slot, deadline)) {
            fence_fail(status, slot);
            ok = 0;
          }
        }
      }
      __syncthreads();
      if (!ok) return;
      for (int k = 0; k < 2; ++k) {
        const int row = 4 * rnd + 2 * phase + k;
        o[row * kCols + c] = x[row * kCols + c] + static_cast<float>(row + 1);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kCols)
fence_wait00_kernel(const float* __restrict__ x, float* __restrict__ o,
                    unsigned* slots, int* status, int signal_mask,
                    unsigned long long budget_ns) {
  __shared__ int ok;
  const int c = threadIdx.x;
  for (int row = 0; row < kRows; ++row) o[row * kCols + c] = x[row * kCols + c];
  __syncthreads();
  if (c == 0) {
    const unsigned long long deadline = fence_clock() + budget_ns;
    for (int s = 0; s < 4; ++s) {
      if (signal_mask & (1 << s)) fence_signal(slots, kSlotReady + s);
    }
    ok = fence_wait(slots, kSlotReady + 0, deadline);
    if (!ok) fence_fail(status, kSlotReady + 0);
  }
  __syncthreads();
  if (ok) o[c] = -1.0f;
}

__global__ void fence_pingpong_kernel(unsigned* mine, unsigned* peer,
                                      int rounds, int leader, int* status,
                                      unsigned long long* times,
                                      unsigned long long budget_ns) {
  const unsigned long long deadline = fence_clock() + budget_ns;
  for (int r = 0; r < rounds; ++r) {
    if (leader) fence_signal(peer, kSlotPing);
    if (!fence_wait(mine, kSlotPing, deadline)) {
      fence_fail(status, kSlotPing);
      return;
    }
    if (!leader) fence_signal(peer, kSlotPing);
    if (r == 0) times[0] = fence_clock();
  }
  times[1] = fence_clock();
}

}  // namespace

extern "C" {

// x, o: (8, 128) float32 on the card; slots: >= kNumSlots zeroed
// unsigned; status: 2 ints.  Each launches one CTA on `stream` and returns
// cudaGetLastError().
int fence_positive_launch(const float* x, float* o, unsigned* slots,
                          int* status, unsigned long long budget_ns,
                          void* stream) {
  fence_positive_kernel<<<1, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, slots, status, budget_ns);
  return static_cast<int>(cudaGetLastError());
}

int fence_wait00_launch(const float* x, float* o, unsigned* slots,
                        int* status, int signal_mask,
                        unsigned long long budget_ns, void* stream) {
  fence_wait00_kernel<<<1, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, slots, status, signal_mask, budget_ns);
  return static_cast<int>(cudaGetLastError());
}

// mine, peer: the slot arrays of my and the peer's window (the peer's
// opened through IPC); times: 2 unsigned long long on the card.
int fence_pingpong_launch(void* mine, void* peer, int rounds, int leader,
                          int* status, unsigned long long* times,
                          unsigned long long budget_ns, void* stream) {
  fence_pingpong_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(mine), static_cast<unsigned*>(peer), rounds,
      leader, status, times, budget_ns);
  return static_cast<int>(cudaGetLastError());
}

// Rounds first+1 .. first+rounds of the stream ping-pong on `stream`:
// the leader signals the peer's kPingValue slot with the round's number
// and waits for its own to reach it; the follower waits, then signals.
// Returns the first CUresult that is not CUDA_SUCCESS (0).
int fence_stream_pingpong_launch(void* mine, void* peer, unsigned first,
                                 int rounds, int leader, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* m = static_cast<unsigned*>(mine) + kSlotPingValue;
  unsigned* p = static_cast<unsigned*>(peer) + kSlotPingValue;
  for (int r = 0; r < rounds; ++r) {
    const unsigned v = first + static_cast<unsigned>(r) + 1u;
    CUresult e = CUDA_SUCCESS;
    if (leader) e = stream_signal(s, p, v);
    if (e == CUDA_SUCCESS) e = stream_wait(s, m, v);
    if (e == CUDA_SUCCESS && !leader) e = stream_signal(s, p, v);
    if (e != CUDA_SUCCESS) return static_cast<int>(e);
  }
  return 0;
}

// *value = the card's CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1
// (attribute 92 of cuda.h; asked by number, since later toolkits rename
// the v1 attributes).  Returns the CUresult.
int fence_stream_memops_attribute(int device, int* value) {
  CUdevice dev;
  CUresult e = cuInit(0);
  if (e == CUDA_SUCCESS) e = cuDeviceGet(&dev, device);
  if (e == CUDA_SUCCESS) {
    e = cuDeviceGetAttribute(value, static_cast<CUdevice_attribute>(92),
                             dev);
  }
  return static_cast<int>(e);
}

}  // extern "C"
