// The remote-DMA halo exchange between ranks, one tile per rank: a rank's
// edge strips go into its neighbours' landing buffers through CUDA IPC,
// fenced.  Shared by the standalone exchange (halo_exchange_rdma.cu) and
// the flagship's fused transport across ranks (nemolite2d_sweep_rdma.cu).
//
// The sequence is that of dl_esm_inf_tpu/parallel/halo_pallas.py:114-261
// and of the exchange inside the TPU sweep, ops/sweep.py:383-513:
//
//   1. entry barrier on the caller's collective id (rdma.py:
//      COLLECTIVE_ID_EXCHANGE, COLLECTIVE_ID_SWEEP);
//   2. x phase: fence(0, east, west); my east interior strip (d columns x
//      ly rows x lead) -> east peer's landing[x][0], my west strip -> west
//      peer's landing[x][1]; signal delivery, wait for mine; merge into the
//      west halo columns where has_w, the east ones where has_e;
//   3. y phase: fence(1, north, south); the full-width rows (x halos just
//      merged included, so corners arrive by sequencing) -> north peer's
//      landing[y][0] and south peer's landing[y][1]; deliver, wait, merge
//      where has_s / has_n.
//
// Landing buffers, not peer outputs: a peer's output tensor changes every
// call, its window (cudaMalloc'd once per (collective id, spec, dtype,
// lead), exported with cudaIpcGetMemHandle) does not.  Sends are
// wrap-indexed on every axis that exchanges, so every rank signals and
// waits the same counts (rdma.py's SPMD symmetry); a walled edge merges
// nothing.
//
// The protocol is ONE CTA: its strips are small (2*d*(ly + lx) elements
// per level), so one CTA moves them in a few microseconds, and
// __syncthreads orders its phases without a grid-wide barrier or a
// cooperative launch.  Thread 0 signals and waits; every thread fences
// its stores with __threadfence_system before the CTA barrier that
// precedes a signal, and reads landing buffers only after the wait's
// acquire fence.  Elements move as raw 4- or 8-byte words: float32,
// int32 and float64 bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "rdma_fence.cuh"

namespace rdma {

constexpr int kCopyThreads = 256;
constexpr int kProtoThreads = 1024;

// The geometry and the window layout, as the wrapper passes them (int64
// array, in this order).
struct RdmaGeo {
  long long lead, ly, lx;        // block: (lead, ly, lx), one tile
  long long h, d, w, hgt;        // halo, depth, tile_nx, tile_ny
  long long do_x, do_y;          // phases that run
  long long has_w, has_e, has_s, has_n;
  long long cid;                 // collective id of the entry barrier
  long long land_x, land_y;      // byte offsets of landing[x][0], [y][0]
  long long land_x_bytes, land_y_bytes;  // bytes of one landing buffer
};
constexpr int kGeoInts = 18;
static_assert(sizeof(RdmaGeo) == kGeoInts * sizeof(long long), "layout");

// Copy the `n_geo` integers of `geo` into RdmaGeo; false if the count or the
// geometry is wrong.
inline bool read_geo(const long long* geo, int n_geo, RdmaGeo* g) {
  if (n_geo != kGeoInts) return false;
  long long* dst = reinterpret_cast<long long*>(g);
  for (int i = 0; i < kGeoInts; ++i) dst[i] = geo[i];
  return g->lead >= 1 && g->ly >= 1 && g->lx >= 1 && g->d >= 1 &&
         g->d <= g->h;
}

__device__ inline unsigned* slots_of(char* win) {
  return reinterpret_cast<unsigned*>(win);
}

__device__ inline int* status_of(char* win) {
  return reinterpret_cast<int*>(win + kNumSlots * sizeof(unsigned));
}

template <typename E>
__device__ inline E* landing(char* win, long long off, long long bytes,
                             int dir) {
  return reinterpret_cast<E*>(win + off + dir * bytes);
}

// Strip element i -> its offsets in the block: the plus-side send (ps),
// the minus-side send (ms), the minus-side halo (md), the plus-side halo
// (pd).  x: i = (row over lead*ly, column c of d).
struct XMap {
  long long lx, h, d, w;
  __device__ void operator()(long long i, long long& ps, long long& ms,
                             long long& md, long long& pd) const {
    const long long row = i / d, c = i - row * d;
    ps = row * lx + h + w - d + c;   // my east interior strip
    ms = row * lx + h + c;           // my west interior strip
    md = row * lx + h - d + c;       // my west halo
    pd = row * lx + h + w + c;       // my east halo
  }
};

// y: i = (level l, row r of d, column c of lx), full width.
struct YMap {
  long long ly, lx, h, d, hgt;
  __device__ void operator()(long long i, long long& ps, long long& ms,
                             long long& md, long long& pd) const {
    const long long c = i % lx, r = (i / lx) % d, l = i / (lx * d);
    const long long base = l * ly;
    ps = (base + h + hgt - d + r) * lx + c;   // my north interior rows
    ms = (base + h + r) * lx + c;             // my south interior rows
    md = (base + h - d + r) * lx + c;         // my south halo
    pd = (base + h + hgt + r) * lx + c;       // my north halo
  }
};

template <typename E>
__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const E* __restrict__ in, E* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)kCopyThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kCopyThreads) {
    out[i] = in[i];
  }
}

// out[0:n] = in[0:n] on `s`; returns cudaGetLastError() of the launch.
template <typename E>
cudaError_t launch_copy(const void* in, void* out, long long n,
                        cudaStream_t s) {
  const long long blocks = (n + kCopyThreads - 1) / kCopyThreads;
  copy_kernel<E><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                   kCopyThreads, 0, s>>>(static_cast<const E*>(in),
                                         static_cast<E*>(out), n);
  return cudaGetLastError();
}

// One phase: fence, send both strips, deliver, wait, merge; `map` is the
// phase's XMap or YMap.
template <typename E, typename Src>
__device__ bool run_phase(E* out, char* mine, char* plus, char* minus,
                          int phase, long long n, long long off,
                          long long bytes, bool has_minus, bool has_plus,
                          Src map, unsigned long long deadline,
                          int* ok) {
  unsigned* my_slots = slots_of(mine);
  int* status = status_of(mine);
  if (threadIdx.x == 0) {
    *ok = fence_phase(my_slots, slots_of(plus), slots_of(minus), phase,
                      deadline, status);
  }
  __syncthreads();
  if (!*ok) return false;
  // my plus-side strip lands in plus's landing[phase][0] (from its
  // minus side), my minus-side strip in minus's landing[phase][1]
  E* to_plus = landing<E>(plus, off, bytes, 0);
  E* to_minus = landing<E>(minus, off, bytes, 1);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    long long ps, ms, md, pd;
    map(i, ps, ms, md, pd);
    to_plus[i] = out[ps];
    to_minus[i] = out[ms];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_signal(slots_of(plus), kSlotDelivered + 2 * phase + 0);
    fence_signal(slots_of(minus), kSlotDelivered + 2 * phase + 1);
    for (int dir = 0; dir < 2 && *ok; ++dir) {
      if (!fence_wait(my_slots, kSlotDelivered + 2 * phase + dir,
                      deadline)) {
        fence_fail(status, kSlotDelivered + 2 * phase + dir);
        *ok = 0;
      }
    }
  }
  __syncthreads();
  if (!*ok) return false;
  const volatile E* from_minus = landing<E>(mine, off, bytes, 0);
  const volatile E* from_plus = landing<E>(mine, off, bytes, 1);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    long long ps, ms, md, pd;
    map(i, ps, ms, md, pd);
    if (has_minus) out[md] = from_minus[i];
    if (has_plus) out[pd] = from_plus[i];
  }
  __syncthreads();   // the merge is complete before the next phase reads
  return true;
}

// The protocol on `out` (lead, ly, lx) in place: entry barrier, x phase,
// y phase.
template <typename E>
__global__ void __launch_bounds__(kProtoThreads)
protocol_kernel(E* out, char* mine, char* east, char* west, char* north,
                char* south, RdmaGeo g, unsigned long long budget_ns) {
  __shared__ int ok;
  __shared__ unsigned long long deadline;
  const long long ly = g.ly, lx = g.lx, h = g.h, d = g.d;
  if (threadIdx.x == 0) {
    deadline = fence_clock() + budget_ns;
    unsigned* peers[4];
    int np = 0;
    if (g.do_x) { peers[np++] = slots_of(east); peers[np++] = slots_of(west); }
    if (g.do_y) { peers[np++] = slots_of(north); peers[np++] = slots_of(south); }
    ok = fence_entry_barrier(slots_of(mine), peers, np,
                             static_cast<int>(g.cid), deadline,
                             status_of(mine));
  }
  __syncthreads();
  if (!ok) return;
  if (g.do_x) {
    const XMap xmap{lx, h, d, g.w};
    if (!run_phase<E>(out, mine, east, west, 0, g.lead * ly * d, g.land_x,
                      g.land_x_bytes, g.has_w, g.has_e, xmap, deadline,
                      &ok)) {
      return;
    }
  }
  if (g.do_y) {
    const YMap ymap{ly, lx, h, d, g.hgt};
    run_phase<E>(out, mine, north, south, 1, g.lead * d * lx, g.land_y,
                 g.land_y_bytes, g.has_s, g.has_n, ymap, deadline, &ok);
  }
}

// The protocol on `out` in place, one CTA on `s`; `wins`: my window, then
// the east, west, north and south peers' (opened) windows.  Returns
// cudaGetLastError() of the launch.
template <typename E>
cudaError_t launch_protocol(void* out, char* const* wins, const RdmaGeo& g,
                            unsigned long long budget_ns, cudaStream_t s) {
  protocol_kernel<E><<<1, kProtoThreads, 0, s>>>(
      static_cast<E*>(out), wins[0], wins[1], wins[2], wins[3], wins[4], g,
      budget_ns);
  return cudaGetLastError();
}

}  // namespace rdma
