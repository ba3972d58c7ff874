// The remote-DMA halo exchange between ranks, one tile per rank: a rank's
// edge strips go into its neighbours' landing buffers through CUDA IPC,
// with one hand-off per call.  Shared by the standalone exchange
// (halo_exchange_rdma.cu) and the flagship's fused transport across
// ranks (nemolite2d_sweep_rdma.cu).
//
// It computes what dl_esm_inf_tpu/parallel/halo_pallas.py:114-261 and
// the exchange inside the TPU sweep (ops/sweep.py:383-513) compute, in
// one phase instead of the TPU's entry barrier and two fenced phases.
// Call n (the window's call count, from 1, kept by the host) of a rank,
// in order on the caller's stream:
//
//   1. send (many CTAs): the block copy, and the strips straight from
//      the source into the neighbours' landing[dir][n & 1]:
//      - the x strips (d columns, every row) to E and W;
//      - the full-width y rows (d rows) to N and S, halo columns
//        included, with the rank's own values there;
//      - the d x d corner blocks to the diagonal peers (SW, SE, NW, NE);
//   2. signal: stream_signal(n) on the delivered slot of this rank's
//      direction in each neighbour's window;
//   3. wait: stream_wait(n) on each of this rank's delivered slots (the
//      one hand-off; the stream blocks in the front end, off the SMs);
//   4. merge (many CTAs): landing[dir][n & 1] into the halo where the rank
//      has that neighbour, so that a y row wins over an x strip and a
//      corner over a y row; the writes are disjoint (`yields`).
//
// The corners make it bitwise equal to the TPU's x-then-y sequencing:
// there the south peer's rows carry, in my south-west corner, what it
// merged from its west peer, my SW diagonal, and its own values where it
// has no west peer; here the SW peer's corner lands there when I have
// both a south and a west neighbour, and the S row's own values when I
// have only the south one.  With only the west one, the full-height x
// strip carries the W peer's own halo rows, as on the TPU.
//
// Why no entry barrier.  The TPU's fence semaphores are scratch, valid
// only while the peer runs the same kernel (dl_esm_inf_tpu/parallel/
// rdma.py:20-34).  The windows here are cudaMalloc'd once per (collective
// id, spec, dtype, lead) and live for the process, so a peer's signal can
// arrive before this rank's call without landing anywhere invalid.
//
// Why no readiness fence.  The landings are double-buffered by call
// parity.  A rank writes landing[p] of a peer in call n + 2 only after
// its own call n + 1 wait, which the peer's call n + 1 signal satisfies;
// the peer signals n + 1 after its call n merge in stream order, and the
// signal's default flag fences the merge first.  So the buffer call n + 2
// writes was read before.  (With one buffer, the peer's call n signal,
// sent before its merge, would let call n + 1 overwrite it.)
//
// Neighbours are wrap-indexed on every axis that exchanges, and the
// directions that exchange (`active`: E, W when x exchanges, N, S when y
// does, the diagonals when both do) are the same on every rank, so every
// rank signals and waits the same slots; a walled edge merges nothing.
// Elements move as raw 4- or 8-byte words: float32, int32 and float64
// bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "rdma_fence.cuh"

namespace rdma {

constexpr int kThreads = 256;
// the directions of a neighbour in the rank grid, by index: W, E, S, N,
// SW, SE, NW, NE
constexpr int kDirs = 8;

__host__ __device__ inline int dir_dy(int d) {
  return (d == 2 || d == 4 || d == 5) ? -1 : (d == 3 || d >= 6) ? 1 : 0;
}

__host__ __device__ inline int dir_dx(int d) {
  return (d == 0 || d == 4 || d == 6) ? -1
         : (d == 1 || d == 5 || d == 7) ? 1
                                        : 0;
}

// W <-> E, S <-> N, SW <-> NE, SE <-> NW
__host__ __device__ inline int opposite(int d) { return d ^ (d < 4 ? 1 : 3); }

// The geometry and the window layout, as the wrapper passes them (int64
// array, in this order).
struct RdmaGeo {
  long long lead, ly, lx;        // block: (lead, ly, lx), one tile
  long long h, d, w, hgt;        // halo, depth, tile_nx, tile_ny
  long long has_w, has_e, has_s, has_n;
  long long active;              // bit dir: the directions that exchange
  long long call;                // this call's number on the window, >= 1
  long long land[kDirs];         // byte offset of landing[dir][0]
  long long land_bytes[kDirs];   // bytes of one landing buffer of dir
};
constexpr int kGeoInts = 29;
static_assert(sizeof(RdmaGeo) == kGeoInts * sizeof(long long), "layout");

// Copy the `n_geo` integers of `geo` into RdmaGeo; false if the count or the
// geometry is wrong.
inline bool read_geo(const long long* geo, int n_geo, RdmaGeo* g) {
  if (n_geo != kGeoInts) return false;
  long long* dst = reinterpret_cast<long long*>(g);
  for (int i = 0; i < kGeoInts; ++i) dst[i] = geo[i];
  return g->lead >= 1 && g->ly >= 1 && g->lx >= 1 && g->d >= 1 &&
         g->d <= g->h && g->active >= 0 && g->active < (1 << kDirs) &&
         g->call >= 1;
}

// A rectangle of the block: rows r0 .. r0 + nr, columns c0 .. c0 + nc.
struct Rect {
  long long r0, nr, c0, nc;
};

// The strip a rank sends toward its neighbour in direction o.
__host__ __device__ inline Rect send_rect(const RdmaGeo& g, int o) {
  const int dy = dir_dy(o), dx = dir_dx(o);
  return {dy == 0 ? 0 : dy > 0 ? g.h + g.hgt - g.d : g.h, dy == 0 ? g.ly : g.d,
          dx == 0 ? 0 : dx > 0 ? g.h + g.w - g.d : g.h, dx == 0 ? g.lx : g.d};
}

// Where the strip of the neighbour in direction s lands in my block (the
// shape of send_rect(g, opposite(s))).
__host__ __device__ inline Rect recv_rect(const RdmaGeo& g, int s) {
  const int dy = dir_dy(s), dx = dir_dx(s);
  return {dy == 0 ? 0 : dy < 0 ? g.h - g.d : g.h + g.hgt, dy == 0 ? g.ly : g.d,
          dx == 0 ? 0 : dx < 0 ? g.h - g.d : g.h + g.w, dx == 0 ? g.lx : g.d};
}

// Whether my block takes the strip of the neighbour in direction s.
inline bool merges(const RdmaGeo& g, int s) {
  const int dy = dir_dy(s), dx = dir_dx(s);
  return (dy == 0 || (dy < 0 ? g.has_s : g.has_n)) &&
         (dx == 0 || (dx < 0 ? g.has_w : g.has_e));
}

// Whether element (row, col) of a merged strip of s is left to a strip
// that wins over it: an x strip leaves the rows of a merged y row, a y
// row the columns of a merged corner.  This makes the merge's writes
// disjoint.
__device__ inline bool yields(const RdmaGeo& g, int s, long long row,
                              long long col) {
  if (dir_dy(s) == 0) {
    return (g.has_s && row >= g.h - g.d && row < g.h) ||
           (g.has_n && row >= g.h + g.hgt && row < g.h + g.hgt + g.d);
  }
  if (dir_dx(s) == 0) {
    return (g.has_w && col >= g.h - g.d && col < g.h) ||
           (g.has_e && col >= g.h + g.w && col < g.h + g.w + g.d);
  }
  return false;
}

// Strip elements of each direction laid end to end: direction d's are
// start[d] .. start[d + 1] (none for a direction left out).
struct Plan {
  long long start[kDirs + 1];
};

// The plan of the strips sent (`merge` false) or merged (true).
inline Plan make_plan(const RdmaGeo& g, bool merge) {
  Plan p;
  p.start[0] = 0;
  for (int d = 0; d < kDirs; ++d) {
    long long n = 0;
    if (((g.active >> d) & 1) && (!merge || merges(g, d))) {
      const Rect r = send_rect(g, d);
      n = g.lead * r.nr * r.nc;
    }
    p.start[d + 1] = p.start[d] + n;
  }
  return p;
}

// My window, and each neighbour's (opened) window by direction.
struct Wins {
  char* mine;
  char* peer[kDirs];
};

// The source of level l of the block: one contiguous block, or three
// planes (the fused sweep's state).
template <typename E>
struct Contiguous {
  const E* p;
  long long plane;
  __device__ const E* level(long long l) const { return p + l * plane; }
};

template <typename E>
struct ThreePlanes {
  const E* p[3];
  __device__ const E* level(long long l) const { return p[l]; }
};

__device__ inline int find_dir(const Plan& p, long long i) {
  int d = 0;
  while (i >= p.start[d + 1]) ++d;
  return d;
}

// Blocks [0, copy_blocks) copy the block into `out`; the rest write the
// strips into the neighbours' landing buffers of this call's parity.  The
// structs are __grid_constant__: indexed by a run-time direction, a
// by-value parameter would be copied to every thread's stack first.
template <typename E, typename Src>
__global__ void __launch_bounds__(kThreads)
send_kernel(const __grid_constant__ Src src, E* __restrict__ out,
            const __grid_constant__ Wins wins,
            const __grid_constant__ RdmaGeo g,
            const __grid_constant__ Plan plan, long long copy_blocks) {
  const long long plane = g.ly * g.lx;
  if (blockIdx.x < copy_blocks) {
    for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
         i < plane; i += copy_blocks * kThreads) {
      for (long long l = 0; l < g.lead; ++l) {
        out[l * plane + i] = src.level(l)[i];
      }
    }
    return;
  }
  const long long stride = (gridDim.x - copy_blocks) * (long long)kThreads;
  const long long parity = g.call & 1;
  for (long long i = (blockIdx.x - copy_blocks) * (long long)kThreads +
                     threadIdx.x;
       i < plan.start[kDirs]; i += stride) {
    const int o = find_dir(plan, i);
    const long long k = i - plan.start[o];
    const Rect r = send_rect(g, o);
    const long long c = k % r.nc, t = k / r.nc, row = t % r.nr,
                    l = t / r.nr;
    const int into = opposite(o);
    E* land = reinterpret_cast<E*>(wins.peer[o] + g.land[into] +
                                   parity * g.land_bytes[into]);
    land[k] = src.level(l)[(r.r0 + row) * g.lx + r.c0 + c];
  }
}

// The merge of this call's landing buffers into `out`.  Loads bypass L1
// (__ldcg): the landings were written by other processes' kernels.
template <typename E>
__global__ void __launch_bounds__(kThreads)
merge_kernel(E* __restrict__ out, const __grid_constant__ Wins wins,
             const __grid_constant__ RdmaGeo g,
             const __grid_constant__ Plan plan) {
  const long long parity = g.call & 1;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < plan.start[kDirs]; i += gridDim.x * (long long)kThreads) {
    const int s = find_dir(plan, i);
    const long long k = i - plan.start[s];
    const Rect r = recv_rect(g, s);
    const long long c = k % r.nc, t = k / r.nc, row = r.r0 + t % r.nr,
                    l = t / r.nr, col = r.c0 + c;
    if (yields(g, s, row, col)) continue;
    const E* land = reinterpret_cast<const E*>(wins.mine + g.land[s] +
                                               parity * g.land_bytes[s]);
    out[(l * g.ly + row) * g.lx + col] = __ldcg(land + k);
  }
}

inline int blocks_for(long long n, long long cap) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : b < cap ? b : cap);
}

inline unsigned* delivered(char* win, int dir) {
  return reinterpret_cast<unsigned*>(win) + kSlotDelivered + dir;
}

// The exchange of call g.call on `s`: send (with the copy of `src` into
// `out`), signal, wait, record `waited`, merge into `out`.  Returns 0, a
// cudaError_t of a launch or of the event, or minus the CUresult of a
// stream memory operation.  Nothing is launched if a landing buffer is
// too small for its strip.
template <typename E, typename Src>
int run_exchange(Src src, E* out, const Wins& wins, const RdmaGeo& g,
                 cudaEvent_t waited, cudaStream_t s) {
  for (int d = 0; d < kDirs; ++d) {
    const Rect r = send_rect(g, opposite(d));
    if (((g.active >> d) & 1) &&
        g.lead * r.nr * r.nc * static_cast<long long>(sizeof(E)) >
            g.land_bytes[d]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Plan send = make_plan(g, false), merge = make_plan(g, true);
  const int copy_blocks = blocks_for(g.ly * g.lx, 1056);   // 8 per SM
  send_kernel<E, Src><<<copy_blocks + blocks_for(send.start[kDirs], 264),
                        kThreads, 0, s>>>(src, out, wins, g, send,
                                          copy_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n = static_cast<unsigned>(g.call);
  for (int o = 0; o < kDirs; ++o) {
    if (!((g.active >> o) & 1)) continue;
    const CUresult e = stream_signal(s, delivered(wins.peer[o], opposite(o)), n);
    if (e != CUDA_SUCCESS) return -static_cast<int>(e);
  }
  for (int d = 0; d < kDirs; ++d) {
    if (!((g.active >> d) & 1)) continue;
    const CUresult e = stream_wait(s, delivered(wins.mine, d), n);
    if (e != CUDA_SUCCESS) return -static_cast<int>(e);
  }
  err = cudaEventRecord(waited, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (merge.start[kDirs] > 0) {
    merge_kernel<E><<<blocks_for(merge.start[kDirs], 264), kThreads, 0, s>>>(
        out, wins, g, merge);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace rdma
