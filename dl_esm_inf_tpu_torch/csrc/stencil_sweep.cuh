// The shared skeleton of the client models' temporal-blocked sweeps: K
// time steps per pass over device memory, for one stacked (ny, nx)
// block of N state planes, M float aux planes, MI int32 aux planes and
// NC int8 mask-code planes (MI = 0 and NC = 0 or 1 for the hand-written
// clients; the sweeps generated from kernel schedules,
// ops/schedule_sweep.py, use them all).
//
// Replaces the no-exchange branch of the TPU kernel
// dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep (`kernel`, the
// window DMAs, `tile`/`emit`); the client's one-step function, which
// the TPU kernel traced from Python, is a device functor here.
//
// Design.  Each CTA owns a TY x TX output tile and stages a window of
// WY = TY + 2R rows and WX columns in dynamic shared memory: the state
// planes, the aux planes, the code bytes (and, for clients that keep a
// next state, NS scratch planes that are not staged).  The ring R is
// K * REACH unless the client names another; the window has R rows
// above and below the tile, RL >= R columns left of it and at least R
// right of it.  Window reads outside the block are clamped to its edge,
// so the kernel never reads outside the (ny, nx) block.  The CTA then
// applies the client's step K times in shared memory; the inputs of
// sub-step k are valid on the window inset by k * REACH, its outputs on
// the window inset by (k + 1) * REACH, so after K sub-steps the output
// tile is valid and is written back.  Cells within R of the block edge
// hold finite values of no meaning, like the halo cells of the plain
// version; callers compare internal points.
//
// The tile rule (pick_shape; ops/stencil_sweep.py::tile mirrors it).
// A window is WX = 96, 64 or 32 columns wide (3, 2 or 1 warps of lanes
// over its columns) with RL = R rounded up to 4, so that every window
// row starts at a 16-byte aligned column of a block whose rows are; the
// tile takes the columns that leave at least R on the right, rounded
// down to 4.  TY is the largest multiple of 4 up to kTileYMax (and at
// least kTileYMin) whose window fits the share of an SM's shared memory
// that kCtasPerSM CTAs leave each; among the widths the one with the
// least ring overhead (window area over tile area) wins.  Where no width
// fits, the square tiles of 32, 16 and 8 cells with a ring of R on every
// side (what the skeleton used before) are tried the same way.  Where
// the best overhead is above kMaxOverhead, fewer CTAs per SM are tried,
// down to one, where the best shape is taken whatever its overhead:
// every window that fitted a CTA before fits now.  A CTA has 256
// threads, 512 for a window of 32 rows or more (fewer rows and values a
// thread, more warps an SM).  A client may fix its window
// width (the Chebyshev march does), its thread count and its tile's
// most rows.
//
// The march's rule (pick_shape(..., march, extra); the N-layer sweep).
// A column march puts warps of kMarchLanes owned columns side by side
// (march_width): its widths are those whose tile and ring, less one
// column, fill n = 3, 2 or 1 such strips, and it may keep `extra` bytes
// per CTA beside the window; the squares, whose narrow windows leave
// lanes idle, are its last resort, at one CTA per SM.  march_threads
// gives its CTA: the column strips the tile and ring need, times row
// strips of about kMarchRows rows, at most kMarchWarps warps an SM over
// the CTAs the rule aimed at (so that a kernel of up to 128 registers a
// thread keeps them all).
//
// Staging.  On a block whose rows are 16-byte aligned (nx % 4 == 0 and
// aligned planes), a window row goes in chunks of 4 points: a chunk
// inside the block by cp.async (16 bytes per float32 or int32 plane,
// 2 x 16 per float64 plane, 4 bytes per code plane), a chunk across its
// edge by clamped scalar reads.  Otherwise every window point is a
// clamped scalar read.  The copy primitives are staging.cuh's, shared
// with the flagship's step (nemolite2d_step.cuh).
//
// Sub-steps.  The K loop is unrolled (K <= 8), so each sub-step's box
// is a compile-time constant.  for_box and staged_update put warps over
// rows and lanes over columns: thread (warp, lane) takes rows warp,
// warp + NW, ... and columns lane, lane + 32, ... of the box, a fixed
// number of each (QY x QX, from the window), with no division per
// point; the row test is uniform over a warp.  staged_update holds its
// new values in registers across a barrier (QY x QX x NV of them,
// unrolled) and keeps every plane's old values outside its box.  The
// generated schedule sweeps' passes (for_points, staged_points) give a
// window point the same thread whatever the box, so calls in place need
// no barrier between them.  A march (Ring<..., MARCH = true>: the
// tracer) runs its own loops.
//
// The cluster form (a Ring with CLUSTER, ClusterRing; Hopper's
// thread-block clusters).  A window that does not fit a CTA's shared
// memory even on 8-cell tiles (a schedule of many levels) is split by
// rows over the CL CTAs of a cluster, on neighbouring SMs, one CTA an
// SM: CTA r holds window rows [r * BR, (r + 1) * BR) of every plane in
// its own shared memory (BR = ceil(WY / CL); cluster_shape's tile), and
// the window never goes to device memory.  A window point keeps one
// (CTA, thread) in every pass, the passes take a point's own values
// from its CTA's band, and a read of a row of another band goes to that
// CTA's shared memory (distributed shared memory: the band accessors
// BandAt/BandLev map the address to the owner's, band_read).  Every
// barrier that orders accesses a peer can see is a cluster barrier
// (release/acquire), and a CTA leaves only after a last one.  Each CTA
// stages its rows with 16-byte cp.async as the shared form does, and
// writes back the tile rows of its band; a persistent grid of every
// cluster that can be resident takes the tiles in turn.
//
// The scratch form (a Ring with SCRATCH, ScratchRing).  A window that
// does not fit even the largest cluster (kClusters) lives in global
// memory instead: each CTA of a persistent grid owns a slice of a
// scratch buffer and takes the tiles in turn, by a grid-stride loop.
// The same steps run on that window unchanged: __syncthreads orders a
// CTA's global-memory accesses as it orders its shared-memory ones.  The
// tile is scratch_shape's (8 rows, a 32-column window: one warp of lanes
// a row), the staging is clamped scalar reads (cp.async writes shared
// memory only), the threads a CTA are the ring's, and the CTAs are at
// most those resident at once and at most what keeps the windows of all
// of them within the bytes the caller names (scratch_ctas).
//
// The output tile goes back with 16-byte stores where the block's rows
// are 16-byte aligned, scalar stores otherwise.  A client that writes
// the tile itself from its last sub-step (WRITES_OUT) skips that pass.
//
// A client step is a struct with
//   static constexpr int N, M;  CODE (bool);
//   using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, REACH>>;
//   using G = typename Tile::G;  Consts (POD of doubles);
// (Tile<T, N, M, CODE, Ring, MI, NC, NS> adds MI int32 planes, NC code
// planes and NS unstaged scratch planes; Ring<K, REACH, RING, WX, NT>
// names another ring, a window width and a thread count);
//   __device__ explicit Step(const Consts&);      // casts to T, once
//   __device__ void substep(Tile&, int k) const;
// and optionally static constexpr bool WRITES_OUT = true (the last
// sub-step stores the tile through Tile::out).  `substep` runs its own
// phases and barriers, and returns only after a __syncthreads() that
// follows its last shared-memory write.  Window point (wy, wx) is index
// wy * G::WX + wx of every plane.  Scalars are folded on the host in
// double, in the grouping of the plain PyTorch step, and cast once to
// T; with --fmad=false the kernel then rounds where the plain version
// rounds.
//
// What bounds it.  A sweep moves N state planes in and out plus the
// aux planes and the code once per K steps, a few bytes per point and
// step, so at 1024^2 the HBM bound is around a microsecond per step on
// an H100: the kernels are bound by the instructions and shared-memory
// traffic per point and sub-step, the barriers between phases and the
// redundant ring work of temporal blocking.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "staging.cuh"

namespace sweep {

using staging::round_up;

// The tile rule's inputs: an H100 SM's shared memory and the runtime's
// reserve per CTA (the difference is the most one CTA may take), the
// CTAs that should share an SM, the tile's most and least rows, the
// ring overhead above which fewer CTAs per SM are tried (in 1/1024ths),
// the window widths and the square tiles.
constexpr int kSmemPerSM = 233472;
constexpr int kSmemReserve = 1024;
constexpr int kCtasPerSM = 3;
constexpr int kTileYMax = 40;
constexpr int kTileYMin = 8;
constexpr int kMaxOverhead = 2560;
constexpr int kWindowX[3] = {96, 64, 32};
constexpr int kSquares[3] = {32, 16, 8};
// threads of a CTA: NT, or kThreadsTall for a window of at least
// kTallRows rows (two rows a warp or more), unless a client names a count
constexpr int NT = 256;
constexpr int kThreadsTall = 512;
constexpr int kTallRows = 32;
// the march: owned columns of a warp, rows of a row strip, warps an SM
constexpr int kMarchLanes = 31;
constexpr int kMarchRows = 2;
constexpr int kMarchWarps = 16;
// the scratch form's window columns
constexpr int kScratchWX = 32;
// the cluster form's cluster sizes, smallest first (past 8 is not
// portable: the kernel allows it by attribute).  None has 2 CTAs: a
// window that two CTAs hold within kMaxOverhead, one CTA holds on an
// 8-cell square (pick_shape)
constexpr int kClusters[3] = {4, 8, 16};

// A tile and its window: TY x TX output points, RL window columns left
// of the tile, WX window columns, CTAS per SM that the rule aimed at.
struct Shape {
  int ty, tx, rl, wx, ctas;
};

// window area over tile area, in 1/1024ths
constexpr long long overhead(const Shape& s, int R) {
  return static_cast<long long>(s.ty + 2 * R) * s.wx * 1024 /
         (static_cast<long long>(s.ty) * s.tx);
}

constexpr Shape better(const Shape& a, const Shape& b, int R) {
  if (a.ty == 0) return b;
  return overhead(b, R) < overhead(a, R) ? b : a;
}

// The rows of the tallest tile (a multiple of 4 in [kTileYMin, tymax])
// whose window, `w` columns of `bpp` bytes per point, fits `budget`; 0
// if none.
constexpr int fit_rows(int w, int R, int bpp, long long budget, int tymax) {
  int ty = tymax;
  while (ty >= kTileYMin &&
         static_cast<long long>(ty + 2 * R) * w * bpp > budget) {
    ty -= 4;
  }
  return ty >= kTileYMin ? ty : 0;
}

// The march's window width for n column strips: the tile's columns
// (a multiple of 4) and the ring on both sides, less one column, fill
// n strips of kMarchLanes; the left ring is rounded up to 4.
constexpr int march_width(int R, int n) {
  const int tx = (kMarchLanes * n - 2 * R + 1) / 4 * 4;
  return round_up(round_up(R, 4) + tx + R, 4);
}

// The tile rule: ring R, `bpp` shared bytes per window point, a window
// width fixed by the client (0: the rule's choice), the tile's most
// rows; with `march`, the march's widths; `extra` bytes per CTA beside
// the window.  ty == 0: nothing fits one CTA.
constexpr Shape pick_shape(int R, int bpp, int wfix, int tymax,
                           bool march = false, int extra = 0) {
  const int rl = round_up(R, 4);
  for (int c = kCtasPerSM; c >= 1; --c) {
    const long long budget = kSmemPerSM / c - kSmemReserve - extra;
    Shape best{0, 0, 0, 0, 0};
    for (int n = 0; n < 3; ++n) {
      const int w = wfix ? wfix : march ? march_width(R, 3 - n) : kWindowX[n];
      const int tx = (w - rl - R) / 4 * 4;
      const int ty = tx >= 8 ? fit_rows(w, R, bpp, budget, tymax) : 0;
      if (ty) best = better(best, Shape{ty, tx, rl, w, c}, R);
      if (wfix) break;
    }
    for (int n = 0; n < 3 && !wfix && !best.ty && (!march || c == 1); ++n) {
      const int e = kSquares[n], w = e + 2 * R;
      if (static_cast<long long>(w) * w * bpp <= budget) {
        best = better(best, Shape{e, e, R, w, c}, R);
      }
    }
    if (best.ty && (c == 1 || overhead(best, R) <= kMaxOverhead)) {
      return best;
    }
  }
  return Shape{0, 0, 0, 0, 0};
}

// The scratch form's tile for ring R: 8 rows, the columns a 32-column
// window leaves with RL = R rounded up to 4 on the left and at least R
// on the right; ctas 0 (its CTA count is set at launch).
constexpr Shape scratch_shape(int R) {
  const int rl = round_up(R, 4);
  return Shape{kTileYMin, (kScratchWX - rl - R) / 4 * 4, rl, kScratchWX, 0};
}

// The cluster form's tile: a window of `bpp` bytes per point and ring R
// split by rows over the `cluster` CTAs of a thread-block cluster, one
// CTA an SM, each holding ceil(WY / cluster) window rows.  For each of kClusters, smallest first, each width of
// kWindowX gets the tallest tile (a multiple of 4 in [kTileYMin, tymax])
// whose window rows the cluster's CTAs hold, and the least ring overhead
// wins (the first of equal ones); it is taken if its overhead is at most
// kMaxOverhead or at the largest cluster.  cluster 0: no cluster holds
// an 8-row window.  ctas 0: the CTA count is set at launch.
struct ClusterShape {
  Shape s;
  int cluster;
};

constexpr ClusterShape cluster_shape(int R, int bpp,
                                     int tymax = kTileYMax) {
  const int rl = round_up(R, 4);
  const long long budget = kSmemPerSM - kSmemReserve;
  for (int c = 0; c < 3; ++c) {
    Shape best{0, 0, 0, 0, 0};
    for (int n = 0; n < 3; ++n) {
      const int w = kWindowX[n];
      const int tx = (w - rl - R) / 4 * 4;
      const long long rows =
          kClusters[c] * (budget / (static_cast<long long>(w) * bpp));
      int ty = tymax;
      while (ty >= kTileYMin && ty + 2 * R > rows) ty -= 4;
      if (tx >= 8 && ty >= kTileYMin) {
        best = better(best, Shape{ty, tx, rl, w, 0}, R);
      }
    }
    if (best.ty && (c == 2 || overhead(best, R) <= kMaxOverhead)) {
      return ClusterShape{best, kClusters[c]};
    }
  }
  return ClusterShape{Shape{0, 0, 0, 0, 0}, 0};
}

// The march's column strips for a tile and ring: the velocity columns
// (the tile's, R west and R - 1 east) over the owned columns a strip.
constexpr int march_strips(const Shape& s, int R) {
  return (s.tx + 2 * R - 1 + kMarchLanes - 1) / kMarchLanes;
}

// The march's threads a CTA: its column strips times row strips of about
// `rows` window rows (a march that carries nothing from row to row may
// name 1), at most `warps` warps (a client whose kernel takes at most 64
// registers a thread may name 32) over the s.ctas CTAs of an SM.
constexpr int march_threads(const Shape& s, int R, int warps = kMarchWarps,
                            int rows = kMarchRows) {
  const int nx = march_strips(s, R);
  const int want = (s.ty + 2 * R + rows - 1) / rows;
  const int most = warps / s.ctas / nx;
  return 32 * nx * (want < most ? want : most > 1 ? most : 1);
}

// A window's geometry: a TY x TX output tile, R rows above and below
// it, RL columns left of it and WX - RL - TX right of it, NT threads.
template <int K_, int REACH_, int R_, int TY_, int TX_, int RL_, int WX_,
          int NT_ = NT>
struct Geom {
  static constexpr int K = K_, REACH = REACH_, R = R_;
  static constexpr int TY = TY_, TX = TX_, RL = RL_, WX = WX_;
  static constexpr int WY = TY + 2 * R;
  static constexpr int WC = WY * WX;                  // points per plane
  static constexpr int NT = NT_, NW = NT / 32;        // threads, warps
  static constexpr int CL = 1;                         // CTAs of a window
  // the rows and columns of a thread in a pass over the window
  static constexpr int QY = (WY + NW - 1) / NW;
  static constexpr int QX = (WX + 31) / 32;
  // window rows start at 16-byte aligned block columns
  static constexpr bool CHUNKS = WX % 4 == 0 && RL % 4 == 0 && TX % 4 == 0;
  static_assert(RL >= R && WX - RL - TX >= R, "the ring");
  static_assert(NT % 32 == 0, "whole warps");
};

// The cluster form's geometry: the window of Geom split by rows over CL
// CTAs, BR rows a CTA; WC is the points of a plane one CTA holds, and a
// thread's rows in a pass are QY of its band.
template <int K_, int REACH_, int R_, int TY_, int TX_, int RL_, int WX_,
          int NT_, int CL_>
struct ClusterGeom : Geom<K_, REACH_, R_, TY_, TX_, RL_, WX_, NT_> {
  using Base = Geom<K_, REACH_, R_, TY_, TX_, RL_, WX_, NT_>;
  static constexpr int CL = CL_;
  static constexpr int BR = (Base::WY + CL - 1) / CL;
  static constexpr int WC = BR * WX_;
  static constexpr int QY = (BR + Base::NW - 1) / Base::NW;
  static_assert(CL >= 4 && CL <= 16, "a cluster of 4-16 CTAs");
};

// What a client names: K sub-steps of a step of reach REACH, a ring
// (K * REACH unless given), a window width (0: the tile rule's), the
// CTA's threads (0: by the window's size) and the tile's most rows; a
// column march (MARCH) takes the march's widths and march_threads with
// WARPS and ROWS; SCRATCH takes the scratch form, CLUSTER the cluster
// form.
template <int K_, int REACH_, int RING_ = K_ * REACH_, int WX_ = 0,
          int NT_ = 0, int TYMAX_ = kTileYMax, bool MARCH_ = false,
          int WARPS_ = kMarchWarps, int ROWS_ = kMarchRows,
          bool SCRATCH_ = false, bool CLUSTER_ = false>
struct Ring {
  static constexpr int K = K_, REACH = REACH_, RING = RING_, WX = WX_;
  static constexpr int THREADS = NT_, TYMAX = TYMAX_;
  static constexpr bool MARCH = MARCH_, SCRATCH = SCRATCH_;
  static constexpr bool CLUSTER = CLUSTER_;
  static constexpr int WARPS = WARPS_, ROWS = ROWS_;
};

// The ring of the scratch form, NT threads a CTA.
template <int K, int REACH, int RING, int NT>
using ScratchRing = Ring<K, REACH, RING, kScratchWX, NT, kTileYMax, false,
                         kMarchWarps, kMarchRows, true>;

// The ring of the cluster form, NT threads a CTA.
template <int K, int REACH, int RING, int NT>
using ClusterRing = Ring<K, REACH, RING, 0, NT, kTileYMax, false,
                         kMarchWarps, kMarchRows, false, true>;

// The geometry the tile rule gives a ring with `bpp` bytes per point.
template <class RG, int BPP, bool CLUSTER = RG::CLUSTER>
struct RuleGeom {
  static constexpr Shape S =
      RG::SCRATCH ? scratch_shape(RG::RING)
                  : pick_shape(RG::RING, BPP, RG::WX, RG::TYMAX, RG::MARCH);
  static_assert(S.ty > 0, "the window does not fit a CTA's shared memory");
  static constexpr int THREADS =
      RG::THREADS  ? RG::THREADS
      : RG::MARCH ? march_threads(S, RG::RING, RG::WARPS, RG::ROWS)
      : (S.ty + 2 * RG::RING >= kTallRows ? kThreadsTall : NT);
  using type = Geom<RG::K, RG::REACH, RG::RING, S.ty, S.tx, S.rl, S.wx,
                    THREADS>;
};

// The cluster form's: cluster_shape's tile and cluster, RG's threads.
template <class RG, int BPP>
struct RuleGeom<RG, BPP, true> {
  static constexpr ClusterShape C = cluster_shape(RG::RING, BPP);
  static_assert(C.cluster > 0, "the window does not fit the largest cluster");
  using type = ClusterGeom<RG::K, RG::REACH, RG::RING, C.s.ty, C.s.tx,
                           C.s.rl, C.s.wx, RG::THREADS, C.cluster>;
};

// Window points, half-open: rows [y0, y1), columns [x0, x1).
struct Box {
  int y0, y1, x0, x1;
};

// The window inset by `lo` cells from its low edges and `hi` from its
// high edges.
template <class G>
__device__ __forceinline__ Box inset(int lo, int hi) {
  return Box{lo, G::WY - hi, lo, G::WX - hi};
}

// The int32 aux planes of a launch (none for MI = 0, which keeps the
// layout of Planes what it was before they existed).
template <int MI>
struct IntAux {
  const int32_t* auxi[MI];
};
template <>
struct IntAux<0> {};

// The device pointers of one launch.  The NC code planes lie one after
// another from `code`, ny * nx bytes each.
template <typename T, int N, int M, int MI = 0>
struct Planes : IntAux<MI> {
  const T* in[N];
  T* out[N];
  const T* aux[M > 0 ? M : 1];
  const int8_t* code;
  int ny, nx;
};

// Where a client that writes its own output (WRITES_OUT) puts the tile:
// the output planes, the block's extent and the block point of window
// point (0, 0).
template <typename T, int N>
struct Out {
  T* p[N];
  int ny, nx, oy, ox;
};

// The window: N state planes, M aux planes, NS scratch planes (not
// staged), MI int32 aux planes, NC code planes (one when CODE, by
// default), in shared memory, or in global memory in the scratch form;
// in the cluster form a CTA's band of it (G::WC points a plane).  G is
// the geometry the tile rule gives the ring RG for these planes.
template <typename T, int N, int M, bool CODE, class RG, int MI = 0,
          int NC = (CODE ? 1 : 0), int NS = 0>
struct Tile {
  using Value = T;
  static constexpr int NINT = MI, NCODE = NC, NSCRATCH = NS;
  static constexpr bool SCRATCH = RG::SCRATCH;
  static constexpr int BPP = (N + M + NS) * static_cast<int>(sizeof(T)) +
                             4 * MI + NC;
  using G = typename RuleGeom<RG, BPP>::type;
  static constexpr size_t bytes = static_cast<size_t>(BPP) * G::WC;
  T* s[N];
  T* a[M > 0 ? M : 1];
  T* x[NS > 0 ? NS : 1];
  int32_t* ai[MI > 0 ? MI : 1];
  int8_t* code;
  Out<T, N> out;

  __device__ explicit Tile(unsigned char* raw) {
    T* base = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int f = 0; f < N; ++f) s[f] = base + f * G::WC;
#pragma unroll
    for (int f = 0; f < (M > 0 ? M : 1); ++f) a[f] = base + (N + f) * G::WC;
#pragma unroll
    for (int f = 0; f < (NS > 0 ? NS : 1); ++f) {
      x[f] = base + (N + M + f) * G::WC;
    }
    int32_t* ibase = reinterpret_cast<int32_t*>(base + (N + M + NS) * G::WC);
#pragma unroll
    for (int f = 0; f < (MI > 0 ? MI : 1); ++f) ai[f] = ibase + f * G::WC;
    code = reinterpret_cast<int8_t*>(ibase + MI * G::WC);
  }

  // mask bit b of the code at window index i, as 0/1 in T
  __device__ __forceinline__ T bit(int i, int b) const {
    return static_cast<T>((static_cast<int>(code[i]) >> b) & 1);
  }
};

// Square root in the type of its argument, correctly rounded (as
// torch.sqrt on the card).
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return ::sqrt(x); }

// Reads of one staged plane around a window point: a(dj, di) is the
// value dj rows north and di columns east, a() the point's own.
template <typename V, int WX>
struct At {
  const V* p;
  __device__ __forceinline__ V operator()(int dj, int di) const {
    return p[dj * WX + di];
  }
  __device__ __forceinline__ V operator()() const { return *p; }
};

// A plane a kernel call writes: reads as At does (the values before the
// call), and `w = value` sets the call's new value at the point, held in
// v (the old value until assigned).
template <typename V, int WX>
struct Put : At<V, WX> {
  V v;
  __device__ __forceinline__ Put& operator=(V x) {
    v = x;
    return *this;
  }
};

// Reads of a levels=N argument, its N staged planes WC apart: a(k, dj, di)
// is level k's value dj rows north and di columns east, a(k) level k's at
// the point; a.levels is N.
template <typename V, int WX, int WC, int N>
struct Lev {
  static constexpr int levels = N;
  const V* p;
  __device__ __forceinline__ V operator()(int k, int dj, int di) const {
    return p[k * WC + dj * WX + di];
  }
  __device__ __forceinline__ V operator()(int k) const { return p[k * WC]; }
};

// A levels=N argument a call writes: reads as Lev does (the values before
// the call); `w[k] = value` sets level k's new value and `w = value` every
// level's (a 2D result broadcasts), held in v (the old values until
// assigned).
template <typename V, int WX, int WC, int N>
struct LevPut : Lev<V, WX, WC, N> {
  V v[N];
  __device__ __forceinline__ V& operator[](int k) { return v[k]; }
  __device__ __forceinline__ LevPut& operator=(V x) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = x;
    return *this;
  }
};

// The thread-block cluster of the cluster form: this CTA's rank in it, a
// barrier of all its threads (arrive.release, wait.acquire: what a
// thread of the cluster stored before it is seen by every thread after
// it), and the address in CTA `rank`'s shared memory of a pointer into
// this CTA's.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}
template <typename V>
__device__ __forceinline__ V* cluster_map(V* p, int rank) {
  unsigned long long q;
  asm("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(p), "r"(rank));
  return reinterpret_cast<V*>(q);
}

// The cluster form's read of window point (wy + dj, wx + di) of a plane,
// `off` elements from p, the address of point (wy, wx) in this CTA's
// band: a row of this band from this CTA's shared memory, a row of
// another band from its CTA's, at the same offset in that band (every
// CTA lays its band out alike).
template <class G, typename V>
__device__ __forceinline__ V band_read(const V* p, int wy, int dj, int off) {
  const int me = wy / G::BR, at = (wy + dj) / G::BR;
  const V* q = p + off;
  if (at == me) return *q;
  return *cluster_map(q + (me - at) * G::WC, at);
}

// At, Put, Lev and LevPut of the cluster form: p is the point's address in its CTA's band, wy its window row.
template <typename V, class G>
struct BandAt {
  const V* p;
  int wy;
  __device__ __forceinline__ V operator()(int dj, int di) const {
    return band_read<G>(p, wy, dj, dj * G::WX + di);
  }
  __device__ __forceinline__ V operator()() const { return *p; }
};

template <typename V, class G>
struct BandPut : BandAt<V, G> {
  V v;
  __device__ __forceinline__ BandPut& operator=(V x) {
    v = x;
    return *this;
  }
};

template <typename V, class G, int N>
struct BandLev {
  static constexpr int levels = N;
  const V* p;
  int wy;
  __device__ __forceinline__ V operator()(int k, int dj, int di) const {
    return band_read<G>(p, wy, dj, k * G::WC + dj * G::WX + di);
  }
  __device__ __forceinline__ V operator()(int k) const { return p[k * G::WC]; }
};

template <typename V, class G, int N>
struct BandLevPut : BandLev<V, G, N> {
  V v[N];
  __device__ __forceinline__ V& operator[](int k) { return v[k]; }
  __device__ __forceinline__ BandLevPut& operator=(V x) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = x;
    return *this;
  }
};

// The tile grown by m cells on every side, within the window inset by d
// cells (m < 0: no points).
template <class G>
__device__ __forceinline__ Box around(int m, int d) {
  if (m < 0) return Box{0, 0, 0, 0};
  return Box{max(G::R - m, d), min(G::R + G::TY + m, G::WY - d),
             max(G::RL - m, d), min(G::RL + G::TX + m, G::WX - d)};
}

__device__ __forceinline__ bool inside(const Box& b, int wy, int wx) {
  return wy >= b.y0 && wy < b.y1 && wx >= b.x0 && wx < b.x1;
}

// The smallest box holding a and b (an empty box holds nothing).
__device__ __forceinline__ Box hull(const Box& a, const Box& b) {
  if (a.y0 >= a.y1 || a.x0 >= a.x1) return b;
  if (b.y0 >= b.y1 || b.x0 >= b.x1) return a;
  return Box{min(a.y0, b.y0), max(a.y1, b.y1), min(a.x0, b.x0),
             max(a.x1, b.x1)};
}

// The passes of a generated sweep give window point (wy, wx) to warp
// wy % NW and lane wx % 32 whatever the box, so a call sees the values
// earlier calls stored at its own point without a barrier.  In the
// cluster form the point is the CTA's that holds row wy, and its warp is
// (wy - the band's first row) % NW; i is its index in the band.

// f(i, wy, wx) for the thread's points of `b`, a row at a time (rows in a
// loop, columns unrolled).
template <class G, class F>
__device__ __forceinline__ void for_points(const Box& b, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (G::CL > 1) {
    const int band0 = cluster_rank() * G::BR;
    const int y0 = max(b.y0, band0), y1 = min(b.y1, band0 + G::BR);
#pragma unroll 1
    for (int wy = y0 + (warp + G::NW - (y0 - band0) % G::NW) % G::NW;
         wy < y1; wy += G::NW) {
#pragma unroll
      for (int q = 0; q < G::QX; ++q) {
        const int wx = lane + 32 * q;
        if (wx >= b.x0 && wx < b.x1) f((wy - band0) * G::WX + wx, wy, wx);
      }
    }
    return;
  }
  const int first = b.y0 + (warp + G::NW - b.y0 % G::NW) % G::NW;
#pragma unroll 1
  for (int wy = first; wy < b.y1; wy += G::NW) {
#pragma unroll
    for (int q = 0; q < G::QX; ++q) {
      const int wx = lane + 32 * q;
      if (wx >= b.x0 && wx < b.x1) f(wy * G::WX + wx, wy, wx);
    }
  }
}

// One call that reads off-point a plane it writes, on the thread's
// points of `b`: its new values into registers, a barrier (every thread
// has read the old values; in the cluster form every thread of the
// cluster), then the stores.  The caller adds the barrier that must
// follow the stores before another thread reads them.
template <class G, typename T, int NV, class F>
__device__ __forceinline__ void staged_points(const Box& b,
                                              T* const (&dst)[NV], F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v[G::QY][G::QX][NV];
  if constexpr (G::CL > 1) {
    const int band0 = cluster_rank() * G::BR;
#pragma unroll
    for (int p = 0; p < G::QY; ++p) {
      const int ly = warp + p * G::NW;
#pragma unroll
      for (int q = 0; q < G::QX; ++q) {
        const int wx = lane + 32 * q;
        if (ly < G::BR && inside(b, band0 + ly, wx)) {
          f(ly * G::WX + wx, band0 + ly, wx, v[p][q]);
        }
      }
    }
    cluster_sync();
#pragma unroll
    for (int p = 0; p < G::QY; ++p) {
      const int ly = warp + p * G::NW;
#pragma unroll
      for (int q = 0; q < G::QX; ++q) {
        const int wx = lane + 32 * q;
        if (ly < G::BR && inside(b, band0 + ly, wx)) {
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            dst[c][ly * G::WX + wx] = v[p][q][c];
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < G::QY; ++p) {
    const int wy = warp + p * G::NW;
#pragma unroll
    for (int q = 0; q < G::QX; ++q) {
      const int wx = lane + 32 * q;
      if (inside(b, wy, wx)) f(wy * G::WX + wx, wy, wx, v[p][q]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < G::QY; ++p) {
    const int wy = warp + p * G::NW;
#pragma unroll
    for (int q = 0; q < G::QX; ++q) {
      const int wx = lane + 32 * q;
      if (inside(b, wy, wx)) {
#pragma unroll
        for (int c = 0; c < NV; ++c) dst[c][wy * G::WX + wx] = v[p][q][c];
      }
    }
  }
}

// f(i, wy, wx) for every window point of `b`: warps over rows, lanes
// over columns, QY x QX points a thread (the rows in a loop, so that K
// unrolled sub-steps keep the code small).
template <class G, class F>
__device__ __forceinline__ void for_box(const Box& b, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int p = 0; p < G::QY; ++p) {
    const int wy = b.y0 + warp + p * G::NW;
    if (wy < b.y1) {
#pragma unroll
      for (int q = 0; q < G::QX; ++q) {
        const int wx = b.x0 + lane + 32 * q;
        if (wx < b.x1) f(wy * G::WX + wx, wy, wx);
      }
    }
  }
}

// Compute NV new values per point of `b` into registers with
// f(i, wy, wx, out), wait until every thread has read the old values,
// then store them into the planes `dst`.  The caller adds the barrier
// that must follow the stores before anyone reads them.
template <class G, typename T, int NV, class F>
__device__ __forceinline__ void staged_update(const Box& b, T* const (&dst)[NV],
                                              F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v[G::QY][G::QX][NV];
#pragma unroll
  for (int p = 0; p < G::QY; ++p) {
    const int wy = b.y0 + warp + p * G::NW;
    if (wy < b.y1) {
#pragma unroll
      for (int q = 0; q < G::QX; ++q) {
        const int wx = b.x0 + lane + 32 * q;
        if (wx < b.x1) f(wy * G::WX + wx, wy, wx, v[p][q]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < G::QY; ++p) {
    const int wy = b.y0 + warp + p * G::NW;
    if (wy < b.y1) {
#pragma unroll
      for (int q = 0; q < G::QX; ++q) {
        const int wx = b.x0 + lane + 32 * q;
        if (wx < b.x1) {
#pragma unroll
          for (int c = 0; c < NV; ++c) dst[c][wy * G::WX + wx] = v[p][q][c];
        }
      }
    }
  }
}

template <class S>
using PlanesOf = Planes<typename S::T, S::N, S::M, S::Tile::NINT>;

// S::WRITES_OUT, false where a client does not declare it.
template <class S, class = void>
struct WritesOut {
  static constexpr bool value = false;
};
template <class S>
struct WritesOut<S, decltype(void(S::WRITES_OUT))> {
  static constexpr bool value = S::WRITES_OUT;
};

// 4 consecutive points of a T plane, global -> shared, asynchronously
template <typename T>
__device__ __forceinline__ void copy4_points(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "float32/64, int32");
  staging::copy16_async(dst, src);
  if constexpr (sizeof(T) == 8) staging::copy16_async(dst + 2, src + 2);
}

// Stage the CTA's window (oy, ox: the block point of window point
// (0, 0)) into the tile's state, aux, int32 and code planes; its first
// `rows` rows (the cluster form: the rows of its CTA's band, oy the
// block row of the band's first).
template <class S>
__device__ __forceinline__ void stage(typename S::Tile& t,
                                      const PlanesOf<S>& p, int oy, int ox,
                                      int rows = S::G::WY) {
  using G = typename S::G;
  constexpr int N = S::N, M = S::M;
  constexpr int MI = S::Tile::NINT, NC = S::Tile::NCODE;
  constexpr int WX = G::WX, WC = G::WC;
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  bool chunks = !S::Tile::SCRATCH && G::CHUNKS && (p.nx % 4) == 0 &&
                (NC == 0 || staging::aligned4(p.code));
#pragma unroll
  for (int f = 0; f < N; ++f) chunks = chunks && staging::aligned16(p.in[f]);
#pragma unroll
  for (int f = 0; f < M; ++f) chunks = chunks && staging::aligned16(p.aux[f]);
  if constexpr (MI > 0) {
#pragma unroll
    for (int f = 0; f < MI; ++f) {
      chunks = chunks && staging::aligned16(p.auxi[f]);
    }
  }
  if (chunks) {
    constexpr int CH = WX / 4;                        // chunks per row
    for (int idx = threadIdx.x; idx < rows * CH; idx += G::NT) {
      const int w = idx / CH, j = idx - w * CH;
      const int gy = oy + w, gx = ox + 4 * j;
      const int i = w * WX + 4 * j;
      if (gy >= 0 && gy < p.ny && gx >= 0 && gx + 4 <= p.nx) {
        const size_t g = static_cast<size_t>(gy) * p.nx + gx;
#pragma unroll
        for (int f = 0; f < N; ++f) copy4_points(t.s[f] + i, p.in[f] + g);
#pragma unroll
        for (int f = 0; f < M; ++f) copy4_points(t.a[f] + i, p.aux[f] + g);
        if constexpr (MI > 0) {
#pragma unroll
          for (int f = 0; f < MI; ++f) {
            copy4_points(t.ai[f] + i, p.auxi[f] + g);
          }
        }
#pragma unroll
        for (int f = 0; f < NC; ++f) {
          staging::copy4_async(t.code + f * WC + i, p.code + f * plane + g);
        }
        continue;
      }
      const size_t row = static_cast<size_t>(min(max(gy, 0), p.ny - 1)) * p.nx;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t g = row + min(max(gx + e, 0), p.nx - 1);
#pragma unroll
        for (int f = 0; f < N; ++f) t.s[f][i + e] = p.in[f][g];
#pragma unroll
        for (int f = 0; f < M; ++f) t.a[f][i + e] = p.aux[f][g];
        if constexpr (MI > 0) {
#pragma unroll
          for (int f = 0; f < MI; ++f) t.ai[f][i + e] = p.auxi[f][g];
        }
#pragma unroll
        for (int f = 0; f < NC; ++f) {
          t.code[f * WC + i + e] = p.code[f * plane + g];
        }
      }
    }
    staging::copy_async_wait();
    return;
  }
  for (int i = threadIdx.x; i < rows * WX; i += G::NT) {
    const int wy = i / WX, wx = i - wy * WX;
    const int gy = min(max(oy + wy, 0), p.ny - 1);
    const int gx = min(max(ox + wx, 0), p.nx - 1);
    const size_t g = static_cast<size_t>(gy) * p.nx + gx;
#pragma unroll
    for (int f = 0; f < N; ++f) t.s[f][i] = p.in[f][g];
#pragma unroll
    for (int f = 0; f < M; ++f) t.a[f][i] = p.aux[f][g];
    if constexpr (MI > 0) {
#pragma unroll
      for (int f = 0; f < MI; ++f) t.ai[f][i] = p.auxi[f][g];
    }
#pragma unroll
    for (int f = 0; f < NC; ++f) t.code[f * WC + i] = p.code[f * plane + g];
  }
}

// Write the output tile (by, bx) from the state planes to the block: 16
// bytes per store where the block's rows are 16-byte aligned.  The
// cluster form writes tile rows [ty0, ty1), whose window rows its CTA
// holds from window row `top` on.
template <class S>
__device__ __forceinline__ void write_back(const typename S::Tile& t,
                                           const PlanesOf<S>& p, int by,
                                           int bx, int ty0 = 0,
                                           int ty1 = S::G::TY,
                                           int top = 0) {
  using G = typename S::G;
  using T = typename S::T;
  constexpr int N = S::N, V = 16 / static_cast<int>(sizeof(T));
  const int gy0 = by * G::TY, gx0 = bx * G::TX;
  bool vec = G::CHUNKS && (p.nx % 4) == 0;
#pragma unroll
  for (int f = 0; f < N; ++f) vec = vec && staging::aligned16(p.out[f]);
  if (vec) {
    constexpr int CH = G::TX / V;
    for (int idx = threadIdx.x; idx < (ty1 - ty0) * CH; idx += G::NT) {
      const int ty = ty0 + idx / CH, j = idx - (ty - ty0) * CH;
      const int gy = gy0 + ty, gx = gx0 + j * V;
      if (gy >= p.ny || gx >= p.nx) continue;
      const int w = (ty + G::R - top) * G::WX + G::RL + j * V;
      const size_t g = static_cast<size_t>(gy) * p.nx + gx;
#pragma unroll
      for (int f = 0; f < N; ++f) {
        *reinterpret_cast<uint4*>(p.out[f] + g) =
            *reinterpret_cast<const uint4*>(t.s[f] + w);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < (ty1 - ty0) * G::TX; idx += G::NT) {
    const int ty = ty0 + idx / G::TX, tx = idx - (ty - ty0) * G::TX;
    const int gy = gy0 + ty, gx = gx0 + tx;
    if (gy >= p.ny || gx >= p.nx) continue;
    const int w = (ty + G::R - top) * G::WX + G::RL + tx;
    const size_t g = static_cast<size_t>(gy) * p.nx + gx;
#pragma unroll
    for (int f = 0; f < N; ++f) p.out[f][g] = t.s[f][w];
  }
}

template <class S>
__global__ void __launch_bounds__(S::G::NT)
sweep_kernel(PlanesOf<S> p, typename S::Consts c) {
  using G = typename S::G;
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  typename S::Tile t(sweep_smem);
  const int oy = blockIdx.y * G::TY - G::R;
  const int ox = blockIdx.x * G::TX - G::RL;
  stage<S>(t, p, oy, ox);
  if constexpr (WritesOut<S>::value) {
#pragma unroll
    for (int f = 0; f < S::N; ++f) t.out.p[f] = p.out[f];
    t.out.ny = p.ny;
    t.out.nx = p.nx;
    t.out.oy = oy;
    t.out.ox = ox;
  }
  const S step(c);
  __syncthreads();

#pragma unroll
  for (int k = 0; k < S::K; ++k) step.substep(t, k);

  if constexpr (!WritesOut<S>::value) {
    write_back<S>(t, p, blockIdx.y, blockIdx.x);
  }
}

// The scratch form of sweep_kernel: CTA b's window is the `stride` bytes
// of `scratch` from b * stride, and the CTAs take the tiles (row-major)
// in turn.
template <class S>
__global__ void __launch_bounds__(S::G::NT)
sweep_kernel_scratch(PlanesOf<S> p, typename S::Consts c,
                     unsigned char* scratch, size_t stride) {
  using G = typename S::G;
  static_assert(S::Tile::SCRATCH, "a ScratchRing");
  typename S::Tile t(scratch + blockIdx.x * stride);
  const S step(c);
  const int ntx = (p.nx + G::TX - 1) / G::TX;
  const int tiles = ntx * ((p.ny + G::TY - 1) / G::TY);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int by = tile / ntx, bx = tile - by * ntx;
    const int oy = by * G::TY - G::R;
    const int ox = bx * G::TX - G::RL;
    __syncthreads();        // the last tile's write-back has read the window
    stage<S>(t, p, oy, ox);
    if constexpr (WritesOut<S>::value) {
#pragma unroll
      for (int f = 0; f < S::N; ++f) t.out.p[f] = p.out[f];
      t.out.ny = p.ny;
      t.out.nx = p.nx;
      t.out.oy = oy;
      t.out.ox = ox;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S::K; ++k) step.substep(t, k);
    if constexpr (!WritesOut<S>::value) write_back<S>(t, p, by, bx);
  }
}

// The bytes of one CTA's slice of the scratch form's buffer: its window,
// rounded up to 256.
template <class S>
constexpr size_t scratch_stride() {
  return (S::Tile::bytes + 255) / 256 * 256;
}

// The scratch form's CTAs for a (ny, nx) block: one per tile, at most
// those resident at once on the current device, and at most what keeps
// their windows within `cap` bytes (at least one).  -1 on a CUDA error.
template <class S>
int scratch_ctas(int ny, int nx, long long cap) {
  using G = typename S::G;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweep_kernel_scratch<S>, G::NT, 0) != cudaSuccess) {
    return -1;
  }
  const long long tiles = static_cast<long long>((nx + G::TX - 1) / G::TX) *
                          ((ny + G::TY - 1) / G::TY);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  long long fit = cap / static_cast<long long>(scratch_stride<S>());
  fit = fit > 1 ? fit : 1;
  long long n = tiles < resident ? tiles : resident;
  return static_cast<int>(n < fit ? n : fit);
}

// Launch the scratch form with `ctas` CTAs on a buffer of at least
// ctas * scratch_stride<S>() bytes.
template <class S>
cudaError_t launch_scratch(const PlanesOf<S>& p, const typename S::Consts& c,
                           void* scratch, int ctas, cudaStream_t stream) {
  using G = typename S::G;
  if (ctas < 1 || scratch == nullptr) return cudaErrorInvalidValue;
  sweep_kernel_scratch<S><<<ctas, G::NT, 0, stream>>>(
      p, c, static_cast<unsigned char*>(scratch), scratch_stride<S>());
  return cudaGetLastError();
}

// The cluster form of sweep_kernel: the CTAs of a cluster hold one
// window, CTA r its band of rows r * BR ..., and the clusters take the
// tiles (row-major) in turn.
template <class S>
__global__ void __launch_bounds__(S::G::NT)
sweep_kernel_cluster(PlanesOf<S> p, typename S::Consts c) {
  using G = typename S::G;
  static_assert(G::CL > 1, "a ClusterRing");
  static_assert(!WritesOut<S>::value, "the cluster form writes the tile");
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  typename S::Tile t(sweep_smem);
  const S step(c);
  const int ntx = (p.nx + G::TX - 1) / G::TX;
  const int tiles = ntx * ((p.ny + G::TY - 1) / G::TY);
  const int clusters = gridDim.x / G::CL;
#pragma unroll 1
  for (int tile = blockIdx.x / G::CL; tile < tiles; tile += clusters) {
    const int by = tile / ntx, bx = tile - by * ntx;
    // the band's first window row, and its rows
    const int band0 = cluster_rank() * G::BR;
    __syncthreads();        // the last tile's write-back has read the band
    stage<S>(t, p, by * G::TY - G::R + band0, bx * G::TX - G::RL,
             max(min(band0 + G::BR, G::WY) - band0, 0));
    cluster_sync();         // every band of the window is staged
#pragma unroll
    for (int k = 0; k < S::K; ++k) step.substep(t, k);
    // the band's first row again, read after the steps so that no
    // register holds it through them (the chain at 29 levels f64 spills
    // otherwise), and its tile rows
    const int top = cluster_rank() * G::BR;
    write_back<S>(t, p, by, bx, max(top - G::R, 0),
                  min(top + G::BR - G::R, G::TY), top);
  }
  cluster_sync();           // no CTA leaves while a peer may read its band
}

// The cluster form's launch of `grid` CTAs on `stream` into cfg (its
// cluster dimension in attr) and, once per device, its kernel's
// attributes: a band's dynamic shared memory, and clusters past the
// portable 8.
template <class S>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int grid, cudaStream_t stream) {
  using G = typename S::G;
  static int attr_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attr_device != dev) {
    err = cudaFuncSetAttribute(sweep_kernel_cluster<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(S::Tile::bytes));
    if (err == cudaSuccess && G::CL > 8) {
      err = cudaFuncSetAttribute(sweep_kernel_cluster<S>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    }
    if (err != cudaSuccess) return err;
    attr_device = dev;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(G::NT);
  cfg->dynamicSmemBytes = S::Tile::bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G::CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The cluster form's clusters for a (ny, nx) block: one per tile, at most
// those resident at once on the current device (0 where none can be);
// -1 on a CUDA error.
template <class S>
int cluster_count(int ny, int nx) {
  using G = typename S::G;
  static int count_device = -1, resident = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (count_device != dev) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if (cluster_config<S>(&cfg, &attr, G::CL, nullptr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(
            &resident, reinterpret_cast<const void*>(sweep_kernel_cluster<S>),
            &cfg) != cudaSuccess) {
      return -1;
    }
    count_device = dev;
  }
  const long long tiles = static_cast<long long>((nx + G::TX - 1) / G::TX) *
                          ((ny + G::TY - 1) / G::TY);
  return static_cast<int>(tiles < resident ? tiles : resident);
}

// Launch the cluster form: cluster_count clusters of G::CL CTAs, each a
// band's shared memory.  A launch the device refuses (no cluster of
// that size can be resident) returns its error; nothing else runs.
template <class S>
cudaError_t launch_cluster(const PlanesOf<S>& p, const typename S::Consts& c,
                           cudaStream_t stream) {
  using G = typename S::G;
  const int n = cluster_count<S>(p.ny, p.nx);
  if (n < 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorUnknown;
  }
  if (n == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<S>(&cfg, &attr, n * G::CL, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, sweep_kernel_cluster<S>, p, c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch grid of a (ny, nx) block: one CTA per tile of G.
template <class G>
inline dim3 tile_grid(int ny, int nx) {
  return dim3((nx + G::TX - 1) / G::TX, (ny + G::TY - 1) / G::TY);
}

template <class S>
cudaError_t launch(const PlanesOf<S>& p, const typename S::Consts& c,
                   cudaStream_t stream) {
  using G = typename S::G;
  return staging::launch<sweep_kernel<S>>(S::Tile::bytes, tile_grid<G>(p.ny,
                                                                      p.nx),
                                          G::NT, stream, p, c);
}

// Launch S<T, K> for the runtime K in [KC, KMAX].
template <template <typename, int> class S, typename T, int KMAX, int KC = 1>
cudaError_t launch_k(int K, const Planes<T, S<T, 1>::N, S<T, 1>::M>& p,
                     const typename S<T, 1>::Consts& c, cudaStream_t stream) {
  if constexpr (KC > KMAX) {
    return cudaErrorInvalidValue;
  } else {
    if (K == KC) return launch<S<T, KC>>(p, c, stream);
    return launch_k<S, T, KMAX, KC + 1>(K, p, c, stream);
  }
}

template <class C>
constexpr int num_consts() {
  static_assert(sizeof(C) % sizeof(double) == 0, "Consts holds doubles");
  return static_cast<int>(sizeof(C) / sizeof(double));
}

template <template <typename, int> class S, typename T, int KMAX,
          int KMIN = 1>
cudaError_t launch_typed(int K, const void* const* in, void* const* out,
                         const void* const* aux, const void* code, int ny,
                         int nx, const typename S<T, 1>::Consts& c,
                         cudaStream_t stream) {
  constexpr int N = S<T, 1>::N, M = S<T, 1>::M;
  Planes<T, N, M> p;
  for (int f = 0; f < N; ++f) {
    p.in[f] = static_cast<const T*>(in[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }
  p.aux[0] = nullptr;
  for (int f = 0; f < M; ++f) p.aux[f] = static_cast<const T*>(aux[f]);
  p.code = static_cast<const int8_t*>(code);
  p.ny = ny;
  p.nx = nx;
  return launch_k<S, T, KMAX, KMIN>(K, p, c, stream);
}

// The checks and dispatch of a C entry point: the constants' count and
// the block's sides are checked (and `k_ok`, the caller's check of K),
// `consts` (host memory, read before the launch returns) is copied into
// a C, and `launch(T{}, c, stream)` is called for the T of dtype_code
// (0 = float32, 1 = float64).  Returns its cudaError_t as an int.
template <typename C, typename F>
int dispatch_entry(int dtype_code, bool k_ok, int ny, int nx,
                   const double* consts, int n_consts, void* stream,
                   F&& launch) {
  if (!k_ok || n_consts != num_consts<C>() || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  C c;
  double* dst = reinterpret_cast<double*>(&c);
  for (int i = 0; i < n_consts; ++i) dst[i] = consts[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = launch(float{}, c, s);
  } else if (dtype_code == 1) {
    err = launch(double{}, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The body of a client's C entry point.  in/out/aux are arrays of
// device pointers of contiguous (ny, nx) planes.  Launches on `stream`
// without synchronising and returns cudaGetLastError() of the launch.
// K lies in [KMIN, KMAX]; see dispatch_entry for the rest.
template <template <typename, int> class S, int KMAX, int KMIN = 1>
int launch_entry(int dtype_code, int K, const void* const* in,
                 void* const* out, const void* const* aux, const void* code,
                 int ny, int nx, const double* consts, int n_consts,
                 void* stream) {
  using C = typename S<float, 1>::Consts;
  return dispatch_entry<C>(
      dtype_code, K >= KMIN && K <= KMAX, ny, nx, consts, n_consts, stream,
      [&](auto zero, const C& c, cudaStream_t s) {
        return launch_typed<S, decltype(zero), KMAX, KMIN>(
            K, in, out, aux, code, ny, nx, c, s);
      });
}

}  // namespace sweep
