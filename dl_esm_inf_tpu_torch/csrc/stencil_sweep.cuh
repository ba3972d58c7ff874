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
// the tile plus a ring of R cells on every side (K * REACH unless the
// client names another ring) in dynamic shared memory: the state
// planes, the aux planes and the code bytes.
// Window reads outside the block are clamped to its edge, so the kernel
// never reads outside the (ny, nx) block.  The CTA then applies the
// client's step K times in shared memory; the inputs of sub-step k are
// valid on the window inset by k * REACH, its outputs on the window
// inset by (k + 1) * REACH, so after K sub-steps exactly the output
// tile is valid and is written back.  Cells within R of the block edge
// hold finite values of no meaning, like the halo cells of the plain
// version; callers compare internal points.
//
// A client step is a struct with
//   using G = Geom<K, REACH>;  static constexpr int N, M;  CODE (bool);
//   using Tile = sweep::Tile<T, N, M, CODE, G>;  Consts (POD of doubles);
// (Tile<T, N, M, CODE, G, MI, NC> adds MI int32 planes and NC code
// planes);
//   __device__ explicit Step(const Consts&);      // casts to T, once
//   __device__ void substep(Tile&, int k) const;
// `substep` runs its own phases and barriers, and returns only after a
// __syncthreads() that follows its last shared-memory write.  Scalars
// are folded on the host in double, in the grouping of the plain
// PyTorch step, and cast once to T; with --fmad=false the kernel then
// rounds where the plain version rounds.
//
// What bounds it.  A sweep moves N state planes in and out plus the
// aux planes and the code once per K steps, a few bytes per point and
// step, so at 1024^2 the HBM bound is around a microsecond per step on
// an H100: the kernels are bound by shared-memory traffic, the
// barriers between phases and the redundant ring work of temporal
// blocking (a 32 x 32 tile with an 8-cell ring stages 2.25x its area).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sweep {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int NT = 256;

// A window's geometry: an EDGE x EDGE output tile (TY x TX unless a client
// names a smaller one, as the N-layer sweep does for many layers) and its
// ring of R cells.
template <int K, int REACH, int RING = K * REACH, int EDGE = TX>
struct Geom {
  static_assert(TY == TX, "square tiles");
  static constexpr int R = RING;
  static constexpr int TILE = EDGE;
  static constexpr int WY = EDGE + 2 * R;
  static constexpr int WX = EDGE + 2 * R;
  static constexpr int WC = WY * WX;
  static constexpr int CPT = (WC + NT - 1) / NT;   // window points a thread
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

// The shared-memory window: N state planes, M aux planes, MI int32 aux
// planes, NC code planes (one when CODE, by default).
template <typename T, int N, int M, bool CODE, class G, int MI = 0,
          int NC = (CODE ? 1 : 0)>
struct Tile {
  static constexpr int NINT = MI, NCODE = NC;
  static constexpr size_t bytes =
      static_cast<size_t>(N + M) * G::WC * sizeof(T) +
      static_cast<size_t>(MI) * G::WC * sizeof(int32_t) +
      static_cast<size_t>(NC) * G::WC;
  T* s[N];
  T* a[M > 0 ? M : 1];
  int32_t* ai[MI > 0 ? MI : 1];
  int8_t* code;

  __device__ explicit Tile(unsigned char* raw) {
    T* base = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int f = 0; f < N; ++f) s[f] = base + f * G::WC;
#pragma unroll
    for (int f = 0; f < (M > 0 ? M : 1); ++f) a[f] = base + (N + f) * G::WC;
    int32_t* ibase = reinterpret_cast<int32_t*>(base + (N + M) * G::WC);
#pragma unroll
    for (int f = 0; f < (MI > 0 ? MI : 1); ++f) ai[f] = ibase + f * G::WC;
    code = reinterpret_cast<int8_t*>(ibase + MI * G::WC);
  }

  // mask bit b of the code at window index i, as 0/1 in T
  __device__ __forceinline__ T bit(int i, int b) const {
    return static_cast<T>((static_cast<int>(code[i]) >> b) & 1);
  }

  // mask bit b of code plane c at window index i
  __device__ __forceinline__ bool bit_set(int i, int c, int b) const {
    return ((static_cast<int>(code[c * G::WC + i]) >> b) & 1) != 0;
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

// f(i, wy, wx) for every window point of `b`, spread over the threads.
template <class G, class F>
__device__ __forceinline__ void for_box(const Box& b, F f) {
  const int w = b.x1 - b.x0;
  const int n = (b.y1 - b.y0) * w;
  for (int j = threadIdx.x; j < n; j += NT) {
    const int dy = j / w;
    const int wy = b.y0 + dy, wx = b.x0 + (j - dy * w);
    f(wy * G::WX + wx, wy, wx);
  }
}

// Compute NV new values per point of `b` into registers with
// f(i, wy, wx, out), wait until every thread has read the old values,
// then store them into the planes `dst`.  The caller adds the barrier
// that must follow the stores before anyone reads them.
template <class G, typename T, int NV, class F>
__device__ __forceinline__ void staged_update(const Box& b, T* const (&dst)[NV],
                                              F f) {
  const int w = b.x1 - b.x0;
  const int n = (b.y1 - b.y0) * w;
  T v[G::CPT][NV];
#pragma unroll
  for (int q = 0; q < G::CPT; ++q) {
    const int j = threadIdx.x + q * NT;
    if (j < n) {
      const int dy = j / w;
      const int wy = b.y0 + dy, wx = b.x0 + (j - dy * w);
      f(wy * G::WX + wx, wy, wx, v[q]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < G::CPT; ++q) {
    const int j = threadIdx.x + q * NT;
    if (j < n) {
      const int dy = j / w;
      const int i = (b.y0 + dy) * G::WX + b.x0 + (j - dy * w);
#pragma unroll
      for (int c = 0; c < NV; ++c) dst[c][i] = v[q][c];
    }
  }
}

template <class S>
using PlanesOf = Planes<typename S::T, S::N, S::M, S::Tile::NINT>;

template <class S>
__global__ void __launch_bounds__(NT)
sweep_kernel(PlanesOf<S> p, typename S::Consts c) {
  using G = typename S::G;
  constexpr int R = G::R, WX = G::WX, WC = G::WC;
  constexpr int MI = S::Tile::NINT, NC = S::Tile::NCODE;
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  typename S::Tile t(sweep_smem);

  // stage the window, clamped to the block
  const int x0 = blockIdx.x * G::TILE - R;
  const int y0 = blockIdx.y * G::TILE - R;
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  for (int i = threadIdx.x; i < WC; i += NT) {
    const int wy = i / WX, wx = i - wy * WX;
    const int gy = min(max(y0 + wy, 0), p.ny - 1);
    const int gx = min(max(x0 + wx, 0), p.nx - 1);
    const size_t g = static_cast<size_t>(gy) * p.nx + gx;
#pragma unroll
    for (int f = 0; f < S::N; ++f) t.s[f][i] = p.in[f][g];
#pragma unroll
    for (int f = 0; f < S::M; ++f) t.a[f][i] = p.aux[f][g];
    if constexpr (MI > 0) {
#pragma unroll
      for (int f = 0; f < MI; ++f) t.ai[f][i] = p.auxi[f][g];
    }
#pragma unroll
    for (int f = 0; f < NC; ++f) t.code[f * WC + i] = p.code[f * plane + g];
  }
  const S step(c);
  __syncthreads();

#pragma unroll 1
  for (int k = 0; k < S::K; ++k) step.substep(t, k);

  // write back the output tile
  for (int i = threadIdx.x; i < G::TILE * G::TILE; i += NT) {
    const int ty = i / G::TILE, tx = i - ty * G::TILE;
    const int gy = blockIdx.y * G::TILE + ty, gx = blockIdx.x * G::TILE + tx;
    if (gy >= p.ny || gx >= p.nx) continue;
    const int w = (ty + R) * WX + tx + R;
    const size_t g = static_cast<size_t>(gy) * p.nx + gx;
#pragma unroll
    for (int f = 0; f < S::N; ++f) p.out[f][g] = t.s[f][w];
  }
}

// The launch grid of a (ny, nx) block: one CTA per EDGE x EDGE tile.
template <int EDGE>
inline dim3 tile_grid(int ny, int nx) {
  return dim3((nx + EDGE - 1) / EDGE, (ny + EDGE - 1) / EDGE);
}

template <class S>
cudaError_t launch(const PlanesOf<S>& p, const typename S::Consts& c,
                   cudaStream_t stream) {
  constexpr size_t smem = S::Tile::bytes;
  // the attribute is per device: set it once for each device used
  static int attr_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attr_device != dev) {
    err = cudaFuncSetAttribute(sweep_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = dev;
  }
  const dim3 grid = tile_grid<S::G::TILE>(p.ny, p.nx);
  sweep_kernel<S><<<grid, NT, smem, stream>>>(p, c);
  return cudaGetLastError();
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

template <template <typename, int> class S, typename T, int KMAX>
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
  return launch_k<S, T, KMAX>(K, p, c, stream);
}

// The body of a client's C entry point.  dtype_code: 0 = float32,
// 1 = float64.  in/out/aux are arrays of device pointers of contiguous
// (ny, nx) planes; `consts` is host memory, read before the launch
// returns.  Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
template <template <typename, int> class S, int KMAX>
int launch_entry(int dtype_code, int K, const void* const* in,
                 void* const* out, const void* const* aux, const void* code,
                 int ny, int nx, const double* consts, int n_consts,
                 void* stream) {
  using C = typename S<float, 1>::Consts;
  if (n_consts != num_consts<C>() || ny < 1 || nx < 1 || K < 1 ||
      K > KMAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  C c;
  double* dst = reinterpret_cast<double*>(&c);
  for (int i = 0; i < n_consts; ++i) dst[i] = consts[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = launch_typed<S, float, KMAX>(K, in, out, aux, code, ny, nx, c, s);
  } else if (dtype_code == 1) {
    err = launch_typed<S, double, KMAX>(K, in, out, aux, code, ny, nx, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace sweep
