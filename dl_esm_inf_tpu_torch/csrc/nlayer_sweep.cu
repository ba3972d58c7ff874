// N-layer linear shallow-water sweep: K forward-backward steps of L
// stacked layers per pass over device memory, a column march on the
// skeleton's tile rule (stencil_sweep.cuh: pick_shape with the march's
// widths, march_threads) and staging primitives (staging.cuh).
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/nlayer.py::
// NLayerModel._make_sweep (make_stencil_sweep with the model's
// per-layer _layer_step): 3L state planes eta_0..eta_{L-1},
// u_0..u_{L-1}, v_0..v_{L-1}; the int8 code of (t_upd, u_wet, v_wet);
// reach 1, K <= 8, float32 and float64.  The planes come as the three
// (L, ny, nx) level blocks eta, u, v, a base pointer each, and the
// weights (pw[0..L), H[0..L) in T) as a small device array: the launch
// carries nothing per layer, so the layer count is bounded only by the
// shared memory of a window.
//
// Per sub-step, in the grouping of the plain PyTorch step (dl_esm_inf_
// tpu_torch/models/nlayer.py::NLayerModel._layer_step) as PyTorch runs
// it on the card, where a tensor divided by the Python scalar dx is a
// product with its reciprocal in T (rdx = 1 / dx, rounded once), with
// the running pressure P_l = pw[0]*eta_0 + pw[1]*eta_1 + ... + pw[l]*eta_l:
//   u_l' = (u_l - dt * ((P_l[i+1] - P_l) * rdx)) * u_wet    (v_l' alike)
//   div_l = (u_l'[i] - u_l'[i-1]) * rdx + (v_l'[j] - v_l'[j-1]) * rdy
//   acc_l = H[L-1]*div_{L-1} + ... + H[l]*div_l          (from the bottom)
//   eta_l' = t_upd ? eta_l - dt * acc_l : eta_l
// Where dx is a power of two, rdx is exact and the product is also the
// true division the CPU's plain version takes.
//
// Design: a column march per phase.  A CTA stages its window (the tile
// rule's shape for 3L planes and the code, ring K: widths that give
// whole strips of 31 lanes) by 16-byte cp.async.  Warps take column
// strips of 31 owned lanes (lane 31 in the velocity phase and lane 0 in
// the eta phase only feed a neighbour by shuffle) and row strips.  A
// sub-step updates only what the tile still needs after it (the tile and
// K - 1 - k cells around, one more west and south for the velocities).
// Velocity phase: u and v at a point read only their own old values and
// the etas, so they are written in place; the lane builds the L running
// pressures of row j + 1 once and keeps those of row j in registers, and
// takes the east pressures by __shfl_down_sync.  One barrier; eta phase:
// eta at a point reads the new u and v of itself, its west and its south
// neighbour and only its own old eta, so it is written in place; the
// lane takes the west u by __shfl_up_sync and keeps v of row j - 1 in
// registers.  A second barrier ends the sub-step: one barrier per
// sub-step would need a second set of planes (a neighbour warp may
// overwrite in place a value a lane still reads), and the layers want
// the shared memory.  The last sub-step writes the tile's 3L planes to
// the outputs from the eta march.  Trip counts are uniform over a warp,
// so every shuffle sits in converged code.
//
// Variants.  L = 1..LCOMPILED take the layer count as a template
// parameter: the weights, the pressures of row j and v of row j - 1 sit
// in registers.  More layers take it at run time: the weights go to
// shared memory once per CTA (beside the window, in the rule's `extra`
// bytes), and the rows a compiled march carries are recomputed (the
// pressures of rows j and j + 1 run side by side) or read again (v of
// row j - 1), so rows are independent and warps take (row, strip) items
// in turn.  Geometry (tile, window, strips) is a launch argument: one
// instantiation per (T, L).
//
// What bounds it: 6L planes' bytes per sweep (24L + 1 B per point at
// float32) against ~20 operations and ~11 shared-memory operations per
// layer, point and sub-step, times the ring's recomputation: the sweep is
// bound by the shared-memory pipe and issue, not HBM.
#include "stencil_sweep.cuh"

namespace {

constexpr int KMAX = 8;
// layer counts compiled into the march
constexpr int LCOMPILED = 8;
constexpr int kLanes = sweep::kMarchLanes;

struct Consts {
  double dt, dx, dy;
  double layers;     // L
};

// A launch's planes: the (L, ny, nx) level blocks eta, u, v in and out,
// the weights pw[0..L), H[0..L) in T, the code.
template <typename T>
struct Blocks {
  const T* in[3];
  T* out[3];
  const T* w;
  const int8_t* code;
  int ny, nx, layers;
};

// A launch's window: the tile rule's shape for ring K, its rows and the
// column strips of the march.
struct Geo {
  int K, ty, tx, rl, wx, wy, strips;
};

// The warps an SM may hold, so that they keep their registers (65536 an
// SM over 32 a warp): by the march's values a lane carries, 2L of T (32
// warps: 64 registers a thread; 24: 85; kMarchWarps = 16: 128); the
// run-time variant carries nothing and takes 32.  Measured on an H100:
// more warps are faster wherever the registers allow them.
// L = 0: the run-time variant; `bytes` the size of T.
__host__ __device__ constexpr int warps_per_sm(int L, int bytes) {
  return (L == 0 || L * bytes <= 16) ? 32
         : L * bytes <= 32           ? 24
                                     : sweep::kMarchWarps;
}

// the run-time variant's weights beside the window, 16-byte rounded
__host__ __device__ constexpr int weight_bytes(int L, int bytes) {
  return (2 * L * bytes + 15) / 16 * 16;
}

template <typename T>
__device__ __forceinline__ T from_right(T v) {      // v of lane + 1
  return __shfl_down_sync(0xffffffffu, v, 1);
}

template <typename T>
__device__ __forceinline__ T from_left(T v) {       // v of lane - 1
  return __shfl_up_sync(0xffffffffu, v, 1);
}

// A CTA's window in shared memory (level l of a field at + l * wc), its
// geometry, the step's scalars and where the tile goes.
template <typename T>
struct Win {
  T* eta;
  T* u;
  T* v;
  const int8_t* code;
  int wc, wx, wy, K, rl, tx;
  T dt, rdx, rdy;
  T* out[3];
  size_t plane;
  int ny, nx, oy, ox;

  // u' (v') from the old value, the pressures east (north) and here, the
  // reciprocal spacing and the wet mask
  __device__ __forceinline__ T face(T u0, T pe, T p, T rd, T wet) const {
    return (u0 - dt * ((pe - p) * rd)) * wet;
  }
  __device__ __forceinline__ T div(T u0, T uw, T v0, T vs) const {
    return (u0 - uw) * rdx + (v0 - vs) * rdy;
  }
  // the last sub-step's store of a tile point (window row j, column c)
  __device__ __forceinline__ void put(int l, int j, int c, T e, T u0,
                                      T v0) const {
    const int gy = oy + j, gx = ox + c;
    if (gy < ny && gx < nx) {
      const size_t g = static_cast<size_t>(gy) * nx + gx + l * plane;
      out[0][g] = e;
      out[1][g] = u0;
      out[2][g] = v0;
    }
  }
};

// The column a lane marches in sub-step k: velocity columns are
// [lo, hi), eta columns [lo + 1, hi); `raw` may lie beyond the window
// (its reads are clamped and feed no owned lane).
struct Col {
  int raw, c, hi;
  __device__ Col(int rl, int tx, int K, int wx, int k, int strip,
                 int lane) {
    const int lo = rl - K + k;
    hi = rl + tx + K - 1 - k;
    raw = lo + kLanes * strip + lane;
    c = min(raw, wx - 1);
  }
};

// --- L compiled: pressures and v of the row below in registers ---------

template <typename T, int L>
__device__ void velocities(const Win<T>& w, const T (&pw)[L], int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nx = (w.tx + 2 * w.K - 1 + kLanes - 1) / kLanes;
  const int ny = (blockDim.x >> 5) / nx;
  const Col col(w.rl, w.tx, w.K, w.wx, k, warp % nx, lane);
  const bool own = lane < kLanes && col.raw < col.hi;
  // rows [k, wy - 1 - k), in row strips of H rows (H a function of k)
  const int y1 = w.wy - 1 - k;
  const int H = (y1 - k + ny - 1) / ny;
  const int o = k + (warp / nx) * H, oe = min(o + H, y1);
  T pj[L];
  {
    const int i = min(o, w.wy - 1) * w.wx + col.c;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const T e = pw[l] * w.eta[l * w.wc + i];
      pj[l] = l ? pj[l - 1] + e : e;
    }
  }
#pragma unroll 1
  for (int n = 0; n < H; ++n) {
    const int j = o + n;
    const int i = min(j, w.wy - 1) * w.wx + col.c;
    const int in = min(j + 1, w.wy - 1) * w.wx + col.c;
    const int cd = w.code[i];
    const T uw = static_cast<T>((cd >> 1) & 1);
    const T vw = static_cast<T>((cd >> 2) & 1);
    const bool act = own && j < oe;
    T pn = static_cast<T>(0);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const T e = pw[l] * w.eta[l * w.wc + in];
      pn = l ? pn + e : e;
      const T pe = from_right(pj[l]);
      if (act) {
        T* const u = w.u + l * w.wc + i;
        T* const v = w.v + l * w.wc + i;
        *u = w.face(*u, pe, pj[l], w.rdx, uw);
        *v = w.face(*v, pn, pj[l], w.rdy, vw);
      }
      pj[l] = pn;
    }
  }
}

template <typename T, int L>
__device__ void etas(const Win<T>& w, const T (&h)[L], int k, bool last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nx = (w.tx + 2 * w.K - 1 + kLanes - 1) / kLanes;
  const int ny = (blockDim.x >> 5) / nx;
  const Col col(w.rl, w.tx, w.K, w.wx, k, warp % nx, lane);
  const bool own = lane > 0 && col.raw < col.hi;
  // rows [k + 1, wy - 1 - k)
  const int y0 = k + 1, y1 = w.wy - 1 - k;
  const int H = (y1 - y0 + ny - 1) / ny;
  const int o = y0 + (warp / nx) * H, oe = min(o + H, y1);
  T vs[L];
  {
    const int i = min(o - 1, w.wy - 1) * w.wx + col.c;
#pragma unroll
    for (int l = 0; l < L; ++l) vs[l] = w.v[l * w.wc + i];
  }
#pragma unroll 1
  for (int n = 0; n < H; ++n) {
    const int j = o + n;
    const int i = min(j, w.wy - 1) * w.wx + col.c;
    const bool upd = (w.code[i] & 1) != 0;
    const bool act = own && j < oe;
    T acc = static_cast<T>(0);
#pragma unroll
    for (int l = L - 1; l >= 0; --l) {
      const T u0 = w.u[l * w.wc + i];
      const T uw = from_left(u0);
      const T v0 = w.v[l * w.wc + i];
      const T hd = h[l] * w.div(u0, uw, v0, vs[l]);
      acc = l == L - 1 ? hd : acc + hd;
      vs[l] = v0;
      if (act) {
        T* const e = w.eta + l * w.wc + i;
        const T en = upd ? *e - w.dt * acc : *e;
        if (!last) {
          *e = en;
        } else {
          w.put(l, j, col.c, en, u0, v0);
        }
      }
    }
  }
}

// --- L at run time: (row, strip) items, nothing carried between rows ---

template <typename T>
__device__ void velocities_rt(const Win<T>& w, const T* pw, int L, int nx,
                              int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = (w.wy - 1 - 2 * k) * nx;
  for (int it = warp; it < items; it += blockDim.x >> 5) {
    const int r = it / nx;
    const Col col(w.rl, w.tx, w.K, w.wx, k, it - r * nx, lane);
    const bool own = lane < kLanes && col.raw < col.hi;
    const int j = k + r;
    const int i = j * w.wx + col.c, in = i + w.wx;
    const int cd = w.code[i];
    const T uw = static_cast<T>((cd >> 1) & 1);
    const T vw = static_cast<T>((cd >> 2) & 1);
    T p = static_cast<T>(0), pn = static_cast<T>(0);
    for (int l = 0; l < L; ++l) {
      const T a = pw[l];
      const T e = a * w.eta[l * w.wc + i], en = a * w.eta[l * w.wc + in];
      p = l ? p + e : e;
      pn = l ? pn + en : en;
      const T pe = from_right(p);
      if (own) {
        T* const u = w.u + l * w.wc + i;
        T* const v = w.v + l * w.wc + i;
        *u = w.face(*u, pe, p, w.rdx, uw);
        *v = w.face(*v, pn, p, w.rdy, vw);
      }
    }
  }
}

template <typename T>
__device__ void etas_rt(const Win<T>& w, const T* h, int L, int nx, int k,
                        bool last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = (w.wy - 2 - 2 * k) * nx;
  for (int it = warp; it < items; it += blockDim.x >> 5) {
    const int r = it / nx;
    const Col col(w.rl, w.tx, w.K, w.wx, k, it - r * nx, lane);
    const bool own = lane > 0 && col.raw < col.hi;
    const int j = k + 1 + r;
    const int i = j * w.wx + col.c;
    const bool upd = (w.code[i] & 1) != 0;
    T acc = static_cast<T>(0);
    for (int l = L - 1; l >= 0; --l) {
      const int o = l * w.wc + i;
      const T u0 = w.u[o];
      const T uw = from_left(u0);
      const T v0 = w.v[o];
      const T hd = h[l] * w.div(u0, uw, v0, w.v[o - w.wx]);
      acc = l == L - 1 ? hd : acc + hd;
      if (own) {
        const T en = upd ? w.eta[o] - w.dt * acc : w.eta[o];
        if (!last) {
          w.eta[o] = en;
        } else {
          w.put(l, j, col.c, en, u0, v0);
        }
      }
    }
  }
}

// Stage the window (oy, ox: the block point of window point (0, 0)) of
// the 3L planes, level l of block b into plane b * L + l, and the code:
// chunks of 4 points inside the block by cp.async where the block's rows
// and the window's are 16-byte aligned, clamped scalar reads otherwise.
template <typename T>
__device__ __forceinline__ void stage(T* s, int8_t* code, const Blocks<T>& p,
                                      int L, const Geo& g, int oy, int ox) {
  const int wc = g.wy * g.wx;
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  bool chunks = g.wx % 4 == 0 && g.rl % 4 == 0 && g.tx % 4 == 0 &&
                p.nx % 4 == 0 && staging::aligned4(p.code);
  for (int b = 0; b < 3; ++b) chunks = chunks && staging::aligned16(p.in[b]);
  if (chunks) {
    const int ch = g.wx / 4;                          // chunks per row
    for (int idx = threadIdx.x; idx < g.wy * ch; idx += blockDim.x) {
      const int r = idx / ch, q = idx - r * ch;
      const int gy = oy + r, gx = ox + 4 * q, i = r * g.wx + 4 * q;
      if (gy >= 0 && gy < p.ny && gx >= 0 && gx + 4 <= p.nx) {
        const size_t gi = static_cast<size_t>(gy) * p.nx + gx;
        for (int b = 0; b < 3; ++b) {
          for (int l = 0; l < L; ++l) {
            sweep::copy4_points(s + (b * L + l) * wc + i,
                                p.in[b] + l * plane + gi);
          }
        }
        staging::copy4_async(code + i, p.code + gi);
        continue;
      }
      const size_t row = static_cast<size_t>(min(max(gy, 0), p.ny - 1)) * p.nx;
      for (int e = 0; e < 4; ++e) {
        const size_t gi = row + min(max(gx + e, 0), p.nx - 1);
        for (int b = 0; b < 3; ++b) {
          for (int l = 0; l < L; ++l) {
            s[(b * L + l) * wc + i + e] = p.in[b][l * plane + gi];
          }
        }
        code[i + e] = p.code[gi];
      }
    }
    staging::copy_async_wait();
    return;
  }
  for (int i = threadIdx.x; i < wc; i += blockDim.x) {
    const int r = i / g.wx, x = i - r * g.wx;
    const int gy = min(max(oy + r, 0), p.ny - 1);
    const int gx = min(max(ox + x, 0), p.nx - 1);
    const size_t gi = static_cast<size_t>(gy) * p.nx + gx;
    for (int b = 0; b < 3; ++b) {
      for (int l = 0; l < L; ++l) {
        s[(b * L + l) * wc + i] = p.in[b][l * plane + gi];
      }
    }
    code[i] = p.code[gi];
  }
}

// One CTA: stage, K sub-steps of two phases, the tile written by the
// last.  L = 0: the layer count of the launch.
template <typename T, int L>
__global__ void __launch_bounds__(32 * warps_per_sm(L, sizeof(T)))
nlayer_kernel(Blocks<T> p, Consts c, Geo g) {
  extern __shared__ __align__(16) unsigned char nlayer_smem[];
  const int nl = L ? L : p.layers;
  const int wc = g.wy * g.wx;
  T* const s = reinterpret_cast<T*>(nlayer_smem);
  T* const sw = s + 3 * nl * wc;                      // run-time weights
  int8_t* const code =
      reinterpret_cast<int8_t*>(sw) + (L ? 0 : weight_bytes(nl, sizeof(T)));
  const int oy = blockIdx.y * g.ty - g.K, ox = blockIdx.x * g.tx - g.rl;
  stage(s, code, p, nl, g, oy, ox);
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  const Win<T> w{s,
                 s + nl * wc,
                 s + 2 * nl * wc,
                 code,
                 wc, g.wx, g.wy, g.K, g.rl, g.tx,
                 static_cast<T>(c.dt),
                 static_cast<T>(1) / static_cast<T>(c.dx),
                 static_cast<T>(1) / static_cast<T>(c.dy),
                 {p.out[0], p.out[1], p.out[2]},
                 plane, p.ny, p.nx, oy, ox};
  if constexpr (L > 0) {
    T pw[L], h[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      pw[l] = p.w[l];
      h[l] = p.w[L + l];
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < g.K; ++k) {
      velocities<T, L>(w, pw, k);
      __syncthreads();
      etas<T, L>(w, h, k, k == g.K - 1);
      if (k < g.K - 1) __syncthreads();
    }
  } else {
    for (int i = threadIdx.x; i < 2 * nl; i += blockDim.x) sw[i] = p.w[i];
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < g.K; ++k) {
      velocities_rt(w, sw, nl, g.strips, k);
      __syncthreads();
      etas_rt(w, sw + nl, nl, g.strips, k, k == g.K - 1);
      if (k < g.K - 1) __syncthreads();
    }
  }
}

// A launch's window, threads a CTA and shared bytes for nl layers of
// `bytes` each and K, by nlayer_kernel<T, L> (L = 0: the run-time
// variant); g.ty = 0 where no window fits a CTA.
struct Plan {
  Geo g;
  int threads;
  size_t smem;
};

Plan plan(int L, int nl, int bytes, int K) {
  const int bpp = 3 * nl * bytes + 1;
  const int extra = L ? 0 : weight_bytes(nl, bytes);
  const sweep::Shape s =
      sweep::pick_shape(K, bpp, 0, sweep::kTileYMax, true, extra);
  if (!s.ty) return Plan{};
  const Geo g{K, s.ty, s.tx, s.rl, s.wx, s.ty + 2 * K,
              sweep::march_strips(s, K)};
  return Plan{g,
              sweep::march_threads(s, K, warps_per_sm(L, bytes),
                                   L ? sweep::kMarchRows : 1),
              static_cast<size_t>(bpp) * g.wy * g.wx + extra};
}

// Launch nlayer_kernel<T, L> on its plan; the shared-memory ceiling is
// raised when a launch needs more.
template <typename T, int L>
cudaError_t launch_layers(const Blocks<T>& p, const Consts& c, int K,
                          cudaStream_t stream) {
  const Plan pl = plan(L, L ? L : p.layers, sizeof(T), K);
  if (!pl.g.ty) return cudaErrorInvalidValue;
  const Geo& g = pl.g;
  const size_t smem = pl.smem;
  static int attr_device = -1;
  static size_t attr_bytes = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attr_device != dev || smem > attr_bytes) {
    err = cudaFuncSetAttribute(nlayer_kernel<T, L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = dev;
    attr_bytes = smem;
  }
  const dim3 grid((p.nx + g.tx - 1) / g.tx, (p.ny + g.ty - 1) / g.ty);
  nlayer_kernel<T, L><<<grid, pl.threads, smem, stream>>>(p, c, g);
  return cudaGetLastError();
}

// The compiled march for L <= LCOMPILED, the run-time variant beyond.
template <typename T, int LC = 1>
cudaError_t launch_any(int L, const Blocks<T>& p, const Consts& c, int K,
                       cudaStream_t stream) {
  if constexpr (LC > LCOMPILED) {
    return launch_layers<T, 0>(p, c, K, stream);
  } else {
    if (L == LC) return launch_layers<T, LC>(p, c, K, stream);
    return launch_any<T, LC + 1>(L, p, c, K, stream);
  }
}

}  // namespace

extern "C" {

// Number of doubles nlayer_sweep_launch expects in `consts`: dt, dx,
// dy, the layer count.
int nlayer_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// Threads a CTA of the launch for `layers` layers and K (dtype_code 0 =
// float32, 1 = float64); 0 where no window fits a CTA.
int nlayer_sweep_threads(int dtype_code, int layers, int K) {
  if (layers < 1 || K < 1 || K > KMAX) return 0;
  return plan(layers <= LCOMPILED ? layers : 0, layers,
              dtype_code ? 8 : 4, K).threads;
}

// K sub-steps of the layer count of `consts` on the level blocks in[3]
// (eta, u, v: contiguous (L, ny, nx) device arrays) into out[3];
// `weights` holds pw[0..L) then H[0..L) in the planes' type, `code` the
// (ny, nx) int8 mask code.  dtype_code 0 = float32, 1 = float64.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (cudaErrorInvalidValue where the window of L layers does
// not fit a CTA, or K is outside 1..8).
int nlayer_sweep_launch(int dtype_code, int K, const void* const* in,
                        void* const* out, const void* weights,
                        const void* code, int ny, int nx,
                        const double* consts, int n_consts, void* stream) {
  return sweep::dispatch_entry<Consts>(
      dtype_code, K >= 1 && K <= KMAX, ny, nx, consts, n_consts, stream,
      [&](auto zero, const Consts& c, cudaStream_t s) {
        using T = decltype(zero);
        const int L = static_cast<int>(c.layers);
        if (L < 1 || static_cast<double>(L) != c.layers) {
          return cudaErrorInvalidValue;
        }
        Blocks<T> p;
        for (int b = 0; b < 3; ++b) {
          p.in[b] = static_cast<const T*>(in[b]);
          p.out[b] = static_cast<T*>(out[b]);
        }
        p.w = static_cast<const T*>(weights);
        p.code = static_cast<const int8_t*>(code);
        p.ny = ny;
        p.nx = nx;
        p.layers = L;
        return launch_any<T>(L, p, c, K, s);
      });
}

}  // extern "C"
