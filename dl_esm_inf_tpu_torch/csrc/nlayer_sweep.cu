// N-layer linear shallow-water sweep: K forward-backward steps of L
// stacked layers per pass over device memory, on the shared skeleton
// stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/nlayer.py::
// NLayerModel._make_sweep (make_stencil_sweep with the model's
// per-layer _layer_step): 3L state planes eta_0..eta_{L-1},
// u_0..u_{L-1}, v_0..v_{L-1}; the int8 code of (t_upd, u_wet, v_wet);
// reach 1, K <= 8, float32 and float64.
//
// Variants.  L = 1..4 (variants 0..3) take the layer count as a template
// parameter and the skeleton's tiles, at every K (at f64, K=8, L=4 a
// 48 x 20 tile whose 64 x 36 window of 12 planes and the code takes 218
// KiB of the 227 KiB a block may use).  More layers (variants 4, 5, 6:
// 32, 16 and 8 cell tiles, up to LMAX layers) take the layer count at
// run time, from the constants:
// 3L planes of (tile + 2K)^2 points each must fit the block's shared
// memory, so the wrapper (models/nlayer.py: kernel_tile) picks the
// largest tile that holds them; at f64, K=8 a 16-cell tile stages
// 24 KiB per layer (L <= 9) and an 8-cell tile 13.5 KiB (L <= 16).  A
// smaller tile recomputes more ring per output point ((tile + 2K)^2 /
// tile^2: 2.25 at 32, 4 at 16, 9 at 8), which is the price of the
// layers.  Per sub-step, in the grouping of the plain
// PyTorch step (dl_esm_inf_tpu_torch/models/nlayer.py::
// NLayerModel._layer_step), with the running pressure
// pk = pw[0]*eta_0 + pw[1]*eta_1 + ... + pw[k]*eta_k:
//   u_k' = (u_k - dt * ((pk[i+1] - pk) / dx)) * u_wet      (v_k' alike)
//   div_k = (u_k'[i] - u_k'[i-1]) / dx + (v_k'[j] - v_k'[j-1]) / dy
//   acc_k = H[L-1]*div_{L-1} + ... + H[k]*div_k          (from the bottom)
//   eta_k' = t_upd ? eta_k - dt * acc_k : eta_k
//
// Phases, as in twolayer_sweep.cu.  The velocities read only their own
// old values and the etas, so they are written in place; after a
// barrier the etas read the new velocities of their west and south
// neighbours and only their own old values, so they are written in
// place too.  Two barriers per sub-step, nothing held in registers
// across them: a second set of planes would not fit at f64.  Bound by
// shared-memory traffic and barriers rather than HBM (6L*4 + 1 B per
// point per sweep at float32).
#include "stencil_sweep.cuh"

namespace {

// The layers a launch's parameter block holds (the run-time variants'
// 3L plane pointers in and out, and the weights), and the compiled ones.
constexpr int LMAX = 32;
constexpr int LCOMPILED = 4;

struct Consts {
  double dt, dx, dy;
  double layers;     // L, read by the run-time variants
  double pw[LMAX];   // pressure weights: g, then the reduced gravities
  double h[LMAX];    // rest thicknesses
};

template <typename TT, int KK, int L>
struct NLayerStep {
  using T = TT;
  static constexpr int K = KK;
  static constexpr int N = 3 * L, M = 0;
  static constexpr bool CODE = true;
  using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, 1>>;
  using G = typename Tile::G;
  using Consts = ::Consts;

  T dt, dx, dy;
  T pw[L], h[L];

  __device__ explicit NLayerStep(const Consts& c)
      : dt(static_cast<T>(c.dt)), dx(static_cast<T>(c.dx)),
        dy(static_cast<T>(c.dy)) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      pw[k] = static_cast<T>(c.pw[k]);
      h[k] = static_cast<T>(c.h[k]);
    }
  }

  __device__ void substep(Tile& t, int k) const {
    constexpr int WX = G::WX;
    T* const* eta = t.s;
    T* const* u = t.s + L;
    T* const* v = t.s + 2 * L;
    sweep::for_box<G>(sweep::inset<G>(k, k + 1), [&](int i, int, int) {
      const T uw = t.bit(i, 1), vw = t.bit(i, 2);
      T pk = pw[0] * eta[0][i];
      T pke = pw[0] * eta[0][i + 1];
      T pkn = pw[0] * eta[0][i + WX];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (l > 0) {
          pk = pk + pw[l] * eta[l][i];
          pke = pke + pw[l] * eta[l][i + 1];
          pkn = pkn + pw[l] * eta[l][i + WX];
        }
        u[l][i] = (u[l][i] - dt * ((pke - pk) / dx)) * uw;
        v[l][i] = (v[l][i] - dt * ((pkn - pk) / dy)) * vw;
      }
    });
    __syncthreads();
    sweep::for_box<G>(sweep::inset<G>(k + 1, k + 1), [&](int i, int, int) {
      if (t.code[i] & 1) {
        T acc = static_cast<T>(0);
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
          const T div =
              (u[l][i] - u[l][i - 1]) / dx + (v[l][i] - v[l][i - WX]) / dy;
          acc = (l == L - 1) ? h[l] * div : acc + h[l] * div;
          eta[l][i] = eta[l][i] - dt * acc;
        }
      }
    });
    __syncthreads();
  }
};

template <typename T, int K>
using Layers1 = NLayerStep<T, K, 1>;
template <typename T, int K>
using Layers2 = NLayerStep<T, K, 2>;
template <typename T, int K>
using Layers3 = NLayerStep<T, K, 3>;
template <typename T, int K>
using Layers4 = NLayerStep<T, K, 4>;

// --- L > 4: the layer count at run time, tiles of EDGE cells -------------

// The run-time variants' planes: 3L pointers in and out, eta, u, v.
struct ManyPlanes {
  const void* in[3 * LMAX];
  void* out[3 * LMAX];
  const int8_t* code;
  int ny, nx, layers;
};

// f(i) for every window point of `b`, spread linearly over the threads.
// The run-time variants' windows are 24 to 48 columns wide, where the
// skeleton's passes (lanes over columns) would leave up to a quarter of
// the lanes idle; here each point's layer loop outweighs the division.
template <class G, class F>
__device__ __forceinline__ void for_box_linear(const sweep::Box& b, F f) {
  const int w = b.x1 - b.x0;
  const int n = (b.y1 - b.y0) * w;
  for (int j = threadIdx.x; j < n; j += sweep::NT) {
    const int dy = j / w;
    f((b.y0 + dy) * G::WX + b.x0 + (j - dy * w));
  }
}

// The same step as NLayerStep, on 3L planes carved from dynamic shared
// memory by the run-time layer count; the plane pointers and the
// weights (cast once to T) sit in static shared memory, so that the
// run-time indices never index the parameter block.
template <typename T, int K, int EDGE>
__global__ void __launch_bounds__(sweep::NT)
nlayer_many_kernel(ManyPlanes p, Consts c) {
  using G = sweep::Geom<K, 1, K, EDGE, EDGE, K, EDGE + 2 * K>;
  constexpr int R = G::R, WX = G::WX, WC = G::WC;
  extern __shared__ __align__(16) unsigned char nlayer_smem[];
  __shared__ const T* s_in[3 * LMAX];
  __shared__ T* s_out[3 * LMAX];
  __shared__ T s_pw[LMAX], s_h[LMAX];
  const int L = p.layers, N = 3 * L;
  for (int f = threadIdx.x; f < N; f += sweep::NT) {
    s_in[f] = static_cast<const T*>(p.in[f]);
    s_out[f] = static_cast<T*>(p.out[f]);
  }
  for (int l = threadIdx.x; l < L; l += sweep::NT) {
    s_pw[l] = static_cast<T>(c.pw[l]);
    s_h[l] = static_cast<T>(c.h[l]);
  }
  T* const s = reinterpret_cast<T*>(nlayer_smem);   // plane f: s + f*WC
  int8_t* const code = reinterpret_cast<int8_t*>(s + N * WC);
  __syncthreads();

  // stage the window, clamped to the block
  const int x0 = blockIdx.x * EDGE - R, y0 = blockIdx.y * EDGE - R;
  for (int i = threadIdx.x; i < WC; i += sweep::NT) {
    const int wy = i / WX, wx = i - wy * WX;
    const int gy = min(max(y0 + wy, 0), p.ny - 1);
    const int gx = min(max(x0 + wx, 0), p.nx - 1);
    const size_t g = static_cast<size_t>(gy) * p.nx + gx;
    for (int f = 0; f < N; ++f) s[f * WC + i] = s_in[f][g];
    code[i] = p.code[g];
  }
  __syncthreads();

  const T dt = static_cast<T>(c.dt), dx = static_cast<T>(c.dx);
  const T dy = static_cast<T>(c.dy);
  T* const eta = s;
  T* const u = s + L * WC;
  T* const v = s + 2 * L * WC;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    for_box_linear<G>(sweep::inset<G>(k, k + 1), [&](int i) {
      const T uw = static_cast<T>((static_cast<int>(code[i]) >> 1) & 1);
      const T vw = static_cast<T>((static_cast<int>(code[i]) >> 2) & 1);
      T pk = s_pw[0] * eta[i];
      T pke = s_pw[0] * eta[i + 1];
      T pkn = s_pw[0] * eta[i + WX];
      for (int l = 0; l < L; ++l) {
        const int o = l * WC + i;
        if (l > 0) {
          pk = pk + s_pw[l] * eta[o];
          pke = pke + s_pw[l] * eta[o + 1];
          pkn = pkn + s_pw[l] * eta[o + WX];
        }
        u[o] = (u[o] - dt * ((pke - pk) / dx)) * uw;
        v[o] = (v[o] - dt * ((pkn - pk) / dy)) * vw;
      }
    });
    __syncthreads();
    for_box_linear<G>(sweep::inset<G>(k + 1, k + 1), [&](int i) {
      if (code[i] & 1) {
        T acc = static_cast<T>(0);
        for (int l = L - 1; l >= 0; --l) {
          const int o = l * WC + i;
          const T div = (u[o] - u[o - 1]) / dx + (v[o] - v[o - WX]) / dy;
          acc = (l == L - 1) ? s_h[l] * div : acc + s_h[l] * div;
          eta[o] = eta[o] - dt * acc;
        }
      }
    });
    __syncthreads();
  }

  // write back the output tile
  for (int i = threadIdx.x; i < EDGE * EDGE; i += sweep::NT) {
    const int ty = i / EDGE, tx = i - ty * EDGE;
    const int gy = blockIdx.y * EDGE + ty, gx = blockIdx.x * EDGE + tx;
    if (gy >= p.ny || gx >= p.nx) continue;
    const int w = (ty + R) * WX + tx + R;
    const size_t g = static_cast<size_t>(gy) * p.nx + gx;
    for (int f = 0; f < N; ++f) s_out[f][g] = s[f * WC + w];
  }
}

template <typename T, int K, int EDGE>
cudaError_t launch_many(const ManyPlanes& p, const Consts& c,
                        cudaStream_t stream) {
  using G = sweep::Geom<K, 1, K, EDGE, EDGE, K, EDGE + 2 * K>;
  const size_t smem = static_cast<size_t>(3 * p.layers) * G::WC * sizeof(T) +
                      G::WC;
  // the ceiling is per device; raise it when a launch needs more
  static int attr_device = -1;
  static size_t attr_bytes = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attr_device != dev || smem > attr_bytes) {
    err = cudaFuncSetAttribute(nlayer_many_kernel<T, K, EDGE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = dev;
    attr_bytes = smem;
  }
  const dim3 grid = sweep::tile_grid<G>(p.ny, p.nx);
  nlayer_many_kernel<T, K, EDGE><<<grid, sweep::NT, smem, stream>>>(p, c);
  return cudaGetLastError();
}

template <typename T, int EDGE, int KC = 1>
cudaError_t launch_many_k(int K, const ManyPlanes& p, const Consts& c,
                          cudaStream_t stream) {
  if constexpr (KC > 8) {
    return cudaErrorInvalidValue;
  } else {
    if (K == KC) return launch_many<T, KC, EDGE>(p, c, stream);
    return launch_many_k<T, EDGE, KC + 1>(K, p, c, stream);
  }
}

// The run-time layer count's entry: EDGE-cell tiles, LCOMPILED < L <= LMAX.
template <int EDGE>
int launch_many_entry(int dtype_code, int K, const void* const* in,
                      void* const* out, const void* code, int ny, int nx,
                      const double* consts, int n_consts,
                      cudaStream_t stream) {
  Consts c;
  if (n_consts != sweep::num_consts<Consts>() || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  double* dst = reinterpret_cast<double*>(&c);
  for (int i = 0; i < n_consts; ++i) dst[i] = consts[i];
  const int L = static_cast<int>(c.layers);
  if (L <= LCOMPILED || L > LMAX || static_cast<double>(L) != c.layers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ManyPlanes p{};
  for (int f = 0; f < 3 * L; ++f) {
    p.in[f] = in[f];
    p.out[f] = out[f];
  }
  p.code = static_cast<const int8_t*>(code);
  p.ny = ny;
  p.nx = nx;
  p.layers = L;
  cudaError_t err;
  if (dtype_code == 0) {
    err = launch_many_k<float, EDGE>(K, p, c, stream);
  } else if (dtype_code == 1) {
    err = launch_many_k<double, EDGE>(K, p, c, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Number of doubles nlayer_sweep_launch expects in `consts`: dt, dx,
// dy, the layer count, pw[LMAX], h[LMAX] (zero beyond the layer count).
int nlayer_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` L-1 takes L = 1..4 layers (3L state
// planes) on the skeleton's tiles; variants 4, 5 and 6 take the layer
// count of the constants, 4 < L <= 32, on 32-, 16- and 8-cell tiles.
// `aux` is not read.
int nlayer_sweep_launch(int dtype_code, int K, int variant,
                        const void* const* in, void* const* out,
                        const void* const* aux, const void* code, int ny,
                        int nx, const double* consts, int n_consts,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return sweep::launch_entry<Layers1, 8>(dtype_code, K, in, out, aux,
                                             code, ny, nx, consts, n_consts,
                                             stream);
    case 1:
      return sweep::launch_entry<Layers2, 8>(dtype_code, K, in, out, aux,
                                             code, ny, nx, consts, n_consts,
                                             stream);
    case 2:
      return sweep::launch_entry<Layers3, 8>(dtype_code, K, in, out, aux,
                                             code, ny, nx, consts, n_consts,
                                             stream);
    case 3:
      return sweep::launch_entry<Layers4, 8>(dtype_code, K, in, out, aux,
                                             code, ny, nx, consts, n_consts,
                                             stream);
    case 4:
      return launch_many_entry<32>(dtype_code, K, in, out, code, ny, nx,
                                   consts, n_consts, s);
    case 5:
      return launch_many_entry<16>(dtype_code, K, in, out, code, ny, nx,
                                   consts, n_consts, s);
    case 6:
      return launch_many_entry<8>(dtype_code, K, in, out, code, ny, nx,
                                  consts, n_consts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
