// Fused Chebyshev sweep of the Helmholtz solver: K Chebyshev iterations
// of (I + lam*L) x = b per pass over device memory, on the shared
// skeleton stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/ops/solvers.py::
// HelmholtzSolver._make_cheb_sweep (make_stencil_sweep with the
// iteration step): three state planes x, r, d; no float aux planes; the
// int8 code of the four face activities (bit 0 e, 1 w, 2 n, 3 s), built
// from the halo-exchanged coefficients; reach 1, K <= 8.  Per sub-step
// k, in the grouping of the plain PyTorch step (dl_esm_inf_tpu_torch/
// ops/solvers.py::cheb_step after cheb_prepare):
//   e = lam_x*be, w = lam_x*bw, n = lam_y*bn, s = lam_y*bs
//   diag = 1 + e + w + n + s
//   x' = x + d
//   r' = r - (diag*d - e*d[i+1] - w*d[i-1] - n*d[j+1] - s*d[j-1])
//   d' = c1_k*d + c2_k*r'
// The recurrence scalars (c1_k, c2_k) change from sweep to sweep: the
// host folds them in double (ops/solvers.py::chebyshev_scalars) and
// passes the sweep's K pairs in the constants, zero-padded to 8; each
// is cast once to T.  A mask bit of 0 or 1 times lam is lam * 0 or lam
// exactly, so the kernel selects between the two products, computed
// once.
//
// What bounds it: 3 planes in and out plus the code, 25 B per point at
// float32 for K iterations (7.95 us at 1024^2 and 3.35 TB/s for K = 4),
// against ~40 instructions and 8 shared-memory operations per point and
// iteration: the sweep is bound by issue and the shared-memory pipe.
//
// Design: a column march, as the flagship's step (nemolite2d_step.cuh).
// The window is kWindowX = 92 columns, so that three warps of 30 owned
// columns (lanes 1..30; lanes 0 and 31 only feed their neighbours) and
// one column each side cover it, by kStrips strips of rows.  Each lane
// walks up its column one row per iteration with d of rows j-1, j and
// j+1 in registers; d's x-neighbours come from the adjacent lanes by
// shuffles, in converged code (the trip count is a function of k
// alone); the code byte is read once per point and sub-step.  x and r
// are read and written only at the point, by its one owner, so they are
// updated in place; the new d goes to a scratch plane that swaps with d
// after the sub-step, one barrier per sub-step.  The last sub-step
// writes x, r and d of the tile to the output planes from the march.
#include "stencil_sweep.cuh"

namespace {

constexpr int KMAX = 8;
// columns a warp owns, the window's columns, the column strips that
// cover them and the row strips of a CTA
constexpr int kOwned = 30;
constexpr int kWindowX = 92;
constexpr int kColStrips = (kWindowX - 2 + kOwned - 1) / kOwned;
constexpr int kStrips = 4;
// the tile's most rows
constexpr int kTileYMax = 24;

struct Consts {
  double lam_x, lam_y;
  double c1[KMAX];
  double c2[KMAX];
};

template <typename T>
__device__ __forceinline__ T from_right(T v) {      // v of lane + 1
  return __shfl_down_sync(0xffffffffu, v, 1);
}

template <typename T>
__device__ __forceinline__ T from_left(T v) {       // v of lane - 1
  return __shfl_up_sync(0xffffffffu, v, 1);
}

template <typename TT, int KK>
struct ChebStep {
  using T = TT;
  static constexpr int K = KK;
  static constexpr int N = 3, M = 0;
  static constexpr bool CODE = true;
  static constexpr bool WRITES_OUT = true;
  // x, r, d and the code staged; one scratch plane for the next d
  using Tile = sweep::Tile<
      T, N, M, CODE,
      sweep::Ring<K, 1, K, kWindowX, 32 * kColStrips * kStrips, kTileYMax>,
      0, 1, 1>;
  using G = typename Tile::G;
  using Consts = ::Consts;

  // lam and the product of lam with a clear mask bit, in x and y
  T lam_x, lam_y, lam_x0, lam_y0;
  T c1[K], c2[K];

  __device__ explicit ChebStep(const Consts& c)
      : lam_x(static_cast<T>(c.lam_x)), lam_y(static_cast<T>(c.lam_y)) {
    lam_x0 = lam_x * static_cast<T>(0);
    lam_y0 = lam_y * static_cast<T>(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c1[k] = static_cast<T>(c.c1[k]);
      c2[k] = static_cast<T>(c.c2[k]);
    }
  }

  // x', r', d' at a point from its code byte, x, r, d and d at the
  // four neighbours, for sub-step k
  struct Point {
    T x, r, d;
  };
  __device__ __forceinline__ Point point(int cd, T x, T r, T d0, T de, T dw,
                                         T dn, T ds, int k) const {
    const T e = (cd & 1) ? lam_x : lam_x0;
    const T w = (cd & 2) ? lam_x : lam_x0;
    const T n = (cd & 4) ? lam_y : lam_y0;
    const T s = (cd & 8) ? lam_y : lam_y0;
    const T diag = static_cast<T>(1) + e + w + n + s;
    const T rn = r - ((((diag * d0 - e * de) - w * dw) - n * dn) - s * ds);
    return {x + d0, rn, c1[k] * d0 + c2[k] * rn};
  }

  __device__ void substep(Tile& t, int k) const {
    constexpr int WX = G::WX, WY = G::WY;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sx = warp % kColStrips, sy = warp / kColStrips;
    // this sub-step's region: rows and columns [k + 1, W - k - 1); each
    // strip marches H rows, a function of k alone
    const int lo = k + 1, hi_y = WY - k - 1, hi_x = WX - k - 1;
    const int H = (hi_y - lo + kStrips - 1) / kStrips;
    const int o = lo + sy * H, oe = min(o + H, hi_y);
    const int col_raw = k + kOwned * sx + lane;
    const int col = min(col_raw, WX - 1);
    const bool own = lane >= 1 && lane <= kOwned && col_raw < hi_x;
    const bool last = k == K - 1;
    // the last sub-step's stores: tile columns of the block
    const int gx = t.out.ox + col;
    const bool out_c = col >= G::RL && col < G::RL + G::TX && gx < t.out.nx;
    T* const x = t.s[0];
    T* const r = t.s[1];
    const T* const d = t.s[2];
    T* const dn = t.x[0];
    T dm = d[min(o - 1, WY - 1) * WX + col];
    T d0 = d[min(o, WY - 1) * WX + col];
#pragma unroll 2
    for (int n = 0; n < H; ++n) {
      const int j = o + n;
      const T dp = d[min(j + 1, WY - 1) * WX + col];
      const T de = from_right(d0);
      const T dw = from_left(d0);
      if (own && j < oe) {
        const int i = j * WX + col;
        const Point v = point(t.code[i], x[i], r[i], d0, de, dw, dp, dm, k);
        if (!last) {
          x[i] = v.x;
          r[i] = v.r;
          dn[i] = v.d;
        } else if (out_c && j >= G::R && j < G::R + G::TY &&
                   t.out.oy + j < t.out.ny) {
          const size_t g =
              static_cast<size_t>(t.out.oy + j) * t.out.nx + gx;
          t.out.p[0][g] = v.x;
          t.out.p[1][g] = v.r;
          t.out.p[2][g] = v.d;
        }
      }
      dm = d0;
      d0 = dp;
    }
    if (!last) {
      __syncthreads();
      t.x[0] = t.s[2];
      t.s[2] = dn;
    }
  }
};

// K = 1: there is nothing to block in time, so nothing is staged.  The
// same march reads x, r, d and the code from the block itself (reads
// clamped to it) and writes x', r', d'; a CTA takes kDirectRows rows and
// the kOwned * kColStrips columns its lanes own, with the same lanes and
// strips.
constexpr int kDirectRows = 16;
constexpr int kDirectCols = kOwned * kColStrips;

template <typename T>
__global__ void __launch_bounds__(32 * kColStrips * kStrips)
cheb_direct_kernel(sweep::Planes<T, 3, 0> p, Consts c) {
  constexpr int H = (kDirectRows + kStrips - 1) / kStrips;
  const ChebStep<T, 1> step(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sx = warp % kColStrips, sy = warp / kColStrips;
  const int gx_raw = blockIdx.x * kDirectCols - 1 + kOwned * sx + lane;
  const int gx = min(max(gx_raw, 0), p.nx - 1);
  const bool own = lane >= 1 && lane <= kOwned && gx_raw < p.nx;
  const int o = blockIdx.y * kDirectRows + sy * H;
  const int oe = min(min(o + H, (blockIdx.y + 1) * kDirectRows), p.ny);
  const T* const d = p.in[2];
  auto at = [&](int gy) {
    return static_cast<size_t>(min(max(gy, 0), p.ny - 1)) * p.nx + gx;
  };
  T dm = d[at(o - 1)];
  T d0 = d[at(o)];
#pragma unroll
  for (int n = 0; n < H; ++n) {
    const int gy = o + n;
    const T dp = d[at(gy + 1)];
    const T de = from_right(d0);
    const T dw = from_left(d0);
    if (own && gy < oe) {
      const size_t g = static_cast<size_t>(gy) * p.nx + gx;
      const auto v = step.point(p.code[g], p.in[0][g], p.in[1][g], d0, de,
                                dw, dp, dm, 0);
      p.out[0][g] = v.x;
      p.out[1][g] = v.r;
      p.out[2][g] = v.d;
    }
    dm = d0;
    d0 = dp;
  }
}

template <typename T>
cudaError_t launch_direct(const void* const* in, void* const* out,
                          const void* code, int ny, int nx, const Consts& c,
                          cudaStream_t stream) {
  sweep::Planes<T, 3, 0> p;
  for (int f = 0; f < 3; ++f) {
    p.in[f] = static_cast<const T*>(in[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }
  p.aux[0] = nullptr;
  p.code = static_cast<const int8_t*>(code);
  p.ny = ny;
  p.nx = nx;
  const dim3 grid((nx + kDirectCols - 1) / kDirectCols,
                  (ny + kDirectRows - 1) / kDirectRows);
  return staging::launch<cheb_direct_kernel<T>>(
      0, grid, 32 * kColStrips * kStrips, stream, p, c);
}

}  // namespace

extern "C" {

// Number of doubles helmholtz_cheb_sweep_launch expects in `consts`:
// lam_x, lam_y, c1[8], c2[8].
int helmholtz_cheb_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` must be 0 and `aux` is not read.
// K = 1 launches the direct march, K = 2..8 the sweep on the skeleton.
int helmholtz_cheb_sweep_launch(int dtype_code, int K, int variant,
                                const void* const* in, void* const* out,
                                const void* const* aux, const void* code,
                                int ny, int nx, const double* consts,
                                int n_consts, void* stream) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K != 1) {
    return sweep::launch_entry<ChebStep, KMAX, 2>(
        dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
  }
  return sweep::dispatch_entry<Consts>(
      dtype_code, true, ny, nx, consts, n_consts, stream,
      [&](auto zero, const Consts& c, cudaStream_t s) {
        return launch_direct<decltype(zero)>(in, out, code, ny, nx, c, s);
      });
}

}  // extern "C"
