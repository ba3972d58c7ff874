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
// is cast once to T.
//
// Phases.  r' reads d at the four neighbours while d itself is
// rewritten, so the three new values wait in registers until every
// thread has read the old d (sweep::staged_update), then are stored; a
// second barrier makes them visible to the next sub-step.  Two
// barriers per sub-step.  The sweep moves 3 planes in and out plus the
// code, 25 B per point at float32 for K iterations; like the client
// sweeps it is bound by the in-SM work per sub-step (shared-memory
// traffic, barriers, ring work), not by HBM.
#include "stencil_sweep.cuh"

namespace {

constexpr int KMAX = 8;

struct Consts {
  double lam_x, lam_y;
  double c1[KMAX];
  double c2[KMAX];
};

template <typename TT, int KK>
struct ChebStep {
  using T = TT;
  static constexpr int K = KK;
  using G = sweep::Geom<K, 1>;
  static constexpr int N = 3, M = 0;
  static constexpr bool CODE = true;
  using Tile = sweep::Tile<T, N, M, CODE, G>;
  using Consts = ::Consts;

  T lam_x, lam_y;
  T c1[K], c2[K];

  __device__ explicit ChebStep(const Consts& c)
      : lam_x(static_cast<T>(c.lam_x)), lam_y(static_cast<T>(c.lam_y)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c1[k] = static_cast<T>(c.c1[k]);
      c2[k] = static_cast<T>(c.c2[k]);
    }
  }

  __device__ void substep(Tile& t, int k) const {
    T* x = t.s[0];
    T* r = t.s[1];
    T* d = t.s[2];
    constexpr int WX = G::WX;
    const T ck1 = c1[k], ck2 = c2[k];
    T* const xrd[3] = {x, r, d};
    sweep::staged_update<G, T, 3>(
        sweep::inset<G>(k + 1, k + 1), xrd,
        [&](int i, int, int, T(&o)[3]) {
          const T e = lam_x * t.bit(i, 0);
          const T w = lam_x * t.bit(i, 1);
          const T n = lam_y * t.bit(i, 2);
          const T s = lam_y * t.bit(i, 3);
          const T diag = static_cast<T>(1) + e + w + n + s;
          const T dv = d[i];
          const T rn = r[i] - ((((diag * dv - e * d[i + 1]) - w * d[i - 1]) -
                                n * d[i + WX]) -
                               s * d[i - WX]);
          o[0] = x[i] + dv;
          o[1] = rn;
          o[2] = ck1 * dv + ck2 * rn;
        });
    __syncthreads();
  }
};

}  // namespace

extern "C" {

// Number of doubles helmholtz_cheb_sweep_launch expects in `consts`:
// lam_x, lam_y, c1[8], c2[8].
int helmholtz_cheb_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` must be 0 and `aux` is not read.
int helmholtz_cheb_sweep_launch(int dtype_code, int K, int variant,
                                const void* const* in, void* const* out,
                                const void* const* aux, const void* code,
                                int ny, int nx, const double* consts,
                                int n_consts, void* stream) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sweep::launch_entry<ChebStep, KMAX>(
      dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
}

}  // extern "C"
