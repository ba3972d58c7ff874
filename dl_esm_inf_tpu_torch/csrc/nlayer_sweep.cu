// N-layer linear shallow-water sweep: K forward-backward steps of L
// stacked layers per pass over device memory, on the shared skeleton
// stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/nlayer.py::
// NLayerModel._make_sweep (make_stencil_sweep with the model's
// per-layer _layer_step): 3L state planes eta_0..eta_{L-1},
// u_0..u_{L-1}, v_0..v_{L-1}; the int8 code of (t_upd, u_wet, v_wet);
// reach 1, K <= 8.  The layer count is a template parameter: variant
// L-1 takes L = 1..4 layers at every K, float32 and float64 (at f64,
// K=8, L=4 the 12 staged 48x48 planes and the code take 218 KiB of the
// 227 KiB a block may use).  Per sub-step, in the grouping of the plain
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

constexpr int LMAX = 4;

struct Consts {
  double dt, dx, dy;
  double pw[LMAX];   // pressure weights: g, then the reduced gravities
  double h[LMAX];    // rest thicknesses
};

template <typename TT, int KK, int L>
struct NLayerStep {
  using T = TT;
  static constexpr int K = KK;
  using G = sweep::Geom<K, 1>;
  static constexpr int N = 3 * L, M = 0;
  static constexpr bool CODE = true;
  using Tile = sweep::Tile<T, N, M, CODE, G>;
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

}  // namespace

extern "C" {

// Number of doubles nlayer_sweep_launch expects in `consts`: dt, dx,
// dy, pw[4], h[4] (zero beyond the layer count).
int nlayer_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` L-1 takes L layers (3L state
// planes), L = 1..4; `aux` is not read.
int nlayer_sweep_launch(int dtype_code, int K, int variant,
                        const void* const* in, void* const* out,
                        const void* const* aux, const void* code, int ny,
                        int nx, const double* consts, int n_consts,
                        void* stream) {
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
