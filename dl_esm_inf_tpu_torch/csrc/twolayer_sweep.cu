// Two-layer linear shallow-water sweep: K forward-backward steps per
// pass over device memory, on the shared skeleton stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/twolayer.py::
// TwoLayerModel._make_sweep (make_stencil_sweep with the model's
// _step_math): six state planes eta1, eta2, u1, v1, u2, v2; the int8
// code of (t_upd, u_wet, v_wet); reach 1, K <= 8.  Per sub-step, in the
// grouping of the plain PyTorch step (dl_esm_inf_tpu_torch/models/
// twolayer.py::TwoLayerModel._step_math), with p1 = g*eta1 and
// p2 = g*eta1 + gp*eta2:
//   u1' = (u1 - dt * ((p1[i+1] - p1) * rdx)) * u_wet     (v1', u2', v2'
//                                                          alike)
//   div_l = (ul'[i] - ul'[i-1]) * rdx + (vl'[j] - vl'[j-1]) * rdy
//   eta1' = t_upd ? eta1 - dt * (H1*div1 + H2*div2) : eta1
//   eta2' = t_upd ? eta2 - (dt*H2) * div2 : eta2
// with rdx = 1 / dx rounded once in T, as PyTorch on the card computes a
// tensor divided by the Python scalar dx (exact where dx is a power of
// two, where it is also the CPU's true division).
//
// Phases.  The four velocities read only their own old value and the
// etas, so they are written in place; after a barrier the etas read the
// new velocities of their west and south neighbours and only their own
// old values, so they are written in place too.  Two barriers per
// sub-step, nothing held in registers: at float64, K = 8 the six staged
// planes and the code take 113 KB of shared memory, and a second set of
// planes for new values would not fit.  Bound by shared-memory traffic
// and barriers rather than HBM (49 B per point per sweep at float32).
#include "stencil_sweep.cuh"

namespace {

struct Consts {
  double g, gp;
  double dt;
  double h1, h2;
  double dth2;   // dt*H2
  double dx, dy;
};

template <typename TT, int KK>
struct TwoLayerStep {
  using T = TT;
  static constexpr int K = KK;
  static constexpr int N = 6, M = 0;
  static constexpr bool CODE = true;
  using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, 1>>;
  using G = typename Tile::G;
  using Consts = ::Consts;

  T g, gp, dt, h1, h2, dth2, rdx, rdy;

  __device__ explicit TwoLayerStep(const Consts& c)
      : g(static_cast<T>(c.g)), gp(static_cast<T>(c.gp)),
        dt(static_cast<T>(c.dt)), h1(static_cast<T>(c.h1)),
        h2(static_cast<T>(c.h2)), dth2(static_cast<T>(c.dth2)),
        rdx(static_cast<T>(1) / static_cast<T>(c.dx)),
        rdy(static_cast<T>(1) / static_cast<T>(c.dy)) {}

  __device__ void substep(Tile& t, int k) const {
    T* eta1 = t.s[0];
    T* eta2 = t.s[1];
    T* u1 = t.s[2];
    T* v1 = t.s[3];
    T* u2 = t.s[4];
    T* v2 = t.s[5];
    constexpr int WX = G::WX;
    sweep::for_box<G>(sweep::inset<G>(k, k + 1), [&](int i, int, int) {
      const T uw = t.bit(i, 1), vw = t.bit(i, 2);
      const T p1 = g * eta1[i];
      const T p1e = g * eta1[i + 1];
      const T p1n = g * eta1[i + WX];
      const T p2 = g * eta1[i] + gp * eta2[i];
      const T p2e = g * eta1[i + 1] + gp * eta2[i + 1];
      const T p2n = g * eta1[i + WX] + gp * eta2[i + WX];
      u1[i] = (u1[i] - dt * ((p1e - p1) * rdx)) * uw;
      v1[i] = (v1[i] - dt * ((p1n - p1) * rdy)) * vw;
      u2[i] = (u2[i] - dt * ((p2e - p2) * rdx)) * uw;
      v2[i] = (v2[i] - dt * ((p2n - p2) * rdy)) * vw;
    });
    __syncthreads();
    sweep::for_box<G>(sweep::inset<G>(k + 1, k + 1), [&](int i, int, int) {
      if (t.code[i] & 1) {
        const T div1 =
            (u1[i] - u1[i - 1]) * rdx + (v1[i] - v1[i - WX]) * rdy;
        const T div2 =
            (u2[i] - u2[i - 1]) * rdx + (v2[i] - v2[i - WX]) * rdy;
        eta1[i] = eta1[i] - dt * (h1 * div1 + h2 * div2);
        eta2[i] = eta2[i] - dth2 * div2;
      }
    });
    __syncthreads();
  }
};

}  // namespace

extern "C" {

// Number of doubles twolayer_sweep_launch expects in `consts`.
int twolayer_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` must be 0.
int twolayer_sweep_launch(int dtype_code, int K, int variant,
                          const void* const* in, void* const* out,
                          const void* const* aux, const void* code, int ny,
                          int nx, const double* consts, int n_consts,
                          void* stream) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sweep::launch_entry<TwoLayerStep, 8>(
      dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
}

}  // extern "C"
