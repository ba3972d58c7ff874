// Flux-form tracer sweep: K advection(-diffusion) steps per pass over
// device memory, on the shared skeleton stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/tracer.py::
// TracerModel._make_sweep (make_stencil_sweep with the model's
// tracer_step): state c; aux planes u, v (steady face velocities,
// masked and exchanged to full halo depth at build) and the int8 code
// of (t_upd, u_wet, v_wet).  Two instantiations of one step: donor-cell
// upwind (reach 1, K <= 8) and MUSCL with the van Leer limiter (reach 2,
// K <= 4), selected by the launch's `variant`.  The masked diffusion
// term is added when the `diffuse` constant is nonzero (the plain
// step's `if kappa:`).  Per sub-step, in the grouping of the plain
// PyTorch step (dl_esm_inf_tpu_torch/models/tracer.py::tracer_step),
// for the U face i between T_i and T_{i+1} (V faces alike):
//   upwind:   cf = u > 0 ? c[i] : c[i+1]
//   van Leer: dc = c[i+1] - c[i], safe = dc == 0 ? 1 : dc,
//             u > 0: cf = c[i] + ((0.5 * vl((c[i] - c[i-1]) / safe)) * dc)
//                                * t_upd[i-1]
//             else:  cf = c[i+1] - ((0.5 * vl((c[i+2] - c[i+1]) / safe))
//                                   * dc) * t_upd[i+2]
//             vl(r) = (r + |r|) / (1 + |r|)
//   fx = u * cf;  tend = -((fx[i] - fx[i-1]) / dx + (fy[j] - fy[j-1]) / dy)
//   diffusion: gx = ((c[i+1] - c[i]) / dx) * u_wet,
//              tend = tend + kappa * ((gx[i] - gx[i-1]) / dx
//                                     + (gy[j] - gy[j-1]) / dy)
//   c' = t_upd ? c + dt * tend : c
//
// Phases.  c' reads c up to REACH cells away, so the new values go to a
// scratch plane that becomes the tracer after one barrier
// (sweep::next_update; the box is the region still valid after the
// sub-step, so what the scratch plane holds outside it does not
// matter).  One barrier per sub-step.  Each face flux is recomputed by
// the two cells that share it instead of being staged as a plane: four
// flux planes would take more shared memory than the state.  Bound by
// the flux arithmetic
// (a division and the limiter per face) and shared-memory traffic, not
// by HBM (17 B per point per sweep at float32).
#include "stencil_sweep.cuh"

namespace {

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

struct Consts {
  double dx, dy, dt;
  double kappa;
  double diffuse;   // nonzero: add the diffusion term
};

template <typename TT, int KK, int REACH>
struct TracerStep {
  using T = TT;
  static constexpr int K = KK;
  static constexpr int N = 1, M = 2;
  static constexpr bool CODE = true;
  // one scratch plane: the next tracer
  using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, REACH>, 0, 1, 1>;
  using G = typename Tile::G;
  using Consts = ::Consts;

  T dx, dy, dt, kappa;
  bool diffuse;

  __device__ explicit TracerStep(const Consts& c)
      : dx(static_cast<T>(c.dx)), dy(static_cast<T>(c.dy)),
        dt(static_cast<T>(c.dt)), kappa(static_cast<T>(c.kappa)),
        diffuse(c.diffuse != 0.0) {}

  // the tracer at the face between window points j and j + s (s = 1 for
  // U faces, WX for V faces), advected by the face velocity vel
  __device__ __forceinline__ T face(const Tile& t, int j, int s,
                                    T vel) const {
    const T* c = t.s[0];
    if constexpr (REACH == 1) return vel > T(0) ? c[j] : c[j + s];
    const T up = c[j], dn = c[j + s];
    const T dc = dn - up;
    const T safe = dc == T(0) ? T(1) : dc;
    const T half = static_cast<T>(0.5);
    if (vel > T(0)) {
      const T r = (up - c[j - s]) / safe;
      const T ar = abs_of(r);
      const T vl = (r + ar) / (T(1) + ar);
      return up + ((half * vl) * dc) * t.bit(j - s, 0);
    }
    const T r = (c[j + 2 * s] - dn) / safe;
    const T ar = abs_of(r);
    const T vl = (r + ar) / (T(1) + ar);
    return dn - ((half * vl) * dc) * t.bit(j + 2 * s, 0);
  }

  __device__ void substep(Tile& t, int k) const {
    T* c = t.s[0];
    const T* u = t.a[0];
    const T* v = t.a[1];
    constexpr int WX = G::WX;
    sweep::next_update<G>(
        t, sweep::inset<G>((k + 1) * REACH, (k + 1) * REACH), {0},
        [&](int i, int, int, T(&o)[1]) {
          const T fx = u[i] * face(t, i, 1, u[i]);
          const T fxw = u[i - 1] * face(t, i - 1, 1, u[i - 1]);
          const T fy = v[i] * face(t, i, WX, v[i]);
          const T fys = v[i - WX] * face(t, i - WX, WX, v[i - WX]);
          T tend = -((fx - fxw) / dx + (fy - fys) / dy);
          if (diffuse) {
            const T gx = ((c[i + 1] - c[i]) / dx) * t.bit(i, 1);
            const T gxw = ((c[i] - c[i - 1]) / dx) * t.bit(i - 1, 1);
            const T gy = ((c[i + WX] - c[i]) / dy) * t.bit(i, 2);
            const T gys = ((c[i] - c[i - WX]) / dy) * t.bit(i - WX, 2);
            tend = tend + kappa * ((gx - gxw) / dx + (gy - gys) / dy);
          }
          o[0] = (t.code[i] & 1) ? c[i] + dt * tend : c[i];
        });
  }
};

template <typename T, int K>
using UpwindStep = TracerStep<T, K, 1>;
template <typename T, int K>
using VanLeerStep = TracerStep<T, K, 2>;

}  // namespace

extern "C" {

// Number of doubles tracer_sweep_launch expects in `consts`.
int tracer_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` 0 is upwind (K <= 8), 1 is van
// Leer (K <= 4).
int tracer_sweep_launch(int dtype_code, int K, int variant,
                        const void* const* in, void* const* out,
                        const void* const* aux, const void* code, int ny,
                        int nx, const double* consts, int n_consts,
                        void* stream) {
  if (variant == 0) {
    return sweep::launch_entry<UpwindStep, 8>(
        dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
  }
  if (variant == 1) {
    return sweep::launch_entry<VanLeerStep, 4>(
        dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
