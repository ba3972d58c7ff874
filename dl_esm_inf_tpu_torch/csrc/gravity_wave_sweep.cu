// Linear gravity-wave sweep: K forward-backward steps per pass over
// device memory, on the shared skeleton stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/gravity_wave.py::
// GravityWaveModel._make_sweep (make_stencil_sweep with the model's
// _step_math): state eta, u, v; the int8 code of (t_upd, u_wet, v_wet);
// reach 1, K <= 8.  It computes, per sub-step and in the grouping of
// the plain PyTorch step (dl_esm_inf_tpu_torch/models/gravity_wave.py::
// GravityWaveModel._step_math):
//   u' = (u - (g*dt) * ((eta[i+1] - eta[i]) * rdx)) * u_wet
//   v' = (v - (g*dt) * ((eta[j+1] - eta[j]) * rdy)) * v_wet
//   eta' = t_upd ? eta - (H*dt) * ((u'[i] - u'[i-1]) * rdx
//                                  + (v'[j] - v'[j-1]) * rdy) : eta
// with rdx = 1 / dx rounded once in T: on the card PyTorch computes a
// tensor divided by the Python scalar dx as that product.  Where dx is
// a power of two, rdx is exact and the product is also the true division
// the CPU's plain version takes.
//
// Phases.  u' and v' read only their own old value and eta, so they are
// written in place; after a barrier eta' reads the new u', v' of its
// west and south neighbours and only its own eta, so it is written in
// place too; a second barrier closes the sub-step.  No values wait in
// registers.  Bound, as every client of the skeleton, by shared-memory
// traffic and the two barriers per sub-step rather than by HBM (25 B
// per point per sweep, about 3 B per point and step at K = 8).
#include "stencil_sweep.cuh"

namespace {

struct Consts {
  double gdt;   // g*dt
  double hdt;   // H*dt
  double dx, dy;
};

template <typename TT, int KK>
struct GravityWaveStep {
  using T = TT;
  static constexpr int K = KK;
  static constexpr int N = 3, M = 0;
  static constexpr bool CODE = true;
  // 256 threads: with 512 some float64 instantiations spill
  using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, 1, K, 0, 256>>;
  using G = typename Tile::G;
  using Consts = ::Consts;

  T gdt, hdt, rdx, rdy;

  __device__ explicit GravityWaveStep(const Consts& c)
      : gdt(static_cast<T>(c.gdt)), hdt(static_cast<T>(c.hdt)),
        rdx(static_cast<T>(1) / static_cast<T>(c.dx)),
        rdy(static_cast<T>(1) / static_cast<T>(c.dy)) {}

  __device__ void substep(Tile& t, int k) const {
    T* eta = t.s[0];
    T* u = t.s[1];
    T* v = t.s[2];
    constexpr int WX = G::WX;
    sweep::for_box<G>(sweep::inset<G>(k, k + 1), [&](int i, int, int) {
      u[i] = (u[i] - gdt * ((eta[i + 1] - eta[i]) * rdx)) * t.bit(i, 1);
      v[i] = (v[i] - gdt * ((eta[i + WX] - eta[i]) * rdy)) * t.bit(i, 2);
    });
    __syncthreads();
    sweep::for_box<G>(sweep::inset<G>(k + 1, k + 1), [&](int i, int, int) {
      if (t.code[i] & 1) {
        const T div = (u[i] - u[i - 1]) * rdx + (v[i] - v[i - WX]) * rdy;
        eta[i] = eta[i] - hdt * div;
      }
    });
    __syncthreads();
  }
};

}  // namespace

extern "C" {

// Number of doubles gravity_wave_sweep_launch expects in `consts`.
int gravity_wave_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` must be 0.
int gravity_wave_sweep_launch(int dtype_code, int K, int variant,
                              const void* const* in, void* const* out,
                              const void* const* aux, const void* code,
                              int ny, int nx, const double* consts,
                              int n_consts, void* stream) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sweep::launch_entry<GravityWaveStep, 8>(
      dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
}

}  // extern "C"
