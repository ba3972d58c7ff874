// Rotating shallow-water sweep (SW offset, doubly periodic): K steps per
// pass over device memory, on the shared skeleton stencil_sweep.cuh.
//
// Replaces the TPU kernel dl_esm_inf_tpu/models/shallow.py::
// ShallowModel._make_sweep (make_stencil_sweep with the model's
// _step_math): state eta, u, v; no aux planes, no masks (the domain is
// all wet); reach 1, K <= 8.  The periodic wrap rides the depth-K halo
// exchange between sweeps, so the kernel sees an ordinary block.  Per
// sub-step, in the grouping of the plain PyTorch step
// (dl_esm_inf_tpu_torch/models/shallow.py::ShallowModel._step_math),
// with U_i west of T_i and V_j south of T_j:
//   v_at_u = 0.25 * (((v + v[i-1]) + v[j+1]) + v[j+1, i-1])
//   u_at_v = 0.25 * (((u + u[j-1]) + u[i+1]) + u[j-1, i+1])
//   u' = (u + (f*dt) * v_at_u) - (g*dt) * ((eta - eta[i-1]) * rdx)
//   v' = (v - (f*dt) * u_at_v) - (g*dt) * ((eta - eta[j-1]) * rdy)
//   eta' = eta - (H*dt) * ((u'[i+1] - u') * rdx + (v'[j+1] - v') * rdy)
// with rdx = 1 / dx rounded once in T, as PyTorch on the card computes a
// tensor divided by the Python scalar dx (exact where dx is a power of
// two, where it is also the CPU's true division).  The host rounds rdx
// and rdy as PyTorch's host code does before its launch
// (ops/stencil_sweep.py::reciprocal): a division in the kernel makes the
// float64 K=1 instantiation spill.
//
// Phases.  u' reads v of its neighbours and v' reads u of theirs, so the
// new velocities wait in registers until every thread has read the old
// ones (sweep::staged_update), then are stored; after a barrier eta'
// reads the new u', v' of its east and north neighbours and only its
// own eta, so it is written in place.  Three barriers per sub-step.
// Bound by shared-memory traffic and barriers, not by HBM (24 B per
// point per sweep).
#include "stencil_sweep.cuh"

namespace {

struct Consts {
  double fdt;   // f0*dt
  double gdt;   // g*dt
  double hdt;   // H*dt
  double rdx, rdy;   // 1 / dx, 1 / dy rounded in the planes' type
};

template <typename TT, int KK>
struct ShallowStep {
  using T = TT;
  static constexpr int K = KK;
  static constexpr int N = 3, M = 0;
  static constexpr bool CODE = false;
  using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, 1>>;
  using G = typename Tile::G;
  using Consts = ::Consts;

  T fdt, gdt, hdt, rdx, rdy;

  __device__ explicit ShallowStep(const Consts& c)
      : fdt(static_cast<T>(c.fdt)), gdt(static_cast<T>(c.gdt)),
        hdt(static_cast<T>(c.hdt)),
        rdx(static_cast<T>(c.rdx)), rdy(static_cast<T>(c.rdy)) {}

  __device__ void substep(Tile& t, int k) const {
    T* eta = t.s[0];
    T* u = t.s[1];
    T* v = t.s[2];
    constexpr int WX = G::WX, WY = G::WY;
    const T quarter = static_cast<T>(0.25);
    T* const uv[2] = {u, v};
    // u' on columns [1, WX) and rows [0, WY-1); v' on columns [0, WX-1)
    // and rows [1, WY): the points whose stencil lies in the window
    sweep::staged_update<G, T, 2>(
        sweep::inset<G>(k, k), uv, [&](int i, int wy, int wx, T(&o)[2]) {
          o[0] = u[i];
          o[1] = v[i];
          if (wx >= 1 && wy < WY - 1) {
            const T v_at_u =
                quarter * (((v[i] + v[i - 1]) + v[i + WX]) + v[i + WX - 1]);
            o[0] = (u[i] + fdt * v_at_u) - gdt * ((eta[i] - eta[i - 1]) * rdx);
          }
          if (wy >= 1 && wx < WX - 1) {
            const T u_at_v =
                quarter * (((u[i] + u[i - WX]) + u[i + 1]) + u[i + 1 - WX]);
            o[1] = (v[i] - fdt * u_at_v) - gdt * ((eta[i] - eta[i - WX]) * rdy);
          }
        });
    __syncthreads();
    sweep::for_box<G>(sweep::inset<G>(k + 1, k + 1), [&](int i, int, int) {
      const T div = (u[i + 1] - u[i]) * rdx + (v[i + WX] - v[i]) * rdy;
      eta[i] = eta[i] - hdt * div;
    });
    __syncthreads();
  }
};

}  // namespace

extern "C" {

// Number of doubles shallow_sweep_launch expects in `consts`.
int shallow_sweep_num_consts() { return sweep::num_consts<Consts>(); }

// See sweep::launch_entry; `variant` must be 0 and `aux`/`code` are
// not read.
int shallow_sweep_launch(int dtype_code, int K, int variant,
                         const void* const* in, void* const* out,
                         const void* const* aux, const void* code, int ny,
                         int nx, const double* consts, int n_consts,
                         void* stream) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sweep::launch_entry<ShallowStep, 8>(
      dtype_code, K, in, out, aux, code, ny, nx, consts, n_consts, stream);
}

}  // extern "C"
