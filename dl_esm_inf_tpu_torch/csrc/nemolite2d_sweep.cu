// NEMOLite2D temporal-blocked sweep: K whole time steps per pass over
// device memory, for one stacked (ny, nx) block of the flagship state.
//
// Replaces the TPU kernel dl_esm_inf_tpu/ops/pallas_step.py::
// make_fused_step, i.e. the generic sweep engine
// dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep instantiated with
// models/nemolite2d.py::step_math (square-cell path), with flat or
// variable bathymetry, and the same sweep with the halo exchange inside it
// (dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep with exchange_spec, the
// "fused" transport).
// It computes (sshn, un, vn, mask_code_i8[, ht], forcing[K]) -> (ssha, ua,
// va),
// operation for operation in the order of the plain PyTorch step
// (dl_esm_inf_tpu_torch/models/nemolite2d.py::step_math), so at float64
// the two agree to roundoff.  Build with --fmad=false: a contracted
// multiply-add rounds once where the plain version rounds twice.
//
// Two template flags select the variants; with both off the kernel is the
// flat-depth sweep it was before they existed.
//  * HT: variable bathymetry.  The T-point depth ht is a fourth input
//    plane, staged like the state.  Its halo is edge-replicated and time
//    invariant, so it needs no ring of its own.  The face depths
//    hu = avg_x(ht), hv = avg_y(ht) and the Flather coefficients
//    cu, cv = -sqrt(g / max(h, 1e-3)) are derived per point from the
//    staged plane, operation for operation as make_prep derives them
//    (PyTorch evaluates g / h as reciprocal(h) * g).
//  * EXCH: the halo exchange of the state at the full halo depth happens
//    in the staging: every window point of the three state planes is read
//    from where the exchange would have put it (halo_remap.cuh), after the
//    clamp to the block edge.  The output equals the exchange followed by
//    the sweep, bitwise, in one launch and with no byte more.  The aux
//    planes (code, ht) are not exchanged, as in the JAX package.  On one
//    card every tile is in the same array and the launch reads only its
//    inputs, so the fence and barrier of the TPU transport have nothing to
//    order.
//
// Design.  Each CTA owns a TY x TX output tile and stages a window of
// the tile plus a ring of R = 2K cells on every side (the step's reach
// is 2) in shared memory: the three state planes, an ssha scratch plane
// and the int8 mask code (and the ht plane).  It then advances K sub-steps in shared
// memory; the valid region shrinks by 2 per sub-step, so after K
// sub-steps exactly the output tile is valid and is written back.  A
// sub-step has three phases separated by __syncthreads(): continuity
// (ssha, which must be complete before momentum reads its east/north
// neighbours), momentum u/v into registers, and the write of u/v back
// into shared memory.  Quantities that neighbours read (face ssh,
// face depths, fluxes) are recomputed from the staged state rather
// than staged as planes, and the six masks are decoded per point from
// the code byte.  Window reads outside the block are clamped to its
// edge: the kernel never reads outside the (ny, nx) block.  Cells
// within 2K of the block edge hold finite but meaningless values, like
// the halo cells of the plain version; callers compare internal points.
//
// What bounds it.  At K = 4 the sweep moves 3 state planes in and out
// plus the code byte per point, about 25/4 B per point and step, so on
// an H100 (3.35 TB/s) the memory bound is well under a microsecond per
// step at 1024^2: the kernel is bound by its arithmetic, the
// redundant ring compute (a 32x32 tile with an 8-cell ring computes up
// to 2.25x its own area) and shared-memory latency.  This first version
// buys simplicity with that redundancy; larger tiles, register blocking
// and staged intermediates are later work.  HT adds one read of the ht
// plane per sweep (4 B/pt at float32), one more shared-memory plane and
// the per-point face depths; EXCH adds no bytes, only the integer map of
// every staged state point.
#include <cuda_runtime.h>

#include <cstdint>

#include "halo_remap.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int NT = 256;

// Host-folded prefactors (double, in the plain step's grouping); the
// kernel casts each once to the working type.
struct Consts {
  double cw;                      // rdt/dx (square cells)
  double fric;                    // 1/(1 + cbfr*rdt)
  double ht, hu, hv;              // flat bathymetry at T/U/V
  double cu, cv;                  // Flather: -sqrt(g/max(h, 1e-3))
  double ux_adv, ux_vis, uy_adv, uy_vis, u_cor, u_hpg;
  double vy_adv, vy_vis, vx_adv, vx_vis, v_cor, v_hpg;
  double g;                       // gravity (Flather, variable depth)
  double forcing[4];              // bc_ssh value of each sub-step
};
constexpr int kNumConsts = 24;
static_assert(sizeof(Consts) == kNumConsts * sizeof(double), "layout");

template <typename T, int K, bool HT>
struct Window {
  static constexpr int R = 2 * K;
  static constexpr int WY = TY + 2 * R;
  static constexpr int WX = TX + 2 * R;
  static constexpr int WC = WY * WX;
  static constexpr int CPT = (WC + NT - 1) / NT;
  static constexpr int PLANES = HT ? 5 : 4;
  static constexpr size_t smem_bytes = PLANES * WC * sizeof(T) + WC;
};

template <typename T, int K, bool HT, bool EXCH>
__global__ void __launch_bounds__(NT)
nemo_sweep_kernel(const T* __restrict__ sshn_g, const T* __restrict__ un_g,
                  const T* __restrict__ vn_g,
                  const int8_t* __restrict__ code_g,
                  const T* __restrict__ ht_g, T* __restrict__ ssha_g,
                  T* __restrict__ ua_g, T* __restrict__ va_g, int ny,
                  int nx, Consts c, HaloRemap m) {
  using W = Window<T, K, HT>;
  constexpr int R = W::R, WY = W::WY, WX = W::WX, WC = W::WC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_ssh = reinterpret_cast<T*>(smem_raw);
  T* s_u = s_ssh + WC;
  T* s_v = s_u + WC;
  T* s_a = s_v + WC;
  T* s_ht = s_a + WC;                      // staged only when HT
  int8_t* s_code = reinterpret_cast<int8_t*>(s_a + (W::PLANES - 3) * WC);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX - R;
  const int y0 = blockIdx.y * TY - R;

  for (int idx = tid; idx < WC; idx += NT) {
    const int wy = idx / WX, wx = idx - wy * WX;
    const int gy = min(max(y0 + wy, 0), ny - 1);
    const int gx = min(max(x0 + wx, 0), nx - 1);
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    size_t gs = g;
    if constexpr (EXCH) {
      gs = static_cast<size_t>(halo_remap_row(m, gy)) * nx +
           halo_remap_col(m, gx);
    }
    s_ssh[idx] = sshn_g[gs];
    s_u[idx] = un_g[gs];
    s_v[idx] = vn_g[gs];
    s_code[idx] = code_g[g];
    if constexpr (HT) s_ht[idx] = ht_g[g];
  }

  const T cw = static_cast<T>(c.cw), fric = static_cast<T>(c.fric);
  const T ht = static_cast<T>(c.ht), hu = static_cast<T>(c.hu);
  const T hv = static_cast<T>(c.hv);
  const T cu = static_cast<T>(c.cu), cv = static_cast<T>(c.cv);
  const T ux_adv = static_cast<T>(c.ux_adv), ux_vis = static_cast<T>(c.ux_vis);
  const T uy_adv = static_cast<T>(c.uy_adv), uy_vis = static_cast<T>(c.uy_vis);
  const T u_cor = static_cast<T>(c.u_cor), u_hpg = static_cast<T>(c.u_hpg);
  const T vy_adv = static_cast<T>(c.vy_adv), vy_vis = static_cast<T>(c.vy_vis);
  const T vx_adv = static_cast<T>(c.vx_adv), vx_vis = static_cast<T>(c.vx_vis);
  const T v_cor = static_cast<T>(c.v_cor), v_hpg = static_cast<T>(c.v_hpg);
  const T one = static_cast<T>(1), half = static_cast<T>(0.5);
  const T zero = static_cast<T>(0);
  const T grav = static_cast<T>(c.g), hmin = static_cast<T>(1e-3);
  __syncthreads();

  // mask bit b of the code (bits: t_wet, u_wet, v_wet, bc, flather_u,
  // flather_v), as 0/1 in T
  auto bit = [&](int i, int b) -> T {
    return static_cast<T>((static_cast<int>(s_code[i]) >> b) & 1);
  };
  auto sw = [&](int i) -> T { return s_ssh[i] * bit(i, 0); };
  auto sshu = [&](int i) -> T {
    return (sw(i) + sw(i + 1)) * (one - half * bit(i, 1));
  };
  auto sshv = [&](int i) -> T {
    return (sw(i) + sw(i + WX)) * (one - half * bit(i, 2));
  };
  // depth bases at the T point, the east U face and the north V face
  auto ht_at = [&](int i) -> T {
    if constexpr (HT) return s_ht[i];
    else return ht;
  };
  auto hu_at = [&](int i) -> T {
    if constexpr (HT) return half * (s_ht[i] + s_ht[i + 1]);
    else return hu;
  };
  auto hv_at = [&](int i) -> T {
    if constexpr (HT) return half * (s_ht[i] + s_ht[i + WX]);
    else return hv;
  };
  // Flather coefficient -sqrt(g / max(h, 1e-3))
  auto flather = [&](T h, T flat) -> T {
    if constexpr (HT) return -sqrt((one / (h < hmin ? hmin : h)) * grav);
    else return flat;
  };
  auto depu = [&](int i) -> T { return hu_at(i) + sshu(i); };
  auto depv = [&](int i) -> T { return hv_at(i) + sshv(i); };
  auto z = [&](int i) -> T { return ht_at(i) + s_ssh[i]; };

  // momentum_u pieces
  auto wx_u = [&](int j) -> T {            // at the west T centre of face j
    const T u = s_u[j], umx = s_u[j - 1];
    const T su = u + umx;
    const T udw = su > zero ? umx : u;
    return (ux_adv * (su * udw) + ux_vis * (u - umx)) * z(j);
  };
  auto wv_at = [&](int j) -> T { return s_v[j] + s_v[j + 1]; };
  auto wy_u = [&](int j) -> T {            // at the NE F corner of face j
    const T wv = wv_at(j);
    const T dep_f2 = depv(j) + depv(j + 1);
    const T u = s_u[j], upy = s_u[j + WX];
    const T udn = wv > zero ? u : upy;
    return (uy_adv * (wv * udn) + uy_vis * (upy - u)) * dep_f2;
  };
  // momentum_v pieces
  auto wy_v = [&](int j) -> T {            // at the south T centre
    const T v = s_v[j], vmy = s_v[j - WX];
    const T sv = v + vmy;
    const T vds = sv > zero ? vmy : v;
    return (vy_adv * (sv * vds) + vy_vis * (v - vmy)) * z(j);
  };
  auto wu_at = [&](int j) -> T { return s_u[j] + s_u[j + WX]; };
  auto wx_v = [&](int j) -> T {            // at the NE F corner
    const T wu = wu_at(j);
    const T dep_f2 = depu(j) + depu(j + WX);
    const T v = s_v[j], xpv = s_v[j + 1];
    const T vde = wu > zero ? v : xpv;
    return (vx_adv * (wu * vde) + vx_vis * (xpv - v)) * dep_f2;
  };

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T forcing = static_cast<T>(c.forcing[k]);
    // continuity + bc_ssh on the region 2k+1 cells inside the window
    const int ra = 2 * k + 1;
    for (int idx = tid; idx < WC; idx += NT) {
      const int wy = idx / WX, wx = idx - wy * WX;
      if (wy < ra || wy >= WY - ra || wx < ra || wx >= WX - ra) continue;
      const T fx = depu(idx) * s_u[idx];
      const T fxw = depu(idx - 1) * s_u[idx - 1];
      const T fy = depv(idx) * s_v[idx];
      const T fys = depv(idx - WX) * s_v[idx - WX];
      T a = s_ssh[idx] - (cw * bit(idx, 0)) * ((fx - fxw) + (fy - fys));
      s_a[idx] = bit(idx, 3) != zero ? forcing : a;
    }
    __syncthreads();

    // momentum on the region 2k+2 inside; results held in registers
    // until every thread has read the old u/v
    const int rb = 2 * k + 2;
    T ua[W::CPT], va[W::CPT];
#pragma unroll
    for (int q = 0; q < W::CPT; ++q) {
      const int idx = tid + q * NT;
      ua[q] = zero;
      va[q] = zero;
      if (idx >= WC) continue;
      const int wy = idx / WX, wx = idx - wy * WX;
      if (wy < rb || wy >= WY - rb || wx < rb || wx >= WX - rb) continue;
      const T du = depu(idx), dv = depv(idx);
      {
        const T term_x = wx_u(idx + 1) - wx_u(idx);
        const T term_y = wy_u(idx) - wy_u(idx - WX);
        const T corhpg = (u_cor * (wv_at(idx) + wv_at(idx - WX))
                          + u_hpg * (s_a[idx + 1] - s_a[idx])) * du;
        const T rd = one / du;
        const T r = (s_u[idx] + (term_x + term_y + corhpg) * rd)
                    * (fric * bit(idx, 1));
        ua[q] = bit(idx, 4) != zero ? flather(hu_at(idx), cu) * sshu(idx)
                                    : r;
      }
      {
        const T term_y = wy_v(idx + WX) - wy_v(idx);
        const T term_x = wx_v(idx) - wx_v(idx - 1);
        const T corhpg = (v_cor * (wu_at(idx) + wu_at(idx - 1))
                          + v_hpg * (s_a[idx + WX] - s_a[idx])) * dv;
        const T rd = one / dv;
        const T r = (s_v[idx] + (term_y + term_x + corhpg) * rd)
                    * (fric * bit(idx, 2));
        va[q] = bit(idx, 5) != zero ? flather(hv_at(idx), cv) * sshv(idx)
                                    : r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < W::CPT; ++q) {
      const int idx = tid + q * NT;
      if (idx >= WC) continue;
      const int wy = idx / WX, wx = idx - wy * WX;
      if (wy < rb || wy >= WY - rb || wx < rb || wx >= WX - rb) continue;
      s_u[idx] = ua[q];
      s_v[idx] = va[q];
    }
    // the new surface becomes the state; the old one becomes scratch
    T* t = s_ssh;
    s_ssh = s_a;
    s_a = t;
    __syncthreads();
  }

  for (int idx = tid; idx < TY * TX; idx += NT) {
    const int ty = idx / TX, tx = idx - ty * TX;
    const int gy = blockIdx.y * TY + ty, gx = blockIdx.x * TX + tx;
    if (gy >= ny || gx >= nx) continue;
    const int w = (ty + R) * WX + tx + R;
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    ssha_g[g] = s_ssh[w];
    ua_g[g] = s_u[w];
    va_g[g] = s_v[w];
  }
}

// The launch's pointers and extents.
struct Args {
  const void *sshn, *un, *vn, *code, *ht;
  void *ssha, *ua, *va;
  int ny, nx;
};

template <typename T, int K, bool HT, bool EXCH>
cudaError_t launch(const Args& a, const Consts& c, const HaloRemap& m,
                   cudaStream_t stream) {
  constexpr size_t smem = Window<T, K, HT>::smem_bytes;
  // the attribute is per device: set it once for each device used
  static int attr_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attr_device != dev) {
    err = cudaFuncSetAttribute(nemo_sweep_kernel<T, K, HT, EXCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = dev;
  }
  const dim3 grid((a.nx + TX - 1) / TX, (a.ny + TY - 1) / TY);
  nemo_sweep_kernel<T, K, HT, EXCH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.sshn), static_cast<const T*>(a.un),
      static_cast<const T*>(a.vn), static_cast<const int8_t*>(a.code),
      static_cast<const T*>(a.ht), static_cast<T*>(a.ssha),
      static_cast<T*>(a.ua), static_cast<T*>(a.va), a.ny, a.nx, c, m);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_flags(bool ht, bool exch, const Args& a,
                           const Consts& c, const HaloRemap& m,
                           cudaStream_t s) {
  if (ht) {
    return exch ? launch<T, K, true, true>(a, c, m, s)
                : launch<T, K, true, false>(a, c, m, s);
  }
  return exch ? launch<T, K, false, true>(a, c, m, s)
              : launch<T, K, false, false>(a, c, m, s);
}

template <typename T>
cudaError_t dispatch_k(int K, bool ht, bool exch, const Args& a,
                       const Consts& c, const HaloRemap& m, cudaStream_t s) {
  switch (K) {
    case 1: return dispatch_flags<T, 1>(ht, exch, a, c, m, s);
    case 2: return dispatch_flags<T, 2>(ht, exch, a, c, m, s);
    case 3: return dispatch_flags<T, 3>(ht, exch, a, c, m, s);
    case 4: return dispatch_flags<T, 4>(ht, exch, a, c, m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of doubles nemo_sweep_launch expects in `consts`.
int nemo_sweep_num_consts() { return kNumConsts; }

// dtype_code: 0 = float32, 1 = float64.  All pointers are device
// pointers of contiguous (ny, nx) planes, except `consts` and `remap`
// (host memory, read before the launch returns).  `ht` is null for flat
// bathymetry; `remap` is null (n_remap 0) for a sweep without the
// exchange, else the fields of HaloRemap with depth = halo.  Launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch.
int nemo_sweep_launch(int dtype_code, int K, const void* sshn,
                      const void* un, const void* vn, const void* code,
                      const void* ht, void* ssha, void* ua, void* va, int ny,
                      int nx, const double* consts, int n_consts,
                      const int* remap, int n_remap, void* stream) {
  const bool exch = remap != nullptr;
  if (n_consts != kNumConsts || ny < 1 || nx < 1 ||
      n_remap != (exch ? kHaloRemapInts : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Consts c;
  double* dst = reinterpret_cast<double*>(&c);
  for (int i = 0; i < kNumConsts; ++i) dst[i] = consts[i];
  HaloRemap m{};
  if (exch) {
    int* mi = reinterpret_cast<int*>(&m);
    for (int i = 0; i < kHaloRemapInts; ++i) mi[i] = remap[i];
    if (m.nprocy * m.local_ny != ny || m.nprocx * m.local_nx != nx) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Args a{sshn, un, vn, code, ht, ssha, ua, va, ny, nx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_ht = ht != nullptr;
  cudaError_t err;
  if (dtype_code == 0) {
    err = dispatch_k<float>(K, has_ht, exch, a, c, m, s);
  } else if (dtype_code == 1) {
    err = dispatch_k<double>(K, has_ht, exch, a, c, m, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
