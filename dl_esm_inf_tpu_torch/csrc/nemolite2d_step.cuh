// The NEMOLite2D step on a shared-memory window: the geometry, the
// host-folded constants, the clamped staging, the K sub-steps and the
// write-back of one CTA.  The production sweep (nemolite2d_sweep.cu) and
// its measurement variants (nemolite2d_variants.cu) both include it, so
// a variant cannot drift from production: the JAX package's microbench
// kept a copy of the step and said so (scripts/kbench.py:15-17).
//
// The sub-steps evaluate the plain PyTorch step
// (dl_esm_inf_tpu_torch/models/nemolite2d.py::step_math) operation for
// operation, so built with --fmad=false the two agree bitwise.
//
// Geometry.  A CTA owns a TY x TX output tile and stages a window of the
// tile plus a ring of R = 2K cells on every side (the step's reach is
// 2): the three state planes, an ssha scratch plane, the int8 mask code
// (and, with HT, the T-point depth ht).  Window reads outside the block
// are clamped to its edge.  Sub-step k updates continuity on the region
// 2k+1 cells inside the window and momentum on the region 2k+2 inside,
// so after K sub-steps exactly the tile is valid.
//
// Cells.  Square cells (dx == dy) fold the wet-cell select into the
// continuity prefactor, as make_prep's cw does; rectangular cells take
// the plain non-square order, (rdt/dx)(fx - xm fx) + (rdt/dy)(fy - ym
// fy), then the wet-cell select.  The choice is the runtime flag
// Consts::rect, uniform over the launch, so the square path's code and
// the number of instantiations stay as they were.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "halo_remap.cuh"

namespace nemo {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int NT = 256;

// Host-folded prefactors (double, in the plain step's grouping); the
// kernel casts each once to the working type.
struct Consts {
  double cw;                      // rdt/dx
  double cwy;                     // rdt/dy (rectangular cells)
  double rect;                    // 1: dx != dy, 0: square cells
  double fric;                    // 1/(1 + cbfr*rdt)
  double ht, hu, hv;              // flat bathymetry at T/U/V
  double cu, cv;                  // Flather: -sqrt(g/max(h, 1e-3))
  double ux_adv, ux_vis, uy_adv, uy_vis, u_cor, u_hpg;
  double vy_adv, vy_vis, vx_adv, vx_vis, v_cor, v_hpg;
  double g;                       // gravity (Flather, variable depth)
  double forcing[4];              // bc_ssh value of each sub-step
};
constexpr int kNumConsts = 26;
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

// The CTA's shared planes; ssh and a swap every sub-step.
template <typename T>
struct Planes {
  T* ssh;
  T* u;
  T* v;
  T* a;                           // ssha scratch
  T* ht;                          // staged only when HT
  int8_t* code;
};

template <typename T, int K, bool HT>
__device__ __forceinline__ Planes<T> carve(unsigned char* smem) {
  using W = Window<T, K, HT>;
  constexpr int WC = W::WC;
  Planes<T> s;
  s.ssh = reinterpret_cast<T*>(smem);
  s.u = s.ssh + WC;
  s.v = s.u + WC;
  s.a = s.v + WC;
  s.ht = s.a + WC;
  s.code = reinterpret_cast<int8_t*>(s.a + (W::PLANES - 3) * WC);
  return s;
}

// Stage the window of this CTA's tile, every read clamped to the
// (ny, nx) block; with EXCH the state points are read from where the
// halo exchange would have put them (halo_remap.cuh).
template <typename T, int K, bool HT, bool EXCH>
__device__ __forceinline__ void stage(const Planes<T>& s,
                                      const T* __restrict__ sshn_g,
                                      const T* __restrict__ un_g,
                                      const T* __restrict__ vn_g,
                                      const int8_t* __restrict__ code_g,
                                      const T* __restrict__ ht_g, int ny,
                                      int nx, const HaloRemap& m) {
  using W = Window<T, K, HT>;
  constexpr int R = W::R, WX = W::WX, WC = W::WC;
  const int x0 = blockIdx.x * TX - R;
  const int y0 = blockIdx.y * TY - R;
  for (int idx = threadIdx.x; idx < WC; idx += NT) {
    const int wy = idx / WX, wx = idx - wy * WX;
    const int gy = min(max(y0 + wy, 0), ny - 1);
    const int gx = min(max(x0 + wx, 0), nx - 1);
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    size_t gs = g;
    if constexpr (EXCH) {
      gs = static_cast<size_t>(halo_remap_row(m, gy)) * nx +
           halo_remap_col(m, gx);
    }
    s.ssh[idx] = sshn_g[gs];
    s.u[idx] = un_g[gs];
    s.v[idx] = vn_g[gs];
    s.code[idx] = code_g[g];
    if constexpr (HT) s.ht[idx] = ht_g[g];
  }
}

// 1/x: exact, or (FAST, float only) the hardware's approximate
// reciprocal refined by one Newton step, as the JAX package's
// _recip_fast does it.
template <typename T, bool FAST>
__device__ __forceinline__ T recip(T x) {
  if constexpr (FAST) {
    static_assert(sizeof(T) == 4, "the fast reciprocal is float only");
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r * (2.0f - x * r);
  } else {
    return static_cast<T>(1) / x;
  }
}

// The K sub-steps of one sweep on the staged window.  Each sub-step has
// three phases separated by __syncthreads(): continuity (ssha, which
// must be complete before momentum reads its east/north neighbours),
// momentum u/v into registers, and the write of u/v back into shared
// memory.  Quantities that neighbours read (face ssh, face depths,
// fluxes) are recomputed from the staged state rather than staged as
// planes, and the six masks are decoded per point from the code byte.
// On return s.ssh holds the new surface (the scratch pointer swapped
// with it every sub-step).
template <typename T, int K, bool HT, bool FAST>
__device__ __forceinline__ void substeps(Planes<T>& s, const Consts& c) {
  using W = Window<T, K, HT>;
  constexpr int WY = W::WY, WX = W::WX, WC = W::WC;
  T* s_ssh = s.ssh;
  T* s_a = s.a;
  const T* s_u = s.u;
  const T* s_v = s.v;
  const T* s_ht = s.ht;
  const int8_t* s_code = s.code;
  const int tid = threadIdx.x;

  const T cw = static_cast<T>(c.cw), cwy = static_cast<T>(c.cwy);
  const bool rect = c.rect != 0.0;
  const T fric = static_cast<T>(c.fric);
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
  // Flather coefficient -sqrt(g / max(h, 1e-3)); PyTorch evaluates
  // g / h as reciprocal(h) * g
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
      T a;
      if (rect) {
        const T div = cw * (fx - fxw) + cwy * (fy - fys);
        a = bit(idx, 0) != zero ? s_ssh[idx] - div : s_ssh[idx];
      } else {
        a = s_ssh[idx] - (cw * bit(idx, 0)) * ((fx - fxw) + (fy - fys));
      }
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
        const T rd = recip<T, FAST>(du);
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
        const T rd = recip<T, FAST>(dv);
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
      s.u[idx] = ua[q];
      s.v[idx] = va[q];
    }
    // the new surface becomes the state; the old one becomes scratch
    T* t = s_ssh;
    s_ssh = s_a;
    s_a = t;
    __syncthreads();
  }
  s.ssh = s_ssh;
  s.a = s_a;
}

// Write the tile (the window's centre) back to the (ny, nx) block.
template <typename T, int K, bool HT>
__device__ __forceinline__ void write_back(const Planes<T>& s,
                                           T* __restrict__ ssha_g,
                                           T* __restrict__ ua_g,
                                           T* __restrict__ va_g, int ny,
                                           int nx) {
  using W = Window<T, K, HT>;
  constexpr int R = W::R, WX = W::WX;
  for (int idx = threadIdx.x; idx < TY * TX; idx += NT) {
    const int ty = idx / TX, tx = idx - ty * TX;
    const int gy = blockIdx.y * TY + ty, gx = blockIdx.x * TX + tx;
    if (gy >= ny || gx >= nx) continue;
    const int w = (ty + R) * WX + tx + R;
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    ssha_g[g] = s.ssh[w];
    ua_g[g] = s.u[w];
    va_g[g] = s.v[w];
  }
}

// Set a kernel's dynamic shared-memory ceiling once per device and
// instantiation, then launch it on `stream`; returns cudaGetLastError()
// of the launch.
template <auto Kern, typename... Args>
cudaError_t launch(size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  static int attr_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attr_device != dev) {
    err = cudaFuncSetAttribute(Kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = dev;
  }
  Kern<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The launch grid of a (ny, nx) block: one CTA per tile.
inline dim3 tile_grid(int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY);
}

// Copy `n` doubles into Consts; false if the count is wrong.
inline bool read_consts(const double* consts, int n, Consts* c) {
  if (n != kNumConsts) return false;
  double* dst = reinterpret_cast<double*>(c);
  for (int i = 0; i < kNumConsts; ++i) dst[i] = consts[i];
  return true;
}

}  // namespace nemo
