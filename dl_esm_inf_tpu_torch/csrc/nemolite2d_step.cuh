// The NEMOLite2D step on a shared-memory window: the tile rule, the
// host-folded constants, the staging, the K sub-steps and the output of
// one CTA.  The production sweep (nemolite2d_sweep.cu), the sweep across
// ranks (nemolite2d_sweep_rdma.cu) and the measurement variants
// (nemolite2d_variants.cu) all include it, so a variant cannot drift from
// production: the JAX package's microbench kept a copy of the step and
// said so (scripts/kbench.py:15-17).
//
// The sub-steps evaluate the plain PyTorch step
// (dl_esm_inf_tpu_torch/models/nemolite2d.py::step_math) operation for
// operation, and every intermediate is computed once and then read, so
// built with --fmad=false the two agree bitwise.
//
// Geometry.  A CTA owns a TY x TX output tile and stages a window of the
// tile plus a ring of R = 2K cells on every side (the step's reach is
// 2): the three state planes, three planes for the next state, the int8
// mask code (and, with HT, the T-point depth ht).  Sub-step k updates
// continuity on the region 2k+1 cells inside the window and momentum on
// the region 2k+2 inside, writing the next-state planes, and then state
// and next state swap; after K sub-steps exactly the tile is valid.
// Outside its region a next-state plane keeps what it held (the staged
// state, or the values of two sub-steps before).  The last sub-step of a
// sweep writes the tile to the output planes directly.
//
// The tile rule (Tile; ops/fused_step.py::tile mirrors it).  TX is 64
// columns at float32 and 32 at float64.  K fixes how many CTAs must share
// an SM (4 at K <= 2, 3 at K >= 3: small windows keep staging, sub-steps
// and stores of different CTAs overlapping, larger ones save ring work)
// and the rows of warps are 2; TY is the largest multiple of 4 up to 64
// whose window fits that share of the SM's shared memory less the
// runtime's reserve.  At float32 K=4 that is a 64 x 20 tile, 192 threads.
//
// The two staging paths.  On a block whose rows are 16-byte aligned and
// not remapped, a window row goes in 16-byte chunks: a chunk inside the
// block by a cp.async copy, a chunk across its edge by clamped scalar
// reads; shared rows are padded so that the window's first column sits
// at the same offset whichever way a chunk came (OFF, OFFC), and the
// state and the code plane decide alone.  EXCH (whose points come through
// halo_remap) and unaligned rows read every window point with its own
// clamped scalar load.  The staged state is
// then copied into the next-state planes, so every plane holds defined
// values (not at K=1, where they are never read, nor in the dma variant,
// whose body writes every window point).
//
// The sub-steps.  Warps march.  Warp (i, j) of the CTA takes 32
// consecutive window columns starting at 2k + 29i, one per lane, and a
// strip j of rows; each lane walks up its column one row per iteration,
// so a row's y-neighbours stay in registers, and x-neighbours come from
// the adjacent lanes by shuffles.  Each face quantity (sw, sshu/depu,
// sshv/depv, the fluxes fx and fy, wx_u, wy_u, wy_v, wx_v, the corner
// sums) is computed once per point and sub-step and then read from a
// register or a shuffle; the code byte is read once per point and
// sub-step and its masks taken by selects.  A lane owns its column if it
// is lane 1..29 (lanes 0, 30 and 31 only feed their neighbours), a strip
// owns its rows; only owners store.  The next state goes to planes that
// nobody reads in the same sub-step, so one __syncthreads() per sub-step
// suffices.  The constants come converted to the working type from the
// host, so they are operands from the parameter bank.
//
// Cells.  Square cells (dx == dy) fold the wet-cell select into the
// continuity prefactor, as make_prep's cw does; rectangular cells take
// the plain non-square order, (rdt/dx)(fx - xm fx) + (rdt/dy)(fy - ym
// fy), then the wet-cell select.  The choice is the runtime flag
// StepConsts::rect, uniform over the launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "halo_remap.cuh"
#include "staging.cuh"

namespace nemo {

// columns a warp owns (lanes 1..29 of its 32)
constexpr int kOwned = 29;
// an H100 SM's shared memory, the runtime's reserve per CTA, and the
// largest tile edge in y
constexpr int kSmemPerSM = 233472;
constexpr int kSmemReserve = 1024;
constexpr int kTileYMax = 64;
// the row strips of a CTA (its warps are row strips x column strips);
// by K (index K - 1), the CTAs that must share an SM
constexpr int kRowStrips = 2;
constexpr int kCtasPerSM[4] = {4, 4, 3, 3};

using staging::round_up;

// The tile and window of a sweep on ES-byte elements with K sub-steps
// (HT: one more plane, the depth).  Shared planes are WY rows of PX
// elements, the window's column 0 at OFF; the code plane has rows of PC
// bytes, column 0 at OFFC.  OFF and OFFC put the window origin's 16-byte
// aligned global address at the start of a shared row.
template <int ES, int K, bool HT>
struct Tile {
  static constexpr int R = 2 * K;
  static constexpr int CTAS = kCtasPerSM[K - 1];
  static constexpr int STRIPS = kRowStrips;
  static constexpr int BUDGET = kSmemPerSM / CTAS - kSmemReserve;
  static constexpr int TX = ES == 4 ? 64 : 32;
  static constexpr int WX = TX + 2 * R;
  static constexpr int V = 16 / ES;                  // elements per 16 B
  static constexpr int OFF = (V - R % V) % V;
  static constexpr int PX = round_up(OFF + WX, V);
  static constexpr int OFFC = (16 - R % 16) % 16;
  static constexpr int PC = round_up(OFFC + WX, 16);
  static constexpr int PLANES = HT ? 7 : 6;
  static constexpr int ROW_BYTES = PLANES * PX * ES + PC;
  static constexpr int pick_ty() {
    int ty = kTileYMax;
    while (ty > 4 && (ty + 2 * R) * ROW_BYTES > BUDGET) ty -= 4;
    return ty;
  }
  static constexpr int TY = pick_ty();
  static constexpr int WY = TY + 2 * R;
  static constexpr int P = WY * PX;                  // elements per plane
  // warps: column strips of kOwned columns over the widest continuity
  // region (WX - 2 columns), times the row strips
  static constexpr int SX = (WX - 2 + kOwned - 1) / kOwned;
  static constexpr int NT = 32 * SX * STRIPS;
  static constexpr size_t smem_bytes = static_cast<size_t>(WY) * ROW_BYTES;
  static_assert(smem_bytes <= static_cast<size_t>(BUDGET), "budget");
  static_assert(TX % 16 == 0 && (OFF + R) % V == 0, "alignment");
};

template <typename T, int K, bool HT>
using Geo = Tile<static_cast<int>(sizeof(T)), K, HT>;

// Host-folded prefactors (double, in the plain step's grouping);
// working() casts each once to the working type, on the host.
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

// The step's constants in the working type, converted on the host (as
// the plain version's Python scalars are cast), so the kernels read them
// as operands from the parameter bank.
template <typename T>
struct StepConsts {
  T cw, cwy, fric, ht, hu, hv, cu, cv;
  T ux_adv, ux_vis, uy_adv, uy_vis, u_cor, u_hpg;
  T vy_adv, vy_vis, vx_adv, vx_vis, v_cor, v_hpg;
  T grav;
  T forcing[4];
  int rect;
};

template <typename T>
inline StepConsts<T> working(const Consts& c) {
  StepConsts<T> w;
  w.cw = static_cast<T>(c.cw);
  w.cwy = static_cast<T>(c.cwy);
  w.fric = static_cast<T>(c.fric);
  w.ht = static_cast<T>(c.ht);
  w.hu = static_cast<T>(c.hu);
  w.hv = static_cast<T>(c.hv);
  w.cu = static_cast<T>(c.cu);
  w.cv = static_cast<T>(c.cv);
  w.ux_adv = static_cast<T>(c.ux_adv);
  w.ux_vis = static_cast<T>(c.ux_vis);
  w.uy_adv = static_cast<T>(c.uy_adv);
  w.uy_vis = static_cast<T>(c.uy_vis);
  w.u_cor = static_cast<T>(c.u_cor);
  w.u_hpg = static_cast<T>(c.u_hpg);
  w.vy_adv = static_cast<T>(c.vy_adv);
  w.vy_vis = static_cast<T>(c.vy_vis);
  w.vx_adv = static_cast<T>(c.vx_adv);
  w.vx_vis = static_cast<T>(c.vx_vis);
  w.v_cor = static_cast<T>(c.v_cor);
  w.v_hpg = static_cast<T>(c.v_hpg);
  w.grav = static_cast<T>(c.g);
  for (int k = 0; k < 4; ++k) w.forcing[k] = static_cast<T>(c.forcing[k]);
  w.rect = c.rect != 0.0;
  return w;
}

// The CTA's shared planes: the state (ssh, u, v at cur, cur + P,
// cur + 2P) and the next state (a, the ssha of the plain step, ua, va at
// nxt, ...), swapped every sub-step; the depth (HT) and the code.
template <typename T>
struct Planes {
  T* cur;
  T* nxt;
  T* ht;
  int8_t* code;
};

template <typename T, int K, bool HT>
__device__ __forceinline__ Planes<T> carve(unsigned char* smem) {
  using G = Geo<T, K, HT>;
  Planes<T> s;
  s.cur = reinterpret_cast<T*>(smem);
  s.nxt = s.cur + 3 * G::P;
  s.ht = s.cur + 6 * G::P;
  s.code = reinterpret_cast<int8_t*>(s.cur + G::PLANES * G::P);
  return s;
}

using staging::aligned16;
using staging::copy16_async;
using staging::copy_async_wait;

// Stage the window of this CTA's tile and (SCRATCH) copy the state into
// the scratch planes.  On a block with 16-byte rows and no remap, the
// window's rows go in 16-byte chunks: a chunk inside the block by a
// cp.async copy, a chunk across its edge by clamped scalar reads.
// Otherwise (EXCH, unaligned rows) every window point is a clamped scalar
// read; with EXCH the state points are read from where the halo exchange
// would have put them (halo_remap.cuh).  The code plane decides alone.
template <typename T, int K, bool HT, bool EXCH, bool SCRATCH>
__device__ __forceinline__ void stage(const Planes<T>& s,
                                      const T* __restrict__ sshn_g,
                                      const T* __restrict__ un_g,
                                      const T* __restrict__ vn_g,
                                      const int8_t* __restrict__ code_g,
                                      const T* __restrict__ ht_g, int ny,
                                      int nx, const HaloRemap& m) {
  using G = Geo<T, K, HT>;
  constexpr int R = G::R, WX = G::WX, WY = G::WY, PX = G::PX, PC = G::PC;
  constexpr int OFF = G::OFF, OFFC = G::OFFC, V = G::V, NT = G::NT;
  constexpr int P = G::P;
  const int x0 = blockIdx.x * G::TX - R;
  const int y0 = blockIdx.y * G::TY - R;
  const bool chunks = !EXCH && (nx % V) == 0 && aligned16(sshn_g) &&
                      aligned16(un_g) && aligned16(vn_g) &&
                      (!HT || aligned16(ht_g));
  const bool chunks_code = (nx % 16) == 0 && aligned16(code_g);
  constexpr int CH = PX / V;                         // 16 B chunks per row
  if (chunks) {
    for (int idx = threadIdx.x; idx < WY * CH; idx += NT) {
      const int w = idx / CH, j = idx - w * CH;
      const int gy = y0 + w, gx = x0 - OFF + j * V;
      const int i = w * PX + j * V;
      if (gy >= 0 && gy < ny && gx >= 0 && gx + V <= nx) {
        const size_t g = static_cast<size_t>(gy) * nx + gx;
        copy16_async(s.cur + i, sshn_g + g);
        copy16_async(s.cur + P + i, un_g + g);
        copy16_async(s.cur + 2 * P + i, vn_g + g);
        if constexpr (HT) copy16_async(s.ht + i, ht_g + g);
        continue;
      }
      const size_t row = static_cast<size_t>(min(max(gy, 0), ny - 1)) * nx;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int wx = j * V + e - OFF;
        if (wx < 0 || wx >= WX) continue;
        const size_t g = row + min(max(x0 + wx, 0), nx - 1);
        s.cur[i + e] = sshn_g[g];
        s.cur[P + i + e] = un_g[g];
        s.cur[2 * P + i + e] = vn_g[g];
        if constexpr (HT) s.ht[i + e] = ht_g[g];
      }
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < WY * WX; idx += NT) {
      const int w = idx / WX, wx = idx - w * WX;
      const int gy = min(max(y0 + w, 0), ny - 1);
      const int gx = min(max(x0 + wx, 0), nx - 1);
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      size_t gs = g;
      if constexpr (EXCH) {
        gs = static_cast<size_t>(halo_remap_row(m, gy)) * nx +
             halo_remap_col(m, gx);
      }
      const int i = w * PX + OFF + wx;
      const T sv = sshn_g[gs], uv = un_g[gs], vv = vn_g[gs];
      s.cur[i] = sv;
      s.cur[P + i] = uv;
      s.cur[2 * P + i] = vv;
      if constexpr (SCRATCH) {
        s.nxt[i] = sv;
        s.nxt[P + i] = uv;
        s.nxt[2 * P + i] = vv;
      }
      if constexpr (HT) s.ht[i] = ht_g[g];
    }
  }
  if (chunks_code) {
    constexpr int CC = PC / 16;
    for (int idx = threadIdx.x; idx < WY * CC; idx += NT) {
      const int w = idx / CC, j = idx - w * CC;
      const int gy = y0 + w, gx = x0 - OFFC + j * 16;
      int8_t* dst = s.code + w * PC + j * 16;
      if (gy >= 0 && gy < ny && gx >= 0 && gx + 16 <= nx) {
        copy16_async(dst, code_g + static_cast<size_t>(gy) * nx + gx);
        continue;
      }
      const size_t row = static_cast<size_t>(min(max(gy, 0), ny - 1)) * nx;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int wx = j * 16 + e - OFFC;
        if (wx < 0 || wx >= WX) continue;
        dst[e] = code_g[row + min(max(x0 + wx, 0), nx - 1)];
      }
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < WY * WX; idx += NT) {
      const int w = idx / WX, wx = idx - w * WX;
      const int gy = min(max(y0 + w, 0), ny - 1);
      const int gx = min(max(x0 + wx, 0), nx - 1);
      s.code[w * PC + OFFC + wx] = code_g[static_cast<size_t>(gy) * nx + gx];
    }
  }
  if (chunks || chunks_code) copy_async_wait();
  if (SCRATCH && chunks) {
    // each thread copies the chunks it staged itself
    for (int idx = threadIdx.x; idx < WY * CH; idx += NT) {
      const int w = idx / CH, j = idx - w * CH;
      for (int p = 0; p < 3; ++p) {
        const int i = p * P + w * PX + j * V;
        *reinterpret_cast<uint4*>(s.nxt + i) =
            *reinterpret_cast<const uint4*>(s.cur + i);
      }
    }
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

template <typename T>
__device__ __forceinline__ T from_right(T x) {      // x of lane + 1
  return __shfl_down_sync(0xffffffffu, x, 1);
}

template <typename T>
__device__ __forceinline__ T from_left(T x) {       // x of lane - 1
  return __shfl_up_sync(0xffffffffu, x, 1);
}

// mask bit b of a code (bits: t_wet, u_wet, v_wet, bc, flather_u,
// flather_v); masks are 0/1, so a product with a positive constant is a
// select between the constant and 0, exactly
__device__ __forceinline__ bool flag(int code, int b) {
  return (code >> b) & 1;
}

template <typename T>
__device__ __forceinline__ T bit(int code, int b) {
  return flag(code, b) ? static_cast<T>(1) : static_cast<T>(0);
}

// What a lane carries up its column: suffix 1 is the row below the one
// loaded last (r - 1), 2 the row r - 2, 3 the row r - 3.
template <typename T>
struct Carry {
  T ssh1, sw1, fx1, fxm1, z1, z2, ht1;
  T u1, u2, v1, v2, umx1, umx2, vx1, vx2;
  T depu1, depu2, sshu1, sshu2, hu1, hu2;
  T fy2, depv2, depvx2, sshv2, hv2;
  T a2, ax2, wyv2, wyu3, wv3;
  int code1, code2;
};

// The output planes of a sweep, which its last sub-step writes directly.
template <typename T>
struct Out {
  T* ssha;
  T* ua;
  T* va;
  int ny, nx;
};

// The lane's place in this sub-step's march.
struct Lane {
  int col;                        // its window column, clamped
  int lo, hi_y;                   // continuity rows [lo, hi_y)
  int o, oe;                      // the strip's rows [o, oe)
  bool own_c, own_m;              // owns continuity / momentum in x
  bool out_c;                     // the column is a block point of the
                                  // tile
  int gy0;                        // the block row of window row 0
  int gx;                         // the block column of the lane's column
};

// One iteration of a lane's march: load row r; PHASE 0 computes row r's
// face terms, 1 also row r-1's, 2 also continuity at r-1 and the pieces
// of momentum at r-2, 3 also momentum at r-2 (the steady state).
template <int PHASE, typename T, int K, bool HT, bool FAST, bool OUT>
__device__ __forceinline__ void march_row(const Planes<T>& s,
                                          const StepConsts<T>& c, T forcing,
                                          const Lane& L, const Out<T>& out,
                                          int r, Carry<T>& q) {
  using G = Geo<T, K, HT>;
  const T one = static_cast<T>(1), half = static_cast<T>(0.5);
  const T zero = static_cast<T>(0), hmin = static_cast<T>(1e-3);
  auto flather = [&](T h, T flat) -> T {
    if constexpr (HT) return -sqrt((one / (h < hmin ? hmin : h)) * c.grav);
    else return flat;
  };
  constexpr int P = G::P;
  const int rr = min(r, G::WY - 1);
  const T* src = s.cur + (rr * G::PX + G::OFF + L.col);
  // row r: the surface on U faces, the U-face depth and flux
  const T ssh0 = src[0], u0 = src[P], v0 = src[2 * P];
  const int code0 = s.code[rr * G::PC + G::OFFC + L.col];
  T ht0 = c.ht, hu0 = c.hu;
  if constexpr (HT) {
    ht0 = s.ht[rr * G::PX + G::OFF + L.col];
    hu0 = half * (ht0 + from_right(ht0));
  }
  const T sw0 = ssh0 * bit<T>(code0, 0);
  // 1 - u_wet/2 and 1 - v_wet/2 are 0.5 or 1 exactly
  const T sshu0 = (sw0 + from_right(sw0)) * (flag(code0, 1) ? half : one);
  const T depu0 = hu0 + sshu0;
  const T fx0 = depu0 * u0;
  const T fxm0 = from_left(fx0);
  const T umx0 = from_left(u0);
  const T vx0 = from_right(v0);
  const T z0 = ht0 + ssh0;
  T sshv1 = zero, hv1 = c.hv, depv1 = zero, fy1 = zero, depvx1 = zero;
  T a1 = zero, ax1 = zero, wyv1 = zero, wyu2 = zero, wv2 = zero;
  if constexpr (PHASE >= 1) {
    // row r-1: the surface on V faces, the V-face depth and flux
    sshv1 = (q.sw1 + sw0) * (flag(q.code1, 2) ? half : one);
    if constexpr (HT) hv1 = half * (q.ht1 + ht0);
    depv1 = hv1 + sshv1;
    fy1 = depv1 * q.v1;
    depvx1 = from_right(depv1);
  }
  if constexpr (PHASE >= 2) {
    // continuity + bc_ssh at row r-1
    const int b1 = q.code1;
    T a;
    if (c.rect) {
      const T div = c.cw * (q.fx1 - q.fxm1) + c.cwy * (fy1 - q.fy2);
      a = flag(b1, 0) ? q.ssh1 - div : q.ssh1;
    } else {
      a = q.ssh1
          - (flag(b1, 0) ? c.cw : zero) * ((q.fx1 - q.fxm1) + (fy1 - q.fy2));
    }
    a1 = flag(b1, 3) ? forcing : a;
    ax1 = from_right(a1);
    const int row1 = r - 1;
    if (L.own_c && row1 < L.oe) {
      if constexpr (!OUT) {
        s.nxt[row1 * G::PX + G::OFF + L.col] = a1;
      } else if (L.out_c && row1 >= G::R && row1 < G::R + G::TY &&
                 L.gy0 + row1 < out.ny) {
        out.ssha[static_cast<size_t>(L.gy0 + row1) * out.nx + L.gx] = a1;
      }
    }
    // momentum_u's y flux at the F corner of row r-2, momentum_v's y flux
    // at the T centre of row r-1
    wv2 = q.v2 + q.vx2;
    {
      const T dep_f2 = q.depv2 + q.depvx2;
      const T udn = wv2 > zero ? q.u2 : q.u1;
      wyu2 = (c.uy_adv * (wv2 * udn) + c.uy_vis * (q.u1 - q.u2)) * dep_f2;
    }
    {
      const T sv = q.v1 + q.v2;
      const T vds = sv > zero ? q.v2 : q.v1;
      wyv1 = (c.vy_adv * (sv * vds) + c.vy_vis * (q.v1 - q.v2)) * q.z1;
    }
  }
  if constexpr (PHASE >= 3) {
    // momentum at row m = r-2
    const int m = r - 2;
    const int b2 = q.code2;
    T wxu;
    {
      const T su = q.u2 + q.umx2;
      const T udw = su > zero ? q.umx2 : q.u2;
      wxu = (c.ux_adv * (su * udw) + c.ux_vis * (q.u2 - q.umx2)) * q.z2;
    }
    const T wxux = from_right(wxu);
    const T wu = q.u2 + q.u1;
    const T wum = from_left(wu);
    T wxv;
    {
      const T dep_f2 = q.depu2 + q.depu1;
      const T vde = wu > zero ? q.v2 : q.vx2;
      wxv = (c.vx_adv * (wu * vde) + c.vx_vis * (q.vx2 - q.v2)) * dep_f2;
    }
    const T wxvm = from_left(wxv);
    T ua, va;
    {
      const T du = q.depu2;
      const T term_x = wxux - wxu;
      const T term_y = wyu2 - q.wyu3;
      const T corhpg = (c.u_cor * (wv2 + q.wv3)
                        + c.u_hpg * (q.ax2 - q.a2)) * du;
      const T rd = recip<T, FAST>(du);
      const T rr_ = (q.u2 + (term_x + term_y + corhpg) * rd)
                    * (flag(b2, 1) ? c.fric : zero);
      if constexpr (HT) {
        if (flag(b2, 4)) ua = flather(q.hu2, c.cu) * q.sshu2;
        else ua = rr_;
      } else {
        ua = flag(b2, 4) ? c.cu * q.sshu2 : rr_;
      }
    }
    {
      const T dv = q.depv2;
      const T term_y = wyv1 - q.wyv2;
      const T term_x = wxv - wxvm;
      const T corhpg = (c.v_cor * (wu + wum) + c.v_hpg * (a1 - q.a2)) * dv;
      const T rd = recip<T, FAST>(dv);
      const T rr_ = (q.v2 + (term_y + term_x + corhpg) * rd)
                    * (flag(b2, 2) ? c.fric : zero);
      if constexpr (HT) {
        if (flag(b2, 5)) va = flather(q.hv2, c.cv) * q.sshv2;
        else va = rr_;
      } else {
        va = flag(b2, 5) ? c.cv * q.sshv2 : rr_;
      }
    }
    if (L.own_m && m > L.lo && m < L.hi_y - 1) {
      if constexpr (!OUT) {
        T* dst = s.nxt + (m * G::PX + G::OFF + L.col);
        dst[P] = ua;
        dst[2 * P] = va;
      } else if (L.out_c && L.gy0 + m < out.ny) {
        // the last momentum region is the tile
        const size_t g = static_cast<size_t>(L.gy0 + m) * out.nx + L.gx;
        out.ua[g] = ua;
        out.va[g] = va;
      }
    }
  }
  // move up one row
  q.wyu3 = wyu2;
  q.wv3 = wv2;
  q.a2 = a1;
  q.ax2 = ax1;
  q.wyv2 = wyv1;
  q.fy2 = fy1;
  q.depv2 = depv1;
  q.depvx2 = depvx1;
  q.sshv2 = sshv1;
  q.hv2 = hv1;
  q.u2 = q.u1;
  q.u1 = u0;
  q.v2 = q.v1;
  q.v1 = v0;
  q.umx2 = q.umx1;
  q.umx1 = umx0;
  q.vx2 = q.vx1;
  q.vx1 = vx0;
  q.depu2 = q.depu1;
  q.depu1 = depu0;
  q.sshu2 = q.sshu1;
  q.sshu1 = sshu0;
  q.hu2 = q.hu1;
  q.hu1 = hu0;
  q.z2 = q.z1;
  q.z1 = z0;
  q.code2 = q.code1;
  q.code1 = code0;
  q.ssh1 = ssh0;
  q.sw1 = sw0;
  q.fx1 = fx0;
  q.fxm1 = fxm0;
  q.ht1 = ht0;
}

// Sub-step k: one march of every warp over its strip, writing the next
// state (OUT: the last sub-step, writing the tile to the output planes).
// Every strip marches the same number of rows, a function of k alone, so
// the loop and its shuffles stay converged; rows past the region store
// nothing.
template <typename T, int K, bool HT, bool FAST, bool OUT>
__device__ __forceinline__ void substep(const Planes<T>& s,
                                        const StepConsts<T>& c,
                                        const Out<T>& o, int k) {
  using G = Geo<T, K, HT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sx = warp % G::SX, sy = warp / G::SX;
  Lane L;
  L.lo = 2 * k + 1;
  L.hi_y = G::WY - 2 * k - 1;
  const int hi_x = G::WX - 2 * k - 1;
  const int H = (L.hi_y - L.lo + G::STRIPS - 1) / G::STRIPS;
  L.o = L.lo + sy * H;
  L.oe = min(L.o + H, L.hi_y);
  const int col = 2 * k + kOwned * sx + lane;
  L.col = min(col, G::WX - 1);
  L.own_c = lane >= 1 && lane <= kOwned && col < hi_x;
  L.own_m = L.own_c && col > L.lo && col < hi_x - 1;
  L.gy0 = blockIdx.y * G::TY - G::R;
  L.gx = blockIdx.x * G::TX - G::R + L.col;
  L.out_c = OUT && L.col >= G::R && L.col < G::R + G::TX && L.gx < o.nx;
  const T forcing = c.forcing[k];
  Carry<T> q{};
  int r = L.o - 1;
  march_row<0, T, K, HT, FAST, OUT>(s, c, forcing, L, o, r++, q);
  march_row<1, T, K, HT, FAST, OUT>(s, c, forcing, L, o, r++, q);
  march_row<2, T, K, HT, FAST, OUT>(s, c, forcing, L, o, r++, q);
#pragma unroll 3
  for (int t = 0; t < H; ++t, ++r) {
    march_row<3, T, K, HT, FAST, OUT>(s, c, forcing, L, o, r, q);
  }
}

// The K sub-steps of one sweep on the staged window, each followed by one
// __syncthreads() and the swap of state and next state.  OUT: the last
// sub-step writes the tile to `o` instead (its stores leave while the
// march goes on) and s.cur is left as it was; else on return s.cur holds
// the new state.
template <typename T, int K, bool HT, bool FAST, bool OUT>
__device__ __forceinline__ void substeps(Planes<T>& s,
                                         const StepConsts<T>& c,
                                         const Out<T>& o) {
#pragma unroll 1
  for (int k = 0; k < (OUT ? K - 1 : K); ++k) {
    substep<T, K, HT, FAST, false>(s, c, o, k);
    __syncthreads();
    T* t = s.cur;
    s.cur = s.nxt;
    s.nxt = t;
  }
  if constexpr (OUT) substep<T, K, HT, FAST, true>(s, c, o, K - 1);
}

// Write the tile (the window's centre) back to the (ny, nx) block, after
// sub-steps that kept the new state in shared memory: 16 bytes per store
// where the block's rows are 16-byte aligned.
template <typename T, int K, bool HT>
__device__ __forceinline__ void write_back(const Planes<T>& s,
                                           T* __restrict__ ssha_g,
                                           T* __restrict__ ua_g,
                                           T* __restrict__ va_g, int ny,
                                           int nx) {
  using G = Geo<T, K, HT>;
  constexpr int R = G::R, PX = G::PX, TX = G::TX, TY = G::TY, V = G::V;
  constexpr int NT = G::NT, C0 = G::OFF + R, P = G::P;
  const int gy0 = blockIdx.y * TY, gx0 = blockIdx.x * TX;
  if ((nx % V) == 0 && aligned16(ssha_g) && aligned16(ua_g) &&
      aligned16(va_g)) {
    constexpr int CH = TX / V;
    for (int idx = threadIdx.x; idx < TY * CH; idx += NT) {
      const int ty = idx / CH, j = idx - ty * CH;
      const int gy = gy0 + ty, gx = gx0 + j * V;
      if (gy >= ny || gx >= nx) continue;
      const T* w = s.cur + ((ty + R) * PX + C0 + j * V);
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      *reinterpret_cast<uint4*>(ssha_g + g) =
          *reinterpret_cast<const uint4*>(w);
      *reinterpret_cast<uint4*>(ua_g + g) =
          *reinterpret_cast<const uint4*>(w + P);
      *reinterpret_cast<uint4*>(va_g + g) =
          *reinterpret_cast<const uint4*>(w + 2 * P);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < TY * TX; idx += NT) {
    const int ty = idx / TX, tx = idx - ty * TX;
    const int gy = gy0 + ty, gx = gx0 + tx;
    if (gy >= ny || gx >= nx) continue;
    const T* w = s.cur + ((ty + R) * PX + C0 + tx);
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    ssha_g[g] = w[0];
    ua_g[g] = w[P];
    va_g[g] = w[2 * P];
  }
}

using staging::launch;

// The launch grid of a (ny, nx) block: one CTA per tile.
template <typename G>
inline dim3 tile_grid(int ny, int nx) {
  return dim3((nx + G::TX - 1) / G::TX, (ny + G::TY - 1) / G::TY);
}

// Copy `n` doubles into Consts; false if the count is wrong.
inline bool read_consts(const double* consts, int n, Consts* c) {
  if (n != kNumConsts) return false;
  double* dst = reinterpret_cast<double*>(c);
  for (int i = 0; i < kNumConsts; ++i) dst[i] = consts[i];
  return true;
}

}  // namespace nemo
