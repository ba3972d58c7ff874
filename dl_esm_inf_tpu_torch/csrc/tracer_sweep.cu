// Flux-form tracer sweep: K advection(-diffusion) steps per pass over
// device memory, a column march on the shared skeleton stencil_sweep.cuh
// (the tile rule with the march's widths, march_threads; staging).
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
// PyTorch step (dl_esm_inf_tpu_torch/models/tracer.py::tracer_step) as
// PyTorch runs it on the card, where a tensor divided by the Python
// scalar dx is a product with its reciprocal in T (rdx = 1 / dx, rounded
// once), for the U face i between T_i and T_{i+1} (V faces alike):
//   upwind:   cf = u > 0 ? c[i] : c[i+1]
//   van Leer: dc = c[i+1] - c[i], safe = dc == 0 ? 1 : dc,
//             u > 0: cf = c[i] + ((0.5 * vl((c[i] - c[i-1]) / safe)) * dc)
//                                * t_upd[i-1]
//             else:  cf = c[i+1] - ((0.5 * vl((c[i+2] - c[i+1]) / safe))
//                                   * dc) * t_upd[i+2]
//             vl(r) = (r + |r|) / (1 + |r|)
//   fx = u * cf;  tend = -((fx[i] - fx[i-1]) * rdx + (fy[j] - fy[j-1]) * rdy)
//   diffusion: gx = ((c[i+1] - c[i]) * rdx) * u_wet,
//              tend = tend + kappa * ((gx[i] - gx[i-1]) * rdx
//                                     + (gy[j] - gy[j-1]) * rdy)
//   c' = t_upd ? c + dt * tend : c
// Where dx is a power of two, rdx is exact and the product is also the
// true division the CPU's plain version takes.
//
// Design: a column march.  Warps take column strips of kMarchLanes = 31
// owned columns (lanes 1..31; lane 0 sits on the column west of the
// strip and only feeds lane 1) and row strips, and march up their
// columns.  Each face's flux is computed once: a lane computes the flux
// (and the diffusive gradient) of its own U face, i.e. its east face,
// and takes its west face's from the lane to its west by __shfl_up_sync;
// it computes its north V face's and carries it to the next row as its
// south face's.  The column's tracer values (rows j - 1 .. j + 2) and
// code bytes ride in registers from row to row, so a point reads one new
// value and code byte of its column, the velocities, and c at i + 1 and
// at the one far-upwind point its U face's direction selects.  That is
// two limiter evaluations (4 divisions) per point and sub-step.  c' reads
// c two cells away, so it goes to a scratch plane that becomes the
// tracer after one barrier per sub-step; a sub-step updates only what
// the tile needs after it (the tile and (K - 1 - k) * REACH cells
// around), and the last one writes the tile to the outputs from the
// march.  Trip counts are uniform over a warp, so every shuffle sits in
// converged code.
//
// What bounds it: 17 B per point per sweep at float32, against ~60
// instructions and ~10 shared-memory operations per point and sub-step
// (van Leer) times the ring's recomputation: issue and the
// shared-memory pipe, not HBM.
#include "stencil_sweep.cuh"

namespace {

// the march's warps an SM and rows of a row strip (measured on an H100:
// 40 warps beat 32 by 17% at van Leer K=4, 48 spill)
constexpr int kWarps = 40;
constexpr int kRows = 2;

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T from_left(T v) {       // v of lane - 1
  return __shfl_up_sync(0xffffffffu, v, 1);
}

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
  static constexpr bool WRITES_OUT = true;
  // one scratch plane: the next tracer
  using Tile = sweep::Tile<
      T, N, M, CODE,
      sweep::Ring<K, REACH, K * REACH, 0, 0, sweep::kTileYMax, true, kWarps,
                  kRows>,
      0, 1, 1>;
  using G = typename Tile::G;
  using Consts = ::Consts;
  // column strips (whole strips of owned lanes over the widest region,
  // the tile and (K - 1) * REACH columns each side) and row strips
  static constexpr int SX =
      (G::TX + 2 * G::R - 1 + sweep::kMarchLanes - 1) / sweep::kMarchLanes;
  static constexpr int SY = G::NW / SX;
  static_assert(SY >= 1 && SX * SY == G::NW, "whole column strips");

  T rdx, rdy, dt, kappa;
  bool diffuse;

  __device__ explicit TracerStep(const Consts& c)
      : rdx(static_cast<T>(1) / static_cast<T>(c.dx)),
        rdy(static_cast<T>(1) / static_cast<T>(c.dy)),
        dt(static_cast<T>(c.dt)), kappa(static_cast<T>(c.kappa)),
        diffuse(c.diffuse != 0.0) {}

  // The tracer at a face from the upwind value up, the downwind value
  // dn, the far value on the side the velocity comes from (far: c[i-1]
  // for vel > 0, else c[i+2]) and t_upd there (tb), as the plain step's
  // where() picks it.
  __device__ __forceinline__ T face(T vel, T up, T dn, T far, T tb) const {
    if constexpr (REACH == 1) {
      return vel > T(0) ? up : dn;
    } else {
      const T dc = dn - up;
      const T safe = dc == T(0) ? T(1) : dc;
      const bool pos = vel > T(0);
      const T r = (pos ? up - far : far - dn) / safe;
      const T ar = abs_of(r);
      const T vl = (r + ar) / (T(1) + ar);
      const T corr = ((static_cast<T>(0.5) * vl) * dc) * tb;
      return pos ? up + corr : dn - corr;
    }
  }

  static __device__ __forceinline__ T bit(int cd, int b) {
    return static_cast<T>((cd >> b) & 1);
  }

  __device__ void substep(Tile& t, int k) const {
    constexpr int WX = G::WX, R = G::R;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sx = warp % SX, sy = warp / SX;
    // the region the tile still needs after this sub-step
    const int m = (K - 1 - k) * REACH;
    const int lo = G::RL - m, hi = G::RL + G::TX + m;
    const int y0 = R - m, y1 = R + G::TY + m;
    const int raw = lo - 1 + sweep::kMarchLanes * sx + lane;
    const int col = min(raw, WX - 1 - REACH);       // reads stay inside
    const bool own = lane >= 1 && raw < hi;
    const int H = (y1 - y0 + SY - 1) / SY;
    const int o = y0 + sy * H, oe = min(o + H, y1);
    const bool last = k == K - 1;
    const T* const c = t.s[0];
    const T* const u = t.a[0];
    const T* const v = t.a[1];
    const int8_t* const code = t.code;
    T* const cn = t.x[0];
    // the last sub-step's stores: tile columns inside the block
    const int gx = t.out.ox + col;
    const bool out_c = gx < t.out.nx;

    // the column below the first row: the south face of row o and the
    // values the march carries
    const int ob = min(o, y1 - 1) * WX + col;
    T cm1, c0, c1;          // c at rows j - 1, j, j + 1 (van Leer)
    int bm1, b0, b1;        // their code bytes
    T fys, gys;
    if constexpr (REACH == 1) {
      const T cs = c[ob - WX];
      c0 = c[ob];
      const int bs = code[ob - WX];
      b0 = code[ob];
      fys = v[ob - WX] * face(v[ob - WX], cs, c0, cs, T(0));
      gys = ((c0 - cs) * rdy) * bit(bs, 2);
      cm1 = c1 = T(0);
      bm1 = b1 = 0;
    } else {
      const T cs2 = c[ob - 2 * WX];
      cm1 = c[ob - WX];
      c0 = c[ob];
      c1 = c[ob + WX];
      const int bs2 = code[ob - 2 * WX];
      bm1 = code[ob - WX];
      b0 = code[ob];
      b1 = code[ob + WX];
      const T vs = v[ob - WX];
      fys = vs * face(vs, cm1, c0, vs > T(0) ? cs2 : c1,
                      bit(vs > T(0) ? bs2 : b1, 0));
      gys = ((c0 - cm1) * rdy) * bit(bm1, 2);
    }

#pragma unroll 2
    for (int n = 0; n < H; ++n) {
      const int j = o + n;
      const int i = min(j, y1 - 1) * WX + col;
      // the column one (upwind) or two (van Leer) rows up
      T cn1, c2;
      int bn1, b2;
      if constexpr (REACH == 1) {
        cn1 = c[i + WX];
        bn1 = code[i + WX];
        c2 = T(0);
        b2 = 0;
      } else {
        cn1 = c1;
        bn1 = b1;
        c2 = c[i + 2 * WX];
        b2 = code[i + 2 * WX];
      }
      // the east (U) face of the point
      const T ue = u[i];
      const T ce = c[i + 1];
      T fx;
      if constexpr (REACH == 1) {
        fx = ue * face(ue, c0, ce, c0, T(0));
      } else {
        const int f = ue > T(0) ? i - 1 : i + 2;
        fx = ue * face(ue, c0, ce, c[f], bit(code[f], 0));
      }
      const T fxw = from_left(fx);
      // the north (V) face of the point
      const T vn = v[i];
      const T fy = vn * face(vn, c0, cn1, vn > T(0) ? cm1 : c2,
                             bit(vn > T(0) ? bm1 : b2, 0));
      T tend = -((fx - fxw) * rdx + (fy - fys) * rdy);
      if (diffuse) {
        const T gx = ((ce - c0) * rdx) * bit(b0, 1);
        const T gxw = from_left(gx);
        const T gy = ((cn1 - c0) * rdy) * bit(b0, 2);
        tend = tend + kappa * ((gx - gxw) * rdx + (gy - gys) * rdy);
        gys = gy;
      }
      const T cnew = (b0 & 1) ? c0 + dt * tend : c0;
      if (own && j < oe) {
        if (!last) {
          cn[i] = cnew;
        } else if (out_c && t.out.oy + j < t.out.ny) {
          t.out.p[0][static_cast<size_t>(t.out.oy + j) * t.out.nx + gx] =
              cnew;
        }
      }
      fys = fy;
      cm1 = c0;
      bm1 = b0;
      c0 = cn1;
      b0 = bn1;
      c1 = c2;
      b1 = b2;
    }
    if (!last) {
      __syncthreads();
      t.x[0] = t.s[0];
      t.s[0] = cn;
    }
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
