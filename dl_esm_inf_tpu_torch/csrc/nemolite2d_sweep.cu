// NEMOLite2D temporal-blocked sweep: K whole time steps per pass over
// device memory, for one stacked (ny, nx) block of the flagship state.
//
// Replaces the TPU kernel dl_esm_inf_tpu/ops/pallas_step.py::
// make_fused_step, i.e. the generic sweep engine
// dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep instantiated with
// models/nemolite2d.py::step_math, on square and rectangular cells, with
// flat or variable bathymetry, and the same sweep with the halo exchange
// inside it (dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep with
// exchange_spec, the "fused" transport).
// It computes (sshn, un, vn, mask_code_i8[, ht], forcing[K]) -> (ssha, ua,
// va),
// operation for operation in the order of the plain PyTorch step
// (dl_esm_inf_tpu_torch/models/nemolite2d.py::step_math), so at float64
// the two agree to roundoff.  Build with --fmad=false: a contracted
// multiply-add rounds once where the plain version rounds twice.
//
// The step itself (window geometry, staging, the K sub-steps, the
// write-back) is nemolite2d_step.cuh, shared with the measurement
// variants of nemolite2d_variants.cu.  This file is the production
// kernel over it.  Rectangular cells are a runtime flag of the constants
// (nemolite2d_step.cuh: Cells).  Two template flags select the
// variants; with both off the kernel is the flat-depth sweep.
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
// Design (nemolite2d_step.cuh).  Each CTA owns a tile from the tile rule
// (64 columns at float32, 32 at float64; as many rows, up to 64, as let
// 4 CTAs share an SM at K <= 2 and 3 at K >= 3; 64 x 20 at float32 K=4)
// and stages it with a ring of 2K cells: 16-byte cp.async copies for the
// chunks inside the block, clamped scalar reads for those across its edge
// and for EXCH, so the kernel never reads outside the (ny, nx) block.  It
// then advances K sub-steps there (the valid region shrinks by 2 per
// sub-step): warps march up columns, 29 owned columns per warp, each face
// quantity computed once per point and sub-step and passed on by register
// or shuffle, the next state written to a second set of planes, one
// __syncthreads() per sub-step.  The last sub-step writes the tile to the
// output planes from the march.  Cells within 2K of the block edge hold
// finite but meaningless values, like the halo cells of the plain
// version; callers compare internal points.
//
// What bounds it.  At K = 4 the sweep moves 3 state planes in and out
// plus the code byte per point, about 25/4 B per point and step, so on
// an H100 (3.35 TB/s) the memory bound is well under a microsecond per
// step at 1024^2 (and there the block sits in the 50 MB L2): the kernel
// is bound by its instruction throughput, about 180 instructions per
// lane and row (the plain step's ~92 element operations, 9 shuffles, 4
// shared loads, 3 stores, the selects of the masks, the division's
// checks and the addressing), times the ring's redundant work (at f32
// K=4 a 64 x 20 tile's window is 80 x 36; the march covers the regions
// ~1.6 times over) and the 3 of 32 lanes that only feed their
// neighbours.  HT adds one read of the ht plane per sweep
// (4 B/pt at float32), one more shared plane (so a smaller tile) and the
// per-point face depths; EXCH adds no bytes, only the integer map of
// every staged state point and the scalar staging.
#include "nemolite2d_step.cuh"

namespace {

using nemo::Consts;

template <typename T, int K, bool HT, bool EXCH>
__global__ void __launch_bounds__(nemo::Geo<T, K, HT>::NT,
                                  nemo::Geo<T, K, HT>::CTAS)
nemo_sweep_kernel(const T* __restrict__ sshn_g, const T* __restrict__ un_g,
                  const T* __restrict__ vn_g,
                  const int8_t* __restrict__ code_g,
                  const T* __restrict__ ht_g, T* __restrict__ ssha_g,
                  T* __restrict__ ua_g, T* __restrict__ va_g, int ny,
                  int nx, const __grid_constant__ nemo::StepConsts<T> c,
                  HaloRemap m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nemo::Planes<T> s = nemo::carve<T, K, HT>(smem_raw);
  // with one sub-step the next-state planes are never read
  nemo::stage<T, K, HT, EXCH, (K > 1)>(s, sshn_g, un_g, vn_g, code_g, ht_g,
                                       ny, nx, m);
  __syncthreads();
  const nemo::Out<T> out{ssha_g, ua_g, va_g, ny, nx};
  nemo::substeps<T, K, HT, false, true>(s, c, out);
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
  using G = nemo::Geo<T, K, HT>;
  return nemo::launch<nemo_sweep_kernel<T, K, HT, EXCH>>(
      G::smem_bytes, nemo::tile_grid<G>(a.ny, a.nx), G::NT, stream,
      static_cast<const T*>(a.sshn), static_cast<const T*>(a.un),
      static_cast<const T*>(a.vn), static_cast<const int8_t*>(a.code),
      static_cast<const T*>(a.ht), static_cast<T*>(a.ssha),
      static_cast<T*>(a.ua), static_cast<T*>(a.va), a.ny, a.nx,
      nemo::working<T>(c), m);
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
int nemo_sweep_num_consts() { return nemo::kNumConsts; }

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
  Consts c;
  if (!nemo::read_consts(consts, n_consts, &c) || ny < 1 || nx < 1 ||
      n_remap != (exch ? kHaloRemapInts : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
