// Measurement variants of the NEMOLite2D sweep: the two floors of one
// production sweep (nemolite2d_sweep.cu), taken apart.
//
// Replaces the TPU kernel scripts/kbench.py::make_variant (the JAX
// package's kernel-variant microbench) in its measuring modes:
//  * dma: the same loads and stores as production, with a copy for the
//    compute (kbench: "same DMA structure, compute = copy");
//  * compute and compute_fast: the production step on a resident window,
//    with no HBM traffic per pass (kbench: "step_math on a resident VMEM
//    window, no DMA"), with the exact or the approximate reciprocal.
// Its modes full and unroll are the production step in two TPU pipeline
// schedules: on the card that is the production kernel itself.
//
// Both variants use the production tile rule and staging
// (nemolite2d_step.cuh: the tile from the shared-memory budget, a ring of
// 2K cells, 16-byte cp.async copies for the chunks inside the block and
// clamped scalar reads for those across its edge), flat depth, no
// exchange, so what they leave out is all they differ by.
//
//  * dma stages the windows of sshn, un, vn and the int8 code, runs the
//    production sub-step structure (one __syncthreads() per sub-step, the
//    state and next-state planes swapped) with x = x + f_k on the three
//    state planes over the whole window as the body, the last sub-step on
//    the tile alone and written out, as production's last sub-step is
//    (16 bytes per thread where the rows allow): sshn + f_0 + ... +
//    f_{K-1}, summed in that order, and the same for un and vn.  Each
//    point's code is read and compared with 127, a value the 6-bit codes
//    never take, so the code plane's bytes are used as production uses
//    them; the variant moves the bytes production moves (25 B per point
//    and sweep at float32 and the ring's), through the same copies.
//  * compute stages once, then runs the production K sub-steps (the
//    shrinking update regions and the swap of state and next-state planes
//    included) `reps` times on the resident window, each pass feeding its
//    output back into the window, and writes the tile back once from
//    shared memory (16 bytes per store).  The next-state planes start as
//    copies of the state, so every later pass reads defined values in the
//    ring.  The time per step is the slope over two `reps` divided by K,
//    which cancels the one staging and write-back.  The reps loop is not
//    unrolled and its body is not loop-invariant: the TPU microbench
//    measured an impossible floor when it was (scripts/kbench.py:100-105).
//    With reps = 1 the output equals production bitwise on every cell.
//  * compute_fast is compute with the two 1/dep divisions done as the
//    JAX package's _recip_fast does them: rcp.approx.ftz.f32 and one
//    Newton step r * (2 - x * r).  Float only.
//
// What bounds them.  dma moves the production sweep's bytes and does one
// add per plane and point per sub-step: it is bound by memory, 25 B per
// point and sweep at float32 over 3.35 TB/s (at 1024^2 the block sits in
// the 50 MB L2, so the bound is no floor there; and the staging, the
// body and the stores of the CTAs sharing an SM run mostly in step, so
// they overlap little).  compute moves no bytes per pass; it is bound by
// the throughput of the step's instructions (about 92 element operations
// per point and step, ~180 instructions per lane and row with the
// shuffles, shared accesses and addressing of the march) and, as
// production, by the ring's redundant work.
#include "nemolite2d_step.cuh"

namespace {

using nemo::Consts;

template <typename T, int K>
__global__ void __launch_bounds__(nemo::Geo<T, K, false>::NT,
                                  nemo::Geo<T, K, false>::CTAS)
nemo_dma_kernel(const T* __restrict__ sshn_g, const T* __restrict__ un_g,
                const T* __restrict__ vn_g,
                const int8_t* __restrict__ code_g, T* __restrict__ ssha_g,
                T* __restrict__ ua_g, T* __restrict__ va_g, int ny, int nx,
                const __grid_constant__ nemo::StepConsts<T> c) {
  using G = nemo::Geo<T, K, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nemo::Planes<T> s = nemo::carve<T, K, false>(smem_raw);
  // the body writes every window point, so the scratch planes need no copy
  nemo::stage<T, K, false, false, false>(s, sshn_g, un_g, vn_g, code_g,
                                         nullptr, ny, nx, HaloRemap{});
  __syncthreads();
  const T zero = static_cast<T>(0);
  constexpr int P = G::P;
#pragma unroll 1
  for (int k = 0; k < K - 1; ++k) {
    const T f = c.forcing[k];
    for (int idx = threadIdx.x; idx < G::WY * G::WX; idx += G::NT) {
      const int w = idx / G::WX, x = idx - w * G::WX;
      const int i = w * G::PX + G::OFF + x;
      const bool never = s.code[w * G::PC + G::OFFC + x] == 127;
      for (int p = 0; p < 3; ++p) {
        s.nxt[p * P + i] = never ? zero : s.cur[p * P + i] + f;
      }
    }
    __syncthreads();
    T* t = s.cur;
    s.cur = s.nxt;
    s.nxt = t;
  }
  // the last sub-step on the tile alone, written out as production's last
  // sub-step is: 16 bytes per thread where the block's rows allow
  const T f = c.forcing[K - 1];
  T* const outs[3] = {ssha_g, ua_g, va_g};
  const int gy0 = blockIdx.y * G::TY, gx0 = blockIdx.x * G::TX;
  constexpr int C0 = G::OFF + G::R, CC0 = G::OFFC + G::R, V = G::V;
  if ((nx % V) == 0 && nemo::aligned16(ssha_g) && nemo::aligned16(ua_g) &&
      nemo::aligned16(va_g)) {
    constexpr int CH = G::TX / V;
    for (int idx = threadIdx.x; idx < G::TY * CH; idx += G::NT) {
      const int ty = idx / CH, j = idx - ty * CH;
      const int gy = gy0 + ty, gx = gx0 + j * V;
      if (gy >= ny || gx >= nx) continue;
      const int i = (ty + G::R) * G::PX + C0 + j * V;
      const int8_t* cd = s.code + (ty + G::R) * G::PC + CC0 + j * V;
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      for (int p = 0; p < 3; ++p) {
        alignas(16) T x[V];
        *reinterpret_cast<uint4*>(x) =
            *reinterpret_cast<const uint4*>(s.cur + p * P + i);
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = cd[e] == 127 ? zero : x[e] + f;
        *reinterpret_cast<uint4*>(outs[p] + g) =
            *reinterpret_cast<const uint4*>(x);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < G::TY * G::TX; idx += G::NT) {
      const int ty = idx / G::TX, tx = idx - ty * G::TX;
      const int gy = gy0 + ty, gx = gx0 + tx;
      if (gy >= ny || gx >= nx) continue;
      const int i = (ty + G::R) * G::PX + C0 + tx;
      const bool never = s.code[(ty + G::R) * G::PC + CC0 + tx] == 127;
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      for (int p = 0; p < 3; ++p) {
        outs[p][g] = never ? zero : s.cur[p * P + i] + f;
      }
    }
  }
}

template <typename T, int K, bool FAST>
__global__ void __launch_bounds__(nemo::Geo<T, K, false>::NT,
                                  nemo::Geo<T, K, false>::CTAS)
nemo_compute_kernel(const T* __restrict__ sshn_g,
                    const T* __restrict__ un_g, const T* __restrict__ vn_g,
                    const int8_t* __restrict__ code_g,
                    T* __restrict__ ssha_g, T* __restrict__ ua_g,
                    T* __restrict__ va_g, int ny, int nx,
                    const __grid_constant__ nemo::StepConsts<T> c, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nemo::Planes<T> s = nemo::carve<T, K, false>(smem_raw);
  nemo::stage<T, K, false, false, true>(s, sshn_g, un_g, vn_g, code_g,
                                        nullptr, ny, nx, HaloRemap{});
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    nemo::substeps<T, K, false, FAST, false>(s, c, nemo::Out<T>{});
  }
  nemo::write_back<T, K, false>(s, ssha_g, ua_g, va_g, ny, nx);
}

enum Mode { kDma = 0, kCompute = 1, kComputeFast = 2 };

struct Args {
  const void *sshn, *un, *vn, *code;
  void *ssha, *ua, *va;
  int ny, nx, reps;
};

template <typename T, int K>
cudaError_t launch_mode(int mode, const Args& a, const Consts& c,
                        cudaStream_t s) {
  using G = nemo::Geo<T, K, false>;
  constexpr size_t smem = G::smem_bytes;
  const dim3 grid = nemo::tile_grid<G>(a.ny, a.nx);
  const T* sshn = static_cast<const T*>(a.sshn);
  const T* un = static_cast<const T*>(a.un);
  const T* vn = static_cast<const T*>(a.vn);
  const int8_t* code = static_cast<const int8_t*>(a.code);
  const nemo::StepConsts<T> ct = nemo::working<T>(c);
  T* ssha = static_cast<T*>(a.ssha);
  T* ua = static_cast<T*>(a.ua);
  T* va = static_cast<T*>(a.va);
  if (mode == kDma) {
    return nemo::launch<nemo_dma_kernel<T, K>>(smem, grid, G::NT, s, sshn,
                                               un, vn, code, ssha, ua, va,
                                               a.ny, a.nx, ct);
  }
  if (mode == kCompute) {
    return nemo::launch<nemo_compute_kernel<T, K, false>>(
        smem, grid, G::NT, s, sshn, un, vn, code, ssha, ua, va, a.ny, a.nx,
        ct, a.reps);
  }
  if constexpr (sizeof(T) == 4) {
    if (mode == kComputeFast) {
      return nemo::launch<nemo_compute_kernel<T, K, true>>(
          smem, grid, G::NT, s, sshn, un, vn, code, ssha, ua, va, a.ny,
          a.nx, ct, a.reps);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_k(int K, int mode, const Args& a, const Consts& c,
                       cudaStream_t s) {
  switch (K) {
    case 1: return launch_mode<T, 1>(mode, a, c, s);
    case 2: return launch_mode<T, 2>(mode, a, c, s);
    case 3: return launch_mode<T, 3>(mode, a, c, s);
    case 4: return launch_mode<T, 4>(mode, a, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of doubles nemo_variant_launch expects in `consts` (the
// production sweep's constants).
int nemo_variant_num_consts() { return nemo::kNumConsts; }

// mode: 0 = dma, 1 = compute, 2 = compute_fast (float32 only);
// dtype_code: 0 = float32, 1 = float64.  All pointers are device
// pointers of contiguous (ny, nx) planes except `consts` (host memory,
// read before the launch returns).  `reps` (>= 1) is the number of
// passes of the compute modes; dma takes 1.  Launches on `stream`
// without synchronising and returns cudaGetLastError() of the launch.
int nemo_variant_launch(int mode, int dtype_code, int K, const void* sshn,
                        const void* un, const void* vn, const void* code,
                        void* ssha, void* ua, void* va, int ny, int nx,
                        const double* consts, int n_consts, int reps,
                        void* stream) {
  Consts c;
  if (!nemo::read_consts(consts, n_consts, &c) || ny < 1 || nx < 1 ||
      reps < 1 || (mode == kDma && reps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{sshn, un, vn, code, ssha, ua, va, ny, nx, reps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = dispatch_k<float>(K, mode, a, c, s);
  } else if (dtype_code == 1) {
    err = dispatch_k<double>(K, mode, a, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
