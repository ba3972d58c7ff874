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
// Both variants use the production geometry, staging and write-back
// (nemolite2d_step.cuh: a 32 x 32 tile, a ring of 2K cells, reads clamped
// to the block), flat depth, no exchange, so what they leave out is all
// they differ by.
//
//  * dma stages the windows of sshn, un, vn and the int8 code, runs the
//    production sub-step structure K times (three __syncthreads() per
//    sub-step, the ssha scratch plane swapped with the surface) with
//    x = x + f_k on the three state planes over the whole window as the
//    body, and writes the tile back: sshn + f_0 + ... + f_{K-1}, summed in
//    that order, and the same for un and vn.  Each point's code is read
//    and compared with 127, a value the 6-bit codes never take, so the
//    compiler keeps the code plane's loads and the variant moves the bytes
//    production moves (25 B per point and sweep at float32).
//  * compute stages once, then runs the production K sub-steps (the
//    shrinking update regions included) `reps` times on the resident
//    window, each pass feeding its output back into the window, and
//    writes the tile back once.  The scratch plane starts as a copy of the
//    surface, so every later pass reads defined values in the ring.  The
//    time per step is the slope over two `reps` divided by K, which
//    cancels the one staging and write-back.  The reps loop is not
//    unrolled and its body is not loop-invariant: the TPU microbench
//    measured an impossible floor when it was (scripts/kbench.py:100-105).
//    With reps = 1 the output equals production bitwise on every cell.
//  * compute_fast is compute with the two 1/dep divisions done as the
//    JAX package's _recip_fast does them: rcp.approx.ftz.f32 and one
//    Newton step r * (2 - x * r).  Float only.
//
// What bounds them.  dma moves the production sweep's bytes and does one
// add per plane and point per sub-step: it is bound by memory, 25 B per
// point and sweep at float32 over 3.35 TB/s.  compute moves no bytes per
// pass; it is bound by the step's arithmetic (about 92 element
// operations per point and step) and, as production, by the ring's
// redundant work and shared-memory latency.
#include "nemolite2d_step.cuh"

namespace {

using nemo::Consts;

template <typename T, int K>
__global__ void __launch_bounds__(nemo::NT)
nemo_dma_kernel(const T* __restrict__ sshn_g, const T* __restrict__ un_g,
                const T* __restrict__ vn_g,
                const int8_t* __restrict__ code_g, T* __restrict__ ssha_g,
                T* __restrict__ ua_g, T* __restrict__ va_g, int ny, int nx,
                Consts c) {
  using W = nemo::Window<T, K, false>;
  constexpr int WC = W::WC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nemo::Planes<T> s = nemo::carve<T, K, false>(smem_raw);
  nemo::stage<T, K, false, false>(s, sshn_g, un_g, vn_g, code_g, nullptr,
                                  ny, nx, HaloRemap{});
  __syncthreads();
  const int tid = threadIdx.x;
  const T zero = static_cast<T>(0);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T f = static_cast<T>(c.forcing[k]);
    for (int idx = tid; idx < WC; idx += nemo::NT) {
      s.a[idx] = s.code[idx] == 127 ? zero : s.ssh[idx] + f;
    }
    __syncthreads();
    T ua[W::CPT], va[W::CPT];
#pragma unroll
    for (int q = 0; q < W::CPT; ++q) {
      const int idx = tid + q * nemo::NT;
      ua[q] = zero;
      va[q] = zero;
      if (idx >= WC) continue;
      const bool never = s.code[idx] == 127;
      ua[q] = never ? zero : s.u[idx] + f;
      va[q] = never ? zero : s.v[idx] + f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < W::CPT; ++q) {
      const int idx = tid + q * nemo::NT;
      if (idx >= WC) continue;
      s.u[idx] = ua[q];
      s.v[idx] = va[q];
    }
    T* t = s.ssh;
    s.ssh = s.a;
    s.a = t;
    __syncthreads();
  }
  nemo::write_back<T, K, false>(s, ssha_g, ua_g, va_g, ny, nx);
}

template <typename T, int K, bool FAST>
__global__ void __launch_bounds__(nemo::NT)
nemo_compute_kernel(const T* __restrict__ sshn_g,
                    const T* __restrict__ un_g, const T* __restrict__ vn_g,
                    const int8_t* __restrict__ code_g,
                    T* __restrict__ ssha_g, T* __restrict__ ua_g,
                    T* __restrict__ va_g, int ny, int nx, Consts c,
                    int reps) {
  constexpr int WC = nemo::Window<T, K, false>::WC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nemo::Planes<T> s = nemo::carve<T, K, false>(smem_raw);
  nemo::stage<T, K, false, false>(s, sshn_g, un_g, vn_g, code_g, nullptr,
                                  ny, nx, HaloRemap{});
  // each thread copies the points it staged itself
  for (int idx = threadIdx.x; idx < WC; idx += nemo::NT) s.a[idx] = s.ssh[idx];
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) nemo::substeps<T, K, false, FAST>(s, c);
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
  constexpr size_t smem = nemo::Window<T, K, false>::smem_bytes;
  const dim3 grid = nemo::tile_grid(a.ny, a.nx);
  const T* sshn = static_cast<const T*>(a.sshn);
  const T* un = static_cast<const T*>(a.un);
  const T* vn = static_cast<const T*>(a.vn);
  const int8_t* code = static_cast<const int8_t*>(a.code);
  T* ssha = static_cast<T*>(a.ssha);
  T* ua = static_cast<T*>(a.ua);
  T* va = static_cast<T*>(a.va);
  if (mode == kDma) {
    return nemo::launch<nemo_dma_kernel<T, K>>(smem, grid, s, sshn, un, vn,
                                               code, ssha, ua, va, a.ny,
                                               a.nx, c);
  }
  if (mode == kCompute) {
    return nemo::launch<nemo_compute_kernel<T, K, false>>(
        smem, grid, s, sshn, un, vn, code, ssha, ua, va, a.ny, a.nx, c,
        a.reps);
  }
  if constexpr (sizeof(T) == 4) {
    if (mode == kComputeFast) {
      return nemo::launch<nemo_compute_kernel<T, K, true>>(
          smem, grid, s, sshn, un, vn, code, ssha, ua, va, a.ny, a.nx, c,
          a.reps);
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
