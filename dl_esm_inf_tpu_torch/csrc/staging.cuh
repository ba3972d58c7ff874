// Staging primitives shared by the flagship's step (nemolite2d_step.cuh)
// and the client sweeps' skeleton (stencil_sweep.cuh): the asynchronous
// global -> shared copies a window is staged with, the alignment test
// that decides between them and clamped scalar reads, and the launch of
// a kernel with a large dynamic shared-memory window.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace staging {

constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// 16-byte asynchronous copy global -> shared (bypassing L1), and the wait
// for all of this thread's copies.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4-byte asynchronous copy global -> shared (through L1: the .cg form
// takes 16 bytes only).
__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// Set a kernel's dynamic shared-memory ceiling once per device and
// instantiation, then launch it with `nt` threads per CTA on `stream`;
// returns cudaGetLastError() of the launch.
template <auto Kern, typename... Args>
cudaError_t launch(size_t smem, dim3 grid, int nt, cudaStream_t stream,
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
  Kern<<<grid, nt, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace staging
