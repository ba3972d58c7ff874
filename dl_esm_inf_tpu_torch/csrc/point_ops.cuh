// Device twins of the PyTorch elementwise operations that the point bodies
// derived from torch bodies (dl_esm_inf_tpu_torch/ops/point_trace.py) call
// by name: each evaluates as PyTorch's CUDA kernel does, NaN handling
// included, so a derived body equals the plain fused tier bitwise.
// Arithmetic, comparisons, casts, where and sqrt are written inline by
// the printer; the sweep is built with --fmad=false.
#pragma once

#include <cuda_runtime.h>

namespace pt {

// torch.clamp(v, min=lo, max=hi), clamp_min, clamp_max with scalar bounds
template <typename V>
__device__ __forceinline__ V clamp(V v, V lo, V hi) {
  return v != v ? v : ::min(::max(v, lo), hi);
}
template <typename V>
__device__ __forceinline__ V clamp_min(V v, V lo) {
  return v != v ? v : ::max(v, lo);
}
template <typename V>
__device__ __forceinline__ V clamp_max(V v, V hi) {
  return v != v ? v : ::min(v, hi);
}

// torch.minimum / torch.maximum: a NaN operand wins
template <typename V>
__device__ __forceinline__ V minimum(V a, V b) {
  return a != a ? a : (b != b ? b : ::min(a, b));
}
template <typename V>
__device__ __forceinline__ V maximum(V a, V b) {
  return a != a ? a : (b != b ? b : ::max(a, b));
}

__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ int abs_(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ long long abs_(long long x) { return x < 0 ? -x : x; }

}  // namespace pt
