// Shared helpers of the port's kernels: element conversions and the cache
// set hash.  The hash must stay bit-compatible with
// repro_torch/core/feature_cache.py::hash_slots (and so with
// repro/core/feature_cache.py::hash_slots): set = (uint32(id) * K) >> shift,
// where shift = 32 - log2(n_sets), and a single-set cache (shift == 32)
// maps every id to set 0 instead of shifting by the full word width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr uint32_t kHashK = 2654435761u;  // Knuth multiplicative constant

__device__ __forceinline__ uint32_t set_of(int32_t id, int shift) {
  if (shift >= 32) return 0u;
  return (static_cast<uint32_t>(id) * kHashK) >> shift;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// dtype codes shared with the ctypes wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace repro
