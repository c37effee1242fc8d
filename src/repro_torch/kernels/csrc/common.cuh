// Shared helpers of the port's kernels: element conversions, the load
// unit of a row (16 bytes or one element), the cache set hash and the set
// probe.  The hash must stay bit-compatible with
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

// Largest associativity a cache may have (core/config.py VALID_CACHE_ASSOC).
constexpr int kMaxAssoc = 4;

// The ways of one cache set (any associativity up to kMaxAssoc, given at
// run time), each a 4-byte load, all issued before any is tested, so that a
// probe of several tiers has every tier's key loads in flight at once.
// first() is the first way whose key equals id, or -1 (an id of -1 matches
// an empty way).
struct SetWays {
  int32_t key[kMaxAssoc];

  __device__ __forceinline__ void load(const int32_t* __restrict__ keys,
                                       uint32_t set, int assoc) {
    const int32_t* p = keys + static_cast<int64_t>(set) * assoc;
#pragma unroll
    for (int j = 0; j < kMaxAssoc; ++j) key[j] = j < assoc ? __ldg(p + j) : 0;
  }

  __device__ __forceinline__ int first(int32_t id, int assoc) const {
    int way = -1;
#pragma unroll
    for (int j = kMaxAssoc - 1; j >= 0; --j)
      if (j < assoc && key[j] == id) way = j;
    return way;
  }
};

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

// The float32 view of one load unit V of elements T (int4: 16 bytes, or T
// itself on the scalar route): E elements, added into E sums, and packed
// back after the division.
template <typename T, typename V>
struct Unit;

template <>
struct Unit<float, int4> {
  static constexpr int E = 4;
  __device__ static void add(float* acc, const int4& v, float w) {
    const float4 f = reinterpret_cast<const float4&>(v);
    acc[0] += f.x * w;
    acc[1] += f.y * w;
    acc[2] += f.z * w;
    acc[3] += f.w * w;
  }
  __device__ static int4 pack(const float* a) {
    const float4 f = make_float4(a[0], a[1], a[2], a[3]);
    return reinterpret_cast<const int4&>(f);
  }
};

template <>
struct Unit<__nv_bfloat16, int4> {
  static constexpr int E = 8;
  __device__ static void add(float* acc, const int4& v, float w) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      acc[2 * i] += f.x * w;
      acc[2 * i + 1] += f.y * w;
    }
  }
  __device__ static int4 pack(const float* a) {
    int4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    return v;
  }
};

template <typename T>
struct Unit<T, T> {
  static constexpr int E = 1;
  __device__ static void add(float* acc, const T& v, float w) {
    acc[0] += to_float(v) * w;
  }
  __device__ static T pack(const float* a) { return from_float<T>(a[0]); }
};

// dtype codes shared with the ctypes wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace repro
