// cache_probe_tiered: the fused two-tier probe of the tiered hot-node cache,
// with the row gather fused in.  For every probe id r:
//   way1 = first j in [0, l1_assoc) with l1_keys[set1 * l1_assoc + j] == id
//   way2 = first j in [0, l2_assoc) with l2_keys[set2 * l2_assoc + j] == id
//   src[r] = 1 if way1 exists, else 2 if way2 exists, else 0
//   out[r, :] = the serving tier's row, zeros on a miss
// where set = (uint32(id) * K) >> shift per tier (shift 32 = single set).
// l1_keys [C1] / l2_keys [C2] int32 (-1 = empty slot), l1_rows [C1, D] /
// l2_rows [C2, D] float32/bfloat16, ids [R] int32, src [R] int32,
// out [R, D].
//
// Replaces: src/repro/kernels/cache_gather.py::cache_probe_tiered_pallas
// (the pallas_call at :316) — feature_cache.tiered_probe, the W = 1 probe of
// the tiered cache that graphgen-gcn-deep trains and serves with.
// Semantics follow the oracle, repro/kernels/ref.py::cache_probe_tiered_ref:
// the FIRST matching way of a tier wins (the Pallas kernel lets the last
// one win; they agree while cache_insert keeps ids unique per set), the L1
// wins a double hit, and an id of -1 matches an empty slot exactly as in
// the oracle (tiered_probe's valid mask removes those hits).
//
// Bound on the H100: bytes — the ids, both key arrays, the rows of the
// hits and the [R] src and [R, D] outputs; no arithmetic to speak of.
//
// Design: the TPU kernel keeps both key arrays and a column block of both
// row tables in VMEM.  At graphgen-gcn-deep's sizes the L2 rows are
// 4096 x 128 x 4 B = 2 MB and the L1 rows 256 KB: neither fits 227 KB of
// shared memory, and both fit the 50 MB L2 cache, which is where they are
// read from.  One warp owns one id.  Every lane hashes the id in uint32 for
// both tiers and walks the L1 ways, then (on an L1 miss) the L2 ways; the
// key loads are warp-uniform, so they broadcast.  Then the 32 lanes copy
// the serving tier's row — or write zeros — along D, so each row moves as
// coalesced 128-byte lines.  Eight warps per block.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // ids per block

__device__ __forceinline__ int64_t first_way(const int32_t* __restrict__ keys,
                                             int32_t id, int shift, int assoc) {
  const int64_t base = static_cast<int64_t>(repro::set_of(id, shift)) * assoc;
  for (int j = 0; j < assoc; ++j)
    if (keys[base + j] == id) return base + j;
  return -1;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
probe_tiered_kernel(const int32_t* __restrict__ l1_keys,
                    const T* __restrict__ l1_rows,
                    const int32_t* __restrict__ l2_keys,
                    const T* __restrict__ l2_rows,
                    const int32_t* __restrict__ ids, int32_t* __restrict__ src,
                    T* __restrict__ out, int64_t n_ids, int d_dim,
                    int l1_assoc, int l1_shift, int l2_assoc, int l2_shift) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (r >= n_ids) return;
  const int32_t id = ids[r];
  const T* row = nullptr;
  int tier = 0;
  int64_t slot = first_way(l1_keys, id, l1_shift, l1_assoc);
  if (slot >= 0) {
    tier = 1;
    row = l1_rows + slot * d_dim;
  } else {
    slot = first_way(l2_keys, id, l2_shift, l2_assoc);
    if (slot >= 0) {
      tier = 2;
      row = l2_rows + slot * d_dim;
    }
  }
  if (lane == 0) src[r] = tier;
  T* o = out + r * d_dim;
  if (row != nullptr) {
    for (int d = lane; d < d_dim; d += 32) o[d] = row[d];
  } else {
    const T zero = repro::from_float<T>(0.f);
    for (int d = lane; d < d_dim; d += 32) o[d] = zero;
  }
}

template <typename T>
void launch(const void* l1_keys, const void* l1_rows, const void* l2_keys,
            const void* l2_rows, const void* ids, void* src, void* out,
            int64_t n_ids, int d_dim, int l1_assoc, int l1_shift, int l2_assoc,
            int l2_shift, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n_ids + kWarps - 1) / kWarps);
  probe_tiered_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(l1_keys), static_cast<const T*>(l1_rows),
      static_cast<const int32_t*>(l2_keys), static_cast<const T*>(l2_rows),
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(src),
      static_cast<T*>(out), n_ids, d_dim, l1_assoc, l1_shift, l2_assoc,
      l2_shift);
}

}  // namespace

extern "C" int repro_cache_probe_tiered(const void* l1_keys, const void* l1_rows,
                                        const void* l2_keys, const void* l2_rows,
                                        const void* ids, void* src, void* out,
                                        long long n_ids, int d_dim,
                                        int l1_assoc, int l1_shift,
                                        int l2_assoc, int l2_shift, int dtype,
                                        void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(l1_keys, l1_rows, l2_keys, l2_rows, ids, src, out, n_ids,
                  d_dim, l1_assoc, l1_shift, l2_assoc, l2_shift, s);
  else
    launch<__nv_bfloat16>(l1_keys, l1_rows, l2_keys, l2_rows, ids, src, out,
                          n_ids, d_dim, l1_assoc, l1_shift, l2_assoc,
                          l2_shift, s);
  return static_cast<int>(cudaGetLastError());
}
