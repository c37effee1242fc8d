// cache_probe_gather: set-associative probe of the hot-node feature cache,
// with the row gather fused in.  For every probe id r:
//   set  = (uint32(id) * K) >> shift            (shift 32 = single set)
//   way  = first j in [0, assoc) with keys[set * assoc + j] == id
//   hit[r] = way exists;  out[r, :] = rows[set * assoc + way, :] or zeros
// keys [C] int32 (-1 = empty slot), rows [C, D] float32/bfloat16,
// ids [R] int32, hit [R] bool, out [R, D].
//
// Replaces: src/repro/kernels/cache_gather.py::cache_probe_gather_pallas
// (the pallas_call at :107) — the local probe of feature_cache.cache_probe,
// which the W = 1 sharded (and replicated) cache runs on every fetch.
// Semantics follow the oracle, repro/kernels/ref.py::cache_probe_gather_ref:
// the FIRST matching way wins (the Pallas kernel lets the last one win; the
// two agree while cache_insert keeps ids unique per set).
//
// Bound on the H100: bytes — the [R, D] output plus the ids, the keys and
// the rows of the hits; no arithmetic to speak of.
//
// Design: the TPU kernel keeps the whole [C, block_d] row block in VMEM.
// That does not carry over (4096 x 128 x 4 B = 2 MB, against 227 KB of
// shared memory), and it need not: the cache is read through L2, which
// holds it whole (50 MB).  One warp owns one id.  Every lane hashes the id
// in uint32 and walks the ways (the key loads are warp-uniform, so they
// broadcast); then the 32 lanes copy the row — or write zeros — along D,
// so each row moves as coalesced 128-byte lines.  Eight warps per block.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // ids per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
probe_gather_kernel(const int32_t* __restrict__ keys, const T* __restrict__ rows,
                    const int32_t* __restrict__ ids, uint8_t* __restrict__ hit,
                    T* __restrict__ out, int64_t n_ids, int d_dim, int assoc,
                    int shift) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (r >= n_ids) return;
  const int32_t id = ids[r];
  const int64_t base = static_cast<int64_t>(repro::set_of(id, shift)) * assoc;
  int64_t slot = -1;
  for (int j = 0; j < assoc; ++j) {
    if (keys[base + j] == id) {
      slot = base + j;
      break;
    }
  }
  if (lane == 0) hit[r] = slot >= 0 ? 1 : 0;
  T* o = out + r * d_dim;
  if (slot >= 0) {
    const T* src = rows + slot * d_dim;
    for (int d = lane; d < d_dim; d += 32) o[d] = src[d];
  } else {
    const T zero = repro::from_float<T>(0.f);
    for (int d = lane; d < d_dim; d += 32) o[d] = zero;
  }
}

template <typename T>
void launch(const void* keys, const void* rows, const void* ids, void* hit,
            void* out, int64_t n_ids, int d_dim, int assoc, int shift,
            cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n_ids + kWarps - 1) / kWarps);
  probe_gather_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(keys), static_cast<const T*>(rows),
      static_cast<const int32_t*>(ids), static_cast<uint8_t*>(hit),
      static_cast<T*>(out), n_ids, d_dim, assoc, shift);
}

}  // namespace

extern "C" int repro_cache_probe_gather(const void* keys, const void* rows,
                                        const void* ids, void* hit, void* out,
                                        long long n_ids, int d_dim, int assoc,
                                        int shift, int dtype, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(keys, rows, ids, hit, out, n_ids, d_dim, assoc, shift, s);
  else
    launch<__nv_bfloat16>(keys, rows, ids, hit, out, n_ids, d_dim, assoc,
                          shift, s);
  return static_cast<int>(cudaGetLastError());
}
