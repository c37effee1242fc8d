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
// Bound on the H100: bytes — the ids, both key arrays, the distinct rows
// the hits need, the [R] src and the [R, D] output.  At the deep train
// step's inputs (graphgen-gcn-deep, batch 32: R = 32 + 480 + 4 800 +
// 24 000 = 29 312 slots after deduplication, 2 297 distinct ids, the
// slots past them all id 0; a 512-row 2-way L1 and a 4 096-row 4-way L2,
// D 128 float32) 783 rows hit and 28 529 miss: the 15.0 MB output is most
// of the 15.7 MB counted, 0.0047 ms at 3.35 TB/s.  A miss row is zeros and
// needs no load; the hit rows are read from the 50 MB L2 cache, where both
// tiers' 2.3 MB of rows live.  chip_smoke.py prints these counts.
//
// What the first version lost: one warp per id, so a serial chain of
// dependent trips (id, then the L1 ways one scalar load at a time, then on
// a miss the L2 ways) before the first row byte moved, and rows copied as
// 4-byte accesses in a loop over a run-time D.
//
// Design (the launch plan is cache_gather.py::tiered_plan): one lane per
// id, kIdsPerWarp = 8 ids a warp.  A warp loads its ids in one coalesced
// load; each lane hashes its id for both tiers and issues both tiers' key
// loads (repro::SetWays, one 4-byte load a way) before testing either,
// then decides the first matching way of each tier and L1-over-L2 in
// registers and writes src as one coalesced store.  Then the warp copies
// its rows together: the rows' 16-byte units (one per lane for a 512-byte
// float32 row, two rows per instruction in bfloat16) are walked 32 at a
// time, each lane reading its unit's row slot from the owning lane
// (__shfl_sync), kUnroll units' loads in flight before the first store; a
// miss row is zero stores with no load.  A row width that is not a
// multiple of 16 bytes, or a base off 16-byte alignment, takes the scalar
// instance of the same kernel (V = T).  One-warp CTAs (kWarps) spread
// evenly over the SMs (3 664 at the deep step, ~28 an SM: one wave).
//
// Measured at the deep step's inputs (scripts/bwd_tiered_variants.py, in
// turns on an H100 80GB HBM3 at 700 W, device duration; PERF.md): 0.0058
// ms against 0.0076 for the first version and 0.0046 for a zero_() of the
// output alone; the kernel's stores alone (no loads) take 0.0050-0.0053
// at 8-32 ids a warp.  Tried and not kept (at 16 ids a warp unless
// stated): 16 ids (0.0060) or 32 (0.0064); CTAs of 2-4 warps (0.0060-
// 0.0061); 4 or 16 units in flight (0.0062 / 0.0060; 16 takes 60-90
// registers, and spilled in the scalar instances beside a set-wide key
// load); every row zeroed while the keys are in flight, then the hits
// written (no faster, 0.0004 ms slower at 32 ids); streaming stores
// (0.0059, within noise); a 2-way L1 set as one 8-byte load and a 4-way
// L2 set as one 16-byte load (0.0059-0.0062, within noise).
#include "common.cuh"

namespace {

constexpr int kIdsPerWarp = 8;   // ids one warp probes, one a lane
constexpr int kWarps = 1;        // warps per CTA
constexpr int kUnroll = 8;       // row units per lane in flight

template <typename V>
__device__ __forceinline__ V zero_unit();
template <>
__device__ __forceinline__ int4 zero_unit<int4>() { return make_int4(0, 0, 0, 0); }
template <>
__device__ __forceinline__ float zero_unit<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_unit<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
probe_tiered_kernel(const int32_t* __restrict__ l1_keys,
                    const V* __restrict__ l1_rows,
                    const int32_t* __restrict__ l2_keys,
                    const V* __restrict__ l2_rows,
                    const int32_t* __restrict__ ids, int32_t* __restrict__ src,
                    V* __restrict__ out, int64_t n_ids, int row_vecs,
                    int l1_assoc, int l1_shift, int l2_assoc, int l2_shift) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kIdsPerWarp;
  if (base >= n_ids) return;  // warp-uniform
  const int n = static_cast<int>(
      min(static_cast<int64_t>(kIdsPerWarp), n_ids - base));
  const bool live = lane < n;

  // probe: one lane per id, both tiers' key loads issued before either test
  const int32_t id = live ? ids[base + lane] : 0;
  const uint32_t set1 = repro::set_of(id, l1_shift);
  const uint32_t set2 = repro::set_of(id, l2_shift);
  repro::SetWays s1, s2;
  s1.load(l1_keys, set1, l1_assoc);
  s2.load(l2_keys, set2, l2_assoc);

  const int w1 = s1.first(id, l1_assoc);
  const int w2 = s2.first(id, l2_assoc);
  // the row to copy: -1 for zeros, else slot * 2 + (1 for the L2)
  int code = -1;
  if (w1 >= 0)
    code = static_cast<int>(set1 * l1_assoc + w1) * 2;
  else if (w2 >= 0)
    code = static_cast<int>(set2 * l2_assoc + w2) * 2 + 1;
  if (live) src[base + lane] = w1 >= 0 ? 1 : (w2 >= 0 ? 2 : 0);

  // rows: the warp's n rows are n * row_vecs consecutive output units;
  // lane takes units lane, lane + 32, ...: unit u is column c of row j,
  // whose slot comes from lane j
  const int total = n * row_vecs;
  V* o = out + base * row_vecs + lane;
  const V zero = zero_unit<V>();
  const int dj = 32 / row_vecs, dc = 32 % row_vecs;
  int j = lane / row_vecs, c = lane % row_vecs;
  for (int u0 = 0; u0 < total; u0 += 32 * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int row = __shfl_sync(0xffffffffu, code, j & 31);
      buf[q] = zero;
      if (u0 + q * 32 + lane < total && row >= 0) {
        const V* rows = (row & 1) ? l2_rows : l1_rows;
        buf[q] = __ldg(rows + static_cast<int64_t>(row >> 1) * row_vecs + c);
      }
      j += dj;
      c += dc;
      if (c >= row_vecs) {
        c -= row_vecs;
        ++j;
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (u0 + q * 32 + lane < total) o[u0 + q * 32] = buf[q];
  }
}

template <typename V>
void launch(const void* l1_keys, const void* l1_rows, const void* l2_keys,
            const void* l2_rows, const void* ids, void* src, void* out,
            int64_t n_ids, int row_vecs, int l1_assoc, int l1_shift,
            int l2_assoc, int l2_shift, int grid, cudaStream_t stream) {
  probe_tiered_kernel<V><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(l1_keys), static_cast<const V*>(l1_rows),
      static_cast<const int32_t*>(l2_keys), static_cast<const V*>(l2_rows),
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(src),
      static_cast<V*>(out), n_ids, row_vecs, l1_assoc, l1_shift, l2_assoc,
      l2_shift);
}

}  // namespace

// vec and grid are the wrapper's launch plan (cache_gather.py::
// tiered_plan): vec is the elements of one row unit (16 bytes' worth, or
// 1); the grid covers the ids at kIdsPerWarp * kWarps a CTA.
extern "C" int repro_cache_probe_tiered(const void* l1_keys, const void* l1_rows,
                                        const void* l2_keys, const void* l2_rows,
                                        const void* ids, void* src, void* out,
                                        long long n_ids, int d_dim,
                                        int l1_assoc, int l1_shift,
                                        int l2_assoc, int l2_shift, int dtype,
                                        int vec, int grid, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == repro::kF32 ? 4 : 2;
  if (vec < 1 || (vec != 1 && vec * elem != 16) || d_dim % vec != 0 ||
      d_dim < 1 || l1_assoc < 1 || l1_assoc > repro::kMaxAssoc ||
      l2_assoc < 1 || l2_assoc > repro::kMaxAssoc ||
      static_cast<int64_t>(grid) * kWarps * kIdsPerWarp < n_ids)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_vecs = d_dim / vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 1)
    launch<int4>(l1_keys, l1_rows, l2_keys, l2_rows, ids, src, out, n_ids,
                 row_vecs, l1_assoc, l1_shift, l2_assoc, l2_shift, grid, s);
  else if (dtype == repro::kF32)
    launch<float>(l1_keys, l1_rows, l2_keys, l2_rows, ids, src, out, n_ids,
                  row_vecs, l1_assoc, l1_shift, l2_assoc, l2_shift, grid, s);
  else
    launch<__nv_bfloat16>(l1_keys, l1_rows, l2_keys, l2_rows, ids, src, out,
                          n_ids, row_vecs, l1_assoc, l1_shift, l2_assoc,
                          l2_shift, grid, s);
  return static_cast<int>(cudaGetLastError());
}
