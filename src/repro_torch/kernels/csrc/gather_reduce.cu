// gather_reduce: row gather fused with the masked mean over the fanout,
//   out[m, d] = sum_k mask[m, k] * table[clamp(idx[m, k], 0, N - 1), d]
//               / max(sum_k mask[m, k], 1)
// with table [N, D] (float32 or bfloat16), idx [M, K] int32, mask [M, K]
// (bool), out [M, D] in the table's dtype, accumulated in float32.
//
// Replaces: src/repro/kernels/gather_reduce.py::gather_reduce_pallas (the
// pallas_call at :104), the reference's public ops.gather_reduce (the
// per-worker hot spot of edge-centric collection plus aggregation).  No
// model of either package calls it.
//
// Bound on the H100: bytes.  Each kept slot's row element is one add, ~0.25
// FLOP a byte.  Counted as the distinct kept rows read once from HBM, with
// the ids, the mask and the output: at a graphgen-gcn bucket-32 request's
// hop-2 level (table (20000, 128) float32, M 1280, K 20) ~3 MB, 0.0009 ms
// at 3.35 TB/s.  The kernel has to read every kept slot's row, ~13 MB
// there; the 10 MB table stays in the 50 MB L2, so what sets its time is
// L2's rate and the round trips to it, not HBM.
//
// What the first version lost: one thread per (row, d) output walked K in
// a serial loop; each turn loaded the mask byte, branched, loaded the id,
// and only then issued one 4-byte table load, ~20 dependent trips to L2 a
// thread (0.0071-0.0073 ms by device duration at the shape above, 12% of
// the bound).
//
// Design (the launch plan is gather_reduce.py::gather_reduce_plan): a warp
// owns one (output row m, share of K), named by its thread coordinates (a
// CTA is 32 x ways x rows threads; no division).  In one round trip its
// lanes load the share's ids and mask bytes (a coalesced access each, up
// to 32 slots a pass) and the row's mask bytes for the count;
// __ballot_sync and __popc give the kept slots and the count (each warp
// counts its whole row, so warps exchange no count).  Lanes run along D
// with 16-byte loads (4 float32 or 8 bfloat16 a lane): a row is `lanes`
// threads, and a warp holds 32 / lanes slot groups.  Group g takes the
// pass's slots g, g + groups, ..., each id handed over by __shfl_sync, and
// issues the row loads of the kept ones, up to kUnroll (__ldg), before its
// first add.  The plan splits K over warps so that a share fits one batch
// of loads, and further until the grid holds about two CTAs per SM; the
// warps' float32 partial sums meet in shared memory and are added in
// (share, group) order by the row's first group, so the result is the
// same from run to run; then one division and one rounding to the table's
// dtype.  A masked slot reads no row.  Rows that are not a 16-byte
// multiple, or a base off 16-byte alignment, take the scalar instance of
// the kernel (V = T).
//
// Measured (scripts/gather_variants.py, in turns on an H100 80GB HBM3 at
// 700 W, device duration; PERF.md): 0.0033 ms in float32 and 0.0033-0.0035
// in bfloat16 at the shape above, against 0.0071-0.0074 for the first
// version and 0.0125-0.0135 for embedding_bag and the division.  The time
// is set by instruction issue and the launch, not by the rows: a grid that
// returns at once takes 0.0012, and the kernel without its row loads
// 0.0026.  So fewer, cheaper warps won: CTAs of kWarps = 4 warps (not 8 or
// 16, whose grids left a second wave), kUnroll = 10 (K 20 over 2 warps, not
// 3-5), slots taken by position rather than by kept rank (no bit-skipping
// chains) and warps named without division.  The load hint does not
// matter (__ldg, default, __ldcs within 0.0001 ms), and the kernel has no
// __launch_bounds__: with one, ptxas capped some instances' registers and
// spilled.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;    // warps per CTA: the plan's rows x ways <= kWarps
constexpr int kUnroll = 10;  // row loads a slot group has in flight

// CTA (x, y) of (32, ways, rows) threads: warp (way, r) takes output row
// m = x * rows + r and K share way, slots [way * share, min(K, (way + 1) *
// share)); lane g * lanes + l is slot group g and load unit v = y * lanes +
// l of the row (lanes = 1 << lane_shift)
template <typename T, typename V>
__global__ void gather_reduce_kernel(const V* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     const uint8_t* __restrict__ mask,
                                     V* __restrict__ out, int64_t n_rows,
                                     int64_t m_rows, int k_fan, int row_vecs,
                                     int lane_shift, int share) {
  using U = repro::Unit<T, V>;
  constexpr int E = U::E;
  // shared memory: the threads' partial sums
  extern __shared__ int4 smem_v[];
  float* sp = reinterpret_cast<float*>(smem_v);

  const int lane = threadIdx.x;
  const int way = threadIdx.y;
  const int ways = blockDim.y;
  const int r = threadIdx.z;
  const int lanes = 1 << lane_shift;
  const int groups = 32 >> lane_shift;
  const int g = lane >> lane_shift;
  const int l = lane & (lanes - 1);
  const int v = blockIdx.y * lanes + l;
  const bool unit = v < row_vecs;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.z + r;
  const int k_lo = way * share;
  const int k_hi = min(k_fan, k_lo + share);
  const V* tv = table + v;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  int cnt = 0;
  if (m < m_rows) {  // warp-uniform
    const int32_t* ir = idx + m * k_fan;
    const uint8_t* mr = mask + m * k_fan;
    // one round trip: the share's first 32 ids and mask bytes, and the
    // row's first 32 mask bytes for the count
    int k = k_lo + lane;
    int32_t id = k < k_hi ? __ldg(ir + k) : 0;
    bool keep = k < k_hi && __ldg(mr + k);
    cnt = __popc(__ballot_sync(~0u, lane < k_fan && __ldg(mr + lane)));
    for (int b = 32; b < k_fan; b += 32)
      cnt += __popc(__ballot_sync(~0u, b + lane < k_fan && __ldg(mr + b + lane)));
    for (int s0 = k_lo; s0 < k_hi; s0 += 32) {
      if (s0 != k_lo) {
        k = s0 + lane;
        id = k < k_hi ? __ldg(ir + k) : 0;
        keep = k < k_hi && __ldg(mr + k);
      }
      // ids past either end of the table read its first or last row
      const int32_t row =
          id < 0 ? 0 : (id >= n_rows ? static_cast<int32_t>(n_rows - 1) : id);
      // bit j: the pass's slot s0 + j is kept (and this lane has a unit)
      const unsigned kept = __ballot_sync(~0u, keep) & (unit ? ~0u : 0u);
      const int n_pos = min(32, k_hi - s0);
      for (int j0 = g; j0 < n_pos + g; j0 += groups * kUnroll) {
        // group g's slots j = j0 + groups q: every kept one's row load
        // issued, then the adds
        V u[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int j = j0 + groups * q;
          const int32_t rq = __shfl_sync(~0u, row, j & 31);
          if (j < 32 && (kept >> j) & 1u)
            u[q] = __ldg(tv + static_cast<int64_t>(rq) * row_vecs);
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int j = j0 + groups * q;
          if (j < 32 && (kept >> j) & 1u) U::add(acc, u[q], 1.f);
        }
      }
    }
  }
  float* mine = sp + ((r * ways + way) * 32 + lane) * E;
#pragma unroll
  for (int e = 0; e < E; ++e) mine[e] = acc[e];
  __syncthreads();

  // group 0 of the row's first share adds the (share, group) partial sums
  // in order (its own first), divides by its count and stores
  if (way == 0 && g == 0 && m < m_rows && unit) {
    for (int wy = 0; wy < ways; ++wy) {
      for (int gg = wy == 0 ? 1 : 0; gg < groups; ++gg) {
        const float* p = sp + ((r * ways + wy) * 32 + gg * lanes + l) * E;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += p[e];
      }
    }
    const float den = fmaxf(static_cast<float>(cnt), 1.f);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] /= den;
    out[m * row_vecs + v] = U::pack(acc);
  }
}

template <typename T, typename V>
void launch(const void* table, const void* idx, const void* mask, void* out,
            int64_t n_rows, int64_t m_rows, int k_fan, int row_vecs,
            int lanes, int ways, int rows, dim3 grid, int smem,
            cudaStream_t stream) {
  const int share = (k_fan + ways - 1) / ways;
  const dim3 block(32, ways, rows);
  gather_reduce_kernel<T, V><<<grid, block, smem, stream>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<V*>(out), n_rows,
      m_rows, k_fan, row_vecs, __builtin_ctz(lanes), share);
}

}  // namespace

// vec, lanes, ways, rows, the grid and smem are the wrapper's launch plan
// (gather_reduce.py::gather_reduce_plan): vec is the elements a lane loads
// at once, 16 bytes' worth on the vector route and 1 on the scalar one.
extern "C" int repro_gather_reduce(const void* table, const void* idx,
                                   const void* mask, void* out,
                                   long long n_rows, long long m_rows,
                                   int k_fan, int d_dim, int dtype, int vec,
                                   int lanes, int ways, int rows, int grid_m,
                                   int grid_d, int smem, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == repro::kF32 ? 4 : 2;
  if (n_rows <= 0 || k_fan < 0 || (vec != 1 && vec * elem != 16) ||
      d_dim % vec != 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      ways < 1 || rows < 1 || rows * ways > kWarps ||
      static_cast<int64_t>(grid_m) * rows < m_rows ||
      static_cast<int64_t>(grid_d) * lanes < d_dim / vec ||
      smem < 4 * rows * ways * 32 * vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_vecs = d_dim / vec;
  const dim3 grid(grid_m, grid_d);
  if (vec == 1 && dtype == repro::kF32)
    launch<float, float>(table, idx, mask, out, n_rows, m_rows, k_fan,
                         row_vecs, lanes, ways, rows, grid, smem, s);
  else if (vec == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(table, idx, mask, out, n_rows,
                                         m_rows, k_fan, row_vecs, lanes, ways,
                                         rows, grid, smem, s);
  else if (dtype == repro::kF32)
    launch<float, int4>(table, idx, mask, out, n_rows, m_rows, k_fan,
                        row_vecs, lanes, ways, rows, grid, smem, s);
  else
    launch<__nv_bfloat16, int4>(table, idx, mask, out, n_rows, m_rows, k_fan,
                                row_vecs, lanes, ways, rows, grid, smem, s);
  return static_cast<int>(cudaGetLastError());
}
