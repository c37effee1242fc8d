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
// Bound on the H100: bytes.  Each kept slot reads one D-row of the table
// and does one add per element; at a graphgen-gcn bucket-32 request's hop-2
// level (M 1280, K 20, D 128, float32) that is ~13 MB of rows against
// ~3.3 MFLOP, a few microseconds at 3.35 TB/s.
//
// Design: fanout_mean.cu with the [M, K, D] operand never built.  The TPU
// kernel DMAs one table row per (row, slot) from HBM into a VMEM tile.
// Here one thread owns one (row, d) output and threads of a warp run along
// D, so every row read is a coalesced line of the table; the slot's id and
// mask are the same for the whole warp (one broadcast load).  A slot the
// mask drops reads no table row.  The sum and the count stay in float32
// registers; one division and one rounding to the table's dtype.
#include "common.cuh"

namespace {

constexpr int kBlockD = 128;  // threads along D (threadIdx.x)
constexpr int kRows = 2;      // output rows per block (threadIdx.y)

template <typename T>
__global__ void __launch_bounds__(kBlockD * kRows)
gather_reduce_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ mask, T* __restrict__ out,
                     int64_t n_rows, int64_t m_rows, int k_fan, int d_dim) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  const int d = blockIdx.y * kBlockD + threadIdx.x;
  if (m >= m_rows || d >= d_dim) return;
  const int32_t* ir = idx + m * k_fan;
  const uint8_t* mr = mask + m * k_fan;
  float acc = 0.f;
  float cnt = 0.f;
  for (int k = 0; k < k_fan; ++k) {
    if (!mr[k]) continue;
    int64_t r = ir[k];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    acc += repro::to_float(table[r * d_dim + d]);
    cnt += 1.f;
  }
  out[m * d_dim + d] = repro::from_float<T>(acc / fmaxf(cnt, 1.f));
}

template <typename T>
void launch(const void* table, const void* idx, const void* mask, void* out,
            int64_t n_rows, int64_t m_rows, int k_fan, int d_dim,
            cudaStream_t stream) {
  const dim3 block(kBlockD, kRows);
  const dim3 grid(static_cast<unsigned>((m_rows + kRows - 1) / kRows),
                  static_cast<unsigned>((d_dim + kBlockD - 1) / kBlockD));
  gather_reduce_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), n_rows,
      m_rows, k_fan, d_dim);
}

}  // namespace

extern "C" int repro_gather_reduce(const void* table, const void* idx,
                                   const void* mask, void* out,
                                   long long n_rows, long long m_rows,
                                   int k_fan, int d_dim, int dtype,
                                   void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(table, idx, mask, out, n_rows, m_rows, k_fan, d_dim, s);
  else if (dtype == repro::kBF16)
    launch<__nv_bfloat16>(table, idx, mask, out, n_rows, m_rows, k_fan,
                          d_dim, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
