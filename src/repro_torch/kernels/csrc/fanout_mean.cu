// fanout_mean: masked mean over the fanout axis of a padded subgraph tree,
//   out[m, d] = sum_k mask[m, k] * x[m, k, d] / max(sum_k mask[m, k], 1)
// with x [M, K, D] (float32 or bfloat16), mask [M, K] (bool), out [M, D]
// in x's dtype.
//
// Replaces: src/repro/kernels/gather_reduce.py::fanout_mean_pallas (the
// pallas_call at :49), which every GCN layer reaches through
// models/gcn.py::_child_mean.
//
// Bound on the H100: bytes.  Each x element is used once (one multiply-add),
// so the kernel does ~0.5 FLOP per byte read, far below the ~20 FLOP/byte
// where float32 arithmetic (67 TFLOP/s) would take over from HBM
// (3.35 TB/s).  At the serve shape (5120, 20, 128) float32 it must read
// 52 MB, about 16 us at the HBM rate.
//
// Design: the TPU kernel keeps a (block_m, K, block_d) tile in VMEM and
// reduces it with an einsum.  Here one thread owns one (row, d) output:
// threads of a warp run along D, so every load of the K loop is a
// contiguous, coalesced 128-byte (float32) line, and each x byte is read
// exactly once.  The K loop accumulates in float32 in a register and counts
// the mask beside it; the division happens once and the result is rounded
// once to the output dtype.  Blocks are independent (no cross-block
// reduction), which is what the sequential TPU grid does not need to care
// about and the 132-SM card does.  No shared memory: nothing is reused.
#include "common.cuh"

namespace {

constexpr int kBlockD = 128;  // threads along D (threadIdx.x)
constexpr int kRows = 2;      // output rows per block (threadIdx.y)

template <typename T>
__global__ void __launch_bounds__(kBlockD * kRows)
fanout_mean_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   T* __restrict__ out, int64_t m_rows, int k_fan, int d_dim) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  const int d = blockIdx.y * kBlockD + threadIdx.x;
  if (m >= m_rows || d >= d_dim) return;
  const T* xr = x + m * k_fan * d_dim + d;
  const uint8_t* mr = mask + m * k_fan;
  float acc = 0.f;
  float cnt = 0.f;
  for (int k = 0; k < k_fan; ++k) {
    const float w = mr[k] ? 1.f : 0.f;
    acc += repro::to_float(xr[static_cast<int64_t>(k) * d_dim]) * w;
    cnt += w;
  }
  out[m * d_dim + d] = repro::from_float<T>(acc / fmaxf(cnt, 1.f));
}

template <typename T>
void launch(const void* x, const void* mask, void* out, int64_t m_rows,
            int k_fan, int d_dim, cudaStream_t stream) {
  const dim3 block(kBlockD, kRows);
  const dim3 grid(static_cast<unsigned>((m_rows + kRows - 1) / kRows),
                  static_cast<unsigned>((d_dim + kBlockD - 1) / kBlockD));
  fanout_mean_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), m_rows, k_fan, d_dim);
}

}  // namespace

extern "C" int repro_fanout_mean(const void* x, const void* mask, void* out,
                                 long long m_rows, int k_fan, int d_dim,
                                 int dtype, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(x, mask, out, m_rows, k_fan, d_dim, s);
  else
    launch<__nv_bfloat16>(x, mask, out, m_rows, k_fan, d_dim, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
