// fanout_mean_bwd: the gradient of fanout_mean with respect to x,
//   dx[m, k, d] = g[m, d] / max(sum_k mask[m, k], 1) * mask[m, k]
// with g [M, D] (float32 or bfloat16, the output's gradient), mask [M, K]
// (bool), dx [M, K, D] in g's dtype.  The division happens in float32 and
// the result is rounded once, as JAX's autodiff of the oracle
// (repro/kernels/ref.py::fanout_mean_ref) computes it: g / den, then the
// einsum's transpose multiplies by the float mask.
//
// Replaces: no TPU kernel — the JAX package differentiates the oracle with
// jax.grad.  It is the backward that the fanout_mean kernel
// (csrc/fanout_mean.cu) needs for the GCN to train on the card: every GCN
// layer after the first differentiates through its children's mean
// (models/gcn.py::_child_mean via kernels/ops.py::FanoutMean).
//
// Bound on the H100: bytes.  Every output element is written once and each
// g element read once; there is one division per (m, d).  At the training
// shape (128, 40, 256) float32 the kernel must write 5.2 MB, ~1.6 us at
// the HBM rate, so launch latency dominates at the shapes training gives.
//
// Design: one block per row m and 128-wide column block of D.  The block
// counts the row's mask with __syncthreads_count (one predicate per thread
// over K slots), then each thread owns one (m, d) column: it reads g once,
// divides once, and writes that value times the mask to every k of a
// stride of the fanout axis (threadIdx.y), so each store is a coalesced
// line along D and no thread reads more of the mask row than its own k
// slots.  No reduction crosses blocks; no shared memory beyond the count.
#include "common.cuh"

namespace {

constexpr int kBlockD = 128;  // threads along D (threadIdx.x)
constexpr int kSlotsK = 4;    // threads along the fanout axis (threadIdx.y)

template <typename T>
__global__ void __launch_bounds__(kBlockD * kSlotsK)
fanout_mean_bwd_kernel(const T* __restrict__ g, const uint8_t* __restrict__ mask,
                       T* __restrict__ dx, int k_fan, int d_dim) {
  const int64_t m = blockIdx.x;
  const int d = blockIdx.y * kBlockD + threadIdx.x;
  const uint8_t* mr = mask + m * k_fan;
  const int tid = threadIdx.y * kBlockD + threadIdx.x;
  int cnt = 0;
  for (int base = 0; base < k_fan; base += kBlockD * kSlotsK) {
    const int k = base + tid;
    cnt += __syncthreads_count(k < k_fan && mr[k] != 0);
  }
  if (d >= d_dim) return;
  const float den = fmaxf(static_cast<float>(cnt), 1.f);
  // times the float mask (not a select), as the twin and jax.grad do, so a
  // non-finite g propagates identically
  const float q = repro::to_float(g[m * d_dim + d]) / den;
  T* out = dx + m * k_fan * d_dim + d;
  for (int k = threadIdx.y; k < k_fan; k += kSlotsK)
    out[static_cast<int64_t>(k) * d_dim] =
        repro::from_float<T>(q * (mr[k] ? 1.f : 0.f));
}

template <typename T>
void launch(const void* g, const void* mask, void* dx, int64_t m_rows,
            int k_fan, int d_dim, cudaStream_t stream) {
  const dim3 block(kBlockD, kSlotsK);
  const dim3 grid(static_cast<unsigned>(m_rows),
                  static_cast<unsigned>((d_dim + kBlockD - 1) / kBlockD));
  fanout_mean_bwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const uint8_t*>(mask),
      static_cast<T*>(dx), k_fan, d_dim);
}

}  // namespace

extern "C" int repro_fanout_mean_bwd(const void* g, const void* mask, void* dx,
                                     long long m_rows, int k_fan, int d_dim,
                                     int dtype, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(g, mask, dx, m_rows, k_fan, d_dim, s);
  else
    launch<__nv_bfloat16>(g, mask, dx, m_rows, k_fan, d_dim, s);
  return static_cast<int>(cudaGetLastError());
}
