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
// (models/gcn.py::_child_mean via kernels/ops.py::FanoutMean), L(L-1)/2
// launches per train step.
//
// Bound on the H100: bytes, and nearly all of them stores: dx is K times
// g's size.  At the train steps' shapes, float32 (g + mask + dx over
// 3.35 TB/s):
//   (32, 15, 256)   deep, twice a step     0.52 MB   0.00016 ms
//   (480, 10, 256)  deep, once a step      5.41 MB   0.0016 ms
//   (128, 40, 256)  W = 4, once a step     5.38 MB   0.0016 ms
// so the kernel's time is one load round trip, the store drain, and the
// launch.
//
// What the first version lost: one 128 x 4-thread block per (row, 128
// columns), so 64 blocks at (32, 15, 256) for 132 SMs; a block barrier
// (__syncthreads_count) to count the mask before g was even loaded, two
// dependent round trips; and 4-byte stores (2-byte in bf16).
//
// Design (the launch plan is gather_reduce.py::fanout_mean_bwd_plan): one
// warp owns one (row m, share of K, block of 32 columns of D), named by its
// CTA's grid coordinates (no division); a lane owns one column.  The warp
// issues its g load and its mask loads together, counts the mask with
// __ballot_sync + __popc over K in 32s (no block barrier, no shared memory;
// the first two ballot words stay in registers for the store loop),
// divides once per (m, d) in float32, and then only stores, with the
// streaming hint (__stcs), one 128-byte line (64 in bfloat16) per warp and
// k: k = way, way + ways, ... each gets q times the float mask (so a
// non-finite g propagates as in jax.grad), rounded once to T.  The plan
// splits K over `ways` warps until the grid holds ~2 CTAs of kWarps = 4
// warps per SM.
//
// Measured (scripts/bwd_tiered_variants.py, in turns on an H100 80GB HBM3
// at 700 W, device duration; PERF.md): 0.0015 / 0.0024 / 0.0025 ms at the
// three shapes above, against 0.0017 / 0.0041 / 0.0027 for the first
// version; a zero_() of dx alone takes 0.0010 / 0.0020 / 0.0021 (0.0010 is
// also a 4-byte zero_(): the launch's floor).  Tried and not kept: 16-byte
// stores on rows of a 16-byte multiple (0.0015 / 0.0025 / 0.0026: no
// faster); default stores (up to 0.0002 ms slower); the first redesign's
// 64-bit index division and shared-memory ballot words (0.0001-0.0002
// slower); K over fewer or more warps than the plan's (slower at every
// shape); CTAs of 8 warps (level), 2 (up to 0.0005 slower) or 1 (up to
// 0.0016 slower).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps (rows of M) per CTA

// warp w of CTA (x, y, z) takes row m = x * kWarps + w, K share way = y
// and columns 32 z + lane
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fanout_mean_bwd_kernel(const T* __restrict__ g, const uint8_t* __restrict__ mask,
                       T* __restrict__ dx, int64_t m_rows, int k_fan,
                       int d_dim) {
  const int lane = threadIdx.x & 31;
  const int64_t m =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (m >= m_rows) return;  // warp-uniform
  const int way = blockIdx.y;
  const int ways = gridDim.y;
  const int d = blockIdx.z * 32 + lane;
  const bool active = d < d_dim;

  // one round trip: g and the mask's first two 32-byte words go out
  // together; the ballots count the row and keep k < 64's bits in
  // registers (a later k re-reads its byte, from L1)
  T gv;
  if (active) gv = __ldg(g + m * d_dim + d);
  const uint8_t* mr = mask + m * k_fan;
  const bool m0 = lane < k_fan && __ldg(mr + lane) != 0;
  const bool m1 = lane + 32 < k_fan && __ldg(mr + lane + 32) != 0;
  const uint32_t b0 = __ballot_sync(0xffffffffu, m0);
  const uint32_t b1 = __ballot_sync(0xffffffffu, m1);
  int cnt = __popc(b0) + __popc(b1);
  for (int k = lane + 64; k - lane < k_fan; k += 32)
    cnt += __popc(__ballot_sync(0xffffffffu, k < k_fan && mr[k] != 0));
  if (!active) return;

  // one division per (m, d) in float32; q * 1 and q * 0 once each (the
  // float mask's two values), rounded once
  const float q = repro::to_float(gv) / fmaxf(static_cast<float>(cnt), 1.f);
  const T on = repro::from_float<T>(q * 1.f);
  const T off = repro::from_float<T>(q * 0.f);
  T* out = dx + (m * k_fan + way) * d_dim + d;
  const int64_t step = static_cast<int64_t>(ways) * d_dim;
  for (int k = way; k < k_fan; k += ways, out += step) {
    const bool bit = k < 32 ? (b0 >> k) & 1u
                   : k < 64 ? (b1 >> (k - 32)) & 1u : mr[k] != 0;
    __stcs(out, bit ? on : off);
  }
}

template <typename T>
void launch(const void* g, const void* mask, void* dx, int64_t m_rows,
            int k_fan, int d_dim, dim3 grid, cudaStream_t stream) {
  fanout_mean_bwd_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const uint8_t*>(mask),
      static_cast<T*>(dx), m_rows, k_fan, d_dim);
}

}  // namespace

// The grid is the wrapper's launch plan (gather_reduce.py::
// fanout_mean_bwd_plan): (rows of M / kWarps, K shares, D blocks of 32
// columns).
extern "C" int repro_fanout_mean_bwd(const void* g, const void* mask, void* dx,
                                     long long m_rows, int k_fan, int d_dim,
                                     int dtype, int grid_m, int grid_k,
                                     int grid_d, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(grid_m) * kWarps < m_rows || grid_k < 1 ||
      grid_k > 65535 || static_cast<int64_t>(grid_d) * 32 < d_dim ||
      grid_d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_m, grid_k, grid_d);
  if (dtype == repro::kF32)
    launch<float>(g, mask, dx, m_rows, k_fan, d_dim, grid, s);
  else
    launch<__nv_bfloat16>(g, mask, dx, m_rows, k_fan, d_dim, grid, s);
  return static_cast<int>(cudaGetLastError());
}
