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
// (3.35 TB/s).  At the W = 4 request's shapes, float32: (5120, 20, 128)
// reads 52 MB (0.0165 ms); (128, 40, 128) and (128, 40, 256) read 2.6 and
// 5.2 MB (0.0008 and 0.0016 ms), where launch and one round trip to L2 are
// most of the time.
//
// What the first version lost: one thread per (row, d) output, 2 rows per
// 256-thread block, a serial K loop of 4-byte loads whose trip count is
// known only at run time.  At M = 128 that was 64 blocks for 132 SMs with
// 40 mostly serial loads per thread (0.39 TB/s).
//
// Design (the launch plan is gather_reduce.py::fanout_mean_plan): lanes
// run along D with 16-byte loads (4 float32 or 8 bfloat16 per lane, so 32
// lanes cover a 128-float row in one instruction); a CTA's thread groups
// split the fanout axis K (group g takes k = g, g + ways, ...), each
// accumulating its share in float32 registers with kUnroll loads in flight
// (with the streaming hint, __ldcs: every x byte is read once);
// at small M the plan narrows the lanes per CTA so the grid holds ~2 CTAs
// per SM.  The CTA's mask rows are staged in shared memory once, after the
// first x loads are issued.  The groups' partial sums and mask counts meet
// in shared memory and are added in group order, so the result is the same
// from run to run; one division and one rounding to the output dtype.  Each
// x byte is read once.  A row whose width is not a multiple of 16 bytes (or
// a base off 16-byte alignment) takes the scalar instance of the same
// kernel (V = T).
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;        // x loads in flight per thread
constexpr int kMaxThreads = 256;  // the plan's CTA size

// thread t = ((r * ways + way) * lanes + lane): output row r of the CTA's
// rows, K share `way`, load unit blockIdx.y * lanes + lane of the row
template <typename T, typename V>
__global__ void __launch_bounds__(kMaxThreads)
fanout_mean_kernel(const V* __restrict__ x, const uint8_t* __restrict__ mask,
                   V* __restrict__ out, int64_t m_rows, int k_fan,
                   int row_vecs, int lanes, int ways, int rows_per_cta) {
  using U = repro::Unit<T, V>;
  constexpr int E = U::E;
  // shared memory: the threads' partial sums, the groups' mask counts, the
  // CTA's mask rows
  extern __shared__ int4 smem_v[];
  float* sp = reinterpret_cast<float*>(smem_v);
  float* sc = sp + blockDim.x * E;
  uint8_t* sm = reinterpret_cast<uint8_t*>(sc + rows_per_cta * ways);

  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int n_rows = static_cast<int>(min(static_cast<int64_t>(rows_per_cta),
                                          m_rows - m0));
  const int lane = t % lanes;
  const int g = t / lanes;
  const int way = g % ways;
  const int r = g / ways;
  const int v = blockIdx.y * lanes + lane;
  const bool active = r < n_rows && v < row_vecs;
  const V* xr = x + (m0 + r) * k_fan * row_vecs + v;

  // the first kUnroll x loads go out before the mask is waited for, so the
  // two round trips overlap (at the main path's fanouts a thread has at
  // most kUnroll slots: this is all of its x)
  V u[kUnroll];
  int k0 = way;
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    const int k = k0 + q * ways;
    if (active && k < k_fan) u[q] = __ldcs(xr + static_cast<int64_t>(k) * row_vecs);
  }
  const uint8_t* mg = mask + m0 * k_fan;
  for (int i = t; i < n_rows * k_fan; i += blockDim.x) sm[i] = mg[i];
  __syncthreads();

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float cnt = 0.f;
  if (active) {
    const uint8_t* mr = sm + r * k_fan;
    while (true) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int k = k0 + q * ways;
        if (k < k_fan) {
          const float w = mr[k] ? 1.f : 0.f;
          U::add(acc, u[q], w);
          cnt += w;
        }
      }
      k0 += kUnroll * ways;
      if (k0 >= k_fan) break;
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int k = k0 + q * ways;
        if (k < k_fan) u[q] = __ldcs(xr + static_cast<int64_t>(k) * row_vecs);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sp[t * E + e] = acc[e];
  if (lane == 0) sc[g] = cnt;
  __syncthreads();

  // one thread per output unit adds the K shares in order
  if (t < rows_per_cta * lanes) {
    const int rr = t / lanes;
    const int vv = blockIdx.y * lanes + t % lanes;
    if (rr < n_rows && vv < row_vecs) {
      float s[E];
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] = 0.f;
      float c = 0.f;
      for (int wy = 0; wy < ways; ++wy) {
        const float* p = sp + ((rr * ways + wy) * lanes + t % lanes) * E;
#pragma unroll
        for (int e = 0; e < E; ++e) s[e] += p[e];
        c += sc[rr * ways + wy];
      }
      const float den = fmaxf(c, 1.f);
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] /= den;
      out[(m0 + rr) * row_vecs + vv] = U::pack(s);
    }
  }
}

template <typename T, typename V>
void launch(const void* x, const void* mask, void* out, int64_t m_rows,
            int k_fan, int row_vecs, int lanes, int ways, int rows, dim3 grid,
            int smem, cudaStream_t stream) {
  fanout_mean_kernel<T, V><<<grid, lanes * ways * rows, smem, stream>>>(
      static_cast<const V*>(x), static_cast<const uint8_t*>(mask),
      static_cast<V*>(out), m_rows, k_fan, row_vecs, lanes, ways, rows);
}

}  // namespace

// vec, lanes, ways, rows, the grid and smem are the wrapper's launch plan
// (gather_reduce.py::fanout_mean_plan): vec is the elements a lane loads at
// once, 16 bytes' worth on the vector route and 1 on the scalar one.
extern "C" int repro_fanout_mean(const void* x, const void* mask, void* out,
                                 long long m_rows, int k_fan, int d_dim,
                                 int dtype, int vec, int lanes, int ways,
                                 int rows, int grid_m, int grid_d, int smem,
                                 void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == repro::kF32 ? 4 : 2;
  const int row_vecs = vec > 0 ? d_dim / vec : 0;
  if (lanes * ways * rows > kMaxThreads || (vec != 1 && vec * elem != 16) ||
      d_dim % vec != 0 || static_cast<int64_t>(grid_m) * rows < m_rows ||
      grid_d * lanes < row_vecs)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_m, grid_d);
  if (vec == 1 && dtype == repro::kF32)
    launch<float, float>(x, mask, out, m_rows, k_fan, row_vecs, lanes, ways,
                         rows, grid, smem, s);
  else if (vec == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, mask, out, m_rows, k_fan,
                                         row_vecs, lanes, ways, rows, grid,
                                         smem, s);
  else if (dtype == repro::kF32)
    launch<float, int4>(x, mask, out, m_rows, k_fan, row_vecs, lanes, ways,
                        rows, grid, smem, s);
  else
    launch<__nv_bfloat16, int4>(x, mask, out, m_rows, k_fan, row_vecs, lanes,
                                ways, rows, grid, smem, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
