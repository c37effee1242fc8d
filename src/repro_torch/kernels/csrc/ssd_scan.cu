// ssd_scan: the Mamba-2 SSD chunked scan in float32,
//   y[b, l, h] = sum_{j <= l in l's chunk} (c_l . b_j) exp(cum_l - cum_j)
//                  dt[b, j, h] x[b, j, h]
//              + exp(cum_l) (c_l . state_h)          (state before the chunk)
//   state_h'   = state_h exp(cum_{Q-1})
//              + sum_j exp(cum_{Q-1} - cum_j) dt[b, j, h] x[b, j, h] b_j^T
// with x [B, L, H, P], dt [B, L, H], a [H], b/c [B, L, N] (one group,
// broadcast over heads), y [B, L, H, P], all float32 and contiguous, cum
// the running sum of a[h] dt[b, :, h] within a chunk of Q rows, and the
// [P, N] state carried across the chunks of one sequence in order.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (the
// pallas_call at :79), and with it the chunked jnp form
// src/repro/models/ssm.py::ssd_chunked that every mamba2 layer's
// full-sequence forward runs (models/ssm.py::mamba_train).
//
// Bound on the H100: operations.  At mamba2-1.3b's prefill (B 8, L 2048,
// H 64, P 64, N 128, Q 128) the function needs C B^T over the causal
// pairs once per (batch, chunk) (shared by the 64 heads), the masked
// scores times x over the same pairs, and the inter-chunk read-out and the
// state update of 2 P N FLOP a row each after the first chunk: ~41 GFLOP
// against ~0.56 GB of x, y, dt, b and c -- ~0.61 ms at the 67 TFLOP/s
// float32 rate, ~0.17 ms at 3.35 TB/s.  (TF32 tensor cores would move the
// bound but change the arithmetic; the port stays in float32.)
//
// Design (a first, simple kernel; tensor cores, sharing C B^T across
// heads and a parallel chunk-state pass are later work): the TPU kernel
// walks a sequential grid axis over chunks and carries the [P, N] state
// in VMEM scratch.  Here one block owns one (batch, head) and walks its
// chunks itself, so nothing carries between blocks; the state (64 x 128
// float32, 32 KB) stays in shared memory for the whole sequence.  Per
// chunk the x rows [Q, P] are staged once; b and c are staged 32 state
// columns at a time ([Q, 32] each), since the whole [Q, N] pair beside
// the state and the [Q, Q] score tile would not fit in 227 KB.  Each of
// 256 threads (16 x 16) keeps an 8 x 8 block of C B^T (rows ty + 16r,
// columns tx + 16c) and an 8 x 4 block of the output in registers; per
// column tile it adds c b^T and c state^T, then updates that tile's state
// columns (the old values were read before a barrier).  Then the decay
// exp(cum_i - cum_j) dt_j is applied only where j <= i (the exponent of a
// positive segment is never evaluated), the masked scores go to shared
// memory, and the output adds scores x.  cum is a sequential float64 sum
// rounded once per row (what torch's CPU cumsum does for float32).
// Rows past Q, heads dims past P and state columns past N are zero-padded,
// so any Q <= 128, P <= 64, N <= 128 runs.
#include "common.cuh"

namespace {

constexpr int kQ = 128;           // largest chunk (rows per chunk)
constexpr int kP = 64;            // largest head dim
constexpr int kN = 128;           // largest state width
constexpr int kNT = 32;           // state columns of b/c per staged tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kSS = kN + 1;       // state row stride (floats)
constexpr int kGS = kQ + 16;      // score row stride: two rows of a warp
                                  // land 16 banks apart
constexpr int kTS = kNT + 1;      // b/c tile row stride

constexpr size_t kSmemFloats =
    kP * kSS + kQ * kP + kQ * kGS + 2 * kQ * kTS + 4 * kQ;

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
                int seq_len, int heads, int p_dim, int n_dim, int q_len) {
  extern __shared__ float smem[];
  float* S = smem;                  // [kP][kSS]   carried state
  float* X = S + kP * kSS;          // [kQ][kP]    the chunk's x rows
  float* G = X + kQ * kP;           // [kQ][kGS]   masked scores
  float* Bt = G + kQ * kGS;         // [kQ][kTS]   b, one column tile
  float* Ct = Bt + kQ * kTS;        // [kQ][kTS]   c, one column tile
  float* cum = Ct + kQ * kTS;       // [kQ]
  float* dts = cum + kQ;            // [kQ]
  float* wv = dts + kQ;             // [kQ]  dt_j exp(cum_{Q-1} - cum_j)
  float* ecum = wv + kQ;            // [kQ]  exp(cum_i)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const float ah = a[h];
  const int64_t x_row = static_cast<int64_t>(heads) * p_dim;  // x/y step
  const int64_t x_col = static_cast<int64_t>(h) * p_dim;

  for (int e = tid; e < kP * kSS; e += kThreads) S[e] = 0.f;

  for (int c0 = 0; c0 < seq_len; c0 += q_len) {
    const int64_t t0 = static_cast<int64_t>(b) * seq_len + c0;
    for (int e = tid; e < kQ * kP; e += kThreads) {
      const int i = e / kP, p = e % kP;
      X[e] = (i < q_len && p < p_dim) ? x[(t0 + i) * x_row + x_col + p] : 0.f;
    }
    if (tid < kQ)
      dts[tid] = tid < q_len ? dt[(t0 + tid) * heads + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int i = 0; i < kQ; ++i) {
        run += static_cast<double>(ah * dts[i]);
        cum[i] = static_cast<float>(run);
      }
    }
    __syncthreads();
    const float last = cum[q_len - 1];
    if (tid < kQ) {
      wv[tid] = tid < q_len ? dts[tid] * expf(last - cum[tid]) : 0.f;
      ecum[tid] = expf(cum[tid]);
    }
    const float total = expf(last);

    float g[8][8], acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) g[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }

    for (int n0 = 0; n0 < n_dim; n0 += kNT) {
      for (int e = tid; e < kQ * kNT; e += kThreads) {
        const int i = e / kNT, k = e % kNT;
        const bool ok = i < q_len && n0 + k < n_dim;
        const int64_t off = (t0 + i) * n_dim + n0 + k;
        Bt[i * kTS + k] = ok ? bm[off] : 0.f;
        Ct[i * kTS + k] = ok ? cm[off] : 0.f;
      }
      __syncthreads();
      // c b^T into g, c state^T into acc (this tile's state columns)
#pragma unroll 2
      for (int k = 0; k < kNT; ++k) {
        float cr[8], br[8], sr[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cr[r] = Ct[(ty + 16 * r) * kTS + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) br[c] = Bt[(tx + 16 * c) * kTS + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) sr[c] = S[(tx + 16 * c) * kSS + n0 + k];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) g[r][c] = fmaf(cr[r], br[c], g[r][c]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(cr[r], sr[c], acc[r][c]);
        }
      }
      __syncthreads();
      // state columns n0 .. n0 + 31: S exp(cum_{Q-1}) + (x w)^T b
      float su[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) su[r][0] = su[r][1] = 0.f;
      for (int i = 0; i < q_len; ++i) {
        const float wi = wv[i];
        float xr[4], br[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) xr[r] = X[i * kP + ty + 16 * r] * wi;
#pragma unroll
        for (int c = 0; c < 2; ++c) br[c] = Bt[i * kTS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) su[r][c] = fmaf(xr[r], br[c], su[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* s = &S[(ty + 16 * r) * kSS + n0 + tx + 16 * c];
          *s = __fadd_rn(__fmul_rn(*s, total), su[r][c]);
        }
      }
      __syncthreads();  // the next tile overwrites Bt/Ct
    }

    // inter-chunk term times exp(cum_i); the decay on the causal scores
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const float e = ecum[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        float v = 0.f;
        if (j <= i && i < q_len)
          v = g[r][c] * (expf(cum[i] - cum[j]) * dts[j]);
        G[i * kGS + j] = v;
      }
    }
    __syncthreads();
    // intra-chunk term: scores x
    for (int j = 0; j < q_len; ++j) {
      float gr[8], xr[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) gr[r] = G[(ty + 16 * r) * kGS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) xr[c] = X[j * kP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(gr[r], xr[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= q_len) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (p < p_dim) y[(t0 + i) * x_row + x_col + p] = acc[r][c];
      }
    }
    __syncthreads();  // X, G, cum and dts are restaged for the next chunk
  }
}

}  // namespace

extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              int batch, int seq_len, int heads, int p_dim,
                              int n_dim, int q_len, void* stream) {
  if (batch <= 0 || heads <= 0 || q_len <= 0 || q_len > kQ || p_dim <= 0 ||
      p_dim > kP || n_dim <= 0 || n_dim > kN || seq_len % q_len)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = static_cast<int>(kSmemFloats * sizeof(float));
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_scan_kernel<<<batch * heads, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), seq_len, heads,
      p_dim, n_dim, q_len);
  return static_cast<int>(cudaGetLastError());
}
