// flash_attention, float32 route: online-softmax attention with GQA head
// grouping,
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, g, j] * scale) v[b, g, j]
// with q [B, Hq, Lq, Dh], k/v [B, Hkv, Lk, Dh] (float32, contiguous),
// g = h / (Hq / Hkv), scale = 1 / sqrt(Dh), Dh 64, 128 or 160, out
// float32.  Bfloat16
// operands, the dense LM's, go to the tensor-core kernel in
// flash_attention_sm90.cu; the wrapper picks the route by dtype.
// Causal: row i sees column j iff i + (Lk - Lq) >= j (the last query
// aligned with the last key); masked logits are -1e30.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the pallas_call at :102) for float32 operands (no path of the dense
// LM runs it: its compute dtype is bfloat16).  The arithmetic is the
// Pallas kernel's: the float32 logits scaled after the dot product, a
// running max and denominator in float32, the denominator clamped at
// 1e-30 before the one division.
//
// Bound on the H100: operations, 4 * Dh FLOP per visible (row, column)
// pair at the 67 TFLOP/s float32 rate outside the tensor cores.
//
// Design (a simple kernel: float32 has no full-rate tensor-core route to
// hold the 1e-5 gates): the TPU kernel keeps a 128-row q block in VMEM
// and carries (max, denom, acc) scratch across a sequential grid axis of
// k blocks.  Here one block owns one (batch * head, 64-row query tile) and
// walks the key tiles itself, so nothing carries between blocks.  The Q
// tile and each 64-row K/V tile are staged in shared memory as float32,
// rows padded to Dh + 1 floats so that the 16 rows a warp reads at one
// column fall in 16 banks.  256 threads each compute a 4 x 4 micro-tile of
// the 64 x 64 score tile by float32 FMA (rows ty + 16i, columns tx + 16j),
// write it to shared memory, and four threads per row take the tile's max
// and sum with warp shuffles.  Each thread keeps a 4 x (Dh / 16) block of
// the output accumulator in registers (Dh 64, 128 or 160: at 160 the
// staged tiles take 141 KB of shared memory, opted in at launch),
// rescales it by the row's alpha and
// adds P V.  Key tiles entirely above the causal diagonal are never
// loaded (the Pallas kernel's pl.when(run)); query tiles run heaviest
// first (blockIdx.x reversed) so the longest blocks start early.
#include "common.cuh"

namespace {

constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kSRow = kTile + 1; // padded score-row stride (floats)
constexpr float kNeg = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return (3 * kTile * (DH + 1) + kTile * kSRow + 3 * kTile) * sizeof(float);
}

// A kTile x DH tile of contiguous rows -> rows of stride DH + 1.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int tid) {
  for (int e = tid; e < kTile * DH; e += kThreads)
    dst[(e / DH) * (DH + 1) + e % DH] = src[e];
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int hq, int hkv, int lq,
                           int lk, int causal, float scale) {
  constexpr int R = DH + 1;
  constexpr int NJ = DH / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * R;
  float* sV = sK + kTile * R;
  float* sS = sV + kTile * R;
  float* sM = sS + kTile * kSRow;   // running max per row
  float* sL = sM + kTile;           // running denominator per row
  float* sA = sL + kTile;           // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;                       // b * hq + h
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int off = lk - lq;
  const float* qp = q + (static_cast<int64_t>(bh) * lq + q0) * DH;
  const float* kp = k + static_cast<int64_t>(kvh) * lk * DH;
  const float* vp = v + static_cast<int64_t>(kvh) * lk * DH;

  load_tile<DH>(sQ, qp, tid);
  if (tid < kTile) {
    sM[tid] = kNeg;
    sL[tid] = 0.f;
  }
  float o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;

  int n_kt = lk / kTile;
  if (causal) {
    const int last = q0 + kTile - 1 + off;  // the tile's last visible column
    n_kt = last < 0 ? 0 : min(n_kt, last / kTile + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sS/sV reads are done
    load_tile<DH>(sK, kp + static_cast<int64_t>(k0) * DH, tid);
    load_tile<DH>(sV, vp + static_cast<int64_t>(k0) * DH, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * R + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * R + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float val = s[i][j] * scale;
        if (causal && q0 + r + off < k0 + c) val = kNeg;
        sS[r * kSRow + c] = val;
      }
    __syncthreads();

    {  // online softmax over the tile: four neighbouring lanes per row
      const int r = tid / 4, part = tid % 4;
      float* row = sS + r * kSRow + part * 16;
      float mx = row[0];
#pragma unroll
      for (int j = 1; j < 16; ++j) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {  // every lane of the row read sM[r] before the shuffles
        const float alpha = expf(m_prev - m_new);
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
    }
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float p[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * kSRow + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = sV[c * R + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(p[i], w[j], o[i][j]);
    }
  }
  __syncthreads();  // sL is final (or still its initial 0 with no tile run)

  float* op = out + (static_cast<int64_t>(bh) * lq + q0) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float den = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      op[static_cast<int64_t>(r) * DH + tx + 16 * j] = o[i][j] / den;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out,
           int batch, int hq, int hkv, int lq, int lk, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_f32_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(lq / kTile),
                  static_cast<unsigned>(batch * hq));
  flash_attention_f32_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, hq, hkv, lq, lk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, int batch,
                                         int hq, int hkv, int lq, int lk,
                                         int dh, int causal, float scale,
                                         void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv || lq % kTile || lk % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(out);
  if (dh == 64)
    return launch<64>(fq, fk, fv, fo, batch, hq, hkv, lq, lk, causal, scale,
                      s);
  if (dh == 128)
    return launch<128>(fq, fk, fv, fo, batch, hq, hkv, lq, lk, causal, scale,
                       s);
  if (dh == 160)
    return launch<160>(fq, fk, fv, fo, batch, hq, hkv, lq, lk, causal, scale,
                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}
