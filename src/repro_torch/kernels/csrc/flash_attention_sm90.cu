// flash_attention_sm90: the bfloat16 route of flash_attention on Hopper,
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * scale) v[b, j, g]
// over q [B, Hq, Lq, Dh] and k/v [B, Hkv, Lk, Dh] given as ANY strided
// views whose last dimension is contiguous (the dense LM passes
// [B, L, H, Dh] tensors transposed to [B, H, L, Dh], read in place), and
// out written through its own strides (the wrapper allocates [B, Lq, Hq,
// Dh] and returns the transposed view).  g = h / (Hq / Hkv), scale =
// 1 / sqrt(Dh), Dh 64, 128 or 160.  Causal: row i sees column j iff
// i + (Lk - Lq) >= j; masked logits are -1e30.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the pallas_call at :102) for bfloat16 operands, the dtype of every
// layer of the dense LM's full-sequence forward (float32 operands keep the
// SIMT kernel in flash_attention.cu).  The arithmetic is the Pallas
// kernel's but for one rounding: the float32 logits are scaled after the
// dot product (with log2(e) folded into the scale, so exp becomes exp2),
// the running max and denominator are float32, the denominator sums the
// unrounded float32 p and is clamped at 1e-30 before the one division and
// the one rounding of the output; p is rounded to bfloat16 before P V, as
// the reference's plain gqa_attention path does, which moves an output by
// at most 2^-8 sum_j p_ij |v_j| / l_i (the bound chip_smoke.py holds it to).
//
// Bound on the H100: operations.  Causal attention at B = 8, Hq = 9,
// L = 2048, Dh = 64 does 4 * Dh FLOP for each of the B * Hq * L(L+1)/2
// visible (row, column) pairs, 38.7 GFLOP, against 50 MB of q/k/v/o
// bytes: ~0.039 ms at the 989 TFLOP/s dense bf16 tensor-core rate and
// ~0.015 ms at 3.35 TB/s.
//
// Design.  One CTA per (batch x query head, 192-row query tile), the
// heaviest causal tiles first (the query tile is the grid's slow axis,
// reversed), 512 threads: three consumer warpgroups, each owning 64 query
// rows (the wgmma M), and one producer warpgroup, which gives up
// registers (setmaxnreg 32) so that each consumer thread may hold 160.
// - Loads: TMA through 4-D tensor maps over (Dh, L, H, B) with the
//   operand's own strides, so a tile is the box (64, rows, 1, 1) at
//   (d0, row0, head, batch): GQA needs no repeat (the KV head is a
//   coordinate) and no layout copy runs.  Every box is 64 bf16 wide, one
//   128-byte row, and lands in shared memory in the 128-byte swizzle;
//   Dh 128 takes two boxes per tile, one after the other, and Dh 160
//   three: the third box starts at column 128 and TMA fills its columns
//   past 160 with zeros (the pad lives in shared memory only; no product
//   reads it).  The Q tile
//   comes once; K and V tiles (128 keys at Dh 64, 64 keys at Dh 128, so
//   and 160, so that the score and output accumulators fit in 160
//   registers) run
//   through two-slot rings, one for K and one for V, each slot with a
//   "full" mbarrier (TMA's transaction count) and an "empty" one that the
//   twelve consumer warps arrive on, so K slots free as soon as the scores
//   are done.  Key tiles entirely above the causal diagonal are never
//   loaded; TMA fills rows past Lq or Lk with zeros, and their columns are
//   masked.
// - S = Q K^T: wgmma m64nNk16 (N = keys per tile), both operands in shared
//   memory, K-major, Dh / 16 steps; the descriptors carry the 128-byte
//   swizzle mode of the tensor maps, and a step advances the start address
//   by 32 bytes within the swizzled row (by a whole box past 64 columns);
//   at Dh 160 the last two steps read the third box's first 64 bytes.
// - Overlap within a warpgroup: tile t's S product is issued together with
//   tile t-1's P V product, and the softmax of S_t runs while P V still
//   occupies the tensor cores (wgmma.wait_group 1, then 0 before O is
//   rescaled).  Ordering the three warpgroups' products against each
//   other (a pingpong) measured slower.
// - Softmax in registers on the float32 accumulator: each thread holds
//   two rows; the row max is reduced over the four lanes of a quad with
//   shuffles; the mask is evaluated only on tiles that cross the diagonal
//   or the end of the keys; elsewhere the max is taken of the raw scores
//   and the scale joins the exponent's one FFMA before ex2.approx.ftz;
//   each thread keeps a partial denominator, summed over the quad once at
//   the end.
// - O += P V: wgmma m64n64k16 with P as the register A operand (the
//   float32 accumulator fragment of m64nN is the A fragment of N / 16 k16
//   steps once packed to bf16 pairs) and V read from shared memory as the
//   B operand with the transpose bit, so V's [keys, Dh] rows need no
//   transposed copy; one n64 product per 64 output columns, and at Dh 160
//   one n32 product for the last 32 (the first 64 bytes of each swizzled
//   row of the third box), so a thread holds 64 + 16 output floats.
// - Epilogue: one division per element by the clamped denominator, the
//   bf16 tile stored into the warpgroup's own rows of the Q buffer in the
//   128-byte swizzle, then one TMA store per box through the output's
//   tensor map (rows past Lq and, at Dh 160, columns past 160 are clipped
//   by the hardware).
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so the library links no libcuda)
// and passed as __grid_constant__ kernel parameters.
#include "sm90.cuh"

namespace {

constexpr int kConsumers = 3;                       // consumer warpgroups
constexpr int kRowsPerWG = 64;                      // wgmma M
constexpr int kBlockM = kConsumers * kRowsPerWG;    // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);    // + a producer WG
// setmaxnreg: 128 x 32 + 384 x 160 = the SM's 65536 registers
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kStages = 2;                          // K and V ring depth
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  static_assert(DH == 64 || DH == 128 || DH == 160, "head dim 64, 128, 160");
  static constexpr int kN = DH == 64 ? 128 : 64;         // keys per tile
  // boxes per row; the last one at Dh 160 is half columns, half TMA pad
  static constexpr int kChunks = (DH + kBoxCols - 1) / kBoxCols;
  static constexpr int kFull = DH / kBoxCols;            // n64 output chunks
  static constexpr int kTail = DH % kBoxCols;            // output columns past
  static constexpr int kTailN = kTail;                   // the tail's product
  static constexpr int kTailRegs = kTailN ? kTailN / 2 : 1;
  static constexpr int kQChunk = kBlockM * kRowBytes;    // one Q box
  static constexpr int kKVChunk = kN * kRowBytes;        // one K or V box
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;
  // Q | K ring | V ring | mbarriers, from a 1024-byte aligned base
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
};

// ------------------------------------------------------------------- kernel

template <int kRegs>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// S = Q K^T for one key tile: Dh / 16 k16 steps, both operands K-major.
template <int DH, int N>
__device__ __forceinline__ void issue_qk(float (&s)[N / 2], uint32_t qa,
                                         uint32_t ka) {
  using T = Tile<DH>;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    wgmma_ss(s, sw128_desc(qa + (ks / 4) * T::kQChunk + (ks % 4) * 32),
             sw128_desc(ka + (ks / 4) * T::kKVChunk + (ks % 4) * 32), ks > 0);
  wgmma_commit();
}

// O += P V for one key tile: N / 16 k16 steps per 64 output columns, P
// from registers, V MN-major (16 key rows of 128 bytes per step); at Dh
// 160 the last 32 columns take n32 steps into `ot`.
template <int DH, int N>
__device__ __forceinline__ void issue_pv(float (&o)[Tile<DH>::kFull][32],
                                         float (&ot)[Tile<DH>::kTailRegs],
                                         const uint32_t (&pa)[N / 16][4],
                                         uint32_t va) {
  using T = Tile<DH>;
#pragma unroll
  for (int c = 0; c < T::kFull; ++c)
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_rs(o[c], pa[ks],
               sw128_desc(va + c * T::kKVChunk + ks * 16 * kRowBytes));
  if constexpr (T::kTailN > 0) {
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_rs(ot, pa[ks], sw128_desc(va + T::kFull * T::kKVChunk +
                                      ks * 16 * kRowBytes));
  }
  wgmma_commit();
}

// Round one output fragment (float32, m64nW: rows r and r + 8, columns c2,
// c2 + 1 of each 8-column group) divided by its row's denominator to bf16
// and store it into the swizzled box at `ob`.
template <int NR>
__device__ __forceinline__ void stage_out(const float (&acc)[NR], uint32_t ob,
                                          int r, int c2, const float (&den)[2]) {
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const int half = (i >> 1) & 1;
    const int row = r + 8 * half;
    const uint32_t addr =
        ob + row * kRowBytes + (((i >> 2) ^ (row & 7)) << 4) + 2 * c2;
    const uint32_t val = pack_bf16(acc[i] / den[half], acc[i + 1] / den[half]);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
  }
}

// Online softmax of one score tile in registers (two rows per thread,
// reduced over the quad), in the log2 domain: new row max, rescale factor
// alpha, p = exp2 in place, the thread's part of the denominator.  A tile
// that crosses the diagonal or Lk (`edge`) scales first and writes -1e30
// into masked logits; any other tile takes the max of the raw scores
// (scaling by a positive factor keeps the max) and scales inside the
// exponent's one FFMA.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int row0, int col0,
                                             int off, int lk, int causal,
                                             float scale_log2) {
  float mx[2] = {kNeg, kNeg};  // below every score but a masked one
  if (edge) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = col0 + (i >> 2) * 8 + (i & 1);
      const bool masked = (causal && col > row + off) || col >= lk;
      s[i] = masked ? kNeg : s[i] * scale_log2;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  const float scale = edge ? 1.f : scale_log2;  // what s still needs
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    mx[j] = fmaxf(m[j], mx[j] * scale);
    alpha[j] = exp2_ftz(m[j] - mx[j]);
    m[j] = mx[j];
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two chains per row
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2_ftz(fmaf(s[i], scale, -mx[(i >> 1) & 1]));
    sum[(i >> 1) & 1][i & 1] += s[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + (sum[j][0] + sum[j][1]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, int hq,
                            int hkv, int lq, int lk, int causal,
                            float scale_log2) {
  using T = Tile<DH>;
  constexpr int N = T::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;                  // + slot * kKVBytes
  const uint32_t sV = sK + kStages * T::kKVBytes;
  const uint32_t q_full = sQ + T::kBarOffset;
  const uint32_t k_full = q_full + 8;                   // + 8 * slot
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int off = lk - lq;
  int kv_end = lk;  // one past the tile's last visible column
  if (causal) kv_end = min(lk, min(q0 + kBlockM, lq) + off);
  const int n_kt = kv_end <= 0 ? 0 : (kv_end + N - 1) / N;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kConsumers);
      mbar_init(v_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer: one lane issues TMA
    regs_down<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(sQ + c * T::kQChunk, &tq, q_full, c * kBoxCols, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t reuse = ((kt / kStages) - 1) & 1;
        if (kt >= kStages) mbar_wait(k_empty + 8 * st, reuse);
        mbar_expect_tx(k_full + 8 * st, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(sK + st * T::kKVBytes + c * T::kKVChunk, &tk,
                   k_full + 8 * st, c * kBoxCols, kt * N, kvh, b);
        if (kt >= kStages) mbar_wait(v_empty + 8 * st, reuse);
        mbar_expect_tx(v_full + 8 * st, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(sV + st * T::kKVBytes + c * T::kKVChunk, &tv,
                   v_full + 8 * st, c * kBoxCols, kt * N, kvh, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg_first .. wg_first + 63 of the tile
  regs_up<kConsumerRegs>();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // rows r and r + 8 of the WG
  const int wg_first = q0 + wg * kRowsPerWG;
  const int c2 = 2 * (lane % 4);  // first column in each 8-column group
  const uint32_t qa = sQ + wg * kRowsPerWG * kRowBytes;
  // does key tile kt hold a masked column for any of this WG's rows?
  auto edge = [&](int kt) {
    return (causal && (kt + 1) * N - 1 > wg_first + off) || (kt + 1) * N > lk;
  };
  // release a K or V slot: each warp arrives once its reads are done
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float o[T::kFull][32], ot[T::kTailRegs];
#pragma unroll
  for (int c = 0; c < T::kFull; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::kTailRegs; ++i) ot[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];
  float s[N / 2];
  uint32_t pa[N / 16][4];

  mbar_wait(q_full, 0);
  if (n_kt > 0) {
    // tile 0: S, softmax, P
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<DH, N>(s, qa, sK);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty);
    softmax_tile<N>(s, m, l, alpha, edge(0), wg_first + r, c2, off, lk,
                    causal, scale_log2);
    pack_a<N>(s, pa);
    // tile kt: S_kt and O += P_{kt-1} V_{kt-1} in flight together; the
    // softmax of S_kt runs while P V still occupies the tensor cores
    for (int kt = 1; kt < n_kt; ++kt) {
      const int st = kt % kStages, pst = (kt - 1) % kStages;
      mbar_wait(k_full + 8 * st, (kt / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk<DH, N>(s, qa, sK + st * T::kKVBytes);
      mbar_wait(v_full + 8 * pst, ((kt - 1) / kStages) & 1);
      issue_pv<DH, N>(o, ot, pa, sV + pst * T::kKVBytes);
      wgmma_wait<1>();
      fence_regs(s);
      release(k_empty + 8 * st);
      softmax_tile<N>(s, m, l, alpha, edge(kt), wg_first + r, kt * N + c2,
                      off, lk, causal, scale_log2);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < T::kFull; ++c) fence_regs(o[c]);
      fence_regs(ot);
      release(v_empty + 8 * pst);
#pragma unroll
      for (int c = 0; c < T::kFull; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < T::kTailRegs; ++i) ot[i] *= alpha[(i >> 1) & 1];
      pack_a<N>(s, pa);
    }
    // the last tile's P V
    const int lst = (n_kt - 1) % kStages;
    mbar_wait(v_full + 8 * lst, ((n_kt - 1) / kStages) & 1);
#pragma unroll
    for (int c = 0; c < T::kFull; ++c) fence_regs(o[c]);
    fence_regs(ot);
    wgmma_fence();
    issue_pv<DH, N>(o, ot, pa, sV + lst * T::kKVBytes);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::kFull; ++c) fence_regs(o[c]);
    fence_regs(ot);
    release(v_empty + 8 * lst);
  }

  // epilogue: divide, round, stage in the Q buffer, one TMA store per box
  float den[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    den[j] = fmaxf(l[j], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < T::kFull; ++c)
    stage_out(o[c], qa + c * T::kQChunk, r, c2, den);
  if constexpr (T::kTailN > 0)
    stage_out(ot, qa + T::kFull * T::kQChunk, r, c2, den);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0 && wg_first < lq) {
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      tma_store(&to, qa + c * T::kQChunk, c * kBoxCols, wg_first, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// --------------------------------------------------------------------- host

// A 4-D map over (Dh, L, H, B) of a bf16 [B, H, L, Dh] view with element
// strides (sb, sh, sl) and a unit last stride; boxes of 64 x rows.
bool make_map(CUtensorMap* map, const void* base, int dh, int len, int heads,
              int batch, long long sb, long long sh, long long sl,
              int box_rows) {
  const long long dims[4] = {dh, len, heads, batch};
  const long long strides[3] = {sl, sh, sb};
  const int box[4] = {kBoxCols, box_rows, 1, 1};
  return make_map_bf16(map, base, 4, dims, strides, box);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int hkv, int lq, int lk, int causal, float scale,
           const long long* st, cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, DH, lq, hq, batch, st[0], st[1], st[2], kBlockM) ||
      !make_map(&mk, k, DH, lk, hkv, batch, st[3], st[4], st[5], T::kN) ||
      !make_map(&mv, v, DH, lk, hkv, batch, st[6], st[7], st[8], T::kN) ||
      !make_map(&mo, out, DH, lq, hq, batch, st[9], st[10], st[11],
                kRowsPerWG))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(batch * hq),
                  static_cast<unsigned>((lq + kBlockM - 1) / kBlockM));
  flash_attention_sm90_kernel<DH><<<grid, kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mo, hq, hkv, lq, lk, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: bf16 [B, H, L, Dh] views; strides: 12 element strides,
// (batch, head, row) of q, k, v and out in that order, each a multiple of
// 8 elements (16 bytes), every base pointer 16-byte aligned (TMA's rules;
// the wrapper checks them).
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int batch, int hq,
    int hkv, int lq, int lk, int dh, int causal, float scale, long long qsb,
    long long qsh, long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, long long osb, long long osh,
    long long osl, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv || lq <= 0 || lk <= 0 ||
      (lq + kBlockM - 1) / kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qsh, qsl, ksb, ksh, ksl,
                            vsb, vsh, vsl, osb, osh, osl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(q, k, v, out, batch, hq, hkv, lq, lk, causal, scale, st,
                      s);
  if (dh == 128)
    return launch<128>(q, k, v, out, batch, hq, hkv, lq, lk, causal, scale,
                       st, s);
  if (dh == 160)
    return launch<160>(q, k, v, out, batch, hq, hkv, lq, lk, causal, scale,
                       st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA (bytes) at head dim `dh`, 0 if unsupported.
extern "C" int repro_flash_attention_sm90_smem(int dh) {
  if (dh == 64) return Tile<64>::kSmem;
  if (dh == 128) return Tile<128>::kSmem;
  if (dh == 160) return Tile<160>::kSmem;
  return 0;
}
