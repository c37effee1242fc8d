// flash_attention_sm90: the bfloat16 route of flash_attention on Hopper,
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * scale) v[b, j, g]
// over q [B, Hq, Lq, Dh] and k/v [B, Hkv, Lk, Dh] given as ANY strided
// views whose last dimension is contiguous (the dense LM passes
// [B, L, H, Dh] tensors transposed to [B, H, L, Dh], read in place), and
// out written through its own strides (the wrapper allocates [B, Lq, Hq,
// Dh] and returns the transposed view).  g = h / (Hq / Hkv), scale =
// 1 / sqrt(Dh), Dh 64 or 128.  Causal: row i sees column j iff
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
//   Dh 128 takes two boxes per tile, one after the other.  The Q tile
//   comes once; K and V tiles (128 keys at Dh 64, 64 keys at Dh 128, so
//   that the score and output accumulators fit in 160 registers) run
//   through two-slot rings, one for K and one for V, each slot with a
//   "full" mbarrier (TMA's transaction count) and an "empty" one that the
//   twelve consumer warps arrive on, so K slots free as soon as the scores
//   are done.  Key tiles entirely above the causal diagonal are never
//   loaded; TMA fills rows past Lq or Lk with zeros, and their columns are
//   masked.
// - S = Q K^T: wgmma m64nNk16 (N = keys per tile), both operands in shared
//   memory, K-major, Dh / 16 steps; the descriptors carry the 128-byte
//   swizzle mode of the tensor maps, and a step advances the start address
//   by 32 bytes within the swizzled row (by a whole box past 64 columns).
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
//   transposed copy; one n64 product per 64 output columns.
// - Epilogue: one division per element by the clamped denominator, the
//   bf16 tile stored into the warpgroup's own rows of the Q buffer in the
//   128-byte swizzle, then one TMA store per 64 columns through the
//   output's tensor map (rows past Lq are clipped by the hardware).
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so the library links no libcuda)
// and passed as __grid_constant__ kernel parameters.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kConsumers = 3;                       // consumer warpgroups
constexpr int kRowsPerWG = 64;                      // wgmma M
constexpr int kBlockM = kConsumers * kRowsPerWG;    // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);    // + a producer WG
// setmaxnreg: 128 x 32 + 384 x 160 = the SM's 65536 registers
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kStages = 2;                          // K and V ring depth
constexpr int kBoxCols = 64;                        // bf16 per swizzled row
constexpr int kRowBytes = 128;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int kN = DH == 64 ? 128 : 64;         // keys per tile
  static constexpr int kChunks = DH / kBoxCols;          // boxes per row
  static constexpr int kQChunk = kBlockM * kRowBytes;    // one Q box
  static constexpr int kKVChunk = kN * kRowBytes;        // one K or V box
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;
  // Q | K ring | V ring | mbarriers, from a 1024-byte aligned base
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle.  The stride between
// 8-row groups is 1024 bytes (8 rows of 128 bytes); the leading offset,
// used by no operand here (a K-major k16 step stays inside one 128-byte
// row, and every MN-major B operand is one 64-wide box), is set to the
// same 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1024 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most `kPending` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Order ordinary reads and writes of accumulator registers against the
// asynchronous products (the compiler sees the asm statements' operands
// only where they are issued).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] (+)= A[64 x 16] B[16 x 128], A and B in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] (+)= A[64 x 16] B[16 x 64], A and B in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A[64 x 16] B[16 x 64], A in registers, B in shared memory
// (MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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
// from registers, V MN-major (16 key rows of 128 bytes per step).
template <int DH, int N>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 64][32],
                                         const uint32_t (&pa)[N / 16][4],
                                         uint32_t va) {
  using T = Tile<DH>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_rs(o[c], pa[ks],
               sw128_desc(va + c * T::kKVChunk + ks * 16 * kRowBytes));
  wgmma_commit();
}

// 2^x, flushing results below 2^-126 to zero (a single MUFU.EX2).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The S fragment of 16 key columns is the A fragment of one k16 step.
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2],
                                       uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[ks][j] = pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
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

  float o[T::kChunks][32];
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
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
    pack_p<N>(s, pa);
    // tile kt: S_kt and O += P_{kt-1} V_{kt-1} in flight together; the
    // softmax of S_kt runs while P V still occupies the tensor cores
    for (int kt = 1; kt < n_kt; ++kt) {
      const int st = kt % kStages, pst = (kt - 1) % kStages;
      mbar_wait(k_full + 8 * st, (kt / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk<DH, N>(s, qa, sK + st * T::kKVBytes);
      mbar_wait(v_full + 8 * pst, ((kt - 1) / kStages) & 1);
      issue_pv<DH, N>(o, pa, sV + pst * T::kKVBytes);
      wgmma_wait<1>();
      fence_regs(s);
      release(k_empty + 8 * st);
      softmax_tile<N>(s, m, l, alpha, edge(kt), wg_first + r, kt * N + c2,
                      off, lk, causal, scale_log2);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) fence_regs(o[c]);
      release(v_empty + 8 * pst);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
      pack_p<N>(s, pa);
    }
    // the last tile's P V
    const int lst = (n_kt - 1) % kStages;
    mbar_wait(v_full + 8 * lst, ((n_kt - 1) / kStages) & 1);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) fence_regs(o[c]);
    wgmma_fence();
    issue_pv<DH, N>(o, pa, sV + lst * T::kKVBytes);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) fence_regs(o[c]);
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
  for (int c = 0; c < T::kChunks; ++c) {
    const uint32_t ob = qa + c * T::kQChunk;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int half = (i >> 1) & 1;
      const int row = r + 8 * half;
      const uint32_t addr =
          ob + row * kRowBytes + (((i >> 2) ^ (row & 7)) << 4) + 2 * c2;
      const uint32_t val =
          pack_bf16(o[c][i] / den[half], o[c][i + 1] / den[half]);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (Dh, L, H, B) of a bf16 [B, H, L, Dh] view with element
// strides (sb, sh, sl) and a unit last stride; boxes of 64 x rows.
bool make_map(CUtensorMap* map, const void* base, int dh, int len, int heads,
              int batch, long long sb, long long sh, long long sl,
              int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA (bytes) at head dim `dh`, 0 if unsupported.
extern "C" int repro_flash_attention_sm90_smem(int dh) {
  if (dh == 64) return Tile<64>::kSmem;
  if (dh == 128) return Tile<128>::kSmem;
  return 0;
}
