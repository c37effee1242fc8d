// ssd_scan_sm90: the bfloat16 route of ssd_scan on Hopper,
//   y[b, l, h] = sum_{j <= l in l's chunk} (c_l . b_j) exp(cum_l - cum_j)
//                  dt[b, j, h] x[b, j, h]
//              + exp(cum_l) (c_l . state_h)          (state before the chunk)
//   state_h'   = state_h exp(cum_{Q-1})
//              + sum_j exp(cum_{Q-1} - cum_j) dt[b, j, h] x[b, j, h] b_j^T
// over x [B, L, H, 64] and b/c [B, L, N] in bfloat16, given as ANY strided
// views whose last dimension is contiguous (the SSM passes three views of
// its conv output [B, L, d_in + 2N], read in place), dt [B, L, H] and a [H]
// in float32 (contiguous), and y [B, L, H, 64] bfloat16 (contiguous).  cum
// is the running sum of a[h] dt[b, :, h] within a chunk of Q rows, the
// [64, N] float32 state carried across the chunks of one sequence in
// order.  Q 64 or 128, N 64 or 128 (mamba2-1.3b: N 128, zamba2-1.2b: N 64,
// both Q 128).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (the
// pallas_call at :79) for bfloat16 operands, the dtype of every layer of
// the SSM's full-sequence forward (float32 operands keep the SIMT kernel in
// ssd_scan.cu).  The Pallas kernel upcasts x, b and c to float32 and
// returns x's dtype; here x, b and c enter the tensor cores as they are
// (exact), every product accumulates in float32, cum, the decays and the
// state stay float32, and three operands the kernel forms are rounded to
// bfloat16: the decayed scores before scores . x, x . w before the state
// update, and the copy of the float32 state the next chunk's inter term
// reads (kernels/ssd_scan.py::bf16_error_bound holds it to the bound
// this gives).
//
// Bound on the H100: bytes.  At mamba2-1.3b's prefill (B 8, L 2048, H 64,
// N 128, Q 128) x and y are 134.2 MB each in bf16, b and c 4.2 MB each and
// dt 4.2 MB: ~0.281 GB, 0.0839 ms at 3.35 TB/s; the 41.3 GFLOP the function
// needs take 0.042 ms at the 989 TFLOP/s dense bf16 tensor-core rate.
//
// Design.  The Pallas kernel carries the [P, N] state in VMEM along a
// sequential grid axis of chunks; here one CTA owns one (batch, head) and
// walks its chunks itself, keeping the state in the registers of one
// warpgroup.  Q / 64 consumer warpgroups (warpgroup w owns chunk rows 64w
// .. 64w + 63) and one producer warp:
// - Loads: TMA through tensor maps built over the operands' own strides,
//   x as (64, L, H, B) with boxes (64, Q, 1, 1), b and c as (N, L, B) with
//   boxes (64, Q, 1) (two per operand at N 128), into a two-slot ring; each
//   slot has a "full" mbarrier (TMA's transaction count) and an "empty" one
//   that every consumer warp arrives on.  Every box lands in the 128-byte
//   swizzle.  dt is read with ordinary loads, one row per thread, a chunk
//   ahead.
// - cum: each warpgroup scans a[h] dt over the chunk's rows in float64
//   (a warp shuffle scan and the four warp totals), rounded once per row:
//   the sum of float32 values in float64 is exact at these ranges, so any
//   order gives the twin's sequential running sum.
// - Per chunk and warpgroup, four wgmma products (m64, k16 steps):
//   G = C B^T over the warpgroup's rows and only the causal columns (n64
//   for rows 0-63, n128 for rows 64-127), both operands K-major in shared
//   memory; the inter term C state^T (n64), B the bf16 state copy, issued
//   with G and scaled per row by exp(cum_i) once done; the scores
//   G exp(cum_i - cum_j) dt_j (masked to j <= i, ex2.approx) rounded to
//   bf16 in registers as the A operand of scores . x (x MN-major, the
//   transpose bit), accumulated onto the inter term; and, in warpgroup 0
//   only, the state update (x w)^T b: x^T loaded from the x tile with
//   ldmatrix's transpose, each column j scaled by w_j and rounded to
//   bf16 as the register A operand, b MN-major as B, one n64 product per
//   64 state columns, accumulated onto state exp(cum_{Q-1}) in registers.
//   Warpgroup 0 owns the state because warpgroup 1's causal products are
//   twice as wide: the two then carry equal work.  Warpgroup 0 forms
//   x . w while G and the inter term run on the tensor cores, and its
//   state update runs there while the scores are formed; x . w never
//   passes through shared memory (a bf16 tile written, fenced and read
//   back was ~5% slower on an H100 at mamba2-1.3b's prefill shape).
// - Only the state is sequential from chunk to chunk: warpgroup 0 writes
//   its bf16 copy once the other warpgroup has read the previous one (a
//   named barrier each way), before its own output store, and the next
//   chunk's G and scores do not wait for it.
// - Output: each warpgroup stages its 64 x 64 bf16 rows in the swizzle and
//   stores them with one TMA store into y.
// The tensor maps are encoded on the host per call and passed as
// __grid_constant__ kernel parameters.
#include "sm90.cuh"

namespace {

constexpr int kP = 64;        // head dim: one swizzled row
constexpr int kStages = 2;    // x / b / c ring depth
constexpr float kLog2e = 1.4426950408889634f;
// named barriers: 1 + w per warpgroup; these two between the warpgroups
constexpr int kStateReady = 3;  // warpgroup 0 wrote the state copy
constexpr int kStateRead = 4;   // warpgroup 1 finished reading it

template <int Q, int N>
struct Layout {
  static constexpr int kConsumers = Q / 64;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kNBoxes = N / 64;
  static constexpr int kTile = Q * kRowBytes;         // one [Q][64] box
  static constexpr int kSlot = (1 + 2 * kNBoxes) * kTile;  // x | b | c
  static constexpr int kStateBox = kP * kRowBytes;    // [64 p][64 n]
  static constexpr int kState = kStages * kSlot;      // bf16 state copy
  static constexpr int kY = kState + kNBoxes * kStateBox;  // output stage
  // per warpgroup: (cum, dt) pairs, w, exp(cum), four warp totals
  static constexpr int kScalars = kY + kTile;
  static constexpr int kScalarBytes = Q * 16 + 4 * 8;
  static constexpr int kBar = kScalars + kConsumers * kScalarBytes;
  static constexpr int kSmem = 1024 + kBar + 8 * 2 * kStages;
};

// Four 8 x 8 bf16 blocks, transposed, from the rows each lane addresses
// (lanes 8m .. 8m + 7 give block m's rows).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A bf16 pair scaled by (w.x, w.y) in float32, rounded back to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float2 w) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(p) * w.x, __high2float(p) * w.y);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One consumer warpgroup W of a (batch, head): rows 64W .. 64W + 63 of
// every chunk, and the state when W == 0.
template <int Q, int N, int W>
__device__ __forceinline__ void consumer(uint32_t base, uint8_t* gbase,
                                         uint32_t full, uint32_t empty,
                                         const CUtensorMap* ty,
                                         const float* __restrict__ dtp,
                                         float ah, int b, int h, int heads,
                                         int nc) {
  using L = Layout<Q, N>;
  constexpr int NG = 64 * (W + 1);      // causal score columns of the rows
  constexpr bool kPair = L::kConsumers == 2;
  constexpr int kSt = W == 0 ? L::kNBoxes : 1;
  const uint32_t sS = base + L::kState;
  const uint32_t sY = base + L::kY + W * 64 * kRowBytes;
  float2* cd = reinterpret_cast<float2*>(gbase + L::kScalars +
                                         W * L::kScalarBytes);
  float* wv = reinterpret_cast<float*>(cd + Q);
  float* ecum = wv + Q;
  double* tot = reinterpret_cast<double*>(ecum + Q);

  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r = warp * 16 + lane / 4;   // rows r and r + 8 of the 64
  const int c2 = 2 * (lane % 4);        // first column of each 8-column group
  const int row0 = 64 * W + r;          // chunk row of the thread's first row
  auto wg_sync = [] { bar_sync(1 + W, 128); };

  float g[NG / 2], y[32], st[kSt][32];
  uint32_t pa[NG / 16][4];
#pragma unroll
  for (int k = 0; k < kSt; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) st[k][i] = 0.f;

  float dt_next = t < Q ? dtp[static_cast<int64_t>(t) * heads] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int s = c % kStages;
    const uint32_t sX = base + s * L::kSlot;
    const uint32_t sB = sX + L::kTile;
    const uint32_t sC = sB + L::kNBoxes * L::kTile;

    // cum over the chunk's rows: float64 prefix scan, rounded once per row
    const float dt_t = dt_next;
    if (c + 1 < nc && t < Q)
      dt_next = dtp[(static_cast<int64_t>(c + 1) * Q + t) * heads];
    double v = static_cast<double>(ah * dt_t);
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) tot[warp] = v;
    wg_sync();
    double pre = 0.0, all = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double tk = tot[k];
      if (k < warp) pre += tk;
      all += tk;
    }
    const float last = static_cast<float>(all);   // cum_{Q-1}
    if (t < Q) {
      const float cum = static_cast<float>(v + pre);
      cd[t] = make_float2(cum, dt_t);
      wv[t] = dt_t * expf(last - cum);
      ecum[t] = expf(cum);
    }
    wg_sync();

    mbar_wait(full + 8 * s, (c / kStages) & 1);
    // G = C B^T (causal columns) and the inter term C state^T, issued
    // together
    const uint32_t cw = sC + W * 64 * kRowBytes;  // this warpgroup's C rows
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_ss(g, sw128_desc(cw + (ks / 4) * L::kTile + (ks % 4) * 32),
               sw128_desc(sB + (ks / 4) * L::kTile + (ks % 4) * 32), ks > 0);
    wgmma_commit();
    if (c > 0) {
      if (kPair && W == 1) bar_sync(kStateReady, 256);
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks)
        wgmma_ss(y, sw128_desc(cw + (ks / 4) * L::kTile + (ks % 4) * 32),
                 sw128_desc(sS + (ks / 4) * L::kStateBox + (ks % 4) * 32),
                 ks > 0);
      wgmma_commit();
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = 0.f;
    }
    if constexpr (W == 0) {
      // while they run: x w in bf16 as the register A operand of the state
      // update (x^T through ldmatrix's transpose, column j scaled by w_j),
      // then the update state exp(cum_{Q-1}) + (x w)^T b, which runs while
      // the scores are formed
      uint32_t xa[Q / 16][4];
#pragma unroll
      for (int ks = 0; ks < Q / 16; ++ks) {
        const int m = lane / 8;   // the 8 x 8 block this lane addresses
        const int j = 16 * ks + 8 * (m / 2) + lane % 8;
        ldmatrix_x4_trans(xa[ks], sX + swizzle_offset(j, 2 * warp + m % 2));
        const float2* w2 = reinterpret_cast<const float2*>(wv + 16 * ks + c2);
        const float2 w_lo = w2[0], w_hi = w2[4];  // columns c2 and 8 + c2
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xa[ks][q] = scale_pair(xa[ks][q], q < 2 ? w_lo : w_hi);
      }
      const float total = expf(last);
#pragma unroll
      for (int k = 0; k < kSt; ++k)
#pragma unroll
        for (int i = 0; i < 32; ++i) st[k][i] *= total;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Q / 16; ++ks)
#pragma unroll
        for (int k = 0; k < kSt; ++k)
          wgmma_rs(st[k], xa[ks],
                   sw128_desc(sB + k * L::kTile + ks * 16 * kRowBytes));
      wgmma_commit();
    }
    // G is done once at most the later groups are pending
    constexpr int kLater = W == 0 ? 1 : 0;   // the state update
    if (c > 0)
      wgmma_wait<kLater + 1>();
    else
      wgmma_wait<kLater>();
    fence_regs(g);

    // scores: G exp(cum_i - cum_j) dt_j where j <= i, rounded to bf16
    const float cum_r[2] = {cd[row0].x, cd[row0 + 8].x};
#pragma unroll
    for (int e = 0; e < NG / 2; ++e) {
      const int half = (e >> 1) & 1;
      const int col = 8 * (e >> 2) + c2 + (e & 1);
      const float2 cj = cd[col];
      const float decay = exp2_ftz((cum_r[half] - cj.x) * kLog2e) * cj.y;
      g[e] = col <= row0 + 8 * half ? g[e] * decay : 0.f;
    }
    pack_a<NG>(g, pa);

    if (c > 0) {
      wgmma_wait<kLater>();
      fence_regs(y);
      if (kPair && W == 1 && c < nc - 1) bar_arrive(kStateRead, 256);
      const float e0 = ecum[row0], e1 = ecum[row0 + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] *= ((i >> 1) & 1) ? e1 : e0;
    }
    // y += scores x
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NG / 16; ++ks)
      wgmma_rs(y, pa[ks], sw128_desc(sX + ks * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    if constexpr (W == 0) {
#pragma unroll
      for (int k = 0; k < kSt; ++k) fence_regs(st[k]);
    }
    __syncwarp();                       // this warpgroup is done with slot s
    if (lane == 0) mbar_arrive(empty + 8 * s);

    if constexpr (W == 0) {
      if (c + 1 < nc) {
        // the bf16 copy the next chunk's inter term reads
        if (kPair && c > 0) bar_sync(kStateRead, 256);
#pragma unroll
        for (int k = 0; k < kSt; ++k)
          store_tile_bf16(st[k], sS + k * L::kStateBox, r, c2);
        fence_async_smem();
        wg_sync();
        if (kPair) bar_arrive(kStateReady, 256);
      }
    }

    // the output rows: stage in the swizzle, one TMA store
    if (t == 0 && c > 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg_sync();
    store_tile_bf16(y, sY, r, c2);
    fence_async_smem();
    wg_sync();
    if (t == 0) {
      tma_store(ty, sY, 0, c * Q + 64 * W, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int Q, int N>
__global__ void __launch_bounds__(Layout<Q, N>::kThreads, 1)
ssd_scan_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap ty,
                     const float* __restrict__ dt,
                     const float* __restrict__ a, int seq_len, int heads) {
  using L = Layout<Q, N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + L::kBar;            // + 8 * slot
  const uint32_t empty = full + 8 * kStages;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int nc = seq_len / Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * L::kConsumers) {  // the producer: one lane issues TMA
    if (lane == 0) {
      for (int c = 0; c < nc; ++c) {
        const int s = c % kStages;
        const uint32_t sX = base + s * L::kSlot;
        const uint32_t sB = sX + L::kTile;
        const uint32_t sC = sB + L::kNBoxes * L::kTile;
        if (c >= kStages) mbar_wait(empty + 8 * s, ((c / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, L::kSlot);
        tma_load(sX, &tx, full + 8 * s, 0, c * Q, h, b);
#pragma unroll
        for (int k = 0; k < L::kNBoxes; ++k) {
          tma_load(sB + k * L::kTile, &tb, full + 8 * s, k * kBoxCols, c * Q,
                   b);
          tma_load(sC + k * L::kTile, &tc, full + 8 * s, k * kBoxCols, c * Q,
                   b);
        }
      }
    }
    return;
  }

  const float* dtp = dt + static_cast<int64_t>(b) * seq_len * heads + h;
  const float ah = a[h];
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  if (warp < 4)
    consumer<Q, N, 0>(base, gbase, full, empty, &ty, dtp, ah, b, h, heads,
                      nc);
  else if constexpr (L::kConsumers == 2)
    consumer<Q, N, 1>(base, gbase, full, empty, &ty, dtp, ah, b, h, heads,
                      nc);
}

// --------------------------------------------------------------------- host

template <int Q, int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, int batch, int seq_len, int heads,
           const long long* st, cudaStream_t stream) {
  using L = Layout<Q, N>;
  // x and y as (P, L, H, B), b and c as (N, L, B); strides in elements
  const long long xdims[4] = {kP, seq_len, heads, batch};
  const long long xstr[3] = {st[1], st[2], st[0]};
  const long long ystr[3] = {static_cast<long long>(heads) * kP, kP,
                             static_cast<long long>(seq_len) * heads * kP};
  const long long ndims[3] = {N, seq_len, batch};
  const long long bstr[2] = {st[4], st[3]};
  const long long cstr[2] = {st[6], st[5]};
  const int xbox[4] = {kBoxCols, Q, 1, 1};
  const int ybox[4] = {kBoxCols, 64, 1, 1};
  const int nbox[3] = {kBoxCols, Q, 1};
  CUtensorMap mx, mb, mc, my;
  if (!make_map_bf16(&mx, x, 4, xdims, xstr, xbox) ||
      !make_map_bf16(&mb, bm, 3, ndims, bstr, nbox) ||
      !make_map_bf16(&mc, cm, 3, ndims, cstr, nbox) ||
      !make_map_bf16(&my, y, 4, xdims, ystr, ybox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_sm90_kernel<Q, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_scan_sm90_kernel<Q, N><<<batch * heads, L::kThreads, L::kSmem, stream>>>(
      mx, mb, mc, my, static_cast<const float*>(dt),
      static_cast<const float*>(a), seq_len, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 [B, L, H, 64] view with element strides (xsb, xsl, xsh) and a
// unit last stride; b, c: bf16 [B, L, N] views with strides (sb, sl); dt
// float32 [B, L, H] and a float32 [H], contiguous; y: bf16 [B, L, H, 64]
// contiguous.  Every bf16 stride but the last a multiple of 8 elements (16
// bytes), every base 16-byte aligned (TMA's rules; the wrapper checks
// them).  q_len 64 or 128 dividing seq_len, n_dim 64 or 128.
extern "C" int repro_ssd_scan_sm90(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, void* y, int batch,
                                   int seq_len, int heads, int n_dim,
                                   int q_len, long long xsb, long long xsl,
                                   long long xsh, long long bsb,
                                   long long bsl, long long csb,
                                   long long csl, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 || q_len <= 0 ||
      seq_len % q_len ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[7] = {xsb, xsl, xsh, bsb, bsl, csb, csl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_len == 128 && n_dim == 128)
    return launch<128, 128>(x, dt, a, bm, cm, y, batch, seq_len, heads, st, s);
  if (q_len == 128 && n_dim == 64)
    return launch<128, 64>(x, dt, a, bm, cm, y, batch, seq_len, heads, st, s);
  if (q_len == 64 && n_dim == 128)
    return launch<64, 128>(x, dt, a, bm, cm, y, batch, seq_len, heads, st, s);
  if (q_len == 64 && n_dim == 64)
    return launch<64, 64>(x, dt, a, bm, cm, y, batch, seq_len, heads, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA (bytes) at chunk `q_len` and state width
// `n_dim`, 0 if unsupported.
extern "C" int repro_ssd_scan_sm90_smem(int q_len, int n_dim) {
  if (q_len == 128 && n_dim == 128) return Layout<128, 128>::kSmem;
  if (q_len == 128 && n_dim == 64) return Layout<128, 64>::kSmem;
  if (q_len == 64 && n_dim == 128) return Layout<64, 128>::kSmem;
  if (q_len == 64 && n_dim == 64) return Layout<64, 64>::kSmem;
  return 0;
}
