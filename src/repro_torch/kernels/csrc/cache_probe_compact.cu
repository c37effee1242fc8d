// cache_probe_compact: the shard holder's side of the compact probe round.
// For each holder h and destination row w of its received probe ids:
//   probe every id (first matching way; ids < 0 never hit — they are the
//   empty-probe-slot sentinel and must not alias empty slots, key -1),
//   keep the first hit_cap hits in slot order (later hits are demoted),
//   words[h, w, :]     = bitmap of the kept hits   (bit s % 32 of word s / 32)
//   raw_words[h, w, :] = bitmap of all hits before demotion
//   payload[h, w, p]   = row of the p-th kept hit, zeros past the kept count
// keys [H, C] int32, rows [H, C, D] float32/bfloat16, ids [H, W, R] int32,
// words/raw_words [H, W, ceil(R/32)] (the int32 bit pattern of uint32
// words), payload [H, W, hc, D] with hc = min(hit_cap, R).
//
// Replaces: src/repro/kernels/cache_gather.py::cache_probe_compact_pallas
// (the pallas_call at :232) — the holder side of
// core/generation.py::_shard_probe on the compact wire, run by the sharded
// cache at W > 1.  Semantics: repro/kernels/ref.py::cache_probe_compact_ref.
//
// Bound on the H100: bytes.  At the W = 4 serve inputs (ids [4, 4, 13 464],
// hit_cap 6 732, D 128 float32, 4 096 key slots per holder) the function
// must read the ids (0.86 MB), the keys (64 KB) and the ~4 200 kept rows
// (~8.6 MB), and write the two bitmaps (54 KB) and the payload, 55.1 MB of
// which ~46 MB is the zero tail past the kept rows: 64.5 MB, 0.0193 ms at
// 3.35 TB/s.  So the kernel is a store stream with a probe in front of it.
//
// What the first version lost: one 1 024-thread block per (holder,
// destination), 16 blocks at W = 4, so 16 of the card's 132 SMs carried
// the whole 55 MB payload with 4-byte stores, one warp per row, after a
// block-wide prefix and three __syncthreads per 1 024-slot tile
// (0.0913 ms, 4.7x the bound).
//
// Design: ONE launch over H * W * S CTAs, S = the plan's cluster size
// (clamp(ceil(SMs / (H * W)), 1, 8): 8 at W = 4, so 128 CTAs in one wave).
// The S CTAs of a destination row form a thread-block cluster; cluster
// rank c owns a contiguous range of whole bitmap words, so no 32-slot word
// is split between CTAs.  Each CTA issues its probe ids, stages holder h's
// keys in shared memory once, probes its slots (a warp's __ballot_sync is
// one raw word), and takes an exclusive prefix over its words' hit counts.
// The kept/demoted split needs every hit's rank in the whole row, a prefix
// ACROSS the CTAs of one launch: that is what the cluster is for.  Each CTA
// publishes its hit count in its shared memory; after cluster.sync() every
// CTA reads all S counts through distributed shared memory
// (map_shared_rank), so it knows the hits below it and the row's total.
// It then issues its share of the zero tail, rows [min(total, hc), hc),
// split evenly over the S CTAs, with 16-byte stores that drain while the
// rest runs.  The warp that owns a word writes its kept and raw words, and
// each CTA lists its kept hits' cache slots in rank order.  The probe
// rounds fill their slots from the front, so the hits sit in the first
// ranks' words: after a second cluster.sync() each CTA takes an EVEN share
// of the row's kept rows and gathers their slots from the owners' lists,
// again through distributed shared memory (owning the copies, the first
// ranks took 24 of 51 us at the serve inputs).  It then arrives on the
// cluster barrier and waits on it only before it exits: a CTA's shared
// memory must outlive the other CTAs' reads of it, and without that wait
// the result is silently wrong.  The share's rows are copied one warp per
// row, four rows in flight per warp, with 16-byte loads and stores (a
// 512-byte float32 row is one int4 per lane).  A row whose byte width is
// not a multiple of 16 takes the scalar instance of the same kernel
// (V = T).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // probe ids and kept rows in flight per thread
constexpr int kMaxCluster = 8;  // the portable cluster size

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ int4 zero_of<int4>() { return make_int4(0, 0, 0, 0); }
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// V is the unit a lane moves: int4 (the vector route, any dtype) or the
// element type itself (the scalar route); row_vecs is a row's width in V.
template <typename V>
__global__ void __launch_bounds__(kThreads)
probe_compact_kernel(const int32_t* __restrict__ keys, const V* __restrict__ rows,
                     const int32_t* __restrict__ ids, int32_t* __restrict__ words,
                     int32_t* __restrict__ raw_words, V* __restrict__ payload,
                     int n_slots_c, int n_probe, int n_words, int words_per_cta,
                     int hit_cap, int row_vecs, int assoc, int shift) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int w = blockIdx.y;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row_id = static_cast<int64_t>(h) * gridDim.y + w;
  const int w0 = rank * words_per_cta;                         // first word
  const int n_own = max(0, min(words_per_cta, n_words - w0));  // words owned
  const int n_own_slots = n_own * 32;

  // shared memory: the holder's keys, then per owned slot its matched cache
  // slot (-1 on a miss) and the kept list, then per owned word its hit
  // ballot and its hit count (turned into an exclusive offset)
  extern __shared__ int4 smem_v[];
  int32_t* sk = reinterpret_cast<int32_t*>(smem_v);
  int32_t* sslot = sk + n_slots_c;
  int32_t* skept = sslot + words_per_cta * 32;
  uint32_t* sraw = reinterpret_cast<uint32_t*>(skept + words_per_cta * 32);
  int32_t* soff = reinterpret_cast<int32_t*>(sraw + words_per_cta);
  __shared__ int s_count;               // this CTA's hits: read by the cluster
  __shared__ int s_pre[kMaxCluster + 1];  // the ranks' hit prefix, the total

  // the thread's first kUnroll probe ids go out before the keys are
  // staged, so the two round trips overlap (at the W = 4 rounds a thread
  // has at most kUnroll slots)
  const int32_t* pid = ids + row_id * n_probe;
  const int s0 = w0 * 32;
  int32_t id[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = threadIdx.x + u * kThreads;
    id[u] = (i < n_own_slots && s0 + i < n_probe) ? pid[s0 + i] : -1;
  }
  const int32_t* kg = keys + static_cast<int64_t>(h) * n_slots_c;
  for (int i = threadIdx.x; i < n_slots_c; i += kThreads) sk[i] = kg[i];
  __syncthreads();

  // probe, kUnroll slots per thread at a time
  for (int i0 = threadIdx.x; i0 < n_own_slots; i0 += kUnroll * kThreads) {
    if (i0 != threadIdx.x) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        id[u] = (i < n_own_slots && s0 + i < n_probe) ? pid[s0 + i] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n_own_slots) break;  // warp-uniform: a multiple of 32
      int slot = -1;
      if (id[u] >= 0) {
        const int sb = static_cast<int>(repro::set_of(id[u], shift)) * assoc;
        for (int j = 0; j < assoc; ++j) {
          if (sk[sb + j] == id[u]) {
            slot = sb + j;
            break;
          }
        }
      }
      const unsigned ball = __ballot_sync(0xffffffffu, slot >= 0);
      sslot[i] = slot;
      if (lane == 0) {
        sraw[i >> 5] = ball;
        soff[i >> 5] = __popc(ball);
      }
    }
  }
  __syncthreads();

  // exclusive prefix over the owned words' hit counts (warp 0, 32 at a time)
  if (warp == 0) {
    int carry = 0;
    for (int b = 0; b < n_own; b += 32) {
      const int j = b + lane;
      const int v = j < n_own ? soff[j] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (j < n_own) soff[j] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_count = carry;
  }
  cluster.sync();  // every CTA's s_count is published

  // the hits of the ranks below each rank, and the row's total
  if (warp == 0) {
    const int v = lane < n_ranks ? *cluster.map_shared_rank(&s_count, lane) : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < kMaxCluster; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < n_ranks) s_pre[lane] = incl - v;
    if (lane == n_ranks - 1) s_pre[n_ranks] = incl;
  }
  __syncthreads();
  const int base = s_pre[rank];
  const int kept_total = min(s_pre[n_ranks], hit_cap);

  const V* rsrc = rows + static_cast<int64_t>(h) * n_slots_c * row_vecs;
  V* pay = payload + row_id * static_cast<int64_t>(hit_cap) * row_vecs;
  // the zero tail, rows [kept_total, hit_cap), split evenly over the
  // cluster: issued first, its stores drain while the words are written,
  // the kept lists gathered and the kept rows copied
  const int64_t tail = static_cast<int64_t>(hit_cap - kept_total) * row_vecs;
  const int64_t per = (tail + n_ranks - 1) / n_ranks;
  const int64_t t1 = min(tail, (rank + 1) * per);
  V* zt = pay + static_cast<int64_t>(kept_total) * row_vecs;
  const V z = zero_of<V>();
#pragma unroll 4
  for (int64_t i = rank * per + threadIdx.x; i < t1; i += kThreads) zt[i] = z;

  // kept and raw words, by the warp that owns each; the kept list in rank
  // order (a kept hit's payload slot is its rank in the row)
  int32_t* wo = words + row_id * n_words;
  int32_t* ro = raw_words + row_id * n_words;
  const unsigned below_lane = (1u << lane) - 1u;
  for (int j = warp; j < n_own; j += kWarps) {
    const unsigned raw = sraw[j];
    const int local = soff[j] + __popc(raw & below_lane);  // rank in the CTA
    const bool hit = (raw >> lane) & 1u;
    const bool kept = hit && base + local < hit_cap;
    const unsigned kball = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) {
      wo[w0 + j] = static_cast<int32_t>(kball);
      ro[w0 + j] = static_cast<int32_t>(raw);
    }
    if (kept) skept[local] = sslot[j * 32 + lane];
  }
  cluster.sync();  // every CTA's kept list is built

  // this rank's even share of the row's kept rows, e0 .. e0 + n_keep: their cache
  // slots gathered from the kept lists of the CTAs that own them (the
  // probe rounds fill their slots from the front, so the hits sit in the
  // first ranks' words) into sslot, which is free now
  const int per_keep = (kept_total + n_ranks - 1) / n_ranks;
  const int e0 = min(rank * per_keep, kept_total);
  const int n_keep = min(e0 + per_keep, kept_total) - e0;
  for (int e = threadIdx.x; e < n_keep; e += kThreads) {
    int q = 0;  // the owner: s_pre[q] <= e0 + e < s_pre[q + 1]
    while (s_pre[q + 1] <= e0 + e) ++q;
    sslot[e] = cluster.map_shared_rank(skept, q)[e0 + e - s_pre[q]];
  }
  __syncthreads();
  cluster_arrive();  // done reading the cluster's shared memory

  // the share's rows: one warp per row, kUnroll rows in flight per warp
  for (int f0 = warp * kUnroll; f0 < n_keep; f0 += kWarps * kUnroll) {
    int src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      src[u] = f0 + u < n_keep ? sslot[f0 + u] : -1;
    V* dst = pay + static_cast<int64_t>(e0 + f0) * row_vecs;
    for (int v = lane; v < row_vecs; v += 32) {
      V t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        t[u] = src[u] >= 0 ? rsrc[static_cast<int64_t>(src[u]) * row_vecs + v]
                           : zero_of<V>();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (src[u] >= 0) dst[static_cast<int64_t>(u) * row_vecs + v] = t[u];
    }
  }

  cluster_wait();  // no CTA leaves while another may read its shared memory
}

template <typename V>
int launch(const void* keys, const void* rows, const void* ids, void* words,
           void* raw_words, void* payload, int n_holders, int n_slots_c,
           int n_dest, int n_probe, int n_words, int hit_cap, int row_vecs,
           int assoc, int shift, int cluster, int words_per_cta, int smem,
           cudaStream_t stream) {
  const auto kernel = probe_compact_kernel<V>;
  cudaError_t err;
  if (smem > 48 * 1024) {  // above the default: opt in (up to 227 KB)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_dest, n_holders);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int32_t*>(keys),
      static_cast<const V*>(rows), static_cast<const int32_t*>(ids),
      static_cast<int32_t*>(words), static_cast<int32_t*>(raw_words),
      static_cast<V*>(payload), n_slots_c, n_probe, n_words, words_per_cta,
      hit_cap, row_vecs, assoc, shift);
  return static_cast<int>(err);
}

}  // namespace

// cluster, words_per_cta and smem are the wrapper's launch plan
// (cache_gather.py::compact_plan); vec selects the 16-byte route, on which
// a row is d_dim * element size / 16 int4 units.
extern "C" int repro_cache_probe_compact(const void* keys, const void* rows,
                                         const void* ids, void* words,
                                         void* raw_words, void* payload,
                                         int n_holders, int n_slots_c,
                                         int n_dest, int n_probe, int n_words,
                                         int hit_cap, int d_dim, int assoc,
                                         int shift, int dtype, int cluster,
                                         int words_per_cta, int smem, int vec,
                                         void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == repro::kF32 ? 4 : 2;
  int status;
  if (vec) {
    if ((d_dim * elem) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    status = launch<int4>(keys, rows, ids, words, raw_words, payload,
                          n_holders, n_slots_c, n_dest, n_probe, n_words,
                          hit_cap, d_dim * elem / 16, assoc, shift, cluster,
                          words_per_cta, smem, s);
  } else if (dtype == repro::kF32) {
    status = launch<float>(keys, rows, ids, words, raw_words, payload,
                           n_holders, n_slots_c, n_dest, n_probe, n_words,
                           hit_cap, d_dim, assoc, shift, cluster,
                           words_per_cta, smem, s);
  } else {
    status = launch<__nv_bfloat16>(keys, rows, ids, words, raw_words, payload,
                                   n_holders, n_slots_c, n_dest, n_probe,
                                   n_words, hit_cap, d_dim, assoc, shift,
                                   cluster, words_per_cta, smem, s);
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
