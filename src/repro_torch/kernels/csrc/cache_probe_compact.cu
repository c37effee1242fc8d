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
// Bound on the H100: bytes — the probe ids, the keys, the kept rows and the
// payload (its zero tail included), and the two bitmaps.  The kernel never
// builds the dense [W, R, D] response block the compact wire exists to
// avoid.
//
// Design: one block of 1024 threads per (destination, holder), and ONE
// launch for every destination of every holder.  The block walks the R
// probe slots in tiles of 1024: each thread probes one slot, a warp packs
// its 32 hit flags into one bitmap word with __ballot_sync (warp j of a
// tile owns exactly word base/32 + j), and a block-wide prefix sum over the
// warps' popcounts, carried across tiles, gives every hit its rank — so the
// kept bitmap and each kept row's payload slot (rank) come out of one pass.
// The TPU kernel's rank select, a [hit_cap, R] comparison matrix (~9e7
// compares per destination at the serve shape), is not carried over.  The
// kept rows of a tile are then copied by whole warps, 32 lanes along D, as
// coalesced lines out of L2 (the 2 MB cache is L2-resident; the TPU design's
// VMEM residency has no counterpart in 227 KB of shared memory).  Known
// limit of this first version: only H * W blocks run (16 at W = 4), so the
// kernel uses a fraction of the card's 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_compact_kernel(const int32_t* __restrict__ keys, const T* __restrict__ rows,
                     const int32_t* __restrict__ ids, int32_t* __restrict__ words,
                     int32_t* __restrict__ raw_words, T* __restrict__ payload,
                     int n_slots_c, int n_dest, int n_probe, int n_words,
                     int hit_cap, int d_dim, int assoc, int shift) {
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row_id = static_cast<int64_t>(h) * n_dest + w;
  const int32_t* k = keys + static_cast<int64_t>(h) * n_slots_c;
  const T* rw = rows + static_cast<int64_t>(h) * n_slots_c * d_dim;
  const int32_t* pid = ids + row_id * n_probe;
  int32_t* wo = words + row_id * n_words;
  int32_t* ro = raw_words + row_id * n_words;
  T* pay = payload + row_id * static_cast<int64_t>(hit_cap) * d_dim;

  __shared__ int warp_cnt[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  __shared__ int kslot[kThreads];

  int running = 0;  // hits in earlier tiles (block-uniform)
  const int n_pad = n_words * 32;
  for (int base = 0; base < n_pad; base += kThreads) {
    const int s = base + threadIdx.x;
    const int32_t id = s < n_probe ? pid[s] : -1;
    int slot = -1;
    if (id >= 0) {
      const int sb = static_cast<int>(repro::set_of(id, shift)) * assoc;
      for (int j = 0; j < assoc; ++j) {
        if (k[sb + j] == id) {
          slot = sb + j;
          break;
        }
      }
    }
    const bool is_hit = slot >= 0;
    const unsigned ball = __ballot_sync(0xffffffffu, is_hit);
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_cnt[lane];
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      warp_off[lane] = incl - v;
      if (lane == 31) tile_total = incl;
    }
    __syncthreads();
    const int rank = running + warp_off[warp] + __popc(ball & ((1u << lane) - 1u));
    const bool kept = is_hit && rank < hit_cap;
    const unsigned kball = __ballot_sync(0xffffffffu, kept);
    const int word = s >> 5;
    if (lane == 0 && word < n_words) {
      wo[word] = static_cast<int32_t>(kball);
      ro[word] = static_cast<int32_t>(ball);
    }
    if (kept) kslot[rank - running] = slot;
    __syncthreads();
    const int n_keep = min(max(hit_cap - running, 0), tile_total);
    for (int e = warp; e < n_keep; e += kWarps) {
      const T* src = rw + static_cast<int64_t>(kslot[e]) * d_dim;
      T* dst = pay + static_cast<int64_t>(running + e) * d_dim;
      for (int d = lane; d < d_dim; d += 32) dst[d] = src[d];
    }
    running += tile_total;
    __syncthreads();  // kslot, warp_cnt and tile_total are rewritten next tile
  }
  const T zero = repro::from_float<T>(0.f);
  for (int p = min(running, hit_cap) + warp; p < hit_cap; p += kWarps) {
    T* dst = pay + static_cast<int64_t>(p) * d_dim;
    for (int d = lane; d < d_dim; d += 32) dst[d] = zero;
  }
}

template <typename T>
void launch(const void* keys, const void* rows, const void* ids, void* words,
            void* raw_words, void* payload, int n_holders, int n_slots_c,
            int n_dest, int n_probe, int n_words, int hit_cap, int d_dim,
            int assoc, int shift, cudaStream_t stream) {
  const dim3 grid(n_dest, n_holders);
  probe_compact_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(keys), static_cast<const T*>(rows),
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(words),
      static_cast<int32_t*>(raw_words), static_cast<T*>(payload), n_slots_c,
      n_dest, n_probe, n_words, hit_cap, d_dim, assoc, shift);
}

}  // namespace

extern "C" int repro_cache_probe_compact(const void* keys, const void* rows,
                                         const void* ids, void* words,
                                         void* raw_words, void* payload,
                                         int n_holders, int n_slots_c,
                                         int n_dest, int n_probe, int n_words,
                                         int hit_cap, int d_dim, int assoc,
                                         int shift, int dtype, void* stream) {
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(keys, rows, ids, words, raw_words, payload, n_holders,
                  n_slots_c, n_dest, n_probe, n_words, hit_cap, d_dim, assoc,
                  shift, s);
  else
    launch<__nv_bfloat16>(keys, rows, ids, words, raw_words, payload,
                          n_holders, n_slots_c, n_dest, n_probe, n_words,
                          hit_cap, d_dim, assoc, shift, s);
  return static_cast<int>(cudaGetLastError());
}
