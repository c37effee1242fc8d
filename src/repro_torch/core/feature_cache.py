"""Device-resident hot-node feature cache (port of
``repro/core/feature_cache.py``, device store).

Set-associative by multiplicative hash, with frequency admission and a
counter-based victim policy; the sharded placement routes each id to
cache shard ``shard_of(id, W)``; the compact probe wire ships a packed hit
bitmap plus a payload of at most ``hit_cap`` rows per destination.  Every
function here reproduces the reference bit for bit: the tests hold each
state array and each wire word against ``repro``.

Two representation choices differ from the reference:

* uint32 arithmetic (the hashes, the bitmap words) runs in int64 with an
  explicit ``& 0xFFFFFFFF`` wrap, and bitmap words are carried as the
  int32 bit pattern of the uint32 word (``.view(np.uint32)`` recovers the
  reference's value);
* ``.at[...].set(..., mode="drop")`` with an out-of-range sentinel becomes
  a scatter into a buffer one row larger, sliced afterwards.

The tiered mode keeps a ``TieredCache(l1, l2)`` of two flat states: a
small replicated L1 (``CacheConfig.l1_config()``) in front of the sharded
L2 (``l2_config()``).  ``tiered_probe`` probes both tiers of one worker
in one ``cache_probe_tiered`` launch on a card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from .config import (VALID_CACHE_ASSOC as VALID_ASSOC,
                     VALID_CACHE_MODES as VALID_MODES,
                     VALID_CACHE_WIRES as VALID_WIRES,
                     VALID_FEATURE_STORES as VALID_STORES,
                     resolve_device)

# Knuth multiplicative hash constant (2^32 / phi): the set index is the
# TOP log2(S) bits of uint32(id) * K
_HASH_K = 2654435761
# murmur3 fmix multiplier for the cache-SHARD routing hash (a different
# mixer than the set hash, so a shard's ids spread over all of its sets)
_SHARD_K = 0x85EBCA6B
_U32 = 0xFFFFFFFF

#: probe slots per packed bitmap word
WIRE_WORD_BITS = 32


class CacheConfig(NamedTuple):
    """Static cache policy, built once from ``ModelConfig``
    (``CacheConfig.from_model``) and threaded through the fetch path.
    Field meanings match ``repro.core.feature_cache.CacheConfig``."""
    n_rows: int          # main-tier slots per worker, power of two
    admit: int = 2       # misses at a set before a candidate is installed
    assoc: int = 1       # ways per set
    mode: str = "replicated"
    l1_rows: int = 0     # tiered mode only
    l1_promote: int = 3  # tiered mode only
    wire: str = "compact"
    hit_cap: int = 0     # compact wire payload rows per destination (0 = auto)
    store: str = "device"
    frozen: bool = False  # read-mostly serve view: admission is the identity

    @property
    def n_sets(self) -> int:
        """Hash sets of the main tier: ``n_rows // assoc``."""
        return self.n_rows // self.assoc

    @property
    def l1_assoc(self) -> int:
        """L1 ways per set (1 when the L2 is direct-mapped, else 2)."""
        return 1 if self.assoc == 1 else 2

    def l1_config(self) -> "CacheConfig":
        """The L1 tier as a standalone replicated policy: ``l1_rows`` slots,
        ``l1_assoc`` ways, and ``l1_promote`` observations as its
        admission threshold."""
        return CacheConfig(n_rows=self.l1_rows, admit=self.l1_promote,
                           assoc=self.l1_assoc, mode="replicated",
                           frozen=self.frozen)

    def l2_config(self) -> "CacheConfig":
        """The L2 tier as a standalone sharded policy; the probe wire
        travels with it."""
        return CacheConfig(n_rows=self.n_rows, admit=self.admit,
                           assoc=self.assoc, mode="sharded",
                           wire=self.wire, hit_cap=self.hit_cap,
                           store=self.store, frozen=self.frozen)

    def serve_view(self) -> "CacheConfig":
        """The read-mostly serve view: same slot layout, ``frozen=True``
        and ``store="device"``."""
        return self._replace(frozen=True, store="device").validated()

    def validated(self) -> "CacheConfig":
        """Self after strict cross-field validation (raises ``ValueError``
        on an inconsistent policy)."""
        if self.n_rows <= 0:
            raise ValueError(f"cache n_rows must be > 0, got {self.n_rows}")
        if self.n_rows & (self.n_rows - 1):
            raise ValueError(
                f"cache n_rows must be a power of two, got {self.n_rows}")
        if self.assoc not in VALID_ASSOC:
            raise ValueError(
                f"cache assoc must be one of {VALID_ASSOC}, got {self.assoc}")
        if self.assoc > self.n_rows:
            raise ValueError(
                f"cache assoc {self.assoc} exceeds n_rows {self.n_rows}")
        if self.mode not in VALID_MODES:
            raise ValueError(
                f"cache mode must be one of {VALID_MODES}, got {self.mode!r}")
        if self.mode == "tiered":
            if self.l1_rows <= 0:
                raise ValueError("tiered mode requires l1_rows > 0 "
                                 f"(got {self.l1_rows})")
            if self.l1_rows & (self.l1_rows - 1):
                raise ValueError(f"l1_rows must be a power of two, "
                                 f"got {self.l1_rows}")
            if self.l1_rows > self.n_rows:
                raise ValueError(
                    f"l1_rows {self.l1_rows} exceeds the L2's n_rows "
                    f"{self.n_rows} — the L1 is the SMALL head tier")
            if self.l1_assoc > self.l1_rows:
                raise ValueError(
                    f"l1_rows {self.l1_rows} cannot hold {self.l1_assoc} ways")
            if self.l1_promote < 1:
                raise ValueError(
                    f"l1_promote must be >= 1, got {self.l1_promote}")
        elif self.l1_rows:
            raise ValueError(
                f"l1_rows is a tiered-mode knob; mode is {self.mode!r}")
        if self.wire not in VALID_WIRES:
            raise ValueError(
                f"cache wire must be one of {VALID_WIRES}, got {self.wire!r}")
        if self.hit_cap < 0:
            raise ValueError(
                f"hit_cap must be >= 0 (0 = auto), got {self.hit_cap}")
        if self.store not in VALID_STORES:
            raise ValueError(
                f"cache store must be one of {VALID_STORES}, "
                f"got {self.store!r}")
        if self.frozen and self.store != "device":
            raise ValueError(
                'a frozen (read-mostly serve) cache requires store='
                '"device" (use serve_view())')
        return self

    @classmethod
    def from_model(cls, cfg) -> Optional["CacheConfig"]:
        """Policy from a ``ModelConfig`` (None when the cache is disabled);
        tiered mode auto-sizes a zero ``cache_l1_rows`` to
        ``cache_rows // 8``."""
        if cfg.cache_rows <= 0:
            return None
        l1 = 0
        if cfg.cache_mode == "tiered":
            l1_assoc = 1 if cfg.cache_assoc == 1 else 2
            l1 = cfg.cache_l1_rows or max(cfg.cache_rows // 8, l1_assoc)
        return cls(n_rows=cfg.cache_rows, admit=cfg.cache_admit,
                   assoc=cfg.cache_assoc, mode=cfg.cache_mode,
                   l1_rows=l1, l1_promote=cfg.cache_l1_promote,
                   wire=cfg.cache_wire, hit_cap=cfg.cache_hit_cap,
                   store=cfg.feature_store).validated()


class FeatureCache(NamedTuple):
    """Cache state: one worker's ``[C]``/``[C, D]`` arrays, or the stacked
    ``[W, C]``/``[W, C, D]`` form of every worker.

    keys    int32  resident node id per slot (-1 = empty)
    rows    float  resident feature rows (bit-exact table copies)
    tags    int32  candidate id awaiting admission (-1 = none)
    counts  int32  admission-progress count for the candidate
    """
    keys: torch.Tensor
    rows: torch.Tensor
    tags: torch.Tensor
    counts: torch.Tensor

    @property
    def n_rows(self) -> int:
        """Slot count ``C`` (``keys.shape[-1]``)."""
        return self.keys.shape[-1]

    def worker(self, w: int) -> "FeatureCache":
        """Worker ``w``'s state out of a stacked ``[W, ...]`` state."""
        return FeatureCache(*(a[w] for a in self))

    @staticmethod
    def stack(states) -> "FeatureCache":
        """Stack per-worker states into the ``[W, ...]`` form."""
        return FeatureCache(*(torch.stack(leaves) for leaves in zip(*states)))


class TieredCache(NamedTuple):
    """Tiered-mode state: the small replicated L1 (``CacheConfig.l1_rows``
    slots, layout ``l1_config()``) and the authoritative sharded L2
    (``n_rows`` slots, layout ``l2_config()``), each a ``FeatureCache`` in
    the per-worker or the stacked ``[W, ...]`` form."""
    l1: FeatureCache
    l2: FeatureCache

    def worker(self, w: int) -> "TieredCache":
        """Worker ``w``'s tiers out of a stacked state."""
        return TieredCache(self.l1.worker(w), self.l2.worker(w))


def state_leaves(state, prefix: str = ""):
    """``(name, tensor)`` pairs of a cache state, flat or tiered
    (``"l1.keys"``, ...), in field order."""
    for name, leaf in zip(state._fields, state):
        if isinstance(leaf, tuple):
            yield from state_leaves(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


def map_state(fn, state):
    """The cache state (flat or tiered) with ``fn`` applied to every
    leaf."""
    return type(state)(*(map_state(fn, leaf) if isinstance(leaf, tuple)
                         else fn(leaf) for leaf in state))


class CacheStats(NamedTuple):
    """Per-worker telemetry of one cached fetch (``[W]`` int32 tensors);
    fields match ``repro.core.feature_cache.CacheStats`` (the host-store
    ``n_l3_hits`` is always zero in this slice)."""
    n_hits: torch.Tensor
    n_misses: torch.Tensor
    n_inserted: torch.Tensor
    bytes_saved: torch.Tensor
    n_local_hits: torch.Tensor
    n_shard_hits: torch.Tensor
    n_l1_hits: torch.Tensor
    n_probe_demoted: torch.Tensor
    probe_hit_peak: torch.Tensor
    n_l3_hits: torch.Tensor


def _mul_u32(ids: torch.Tensor, k: int) -> torch.Tensor:
    """``uint32(ids) * k`` with uint32 wrap-around, as int64 in
    ``[0, 2^32)``.  The product is split into 16-bit halves of ``k`` so
    no partial product leaves int64 (``0xFFFFFFFF * k`` would)."""
    u = ids.to(torch.int64) & _U32
    lo = u * (k & 0xFFFF)
    hi = (u * (k >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def hash_slots(ids: torch.Tensor, n_sets: int) -> torch.Tensor:
    """Set index of each id: top ``log2(n_sets)`` bits of the
    multiplicative hash.  A single-set cache short-circuits to set 0 (a
    32-bit shift would be out of range for uint32)."""
    if n_sets <= 0 or n_sets & (n_sets - 1):
        raise ValueError(f"cache set count must be a power of two, "
                         f"got {n_sets}")
    if n_sets == 1:
        return torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
    shift = 32 - (int(n_sets).bit_length() - 1)    # keep log2(n_sets) bits
    return (_mul_u32(ids, _HASH_K) >> shift).to(torch.int32)


def shard_of(ids: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Cache-shard owner of each id: worker ``mix(id) mod W`` (``W`` the
    group's whole world, whatever this process holds)."""
    if n_workers <= 1:
        return torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
    h = _mul_u32(ids, _SHARD_K) >> 16
    return (h % n_workers).to(torch.int32)


# ---------------------------------------------------------------------------
# Probe-round wire codec (``CacheConfig.wire == "compact"``)
# ---------------------------------------------------------------------------

def hit_bitmap_words(n_slots: int) -> int:
    """Bitmap words a packed bitmap of ``n_slots`` probe slots occupies."""
    if n_slots < 0:
        raise ValueError(f"n_slots must be >= 0, got {n_slots}")
    return -(-n_slots // WIRE_WORD_BITS)


def pack_hit_bitmap(hit: torch.Tensor) -> torch.Tensor:
    """Pack ``[..., R]`` bool into ``[..., ceil(R/32)]`` words: slot ``s`` is
    bit ``s % 32`` of word ``s // 32``, pad bits zero.  Words are the int32
    bit pattern of the reference's uint32 words."""
    r = hit.shape[-1]
    words = hit_bitmap_words(r)
    pad = words * WIRE_WORD_BITS - r
    if pad:
        hit = torch.cat([hit, hit.new_zeros(hit.shape[:-1] + (pad,))], dim=-1)
    bits = hit.reshape(hit.shape[:-1] + (words, WIRE_WORD_BITS)).to(torch.int64)
    weight = torch.ones((), dtype=torch.int64, device=hit.device) << torch.arange(
        WIRE_WORD_BITS, dtype=torch.int64, device=hit.device)
    v = (bits * weight).sum(-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_hit_bitmap(words: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Inverse of ``pack_hit_bitmap``: ``[..., W]`` words ->
    ``[..., n_slots]`` bool (pad bits discarded)."""
    if hit_bitmap_words(n_slots) != words.shape[-1]:
        raise ValueError(
            f"{words.shape[-1]} bitmap words cannot encode {n_slots} slots "
            f"(expected {hit_bitmap_words(n_slots)})")
    shift = torch.arange(WIRE_WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shift) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WIRE_WORD_BITS,))
    return flat[..., :n_slots].to(torch.bool)


def compact_hit_rows(hit: torch.Tensor, rows: torch.Tensor,
                     hit_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Holder-side payload compaction: ``hit [..., R]``, ``rows [..., R, D]``
    -> ``(kept [..., R], payload [..., min(hit_cap, R), D])``.  ``kept``
    marks the first ``hit_cap`` hits in slot order; payload slot ``p``
    holds the ``p``-th kept row, zeros beyond the kept count."""
    if hit_cap < 0:
        raise ValueError(f"hit_cap must be >= 0, got {hit_cap}")
    hit_cap = min(hit_cap, hit.shape[-1])
    d = rows.shape[-1]
    if hit_cap == 0:
        return (torch.zeros_like(hit),
                rows.new_zeros(rows.shape[:-2] + (0, d)))
    cs = torch.cumsum(hit.to(torch.int32), dim=-1)
    kept = hit & (cs <= hit_cap)
    # slot indices of the hits first, in slot order (stable sort)
    order = torch.sort((~hit).to(torch.uint8), dim=-1, stable=True).indices
    sel = order[..., :hit_cap]
    n_kept = torch.clamp(cs[..., -1:], max=hit_cap)
    pvalid = torch.arange(hit_cap, device=hit.device) < n_kept
    payload = torch.gather(rows, -2, sel[..., None].expand(
        sel.shape + (d,)))
    return kept, torch.where(pvalid[..., None], payload, 0)


def expand_hit_rows(kept: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Requester-side re-expansion, inverse of ``compact_hit_rows``:
    ``kept [..., R]``, ``payload [..., hc, D]`` -> ``rows [..., R, D]`` with
    the ``p``-th kept slot carrying ``payload[..., p, :]``, zeros elsewhere."""
    hc, d = payload.shape[-2], payload.shape[-1]
    if hc == 0:
        return payload.new_zeros(kept.shape + (d,))
    pos = torch.cumsum(kept.to(torch.int32), dim=-1) - 1
    idx = torch.clamp(pos, 0, hc - 1).to(torch.int64)
    rows = torch.gather(payload, -2, idx[..., None].expand(idx.shape + (d,)))
    return torch.where(kept[..., None], rows, 0)


def init_cache_state(cfg: CacheConfig, dim: int, n_workers: int,
                     dtype=torch.float32, device="cuda"):
    """Empty ``[n_workers, ...]`` cache state on ``device`` for ``cfg``
    (``n_workers`` the workers this process holds: all ``W`` on the
    stacked axis, 1 per process, whose state is then its own shard): a
    ``FeatureCache`` in the flat modes, a ``TieredCache`` in tiered mode."""
    device = resolve_device(device)
    if cfg.mode == "tiered":
        return TieredCache(
            l1=_empty_state(cfg.l1_rows, dim, n_workers, dtype, device),
            l2=_empty_state(cfg.n_rows, dim, n_workers, dtype, device))
    return _empty_state(cfg.n_rows, dim, n_workers, dtype, device)


def _empty_state(c: int, dim: int, n_workers: int, dtype,
                 device) -> FeatureCache:
    return FeatureCache(
        keys=torch.full((n_workers, c), -1, dtype=torch.int32, device=device),
        rows=torch.zeros((n_workers, c, dim), dtype=dtype, device=device),
        tags=torch.full((n_workers, c), -1, dtype=torch.int32, device=device),
        counts=torch.zeros((n_workers, c), dtype=torch.int32, device=device),
    )


def cache_probe(cache: FeatureCache, ids: torch.Tensor,
                valid: Optional[torch.Tensor] = None, *,
                cfg: CacheConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe one worker's cache for ``[R]`` ids: ``(hit [R] bool,
    rows [R, D])``, zeros where missed.  ``cfg`` must be the config the
    state was populated under.  The probe is the ``cache_probe_gather``
    kernel on a CUDA state and its plain twin on a CPU state."""
    if cfg.n_rows != cache.n_rows:
        raise ValueError(f"cfg.n_rows {cfg.n_rows} != cache state rows "
                         f"{cache.n_rows}: probing under a mismatched "
                         f"layout silently loses residents")
    hit, rows = ops.cache_probe_gather(cache.keys, cache.rows, ids,
                                       assoc=cfg.assoc)
    if valid is not None:
        hit = hit & valid
        rows = torch.where(hit[:, None], rows, 0)
    return hit, rows


def tiered_probe(state: TieredCache, ids: torch.Tensor,
                 valid: Optional[torch.Tensor] = None, *,
                 cfg: CacheConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Probe both tiers of one worker's state for ``[R]`` ids: ``(l1_hit,
    l2_hit, rows [R, D])`` — disjoint hits (the L1 wins a double hit) and
    the serving tier's rows, zeros where both miss.  One
    ``cache_probe_tiered`` launch on a CUDA state, its plain twin on a CPU
    state."""
    if cfg.mode != "tiered":
        raise ValueError(f"tiered_probe requires mode='tiered', "
                         f"got {cfg.mode!r}")
    if cfg.l1_rows != state.l1.n_rows or cfg.n_rows != state.l2.n_rows:
        raise ValueError(
            f"cfg tiers ({cfg.l1_rows}, {cfg.n_rows}) != state tiers "
            f"({state.l1.n_rows}, {state.l2.n_rows}): probing under a "
            f"mismatched layout silently loses residents")
    src, rows = ops.cache_probe_tiered(
        state.l1.keys, state.l1.rows, state.l2.keys, state.l2.rows, ids,
        l1_assoc=cfg.l1_assoc, l2_assoc=cfg.assoc)
    l1_hit = src == 1
    l2_hit = src == 2
    if valid is not None:
        l1_hit = l1_hit & valid
        l2_hit = l2_hit & valid
        rows = torch.where((l1_hit | l2_hit)[:, None], rows, 0)
    return l1_hit, l2_hit, rows


def _set_drop(buf: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` for indices in
    ``[0, len(buf)]``: index ``len(buf)`` is the dropped sentinel."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]])
    ext[idx.to(torch.int64)] = vals.to(buf.dtype)
    return ext[:n]


def cache_insert(cache: FeatureCache, ids: torch.Tensor, rows: torch.Tensor,
                 should: torch.Tensor,
                 cfg: CacheConfig) -> Tuple[FeatureCache, torch.Tensor]:
    """Offer ``[R]`` fetched rows to one worker's cache; returns
    ``(new_cache, n_inserted)``.

    Frequency admission (a candidate installs once its counter reaches
    ``cfg.admit``); an id already tracked keeps its way, a new candidate
    takes the way with the smallest counter, virgin ways first, ways
    claimed by a same-batch tagged offer excluded; same-set new
    candidates of one batch are ranked over distinct ids so they spread
    over the ways; one winner (highest request index) per slot before
    any write.  Bit-identical to ``repro.core.feature_cache.cache_insert``
    (every argsort stable, as ``jnp.argsort`` is)."""
    if cfg.n_rows != cache.n_rows:
        raise ValueError(f"cfg.n_rows {cfg.n_rows} != cache state rows "
                         f"{cache.n_rows}: inserting under a mismatched "
                         f"layout silently corrupts the placement")
    a, admit = cfg.assoc, cfg.admit
    c = cache.n_rows
    r = ids.shape[0]
    dev = ids.device
    if r == 0:
        return cache, torch.zeros((), dtype=torch.int32, device=dev)
    i32 = torch.int32
    sets = hash_slots(ids, cfg.n_sets)
    slots = (sets[:, None] * a
             + torch.arange(a, dtype=i32, device=dev)[None, :]).to(torch.int64)
    keys_w = cache.keys[slots]                              # [R, A]
    tags_w = cache.tags[slots]
    counts_w = cache.counts[slots]
    tag_match = tags_w == ids[:, None]
    has_tag = tag_match.any(dim=-1)
    tag_way = torch.argmax(tag_match.to(i32), dim=-1).to(i32)
    claim_slot = sets * a + tag_way
    claimed = _set_drop(
        torch.zeros((c,), dtype=torch.bool, device=dev),
        torch.where(should & has_tag, claim_slot, c),
        torch.ones((r,), dtype=torch.bool, device=dev))
    victim_score = torch.where((keys_w < 0) & (tags_w < 0),
                               torch.full_like(counts_w, -1), counts_w)
    victim_score = torch.where(claimed[slots],
                               torch.full_like(counts_w, 2**30), victim_score)
    ways_pref = torch.sort(victim_score, dim=-1, stable=True).indices.to(i32)
    sets_eff = torch.where(should, sets, cfg.n_sets)
    o1 = torch.sort(ids, stable=True).indices
    order = o1[torch.sort(sets_eff[o1], stable=True).indices]
    s_sorted = sets_eff[order]
    i_sorted = ids[order]
    new_group = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev),
        (s_sorted[1:] != s_sorted[:-1]) | (i_sorted[1:] != i_sorted[:-1])])
    nontag_start = new_group & ~has_tag[order]
    ng = torch.cumsum(nontag_start.to(i32), dim=0).to(i32)
    set_start = torch.searchsorted(s_sorted, s_sorted, side="left")
    before_set = ng[set_start] - nontag_start[set_start].to(i32)
    rank = torch.zeros((r,), dtype=i32, device=dev)
    rank[order] = ng - before_set - 1
    victim_way = torch.gather(ways_pref, 1,
                              (rank % a).to(torch.int64)[:, None])[:, 0]
    way = torch.where(has_tag, tag_way, victim_way)
    slot = sets * a + way                                   # [R]
    prev = torch.gather(counts_w, 1, way.to(torch.int64)[:, None])[:, 0]
    new_count = torch.where(has_tag, prev + 1, torch.ones_like(prev))
    idx = torch.arange(r, dtype=i32, device=dev)
    win = torch.full((c + 1,), -1, dtype=i32, device=dev).scatter_reduce(
        0, torch.where(should, slot, c).to(torch.int64), idx, reduce="amax")
    offer = should & (win[slot.to(torch.int64)] == idx)
    install = offer & (new_count >= admit)
    s_track = torch.where(offer, slot, c)
    s_install = torch.where(install, slot, c)
    new = FeatureCache(
        keys=_set_drop(cache.keys, s_install, ids),
        rows=_set_drop(cache.rows, s_install, rows),
        tags=_set_drop(cache.tags, s_track, ids),
        counts=_set_drop(cache.counts, s_track, new_count),
    )
    return new, install.sum().to(i32)
