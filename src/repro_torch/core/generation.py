"""Distributed subgraph generation (paper §2 step 3) over a worker
group — the port of ``repro/core/generation.py``.

``repro`` runs one ``shard_map`` instance per worker.  Here every
per-worker array carries a leading axis of the ``L`` workers this
process holds, and the ``lax`` collectives are a ``WorkerGroup``'s
(``core/collectives.py``).  On the stacked group (the default) ``L = W``
and a ``W``-worker round runs in one process, on one CPU or one GPU; on
a process group ``L = 1`` and each worker runs in its own process on its
own device.  ``world`` (``W``, the destinations of every exchange)
and ``L`` (the loops over held workers) are kept apart throughout, so
the two backends run the same code.  The per-worker primitives
(``local_candidates``, ``merge_topk``, ``dedup_requests``,
``_route_plan``, the wire codec) take arbitrary leading axes; the cache
state is per worker, so its probe and insert run per held worker —
except the shard holders' compact probe, which is one kernel launch
over every held holder.

Flow per round, per hop: broadcast the frontier (``all_gather``), sample
``k`` weighted candidates per frontier node from each worker's local
edges (``local_candidates``), merge them (``merge_mode="butterfly"``:
``tree_allreduce`` of ``merge_topk``, then slice this worker's rows;
``"reduce_scatter"``: ``tree_reduce_scatter``, each worker merging only
its own segment, then an ``all_gather`` of the next frontier).  Then one
request-deduplicated feature fetch (``fetch_rows``): distinct ids probe
the hot-node cache (locally at W = 1, through the shard-probe round to
their cache-shard holders at W > 1), and only misses take the routed
owner fetch — or, with ``feature_store="host"``, are staged for the L3
host gather (``core/host_store.py``) and patched into the batch one step
later.

**Random draws.** ``repro`` draws the sampler's offsets and Exp(1)
variates from threefry inside the worker; torch cannot reproduce those
bits.  So the draws are an INPUT here: ``draws[l] = (offs, e)`` with
``offs [W, F_l, k_l]`` int32 in ``[0, 2^31 - 1)`` and ``e [W, F_l, k_l]``
float32 ``= -log(u)``.  Production makes them with ``sample_draws`` from
a seeded ``torch.Generator``; the parity tests feed ``repro``'s own
draws, and the keys ``e / max(deg / k, 1e-30)`` then agree bit for bit.

A process draws the whole ``[W, ...]`` round too and keeps its own row
(``group.block``), so its bits equal the stacked run's worker block.

**Telemetry.** ``collect_stats=True`` (the autotuner's trace seam) makes
every generator return grow a ``(FetchStats, CacheStats)`` tail with an
``[L]`` leading axis: the feature shuffle's per-worker counters, equal
to the reference's on the same draws.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.subgraph import SubgraphBatch
from ..kernels import ops
from .collectives import StackedGroup, WorkerGroup, stacked
from .config import resolve_device
from .feature_cache import (CacheConfig, CacheStats, FeatureCache,
                            TieredCache, cache_insert, cache_probe,
                            expand_hit_rows, hit_bitmap_words,
                            init_cache_state, shard_of, tiered_probe,
                            unpack_hit_bitmap)
from .host_store import HostFeatureStore, HostMissRequest
from .partition import PartitionedGraph
from .tree_reduce import tree_allreduce, tree_reduce_scatter

#: how the per-hop candidates merge across workers
MERGE_MODES = ("butterfly", "reduce_scatter")

#: smallest positive float32 — the floor ``repro`` draws ``u`` from
_F32_TINY = float(np.finfo(np.float32).tiny)
_I32_MAX = 2**31 - 1


class Candidates(NamedTuple):
    """Sampled neighbors and their reservoir keys (``+inf`` = invalid)."""
    ids: torch.Tensor    # [..., F, k] int32
    keys: torch.Tensor   # [..., F, k] float32


class FetchStats(NamedTuple):
    """Per-worker telemetry of one ``fetch_rows`` (``[L]`` int32 each);
    fields match ``repro.core.generation.FetchStats``."""
    n_requests: torch.Tensor
    n_unique: torch.Tensor
    n_dropped: torch.Tensor
    probe_round_bytes: torch.Tensor
    host_gather_bytes: torch.Tensor


def sample_draws(generator: torch.Generator, n_workers: int, batch: int,
                 fanouts: Sequence[int], device) -> tuple:
    """The sampler's random inputs for one round, from ``generator``:
    per hop ``(offs [W, F, k] int32, e [W, F, k] float32)`` where ``F`` is
    the global frontier size (``W * batch * k_1 * ... * k_{l-1}``), ``offs``
    is uniform in ``[0, 2^31 - 1)`` and ``e = -log(u)`` is Exp(1) with
    ``u`` uniform in ``[tiny, 1)``."""
    f = n_workers * batch
    draws = []
    for k in fanouts:
        shape = (n_workers, f, k)
        offs = torch.randint(0, _I32_MAX, shape, generator=generator,
                             dtype=torch.int32, device=device)
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        draws.append((offs, -torch.log(torch.clamp(u, min=_F32_TINY))))
        f *= k
    return tuple(draws)


class SeededDraws:
    """Per-round draws from a ``torch.Generator`` seeded with
    ``(seed, round index)`` — the port's ``fold_in(PRNGKey(seed), n)``:
    rounds are reproducible and independent of each other and of global
    RNG state.  ``draws(n, n_workers, batch)`` returns round ``n``'s
    draws (see ``sample_draws``).

    With a ``group`` the round is drawn for all ``group.world`` workers
    (``n_workers`` is then the held count and only checked) and the held
    workers' rows are returned: a process gets exactly its worker block
    of the stacked round, at ``W`` times the RNG work of its own rows."""

    def __init__(self, fanouts: Sequence[int], seed: int, device,
                 group: Optional[WorkerGroup] = None):
        self.fanouts = tuple(fanouts)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.group = group

    def __call__(self, index: int, n_workers: int, batch: int) -> tuple:
        """Draws of round ``index`` for ``n_workers`` x ``batch`` seeds."""
        state = np.random.SeedSequence([self.seed, int(index)]).generate_state(1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0]))
        if self.group is None:
            return sample_draws(gen, n_workers, batch, self.fanouts,
                                self.device)
        if n_workers != self.group.local:
            raise ValueError(f"draws for {n_workers} workers from a group "
                             f"holding {self.group.local}")
        full = sample_draws(gen, self.group.world, batch, self.fanouts,
                            self.device)
        return tuple((self.group.block(o), self.group.block(e))
                     for o, e in full)


def local_candidates(indptr: torch.Tensor, indices: torch.Tensor,
                     frontier: torch.Tensor, k: int, offs: torch.Tensor,
                     e: torch.Tensor) -> Candidates:
    """Sample ``k`` neighbors-with-replacement of each frontier node from a
    local CSR partition, tagged with weighted reservoir keys.

    ``indptr [..., N+1]``, ``indices [..., E]``, ``frontier [..., F]`` and
    the draws ``offs``/``e [..., F, k]`` (see the module docstring).  Each
    draw represents ``deg_local / k`` edges, so its key is ``e`` over that
    rate; nodes with no local edge get ``+inf`` keys."""
    n = indptr.shape[-1] - 2
    node = torch.clamp(frontier, 0, n).to(torch.int64)
    start = torch.gather(indptr, -1, node)
    deg = torch.gather(indptr, -1, node + 1) - start
    o = offs % torch.clamp(deg, min=1)[..., None]
    idx = torch.clamp(start[..., None] + o, 0, indices.shape[-1] - 1)
    lead = idx.shape[:-2]
    ids = torch.gather(indices, -1,
                       idx.reshape(lead + (-1,)).to(torch.int64))
    # the reference writes deg / k; XLA compiles a division by the
    # constant k as a multiplication by float32(1 / k), so that product
    # is what the keys must be built from to agree bit for bit
    weight = (deg.to(torch.float32) * float(np.float32(1.0 / k)))[..., None]
    keys = e / torch.clamp(weight, min=1e-30)
    keys = torch.where((deg > 0)[..., None], keys, float("inf"))
    return Candidates(ids=ids.reshape(idx.shape).to(torch.int32), keys=keys)


def merge_topk(a: Candidates, b: Candidates) -> Candidates:
    """Associative merge: keep the ``k`` smallest keys of the union, ties to
    the lower index (``lax.top_k``'s rule, hence the stable sort)."""
    k = a.keys.shape[-1]
    keys = torch.cat([a.keys, b.keys], dim=-1)
    ids = torch.cat([a.ids, b.ids], dim=-1)
    idx = torch.sort(keys, dim=-1, stable=True).indices[..., :k]
    return Candidates(ids=torch.gather(ids, -1, idx),
                      keys=torch.gather(keys, -1, idx))


def dedup_requests(ids: torch.Tensor):
    """Static-shape sort+segment unique over the last axis.

    Returns ``(uniq, inverse, valid, n_unique)``: ``uniq [..., R]`` holds
    the distinct ids in its first ``n_unique`` slots (zeros after),
    ``uniq[inverse] == ids``, and ``valid[i] = i < n_unique``."""
    r = ids.shape[-1]
    dev = ids.device
    if r == 0:
        return (ids, torch.zeros(ids.shape, dtype=torch.int32, device=dev),
                torch.zeros(ids.shape, dtype=torch.bool, device=dev),
                torch.zeros(ids.shape[:-1], dtype=torch.int32, device=dev))
    s, order = torch.sort(ids, dim=-1, stable=True)
    is_first = torch.cat([torch.ones(ids.shape[:-1] + (1,), dtype=torch.bool,
                                     device=dev),
                          s[..., 1:] != s[..., :-1]], dim=-1)
    group = torch.cumsum(is_first.to(torch.int32), dim=-1) - 1
    n_unique = (group[..., -1] + 1).to(torch.int32)
    uniq = torch.zeros_like(ids).scatter(-1, group.to(torch.int64), s)
    inverse = torch.empty_like(group).scatter(-1, order, group)
    valid = torch.arange(r, device=dev) < n_unique[..., None]
    return uniq, inverse.to(torch.int32), valid, n_unique


def probe_round_capacity(n_requests: int, n_workers: int,
                         capacity_slack: float = 2.0) -> int:
    """Per-destination slot count of the slack-sized exchange rounds:
    ``min(R, ceil(R / W) * slack + 8)``."""
    return int(min(n_requests,
                   -(-n_requests // n_workers) * capacity_slack + 8))


class _RoutePlan(NamedTuple):
    """Per-destination slot assignment of one routed all_to_all round; a
    pure function of ``(dest, cap)``, so the probe and admission rounds
    share one plan."""
    order: torch.Tensor        # [..., R] stable argsort of dest
    sorted_dest: torch.Tensor  # [..., R] dest[order] (w = "nowhere")
    slot_c: torch.Tensor       # [..., R] per-destination slot, cap = dropped
    ok: torch.Tensor           # [..., R] request got a wire slot (sorted)


def _route_plan(dest: torch.Tensor, cap: int, w: int) -> _RoutePlan:
    """Assign each request a (destination, slot) wire position; requests
    beyond ``cap`` per destination, and ``dest == w``, get no slot."""
    r = dest.shape[-1]
    sorted_dest, order = torch.sort(dest, dim=-1, stable=True)
    first = torch.searchsorted(sorted_dest.contiguous(),
                               sorted_dest.contiguous(), side="left")
    slot = torch.arange(r, device=dest.device) - first
    ok = (slot < cap) & (sorted_dest < w)
    slot_c = torch.where(ok, slot, torch.full_like(slot, cap))
    return _RoutePlan(order, sorted_dest, slot_c, ok)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, *tail]`` along the request axis (``idx [..., R]``)."""
    nd = idx.dim()
    full = idx.reshape(idx.shape + (1,) * (x.dim() - nd)).expand(
        idx.shape + x.shape[nd:])
    return torch.gather(x, nd - 1, full.to(torch.int64))


def _unsort(vals: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Scatter ``vals`` (in ``order``'s sorted order) back to request
    order: ``out[..., order[i]] = vals[..., i]``."""
    nd = order.dim()
    full = order.reshape(order.shape + (1,) * (vals.dim() - nd)).expand(
        vals.shape)
    return torch.empty_like(vals).scatter(nd - 1, full.to(torch.int64), vals)


def _to_wire(plan: _RoutePlan, vals: torch.Tensor, w: int, cap: int,
             fill) -> torch.Tensor:
    """Send buffer ``[..., w, cap, *tail]`` of a round: sorted-order
    ``vals [..., R, *tail]`` land at their (dest, slot), ``fill`` elsewhere;
    requests without a slot are dropped (they scatter to a pad row)."""
    nd = plan.sorted_dest.dim()
    lead, tail = vals.shape[:nd - 1], vals.shape[nd:]
    flat = plan.sorted_dest.to(torch.int64) * (cap + 1) + plan.slot_c
    index = flat.reshape(flat.shape + (1,) * len(tail)).expand(vals.shape)
    buf = torch.full(lead + ((w + 1) * (cap + 1),) + tail, fill,
                     dtype=vals.dtype, device=vals.device)
    buf.scatter_(nd - 1, index, vals)
    buf = buf.reshape(lead + (w + 1, cap + 1) + tail)
    return buf.narrow(nd - 1, 0, w).narrow(nd, 0, cap)


def _from_wire(buf: torch.Tensor, plan: _RoutePlan) -> torch.Tensor:
    """Read a response buffer ``[..., w, cap, *tail]`` at every request's
    (clipped) wire position, in sorted order."""
    nd = plan.sorted_dest.dim()
    w, cap = buf.shape[nd - 1], buf.shape[nd]
    flat = (torch.clamp(plan.sorted_dest, 0, w - 1).to(torch.int64) * cap
            + torch.clamp(plan.slot_c, 0, cap - 1))
    merged = buf.reshape(buf.shape[:nd - 1] + (w * cap,) + buf.shape[nd + 1:])
    return _take(merged, flat)


def _routed_fetch(table: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                  cap: int, group: WorkerGroup, rows: int):
    """One routed all_to_all round trip serving ``ids[valid]`` from the
    row-sharded ``table [L, rows, D]`` (global row ``i`` on worker
    ``i // rows``).  Returns ``(rows [L, R, D], served [L, R])``; invalid
    slots and slots beyond ``cap`` per destination get zero rows and
    ``served=False``."""
    w = group.world
    owner = torch.clamp(torch.div(ids, rows, rounding_mode="floor"), 0, w - 1)
    owner = torch.where(valid, owner, torch.full_like(owner, w))
    plan = _route_plan(owner, cap, w)
    send = _to_wire(plan, _take(ids, plan.order), w, cap, 0)
    recv = group.all_to_all(send)                          # [L, w, cap]
    me = group.axis_index(ids.device)[:, None, None]
    local = torch.clamp(recv - me * rows, 0, rows - 1).to(torch.int64)
    held = torch.arange(ids.shape[0], device=ids.device)[:, None, None]
    served = table[held, local]
    resp = group.all_to_all(served)                        # [L, w, cap, D]
    got = torch.where(plan.ok[..., None], _from_wire(resp, plan), 0)
    return _unsort(got, plan.order), _unsort(plan.ok, plan.order)


class _WireStats(NamedTuple):
    """Holder-side probe-round telemetry: ``n_demoted``/``hit_peak`` are
    ``[L]`` int32, ``probe_bytes`` the static per-worker bytes shipped."""
    n_demoted: torch.Tensor
    hit_peak: torch.Tensor
    probe_bytes: int


def probe_hit_cap(cfg: CacheConfig, cap: int) -> int:
    """Resolved compact-wire payload bound for a probe capacity ``cap``:
    ``cfg.hit_cap`` (0 = half the capacity), clamped into ``[1, cap]``."""
    return max(min(cfg.hit_cap or max(cap // 2, 1), cap), 1)


def probe_send(ids: torch.Tensor, valid: torch.Tensor, cap: int,
               group: WorkerGroup):
    """Routing half of the shard-probe round: each valid id rides to its
    cache-shard holder.  Returns ``(plan, recv [L_holder, W_src, cap])``,
    empty probe slots carrying -1."""
    w = group.world
    dest = torch.where(valid, shard_of(ids, w),
                       torch.full_like(ids, w))
    plan = _route_plan(dest, cap, w)
    send = _to_wire(plan, _take(ids, plan.order), w, cap, -1)
    return plan, group.all_to_all(send)


def _shard_probe(cache: FeatureCache, cfg: CacheConfig, ids: torch.Tensor,
                 valid: torch.Tensor, cap: int, group: WorkerGroup):
    """Stage-1 routing: probe each id against its CACHE-SHARD worker.

    The response rides the wire ``cfg.wire`` selects: ``dense`` ships a
    hit flag and a row for every probe slot; ``compact`` ships the packed
    kept bitmap plus at most ``probe_hit_cap`` rows per destination,
    encoded on the holders by one ``cache_probe_compact`` launch and
    re-expanded by the requesters.  Returns ``(hit [L, R],
    rows [L, R, D], plan, recv, wire)``."""
    w = group.world
    plan, recv = probe_send(ids, valid, cap, group)
    d = cache.rows.shape[-1]
    item = cache.rows.element_size()
    probe_bytes = w * cap * 4                    # ids up, int32
    if cfg.wire == "compact":
        hc = probe_hit_cap(cfg, cap)
        n_words = hit_bitmap_words(cap)
        words, raw_words, payload = ops.cache_probe_compact(
            cache.keys, cache.rows, recv, assoc=cfg.assoc, hit_cap=hc)
        kept = unpack_hit_bitmap(words, cap)
        raw_hit = unpack_hit_bitmap(raw_words, cap)
        wire = _WireStats(
            n_demoted=(raw_hit & ~kept).sum((1, 2)).to(torch.int32),
            hit_peak=raw_hit.sum(2).amax(1).to(torch.int32),
            probe_bytes=probe_bytes + w * n_words * 4 + w * hc * d * item)
        hit_b = unpack_hit_bitmap(group.all_to_all(words), cap)
        rows_b = expand_hit_rows(hit_b, group.all_to_all(payload))
    else:
        hits, rows = [], []
        for h in range(ids.shape[0]):
            flat = recv[h].reshape(-1)
            hit_f, rows_f = cache_probe(cache.worker(h), flat,
                                        valid=flat >= 0, cfg=cfg)
            hits.append(hit_f.reshape(w, cap))
            rows.append(rows_f.reshape(w, cap, d))
        hit2 = torch.stack(hits)
        wire = _WireStats(
            n_demoted=torch.zeros(ids.shape[0], dtype=torch.int32,
                                  device=ids.device),
            hit_peak=hit2.sum(2).amax(1).to(torch.int32),
            probe_bytes=probe_bytes + w * cap * 1 + w * cap * d * item)
        hit_b = group.all_to_all(hit2)
        rows_b = group.all_to_all(torch.stack(rows))
    got_hit = _from_wire(hit_b, plan) & plan.ok
    got_rows = torch.where(got_hit[..., None], _from_wire(rows_b, plan), 0)
    return (_unsort(got_hit, plan.order), _unsort(got_rows, plan.order),
            plan, recv, wire)


def _shard_admit(cache: FeatureCache, cfg: CacheConfig, plan: _RoutePlan,
                 recv_ids: torch.Tensor, fetched: torch.Tensor,
                 should: torch.Tensor, group: WorkerGroup):
    """Stage-2 write-back: offer owner-fetched rows to their shard holders
    over the probe round's slot assignment, so each holder pairs a row
    with the id it probed there.  Returns ``(new_cache, n_inserted [L])``."""
    w = group.world
    cap = recv_ids.shape[-1]
    d = fetched.shape[-1]
    recv_rows = group.all_to_all(
        _to_wire(plan, _take(fetched, plan.order), w, cap, 0))
    recv_should = group.all_to_all(
        _to_wire(plan, _take(should, plan.order), w, cap, False))
    states, counts = [], []
    for h in range(recv_ids.shape[0]):
        ids_f = recv_ids[h].reshape(-1)
        offer = recv_should[h].reshape(-1) & (ids_f >= 0)
        new, n = cache_insert(cache.worker(h), ids_f,
                              recv_rows[h].reshape(-1, d), offer, cfg)
        states.append(new)
        counts.append(n)
    return FeatureCache.stack(states), torch.stack(counts)


class _TierProbe(NamedTuple):
    """What a cache-mode strategy's probe stage hands back to ``fetch_rows``
    (per held worker, ``[L, ...]``); ``ctx`` is private to the matching
    admit."""
    hit: torch.Tensor
    rows: torch.Tensor
    l1_hit: torch.Tensor
    local: torch.Tensor
    wire: _WireStats
    ctx: tuple


def _no_wire(n_held: int, device) -> _WireStats:
    z = torch.zeros(n_held, dtype=torch.int32, device=device)
    return _WireStats(z, z, 0)


class _ReplicatedTier:
    """mode="replicated": local probe, local admission."""

    @staticmethod
    def probe(cache, cfg, ids, valid, cap, group):
        """Each worker probes its own cache."""
        n = ids.shape[0]
        hits, rows = zip(*(cache_probe(cache.worker(i), ids[i], valid[i],
                                       cfg=cfg) for i in range(n)))
        hit = torch.stack(hits)
        return _TierProbe(hit, torch.stack(rows), torch.zeros_like(hit), hit,
                          _no_wire(n, ids.device), ())

    @staticmethod
    def admit(cache, cfg, probe, ids, fetched, should, group):
        """Each worker offers its served misses to its own cache."""
        out = [cache_insert(cache.worker(i), ids[i], fetched[i], should[i],
                            cfg) for i in range(ids.shape[0])]
        return (FeatureCache.stack([s for s, _ in out]),
                torch.stack([n for _, n in out]))


class _ShardedTier:
    """mode="sharded": one probe round to the shard holders, admission
    routed back on the same plan; W == 1 degenerates to replicated."""

    @staticmethod
    def probe(cache, cfg, ids, valid, cap, group):
        """Local probe at W == 1, else the shard-probe round."""
        if group.world == 1:
            return _ReplicatedTier.probe(cache, cfg, ids, valid, cap, group)
        hit, rows, plan, recv, wire = _shard_probe(cache, cfg, ids, valid,
                                                   cap, group)
        local = hit & (shard_of(ids, group.world)
                       == group.axis_index(ids.device)[:, None])
        return _TierProbe(hit, rows, torch.zeros_like(hit), local, wire,
                          (plan, recv))

    @staticmethod
    def admit(cache, cfg, probe, ids, fetched, should, group):
        """Local admission at W == 1, else routed to the shard holders."""
        if group.world == 1:
            return _ReplicatedTier.admit(cache, cfg, probe, ids, fetched,
                                         should, group)
        plan, recv = probe.ctx
        return _shard_admit(cache, cfg, plan, recv, fetched, should, group)


class _TieredTier:
    """mode="tiered": the local L1 probe, the shard probe (L2) for the L1
    misses, the owner fetch for the rest; admission updates the
    authoritative L2 shard, then offers the L2-served rows to the
    requester's L1 (installed after ``l1_promote`` observations)."""

    @staticmethod
    def probe(cache, cfg, ids, valid, cap, group):
        """The fused two-tier probe at W == 1; else each worker's L1
        probe, then the shard-probe round for the L1 misses."""
        n = ids.shape[0]
        if group.world == 1:
            l1_hit, l2_hit, rows = tiered_probe(cache.worker(0), ids[0],
                                                valid[0], cfg=cfg)
            l1_hit, l2_hit, rows = l1_hit[None], l2_hit[None], rows[None]
            return _TierProbe(l1_hit | l2_hit, rows, l1_hit, l2_hit,
                              _no_wire(n, ids.device), (None, None, l2_hit))
        l1_cfg = cfg.l1_config()
        l1_hit, l1_rows = (torch.stack(t) for t in zip(*(
            cache_probe(cache.l1.worker(i), ids[i], valid[i], cfg=l1_cfg)
            for i in range(n))))
        # only L1 misses enter the probe round
        l2_valid = valid & ~l1_hit
        l2_hit, l2_rows, plan, recv, wire = _shard_probe(
            cache.l2, cfg.l2_config(), ids, l2_valid, cap, group)
        rows = torch.where(l1_hit[..., None], l1_rows, l2_rows)
        local = l2_hit & (shard_of(ids, group.world)
                          == group.axis_index(ids.device)[:, None])
        return _TierProbe(l1_hit | l2_hit, rows, l1_hit, local, wire,
                          (plan, recv, l2_hit))

    @staticmethod
    def admit(cache, cfg, probe, ids, fetched, should, group):
        """The L2 insert (local at W == 1, routed to the shard holders
        otherwise), then the L1 offered the probe's rows under ``l2_hit``;
        returns ``(TieredCache, n_l2 + n_l1 [L])``."""
        plan, recv, l2_hit = probe.ctx
        l2_cfg = cfg.l2_config()
        if group.world == 1:
            new_l2, n_l2 = cache_insert(cache.l2.worker(0), ids[0],
                                        fetched[0], should[0], l2_cfg)
            new_l2, n_l2 = FeatureCache.stack([new_l2]), n_l2[None]
        else:
            new_l2, n_l2 = _shard_admit(cache.l2, l2_cfg, plan, recv,
                                        fetched, should, group)
        l1_cfg = cfg.l1_config()
        out = [cache_insert(cache.l1.worker(i), ids[i], probe.rows[i],
                            l2_hit[i], l1_cfg) for i in range(ids.shape[0])]
        new_l1 = FeatureCache.stack([s for s, _ in out])
        n_l1 = torch.stack([n for _, n in out])
        return TieredCache(l1=new_l1, l2=new_l2), n_l2 + n_l1


_CACHE_TIERS = {"replicated": _ReplicatedTier, "sharded": _ShardedTier,
                "tiered": _TieredTier}


class _FrozenTier:
    """Read-mostly serve view of a base strategy (``cfg.frozen``): the probe
    delegates verbatim, the admit stage is the identity — a warm state is
    bit-stable across requests."""

    def __init__(self, base):
        self._base = base

    def probe(self, cache, cfg, ids, valid, cap, group):
        """Delegate to the base mode's probe stage unchanged."""
        return self._base.probe(cache, cfg, ids, valid, cap, group)

    def admit(self, cache, cfg, probe, ids, fetched, should, group):
        """Identity: the cache state passes through untouched."""
        return cache, torch.zeros(ids.shape[0], dtype=torch.int32,
                                  device=ids.device)


def _cache_tier(cfg: CacheConfig):
    """The (probe, admit) strategy for ``cfg``, frozen when ``cfg.frozen``."""
    if cfg.mode not in _CACHE_TIERS:
        raise ValueError(f"unknown cache mode {cfg.mode!r}; "
                         f"expected one of {sorted(_CACHE_TIERS)}")
    base = _CACHE_TIERS[cfg.mode]
    return _FrozenTier(base) if cfg.frozen else base


def _host_admit(cache, cfg: CacheConfig, adm_ids: torch.Tensor,
                adm_rows: torch.Tensor, group: WorkerGroup):
    """Deferred admission: offer the PREVIOUS step's landed L3 rows
    (``adm_ids [L, S]``, ``adm_rows [L, S, D]``) to the cache.

    Sharded and tiered stores at W > 1 route each row to its cache-shard
    holder in one ``all_to_all`` round first (never overflowing: a
    holder's slots per source equal ``S``); tiered stores admit into the
    L2.  Returns ``(new_cache, n_inserted [L], admit_round_bytes)``."""
    w, n = group.world, adm_ids.shape[0]
    s, d = adm_ids.shape[-1], adm_rows.shape[-1]
    if cfg.mode == "tiered":
        target, tcfg = cache.l2, cfg.l2_config()
    else:
        target, tcfg = cache, cfg
    if w == 1 or cfg.mode == "replicated":
        out = [cache_insert(target.worker(i), adm_ids[i], adm_rows[i],
                            adm_ids[i] >= 0, tcfg) for i in range(n)]
        adm_bytes = 0
    else:
        dest = torch.where(adm_ids >= 0, shard_of(adm_ids, w),
                           torch.full_like(adm_ids, w))
        plan = _route_plan(dest, s, w)
        recv_ids = group.all_to_all(
            _to_wire(plan, _take(adm_ids, plan.order), w, s, -1))
        recv_rows = group.all_to_all(
            _to_wire(plan, _take(adm_rows, plan.order), w, s, 0))
        out = []
        for h in range(n):
            flat = recv_ids[h].reshape(-1)
            out.append(cache_insert(target.worker(h), flat,
                                    recv_rows[h].reshape(-1, d), flat >= 0,
                                    tcfg))
        adm_bytes = w * s * (4 + d * adm_rows.element_size())
    new = FeatureCache.stack([c for c, _ in out])
    n_ins = torch.stack([n for _, n in out])
    if cfg.mode == "tiered":
        return TieredCache(l1=cache.l1, l2=new), n_ins, adm_bytes
    return new, n_ins, adm_bytes


def _host_fetch(ids, capacity_slack, capacity, cache, cache_cfg, host_admit,
                d, dtype, group):
    """The ``store="host"`` fetch body: probe the tiers, then STAGE the
    misses into a per-worker ``[S]`` id buffer for the L3 gather.

    Hit slots are served now; staged slots are zero holes flagged
    ``req.patch``; misses beyond the staging capacity ``S`` are dropped
    and counted.  Returns ``(out, stats, req)``, or with a cache ``(out,
    new_cache, stats, cstats, req)`` where ``cstats.n_l3_hits`` counts
    the staged ids and ``n_misses`` the overflow."""
    n, r = ids.shape[0], ids.shape[-1]
    dev = ids.device
    s = capacity if capacity is not None \
        else probe_round_capacity(r, 1, capacity_slack)
    s = max(int(s), 1)
    req_ids, inverse, req_valid, _ = dedup_requests(ids)
    z = torch.zeros(n, dtype=torch.int32, device=dev)
    n_adm, adm_bytes = z, 0
    if cache is not None and host_admit is not None:
        cache, n_adm, adm_bytes = _host_admit(cache, cache_cfg, *host_admit,
                                              group)
    tier = _cache_tier(cache_cfg) if cache is not None else None
    if tier is not None:
        probe = tier.probe(
            cache, cache_cfg, req_ids, req_valid,
            probe_round_capacity(r, group.world, capacity_slack), group)
        hit = probe.hit
    else:
        probe = None
        hit = torch.zeros(ids.shape, dtype=torch.bool, device=dev)
    # stage the misses: compact them into the [S] id buffer
    miss = req_valid & ~hit
    cs = torch.cumsum(miss.to(torch.int32), dim=-1)
    staged = miss & (cs <= s)
    slot_u = cs - 1
    miss_ids = torch.full((n, s + 1), -1, dtype=torch.int32, device=dev)
    miss_ids.scatter_(1, torch.where(staged, slot_u, s).to(torch.int64),
                      torch.where(staged, req_ids, -1))
    miss_ids = miss_ids[:, :s].contiguous()
    n_staged = staged.sum(-1).to(torch.int32)
    n_overflow = miss.sum(-1).to(torch.int32) - n_staged
    if tier is not None:
        out_u = torch.where(hit[..., None], probe.rows, 0)
    else:
        out_u = torch.zeros(ids.shape + (d,), dtype=dtype, device=dev)
    served_u = hit | staged
    out = _take(out_u, inverse)
    dropped = (~_take(served_u, inverse)).sum(-1).to(torch.int32)
    req = HostMissRequest(ids=miss_ids,
                          slot=_take(slot_u, inverse).to(torch.int32),
                          patch=_take(staged, inverse))
    item = torch.empty((), dtype=dtype).element_size()
    probe_bytes = probe.wire.probe_bytes if tier is not None else 0
    stats = FetchStats(
        torch.full((n,), r, dtype=torch.int32, device=dev), n_staged, dropped,
        torch.full((n,), probe_bytes + adm_bytes, dtype=torch.int32,
                   device=dev),
        torch.full((n,), s * (4 + d * item), dtype=torch.int32, device=dev))
    if tier is None:
        return out, stats, req
    # tiered L1 promotion still happens at probe time (L2-served rows)
    new_cache, n_ins = cache, n_adm
    if cache_cfg.mode == "tiered":
        l2_hit = probe.ctx[2]
        l1_cfg = cache_cfg.l1_config()
        l1 = [cache_insert(cache.l1.worker(i), req_ids[i], probe.rows[i],
                           l2_hit[i], l1_cfg) for i in range(n)]
        new_cache = TieredCache(l1=FeatureCache.stack([c for c, _ in l1]),
                                l2=cache.l2)
        n_ins = n_ins + torch.stack([n for _, n in l1])
    n_hits = probe.hit.sum(-1).to(torch.int32)
    n_l1 = probe.l1_hit.sum(-1).to(torch.int32)
    n_local = probe.local.sum(-1).to(torch.int32)
    cstats = CacheStats(
        n_hits=n_hits, n_misses=n_overflow, n_inserted=n_ins,
        bytes_saved=(n_l1 + n_local) * (d * item), n_local_hits=n_local,
        n_shard_hits=n_hits - n_l1 - n_local, n_l1_hits=n_l1,
        n_probe_demoted=probe.wire.n_demoted,
        probe_hit_peak=probe.wire.hit_peak, n_l3_hits=n_staged)
    return out, new_cache, stats, cstats, req


def fetch_rows(table: Optional[torch.Tensor], ids: torch.Tensor, *,
               capacity_slack: float = 2.0, dedup: bool = True,
               capacity: Optional[int] = None,
               cache: Optional[FeatureCache] = None,
               cache_cfg: Optional[CacheConfig] = None,
               store: Optional[str] = None, feat_dim: Optional[int] = None,
               host_admit=None, group: Optional[WorkerGroup] = None):
    """Routed row fetch (the MapReduce shuffle) for every held worker at
    once.

    ``table [L, rows, D]`` is this process's blocks of the row-sharded
    table (global row ``i`` on worker ``i // rows``); ``ids [L, R]`` are
    each held worker's requests; ``group`` is the worker group (default:
    the stacked group of ``ids``' leading axis, ``L = W``).  Returns
    ``(out [L, R, D], FetchStats)``, or with a ``cache`` (the held
    workers' state, and its ``cache_cfg``, which is required) ``(out,
    new_cache, FetchStats, CacheStats)``.

    With ``dedup`` each distinct id takes one wire slot and its row is
    scattered back to every slot that asked for it.  Cached, distinct ids
    probe the cache tier first and only misses route to their owners;
    served misses are offered for admission unless ``cache_cfg.frozen``.
    Requests beyond the per-destination capacity (``ceil(R/W) * slack``,
    clamped to ``rows`` under dedup, or ``capacity``) return zero rows and
    count as dropped.  Rows are bit-identical to ``repro``'s.

    ``store`` picks where misses resolve (default ``cache_cfg.store``,
    else ``"device"``).  With ``store="host"`` they are staged for the L3
    gather instead (``_host_fetch``): the return grows a
    ``HostMissRequest`` tail, the staged rows are zero holes until
    ``host_store.patch_batch`` fills them, ``host_admit=(ids [L, S], rows
    [L, S, D])`` feeds the previous step's landed rows to the cache, and
    ``table`` may be ``None`` when ``feat_dim`` gives the row width."""
    if cache is not None and not dedup:
        raise ValueError("the cache front end requires dedup=True")
    if cache is not None and cache_cfg is None:
        raise ValueError("fetch_rows(cache=...) requires cache_cfg "
                         "(the CacheConfig the state was populated under)")
    if store is None:
        store = cache_cfg.store if cache_cfg is not None else "device"
    host = store == "host"
    if host and not dedup:
        raise ValueError('fetch_rows(store="host") requires dedup=True')
    if host and cache_cfg is not None and cache_cfg.frozen:
        raise ValueError('a frozen (read-mostly serve) cache cannot ride '
                         'the L3 staging path — serve misses resolve '
                         'against the device table (see serve_view())')
    if host and table is None and feat_dim is None:
        raise ValueError('fetch_rows(store="host") without a device table '
                         'requires feat_dim (the feature row width)')
    if not host and table is None:
        raise ValueError('fetch_rows(store="device") requires a table')
    if not host and host_admit is not None:
        raise ValueError('host_admit only applies to store="host"')
    if group is None:
        group = stacked(ids)
    w = group.world
    n, r = ids.shape[0], ids.shape[-1]
    d = table.shape[-1] if table is not None else feat_dim
    dtype = table.dtype if table is not None else torch.float32
    dev = ids.device
    z = torch.zeros(n, dtype=torch.int32, device=dev)
    if r == 0:
        out = torch.zeros((n, 0, d), dtype=dtype, device=dev)
        stats = FetchStats(z, z, z, z, z)
        if host:
            # a landed buffer may be pending even when nothing is requested
            n_adm = z
            if cache is not None and host_admit is not None:
                cache, n_adm, _ = _host_admit(cache, cache_cfg, *host_admit,
                                              group)
            s0 = max(int(capacity), 1) if capacity is not None else 1
            req = HostMissRequest(
                torch.full((n, s0), -1, dtype=torch.int32, device=dev),
                torch.zeros((n, 0), dtype=torch.int32, device=dev),
                torch.zeros((n, 0), dtype=torch.bool, device=dev))
            if cache is not None:
                return out, cache, stats, CacheStats(
                    z, z, n_adm, z, z, z, z, z, z, z), req
            return out, stats, req
        if cache is not None:
            return out, cache, stats, CacheStats(*(z,) * 10)
        return out, stats
    if host:
        return _host_fetch(ids, capacity_slack, capacity, cache, cache_cfg,
                           host_admit, d, dtype, group)
    rows = table.shape[1]
    n_req = torch.full((n,), r, dtype=torch.int32, device=dev)
    if w == 1 and cache is None:
        out = table[0][torch.clamp(ids[0], 0, rows - 1).to(torch.int64)][None]
        n_unique = dedup_requests(ids)[3] if dedup else n_req
        return out, FetchStats(n_req, n_unique, z, z, z)
    slack_cap = probe_round_capacity(r, w, capacity_slack)
    cap = capacity
    if cap is None:
        cap = slack_cap
        if dedup:
            cap = min(cap, rows)
    if dedup:
        req_ids, inverse, req_valid, n_unique = dedup_requests(ids)
    else:
        req_ids, inverse = ids, None
        req_valid = torch.ones(ids.shape, dtype=torch.bool, device=dev)
        n_unique = n_req
    tier = _cache_tier(cache_cfg) if cache is not None else None
    if tier is not None:
        probe = tier.probe(cache, cache_cfg, req_ids, req_valid, slack_cap,
                           group)
        route_valid = req_valid & ~probe.hit
    else:
        probe = None
        route_valid = req_valid
    if w == 1:
        fetched = table[0][torch.clamp(req_ids[0], 0, rows - 1)
                           .to(torch.int64)][None]
        fetched = torch.where(route_valid[..., None], fetched, 0)
        served_r = route_valid
    else:
        fetched, served_r = _routed_fetch(table, req_ids, route_valid, cap,
                                          group, rows)
    n_routed = route_valid.sum(-1).to(torch.int32)
    new_cache = cstats = None
    probe_bytes = 0
    if tier is not None:
        out_u = torch.where(probe.hit[..., None], probe.rows, fetched)
        served_u = probe.hit | served_r
        should = route_valid & served_r
        new_cache, n_ins = tier.admit(cache, cache_cfg, probe, req_ids,
                                      fetched, should, group)
        n_hits = probe.hit.sum(-1).to(torch.int32)
        n_l1 = probe.l1_hit.sum(-1).to(torch.int32)
        n_local = probe.local.sum(-1).to(torch.int32)
        row_bytes = d * table.element_size()
        cstats = CacheStats(
            n_hits=n_hits, n_misses=n_routed, n_inserted=n_ins,
            bytes_saved=(n_l1 + n_local) * row_bytes, n_local_hits=n_local,
            n_shard_hits=n_hits - n_l1 - n_local, n_l1_hits=n_l1,
            n_probe_demoted=probe.wire.n_demoted,
            probe_hit_peak=probe.wire.hit_peak, n_l3_hits=z)
        n_unique = n_routed
        probe_bytes = probe.wire.probe_bytes
    else:
        out_u, served_u = fetched, served_r
    if dedup:
        out = _take(out_u, inverse)
        dropped = (~_take(served_u, inverse)).sum(-1)
    else:
        out = out_u
        dropped = (~served_u).sum(-1)
    stats = FetchStats(n_req, n_unique.to(torch.int32),
                       dropped.to(torch.int32),
                       torch.full((n,), probe_bytes, dtype=torch.int32,
                                  device=dev), z)
    if cache is not None:
        return out, new_cache, stats, cstats
    return out, stats


def _worker_generate(indptr: torch.Tensor, indices: torch.Tensor,
                     x: Optional[torch.Tensor], y: torch.Tensor,
                     seeds: torch.Tensor, draws,
                     cache: Optional[FeatureCache] = None, *,
                     fanouts: Tuple[int, ...], merge_mode: str = "butterfly",
                     capacity_slack: float = 2.0,
                     cache_cfg: Optional[CacheConfig] = None,
                     fetch_capacity: Optional[int] = None,
                     feature_store: str = "device",
                     feat_dim: Optional[int] = None, host_admit=None,
                     collect_stats: bool = False,
                     group: Optional[WorkerGroup] = None):
    """One L-hop generation round of every held worker.

    ``indptr [L, N+1]``, ``indices [L, E]``, ``x [L, rows, D]``,
    ``y [L, rows, 1]``, ``seeds [L, b]`` and the round's ``draws`` (the
    held workers' rows), over ``group`` (default: the stacked group of
    ``seeds``' leading axis).  Per
    hop: broadcast the frontier, sample local candidates, merge them
    (``merge_mode``: the butterfly, then this worker's rows; or the
    reduce-scatter of this worker's segment, then an ``all_gather`` of the
    global frontier); masks chain so a padded parent's subtree stays
    padded.  Then one deduplicated feature fetch (cache-probed first when
    a cache is threaded in) and the label fetch.  Returns the
    ``SubgraphBatch`` (the held workers' seeds, ``L * b`` rows: the
    global batch on the stacked group, the rank's own on a process), and
    the new cache state when a cache is given.

    With ``feature_store="host"`` ``x`` is ``None`` (``feat_dim`` gives
    the width), the misses are staged for the L3 gather and the returns
    grow a ``HostMissRequest`` tail — ``(batch, cache, req)`` or
    ``(batch, req)``; ``host_admit`` is the previous step's landed
    ``(ids, rows)``.

    With ``collect_stats`` the return grows a ``(FetchStats, CacheStats)``
    tail (``[L]`` each).  An uncached run ships a synthesized
    ``CacheStats`` whose only nonzero field is the conservation remainder
    (``n_misses`` for the device store, ``n_l3_hits`` for the host
    store), so ``n_l1 + n_local + n_shard + n_l3 + n_misses`` counts the
    distinct ids in every traced configuration."""
    if merge_mode not in MERGE_MODES:
        raise ValueError(f"merge_mode must be one of {MERGE_MODES}, "
                         f"got {merge_mode!r}")
    if group is None:
        group = stacked(seeds)
    held, b = seeds.shape
    dev = seeds.device
    frontier = group.all_gather(seeds)                     # [L, W*b]
    parent_mask = torch.ones(frontier.shape, dtype=torch.bool, device=dev)
    me = group.axis_index(dev).to(torch.int64)
    hops, masks = [], []
    shape = (b,)
    local_rows = b
    for level, k in enumerate(fanouts):
        offs, e = draws[level]
        cand = local_candidates(indptr, indices, frontier, k, offs, e)
        cand = Candidates(ids=cand.ids, keys=torch.where(
            parent_mask[..., None], cand.keys, float("inf")))
        last = level + 1 == len(fanouts)
        if merge_mode == "reduce_scatter":
            seg = tree_reduce_scatter(cand, merge_topk,
                                      group)               # [L, rows_l, k]
            m = torch.isfinite(seg.keys)
            h = torch.where(m, seg.ids, 0)
            # the next frontier is still global: every worker scans its
            # local edges against all hop-l nodes (the last hop has no
            # next one: nothing to gather)
            if not last:
                h_all, m_all = group.all_gather(h), group.all_gather(m)
        else:
            merged = tree_allreduce(cand, merge_topk, group)   # [L, F, k]
            m_all = torch.isfinite(merged.keys)
            h_all = torch.where(m_all, merged.ids, 0)
            mine = (me[:, None] * local_rows
                    + torch.arange(local_rows, device=dev))
            h = _take(h_all, mine)
            m = _take(m_all, mine)
        shape = shape + (k,)
        hops.append(h.reshape((held,) + shape))
        masks.append(m.reshape((held,) + shape))
        if not last:
            frontier = h_all.reshape(held, -1)
            parent_mask = m_all.reshape(held, -1)
        local_rows *= k
    for level in range(1, len(masks)):
        masks[level] = masks[level] & masks[level - 1][..., None]

    need = torch.cat([seeds] + [h.reshape(held, -1) for h in hops], dim=1)
    z = torch.zeros(held, dtype=torch.int32, device=dev)
    kw = dict(capacity_slack=capacity_slack, capacity=fetch_capacity,
              store=feature_store, feat_dim=feat_dim, host_admit=host_admit,
              group=group)
    if cache is not None:
        # the host store's fetch returns its HostMissRequest as the tail
        feats, cache, fstats, cstats, *tail = fetch_rows(
            x, need, cache=cache, cache_cfg=cache_cfg, **kw)
        n_hits, n_misses = cstats.n_hits, cstats.n_misses
        n_demoted = cstats.n_probe_demoted
    else:
        feats, fstats, *tail = fetch_rows(x, need, **kw)
        n_hits, n_misses, n_demoted = z, fstats.n_unique, z
        host = feature_store == "host"
        cstats = CacheStats(
            n_hits=z, n_misses=z if host else fstats.n_unique, n_inserted=z,
            bytes_saved=z, n_local_hits=z, n_shard_hits=z, n_l1_hits=z,
            n_probe_demoted=z, probe_hit_peak=z,
            n_l3_hits=fstats.n_unique if host else z)
    req = tail[0] if tail else None
    d = feats.shape[-1]
    x_seed = feats[:, :b]
    x_hops = []
    off = n = b
    for level, k in enumerate(fanouts):
        n *= k
        xh = feats[:, off:off + n].reshape(masks[level].shape + (d,))
        x_hops.append(xh * masks[level][..., None])
        off += n
    ys, ystats = fetch_rows(y, seeds, capacity_slack=capacity_slack,
                            dedup=False, store="device", group=group)
    labels = ys[..., 0].to(torch.int32)

    def glob(t):
        return t.reshape((held * b,) + tuple(t.shape[2:]))

    batch = SubgraphBatch(
        seeds=glob(seeds), hops=tuple(map(glob, hops)),
        masks=tuple(map(glob, masks)), x_seed=glob(x_seed),
        x_hops=tuple(map(glob, x_hops)), labels=glob(labels),
        n_dropped=fstats.n_dropped + ystats.n_dropped,
        n_cache_hits=n_hits, n_cache_misses=n_misses,
        n_probe_demoted=n_demoted)
    out = (batch,) + ((cache,) if cache is not None else ()) \
        + ((req,) if req is not None else ()) \
        + (((fstats, cstats),) if collect_stats else ())
    return out if len(out) > 1 else batch


def shard_rows(table: np.ndarray, n_workers: int) -> np.ndarray:
    """Pad a ``[N, D]`` host table to ``[W, ceil(N/W), D]`` row blocks."""
    n = table.shape[0]
    rows = -(-n // n_workers)
    pad = n_workers * rows - n
    if pad:
        table = np.concatenate(
            [table, np.zeros((pad,) + table.shape[1:], table.dtype)])
    return table.reshape((n_workers, rows) + table.shape[1:])


def make_generator_fn(*, fanouts: Tuple[int, ...] = (40, 20),
                      merge_mode: str = "butterfly",
                      capacity_slack: float = 2.0,
                      cache_cfg: Optional[CacheConfig] = None,
                      fetch_capacity: Optional[int] = None,
                      feature_store: str = "device",
                      feat_dim: Optional[int] = None,
                      collect_stats: bool = False,
                      group: Optional[WorkerGroup] = None):
    """The generator function, without data.

    ``gen_fn(device_args, seeds [L, b], draws) -> SubgraphBatch`` where
    ``device_args = (indptr [L, N+1], indices [L, E], x [L, rows, D],
    y [L, rows, 1])`` are the held workers' blocks (``L = W`` on the
    stacked group, the default; 1 on a process ``group``).  With a
    ``cache_cfg`` it threads the held workers' cache state: ``gen_fn(
    device_args, seeds, draws, cache) -> (batch, cache)``;
    with a FROZEN ``cache_cfg`` (``serve_view()``) the cache is a
    read-only input and only the batch comes back.

    With ``feature_store="host"`` (``feat_dim`` required) the feature
    table never reaches the device: ``device_args = (indptr, indices,
    y)``, and ``gen_fn(device_args, seeds, draws) -> (batch, req)``
    uncached, ``gen_fn(device_args, seeds, draws, cache, admit_ids
    [L, S], admit_rows [L, S, D]) -> (batch, cache, req)`` cached, where
    ``admit_*`` is the previous step's landed gather
    (``host_store.empty_admit`` for the first).

    With ``collect_stats`` every form's return grows the per-worker
    ``(FetchStats, CacheStats)`` tail (see ``_worker_generate``); the
    frozen serve form refuses it."""
    if not fanouts:
        raise ValueError("fanouts must name at least one hop, got ()")
    if merge_mode not in MERGE_MODES:
        raise ValueError(f"merge_mode must be one of {MERGE_MODES}, "
                         f"got {merge_mode!r}")
    if feature_store not in ("device", "host"):
        raise ValueError(f"feature_store must be 'device' or 'host', "
                         f"got {feature_store!r}")
    host = feature_store == "host"
    if host and feat_dim is None:
        raise ValueError('make_generator_fn(feature_store="host") requires '
                         'feat_dim (no device table to read it from)')
    cached = cache_cfg is not None and cache_cfg.n_rows > 0
    frozen = cached and cache_cfg.frozen
    if frozen and host:
        raise ValueError('a frozen (read-mostly serve) cache cannot ride '
                         'the L3 staging path — build the serve generator '
                         'with feature_store="device"')
    if frozen and collect_stats:
        raise ValueError('collect_stats instruments the training-path '
                         'generator; the frozen serve form ships answers, '
                         'not telemetry — trace before serve_view()')
    if cached:
        # the generator's feature_store is authoritative
        cache_cfg = cache_cfg.validated()._replace(store=feature_store)
    worker_gen = functools.partial(
        _worker_generate, fanouts=tuple(fanouts), merge_mode=merge_mode,
        capacity_slack=capacity_slack,
        cache_cfg=cache_cfg if cached else None,
        fetch_capacity=fetch_capacity, feature_store=feature_store,
        feat_dim=feat_dim, collect_stats=collect_stats, group=group)

    if host and cached:
        def gen_fn(device_args, seeds, draws, cache, admit_ids, admit_rows):
            indptr, indices, ys = device_args
            return worker_gen(indptr, indices, None, ys, seeds, draws, cache,
                              host_admit=(admit_ids, admit_rows))
    elif host:
        def gen_fn(device_args, seeds, draws):
            indptr, indices, ys = device_args
            return worker_gen(indptr, indices, None, ys, seeds, draws)
    elif frozen:
        def gen_fn(device_args, seeds, draws, cache):
            batch, _ = worker_gen(*device_args, seeds, draws, cache)
            return batch
    elif cached:
        def gen_fn(device_args, seeds, draws, cache):
            return worker_gen(*device_args, seeds, draws, cache)
    else:
        def gen_fn(device_args, seeds, draws):
            return worker_gen(*device_args, seeds, draws)
    return gen_fn


def make_distributed_generator(part: PartitionedGraph, features: np.ndarray,
                               labels: np.ndarray, *,
                               fanouts: Tuple[int, ...] = (40, 20),
                               merge_mode: str = "butterfly",
                               capacity_slack: float = 2.0,
                               cache_cfg: Optional[CacheConfig] = None,
                               fetch_capacity: Optional[int] = None,
                               feature_store: str = "device",
                               host_gather_depth: int = 2,
                               collect_stats: bool = False,
                               device="cuda",
                               group: Optional[WorkerGroup] = None):
    """Place the graph, features and labels on ``device`` and build the
    generator: ``(gen_fn, device_args)``, or with a ``cache_cfg``
    ``(gen_fn, device_args, cache0)`` with an empty cache state.

    On a process ``group`` only the rank's own blocks go to the device
    (``group.device``; ``device`` is ignored): its row of the partition's
    ``indptr``/``indices``, its feature and label shards and its cache
    shard.  The host arrays are the whole ``W``-worker ones every rank
    builds from the seed.

    With ``feature_store="host"`` the feature table stays in host RAM
    (unsharded) behind a ``HostFeatureStore`` of depth
    ``host_gather_depth``; only the graph and the labels go to the
    device, and the returns are ``(gen_fn, device_args, store)`` and
    ``(gen_fn, device_args, store, cache0)``.  ``collect_stats`` builds
    the instrumented generator (``make_generator_fn``)."""
    w = part.n_workers
    if group is None:
        group = StackedGroup(w, resolve_device(device))
    elif group.world != w:
        raise ValueError(f"the partition has {w} workers, the group "
                         f"{group.world}")
    dev = group.device
    host = feature_store == "host"

    def place(a):
        return torch.from_numpy(np.ascontiguousarray(group.block(a))).to(dev)
    y = shard_rows(labels.reshape(-1, 1).astype(np.float32), w)
    graph = (place(part.indptr), place(part.indices))
    labels_t = place(y)
    d = int(features.shape[1])
    gen_fn = make_generator_fn(fanouts=fanouts, merge_mode=merge_mode,
                               capacity_slack=capacity_slack,
                               cache_cfg=cache_cfg,
                               fetch_capacity=fetch_capacity,
                               feature_store=feature_store,
                               feat_dim=d if host else None,
                               collect_stats=collect_stats, group=group)
    cached = cache_cfg is not None and cache_cfg.n_rows > 0
    cache0 = (init_cache_state(cache_cfg.validated(), d, group.local,
                               device=dev) if cached else None)
    if host:
        table = (features if features.dtype == np.float32
                 else features.astype(np.float32))
        out = (gen_fn, graph + (labels_t,),
               HostFeatureStore(table, depth=host_gather_depth))
    else:
        x = shard_rows(features.astype(np.float32), w)
        out = (gen_fn, graph + (place(x), labels_t))
    return out + ((cache0,) if cached else ())
