"""Profile-driven unified autotuner: trace once, fit, replay offline
(the port of ``repro/launch/autotune.py``).

Instead of the serial calibration ladders (capacity slack, compact-wire
hit cap), one short instrumented window of the real generator is
recorded and the joint knob space is searched offline against a cost
model fit from that window:

1. **Trace** (:func:`record_trace`): run ``--autotune-steps`` rounds of
   the ``collect_stats=True`` generator and record, per step, the
   summed-over-workers ``FetchStats``/``CacheStats`` telemetry and the
   step's wall time (stopped after ``torch.cuda.synchronize()`` on a
   card).  :meth:`Trace.violations` checks the cache-tier conservation
   identities and the static wire formulas on every record.
2. **Fit** (:meth:`CostModel.fit`): anchor a log-linear hit-rate curve at
   the traced point over the warm half of the window.  Evaluating the
   traced candidate reproduces the warm sums, the measured wire bytes
   and the traced mean step time exactly.
3. **Replay** (:func:`candidate_grid` + :func:`search`): predict every
   candidate ``(fanouts, cache_rows, l1_rows, assoc, hit_cap,
   capacity_slack)`` from the static wire formulas ``fetch_rows`` uses
   and the roofline terms of the card (:mod:`.roofline`).  No device
   work.
4. **Validate** (:func:`autotune_gcn`): the top-ranked candidates are
   rebuilt and measured live for a few rounds each; the first that drops
   no request, demotes no hit and lands within ``VALIDATOR_RATIO`` of
   ``max(predicted, traced)`` wins, else the caller falls back to the
   ladders.

Everything from the trace records down to the prediction is plain Python
ints and floats, line for line the reference's: the same records give
bit-identical :class:`Prediction` s and rankings.  Where the reference
takes PRNG keys, the port takes the draws seam: ``draws_for(fanouts)``
returns a ``SeededDraws`` (a candidate may permute the fanouts, which
changes the draw shapes).
"""
from __future__ import annotations

import itertools
import math
import time
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import VALID_CACHE_ASSOC, TuneCandidate
from .roofline import roofline_terms

#: live-measurement acceptance bound: the validator rejects the model's
#: pick when its measured warm step time exceeds this multiple of
#: max(predicted, traced) — wide enough for host-clock jitter, tight
#: enough to catch a mis-fit model picking a config that thrashes
VALIDATOR_RATIO = 3.0

#: fewest trace steps the fit accepts: the cold-half exclusion
#: leaves half the window, and one warm step has no averaging at all
MIN_TRACE_STEPS = 4

#: approximate conflict-miss utilization of an assoc-way cache relative
#: to fully-associative — the only empirically-shaped constant in the
#: model (direct-mapped caches waste capacity to conflict evictions)
ASSOC_UTILIZATION = {1: 0.66, 2: 0.85, 4: 1.0}

#: compact-wire hit-cap fractions the grid probes (mirrors the
#: calibration ladder ``launch.train.HIT_CAP_LADDER`` — kept as a
#: literal here because train imports this module)
HIT_CAP_FRACTIONS = (0.125, 0.25, 0.5)

#: capacity-slack rungs the grid probes (subset of
#: ``launch.train.SLACK_LADDER``; 0.25 is omitted — the model has
#: no drop term, so the live validator would pay for most 0.25 picks)
SLACK_RUNGS = (0.5, 1.0, 1.5, 2.0)


class TraceTooShort(ValueError):
    """The trace's warm window is too short to fit a model from."""


class TraceInconsistent(ValueError):
    """A trace record violated the cache-tier conservation identities."""


class TraceRecord(NamedTuple):
    """One instrumented step's telemetry, summed over workers.

    Every count is a python int (the sum of the per-worker
    ``FetchStats``/``CacheStats`` scalars for that step) except
    ``probe_hit_peak`` (the max over workers) and ``wall_time_s``.
    """
    n_requests: int         # request slots presented (incl. duplicates)
    n_unique: int           # ids routed to owners (device) / staged (host)
    n_dropped: int          # request slots zero-filled by capacity bounds
    probe_round_bytes: int  # measured shard-probe (+ host-admit) bytes
    host_gather_bytes: int  # measured L3 staging-round PCIe bytes
    n_hits: int             # distinct ids served by ANY cache tier
    n_misses: int           # distinct ids routed to the owner exchange
    n_l1_hits: int          # subset of hits served by the replicated L1
    n_local_hits: int       # subset served by THIS worker's main tier
    n_shard_hits: int       # subset served by a remote cache shard
    n_l3_hits: int          # distinct ids staged for the L3 host gather
    n_probe_demoted: int    # hits demoted to misses by the hit_cap bound
    probe_hit_peak: int     # max per-destination probe hits (over workers)
    wall_time_s: float      # wall time of the step, measured at the host

    def n_distinct(self) -> int:
        """Distinct ids the step resolved — the conservation total
        ``l1 + local + shard + l3 + misses`` every id routes through
        exactly once."""
        return (self.n_l1_hits + self.n_local_hits + self.n_shard_hits
                + self.n_l3_hits + self.n_misses)


class TracedConfig(NamedTuple):
    """The static facts of the configuration a trace was recorded under.

    Pure-python — everything the cost model needs to replay the wire
    formulas without touching the device: the generation shape
    (``fanouts``/``batch_per_worker``/``n_workers``), the feature row
    (``feat_dim`` x ``itemsize`` bytes), and the cache policy knobs.
    ``mode is None`` records an uncached trace.
    """
    fanouts: Tuple[int, ...]
    n_workers: int
    batch_per_worker: int
    feat_dim: int
    itemsize: int = 4
    mode: Optional[str] = None
    cache_rows: int = 0
    l1_rows: int = 0
    assoc: int = 1
    wire: str = "compact"
    hit_cap: int = 0
    capacity_slack: float = 2.0
    store: str = "device"

    def candidate(self) -> TuneCandidate:
        """The traced point expressed as a search candidate — the anchor
        every prediction is exact at."""
        return TuneCandidate(
            fanouts=tuple(self.fanouts), cache_rows=self.cache_rows,
            l1_rows=self.l1_rows, assoc=self.assoc, hit_cap=self.hit_cap,
            capacity_slack=self.capacity_slack)


def _requests_per_worker(fanouts: Tuple[int, ...],
                         batch_per_worker: int) -> int:
    """Feature-fetch request slots per worker per step: every padded
    node slot of the sampled trees (``b * slots_per_seed``)."""
    from ..graph.subgraph import slots_per_seed
    return batch_per_worker * slots_per_seed(tuple(fanouts))


def static_wire_bytes(tc: TracedConfig,
                      cand: TuneCandidate) -> Tuple[int, int, int]:
    """Per-worker static wire bytes of one step at candidate ``cand``.

    Returns ``(probe_bytes, gather_bytes, admit_bytes)`` — the byte
    sizes of the shard-probe round, the L3 host-staging round trip, and
    the deferred host-admission round, computed from the SAME sizing
    functions the fetch uses (``probe_round_capacity``,
    ``probe_hit_cap``, ``hit_bitmap_words``), so the model's byte
    predictions equal the measured ``FetchStats`` values exactly.
    """
    from ..core.feature_cache import CacheConfig, hit_bitmap_words
    from ..core.generation import probe_hit_cap, probe_round_capacity

    w, d, item = tc.n_workers, tc.feat_dim, tc.itemsize
    r_pw = _requests_per_worker(cand.fanouts, tc.batch_per_worker)
    cached = tc.mode is not None and cand.cache_rows > 0
    host = tc.store == "host"
    probe = 0
    if cached and w > 1 and tc.mode != "replicated":
        cap = probe_round_capacity(r_pw, w, cand.capacity_slack)
        probe = w * cap * 4                                   # ids up
        if tc.wire == "compact":
            hc = probe_hit_cap(
                CacheConfig(n_rows=max(cand.cache_rows, 1),
                            hit_cap=cand.hit_cap), cap)
            probe += w * hit_bitmap_words(cap) * 4 + w * hc * d * item
        else:
            probe += w * cap * 1 + w * cap * d * item
    gather = admit = 0
    if host:
        s = max(int(probe_round_capacity(r_pw, 1, cand.capacity_slack)), 1)
        gather = s * (4 + d * item)
        if cached and w > 1 and tc.mode != "replicated":
            admit = w * s * (4 + d * item)
    return probe, gather, admit


class Trace(NamedTuple):
    """An instrumented window of the real loop: config + per-step records."""
    config: TracedConfig
    records: Tuple[TraceRecord, ...]

    def warm_records(self) -> Tuple[TraceRecord, ...]:
        """The warm half of the window — the cold-half exclusion:
        the first ``max(n // 2, 1)`` steps carry the cold-start miss
        burst (and step 0 the process's start-up), so only the second half
        feeds the fit.  Empty when the window has fewer than 2 steps."""
        n = len(self.records)
        return self.records[max(n // 2, 1):]

    def violations(self) -> Tuple[str, ...]:
        """Conservation-identity violations, one message per breach.

        Per record: counts non-negative and wall time positive/finite;
        tier hits sum to total hits; the requester-side
        ``FetchStats.n_unique`` equals the owner-routed misses (device
        store) or the L3-staged count (host store); the measured
        probe-round and host-gather bytes equal the static wire
        formulas (host admission may also ride the 1-slot
        ``empty_admit`` prologue buffer on early steps).  An empty
        tuple means the trace is internally consistent.
        """
        tc = self.config
        out = []
        probe, gather, admit = static_wire_bytes(tc, tc.candidate())
        w, d, item = tc.n_workers, tc.feat_dim, tc.itemsize
        admit0 = w * 1 * (4 + d * item) if admit else 0
        r_all = w * _requests_per_worker(tc.fanouts, tc.batch_per_worker)
        for t, r in enumerate(self.records):
            for f, v in zip(r._fields, r):
                if v < 0:
                    out.append(f"step {t}: {f} negative ({v})")
            if not (r.wall_time_s > 0.0 and math.isfinite(r.wall_time_s)):
                out.append(f"step {t}: wall_time_s not positive/finite "
                           f"({r.wall_time_s})")
            tiers = r.n_l1_hits + r.n_local_hits + r.n_shard_hits
            if r.n_hits != tiers:
                out.append(f"step {t}: tier hits {tiers} != n_hits "
                           f"{r.n_hits}")
            routed = r.n_l3_hits if tc.store == "host" else r.n_misses
            if r.n_unique != routed:
                out.append(f"step {t}: n_unique {r.n_unique} != "
                           f"routed/staged {routed}")
            if r.n_requests != r_all:
                out.append(f"step {t}: n_requests {r.n_requests} != "
                           f"{r_all} (= W * b * slots_per_seed)")
            if r.n_distinct() > r.n_requests:
                out.append(f"step {t}: distinct {r.n_distinct()} > "
                           f"requests {r.n_requests}")
            want = {w * (probe + admit), w * (probe + admit0)}
            if r.probe_round_bytes not in want:
                out.append(f"step {t}: probe_round_bytes "
                           f"{r.probe_round_bytes} not in {sorted(want)}")
            if r.host_gather_bytes != w * gather:
                out.append(f"step {t}: host_gather_bytes "
                           f"{r.host_gather_bytes} != {w * gather}")
        return tuple(out)

    def validate(self) -> None:
        """Raise :class:`TraceInconsistent` listing every conservation
        violation; return silently when the trace is consistent."""
        bad = self.violations()
        if bad:
            raise TraceInconsistent("; ".join(bad))


class Prediction(NamedTuple):
    """One offline replay of a candidate — scalars only, so two replays
    of the same (trace, candidate) compare bit-identically with ``==``.

    Counts are predicted WARM-WINDOW totals summed over workers (the
    same aggregation the trace records use); byte fields are the static
    per-worker sizes of one round (the values ``FetchStats`` measures).
    """
    candidate: TuneCandidate
    step_time_s: float      # predicted mean step wall time
    probe_round_bytes: int  # static per-worker shard-probe (+admit) bytes
    host_gather_bytes: int  # static per-worker L3 staging bytes
    n_distinct: float       # predicted distinct ids over the warm window
    n_hits: float           # predicted cache-tier hits (all tiers)
    n_l1_hits: float        # predicted replicated-L1 subset
    n_l3_hits: float        # predicted L3-staged ids (host store)
    n_misses: float         # predicted owner-routed misses
    wire_bytes: float       # per-worker per-step interconnect bytes
    cost_s: float           # summed roofline terms of one step


def _effective_capacity(tc: TracedConfig, rows: int, assoc: int) -> float:
    """Distinct-id capacity of the main cache tier at ``rows`` x
    ``assoc``: sharded/tiered modes pool all W shards; conflict-miss
    utilization scales by ``ASSOC_UTILIZATION``."""
    pooled = rows * (tc.n_workers if tc.mode in ("sharded", "tiered")
                     else 1)
    return pooled * ASSOC_UTILIZATION[assoc]


class CostModel(NamedTuple):
    """Warm-window anchor sums + the traced config: the fitted model.

    All fields are python ints/floats, so :meth:`predict` is a pure
    deterministic function — the replay-determinism contract.  The hit
    curve is count-space log-linear, anchored EXACTLY at the traced
    point: ``hits(c) = clip(H0 + B * (log2 eff(c) - log2 eff(c0)), 0,
    D)`` with ``B = H0 / log2 eff(c0)`` — the one-point fit that passes
    through both the anchor and the hits->0 limit of a vanishing cache.
    """
    traced: TracedConfig
    steps: int              # warm-window length (records)
    distinct_sum: int       # sum of n_distinct over the warm window
    hit_sum: int            # sum of n_hits
    l1_sum: int             # sum of n_l1_hits
    l3_sum: int             # sum of n_l3_hits
    miss_sum: int           # sum of n_misses
    wall_mean_s: float      # mean warm-window step wall time

    @classmethod
    def fit(cls, trace: Trace, strict: bool = True) -> "CostModel":
        """Fit the model from a trace's warm window.

        Raises :class:`TraceTooShort` when the window is shorter than
        ``MIN_TRACE_STEPS`` or its warm half is empty, and (unless
        ``strict=False``) :class:`TraceInconsistent` when the records
        breach the conservation identities — a corrupted trace must not
        silently become a confident model.
        """
        if strict:
            trace.validate()
        warm = trace.warm_records()
        if len(trace.records) < MIN_TRACE_STEPS or not warm:
            raise TraceTooShort(
                f"trace has {len(trace.records)} steps "
                f"({len(warm)} warm); need >= {MIN_TRACE_STEPS}")
        return cls(
            traced=trace.config,
            steps=len(warm),
            distinct_sum=sum(r.n_distinct() for r in warm),
            hit_sum=sum(r.n_hits for r in warm),
            l1_sum=sum(r.n_l1_hits for r in warm),
            l3_sum=sum(r.n_l3_hits for r in warm),
            miss_sum=sum(r.n_misses for r in warm),
            wall_mean_s=sum(r.wall_time_s for r in warm) / len(warm),
        )

    def _counts(self, cand: TuneCandidate):
        """Predicted warm-window (distinct, hits, l1, l3, misses)."""
        tc = self.traced
        work0 = _requests_per_worker(tc.fanouts, tc.batch_per_worker)
        work = _requests_per_worker(cand.fanouts, tc.batch_per_worker)
        distinct = self.distinct_sum * (work / work0)
        cached = tc.mode is not None and cand.cache_rows > 0
        if not cached:
            hits = 0.0
        else:
            e0 = _effective_capacity(tc, tc.cache_rows, tc.assoc)
            e = _effective_capacity(tc, cand.cache_rows, cand.assoc)
            if e <= 0.0 or e0 <= 0.0:
                hits = 0.0
            else:
                slope = self.hit_sum / math.log2(max(e0, 2.0))
                hits = self.hit_sum + slope * (math.log2(e)
                                               - math.log2(e0))
                hits = min(max(hits, 0.0), distinct)
        if tc.mode == "tiered" and cand.l1_rows > 0 and hits > 0.0:
            l1_0 = max(tc.l1_rows, 1)
            slope1 = self.l1_sum / math.log2(max(l1_0, 2.0))
            l1 = self.l1_sum + slope1 * (math.log2(max(cand.l1_rows, 1))
                                         - math.log2(l1_0))
            l1 = min(max(l1, 0.0), hits)
        else:
            l1 = 0.0
        rest = distinct - hits
        if tc.store == "host":
            l3, misses = rest, 0.0
        else:
            l3, misses = 0.0, rest
        return distinct, hits, l1, l3, misses

    def _cost(self, cand: TuneCandidate, misses: float) -> Tuple[float,
                                                                 float]:
        """Summed per-step roofline terms and the wire-bytes component."""
        tc = self.traced
        probe, gather, admit = static_wire_bytes(tc, cand)
        d, item, w = tc.feat_dim, tc.itemsize, tc.n_workers
        # owner-exchange occupancy: each routed distinct id ships its id
        # up and its feature row back (per worker per step)
        miss_pw = misses / (self.steps * w)
        wire = probe + admit + miss_pw * (4 + d * item)
        # HBM traffic: every padded node slot's feature row moves ~3x
        # (gather, mask-multiply, layer input) — the constant cancels in
        # the anchored ratio and only shapes cross-fanout comparisons
        hbm = 3.0 * _requests_per_worker(cand.fanouts,
                                         tc.batch_per_worker) * d * item
        terms = roofline_terms(0.0, hbm, wire, gather)
        return sum(terms.values()), wire

    def predict(self, cand: TuneCandidate) -> Prediction:
        """Replay one candidate offline: counts from the anchored hit
        curve, bytes from the static wire formulas, step time from the
        roofline-term ratio against the traced point.  Evaluating the
        traced candidate returns the trace's own warm-window sums and
        measured wall time exactly."""
        cand = TuneCandidate(tuple(cand.fanouts), int(cand.cache_rows),
                             int(cand.l1_rows), int(cand.assoc),
                             int(cand.hit_cap),
                             float(cand.capacity_slack))
        distinct, hits, l1, l3, misses = self._counts(cand)
        cost, wire = self._cost(cand, misses)
        cost0, _ = self._cost(self.traced.candidate(),
                              self._counts(self.traced.candidate())[4])
        probe, gather, _ = static_wire_bytes(self.traced, cand)
        return Prediction(
            candidate=cand,
            step_time_s=self.wall_mean_s * (cost / cost0),
            probe_round_bytes=probe,
            host_gather_bytes=gather,
            n_distinct=distinct, n_hits=hits, n_l1_hits=l1,
            n_l3_hits=l3, n_misses=misses,
            wire_bytes=wire, cost_s=cost)


def candidate_cache_cfg(base, cand: TuneCandidate):
    """The candidate applied to a ``CacheConfig`` — the cache half of
    the rebuild seam (``ModelConfig.with_candidate`` is the model half).
    Keeps the traced policy fields (mode, admit, wire, store) and swaps
    the sizing knobs the search explored."""
    return base._replace(n_rows=cand.cache_rows, l1_rows=cand.l1_rows,
                         assoc=cand.assoc, hit_cap=cand.hit_cap)


def observed_floors(trace: Trace) -> dict:
    """Demotion-safety floors the trace's own evidence implies.

    The cost model has no demotion term — demotions are per-destination
    SKEW events, not averages — so the grid must not offer compact-wire
    hit caps the traced workload already exceeded.  ``hit_peak`` is the
    largest per-destination probe-hit count any holder observed: a
    ``hit_cap`` below it would have demoted hits on this very trace
    (and :func:`candidate_grid` scales it up for candidates with MORE
    effective cache capacity than the traced point, whose hit peaks
    will grow with the hit count).  Drops get no floor on purpose:
    request drops depend on per-destination occupancy at capacities the
    trace never ran, which no offline margin can honestly bound — the
    live validator in :func:`autotune_gcn` is the drop check, exactly
    the evidence the calibration ladders use.
    """
    return {
        "hit_peak": max((r.probe_hit_peak for r in trace.records),
                        default=0),
    }


def candidate_grid(tc: TracedConfig, base_cache_cfg=None, floors=None):
    """The joint search space around a traced point.

    Fanout variants preserve the sampled tree exactly up to hop order
    (permutations of the traced tuple — same receptive field, different
    slot counts); cache rows sweep two power-of-two octaves either way;
    assoc spans ``VALID_CACHE_ASSOC``; L1 rows sweep an octave (tiered
    mode only); hit caps take the ladder fractions of each candidate's
    probe capacity (plus the never-demoting full-capacity cap); slack
    takes ``SLACK_RUNGS`` plus the traced value.  Candidates whose
    ``CacheConfig`` would not validate are filtered (``base_cache_cfg``
    supplies the policy fields; omit it for an uncached trace).  With
    ``floors`` (:func:`observed_floors`), hit caps below the traced
    per-destination hit peak — scaled by the candidate's effective-
    capacity growth over the traced point, since hit peaks grow with
    the hit count — are filtered: the trace's own evidence says they
    would demote.  Deterministically ordered and deduplicated.
    """
    from ..core.generation import probe_round_capacity

    fanout_opts = sorted(set(itertools.permutations(tc.fanouts)))[:6]
    cached = tc.mode is not None and tc.cache_rows > 0
    if cached:
        r0 = tc.cache_rows
        row_opts = sorted({max(r0 >> 2, 1), max(r0 >> 1, 1), r0,
                           r0 << 1, r0 << 2})
        assoc_opts = tuple(VALID_CACHE_ASSOC)
        if tc.mode == "tiered":
            l0 = max(tc.l1_rows, 1)
            l1_opts = sorted({max(l0 >> 1, 1), l0, l0 << 1})
        else:
            l1_opts = [tc.l1_rows]
    else:
        row_opts, assoc_opts, l1_opts = [tc.cache_rows], [tc.assoc], [0]
    slack_opts = sorted(set(SLACK_RUNGS) | {tc.capacity_slack})
    probe_wire = (cached and tc.n_workers > 1 and tc.mode != "replicated"
                  and tc.wire == "compact")
    out = []
    seen = set()
    for fo, rows, assoc, l1, slack in itertools.product(
            fanout_opts, row_opts, assoc_opts, l1_opts, slack_opts):
        cap = probe_round_capacity(
            _requests_per_worker(fo, tc.batch_per_worker),
            tc.n_workers, slack)
        if probe_wire:
            hc_opts = sorted({0, cap} | {max(int(cap * f), 1)
                                         for f in HIT_CAP_FRACTIONS})
            if floors is not None:
                # scale the traced demotion floor with the candidate's
                # capacity growth (clamped to cap: a full-capacity
                # payload can never demote, so it always survives)
                e0 = max(_effective_capacity(tc, tc.cache_rows, tc.assoc),
                         1.0)
                e = _effective_capacity(tc, rows, assoc)
                hp = min(int(math.ceil(floors["hit_peak"]
                                       * max(e / e0, 1.0))), cap)
                hc_opts = [h for h in hc_opts
                           if min(cap // 2 if h == 0 else h, cap) >= hp]
        else:
            hc_opts = [tc.hit_cap]
        for hc in hc_opts:
            cand = TuneCandidate(fo, rows, l1, assoc, hc, slack)
            if cand in seen:
                continue
            seen.add(cand)
            if cached and base_cache_cfg is not None:
                try:
                    candidate_cache_cfg(base_cache_cfg, cand).validated()
                except ValueError:
                    continue
            out.append(cand)
    return out


def search(model: CostModel, grid=None):
    """Replay the grid offline and rank it: returns ``(best, ranked)``
    where ``ranked`` is every prediction sorted by predicted step time
    (candidate tuple as the deterministic tie-break)."""
    if grid is None:
        grid = candidate_grid(model.traced)
    ranked = sorted((model.predict(c) for c in grid),
                    key=lambda p: (p.step_time_s, p.candidate))
    if not ranked:
        raise ValueError("empty candidate grid — nothing to search")
    return ranked[0], ranked


def _sum_stats(stats) -> dict:
    """Host-side reduction of one step's stacked ``(FetchStats,
    CacheStats)``: every per-worker counter summed (the probe-hit peak:
    its max) into Python ints."""
    fs, cs = stats
    out = {f: int(v.sum()) for f, v in zip(fs._fields, fs)}
    for f, v in zip(cs._fields, cs):
        out[f] = int(v.max()) if f == "probe_hit_peak" else int(v.sum())
    return out


def record_trace(gen_fn, device_args, probes, traced: TracedConfig, *,
                 cache=None, store=None) -> Trace:
    """Run the instrumented window and build the :class:`Trace`.

    ``gen_fn`` must be the ``collect_stats=True`` generator for the
    configuration ``traced`` describes; ``probes`` is a list of ``(seeds
    [W, b], draws)`` rounds.  Host-store traces drive the real split
    dispatch (issue the L3 gather, land it, admit the landed rows next
    step), so ``host_gather_bytes`` enters the records.  A step whose
    telemetry breaches the tier-sum identity ends the window early (the
    short trace then fails :meth:`CostModel.fit`); the in-flight gather
    is drained on every exit."""
    from ..core.host_store import empty_admit

    host = traced.store == "host"
    if host and store is None:
        raise ValueError('record_trace on a store="host" trace needs the '
                         'HostFeatureStore to drive the gather pipeline')
    dev = device_args[0].device
    records = []
    pending = None
    prev_req = None
    try:
        with torch.no_grad():
            for seeds, draws in probes:
                t0 = time.perf_counter()
                if host and cache is not None:
                    if pending is None:
                        adm_ids, adm_rows = empty_admit(
                            traced.n_workers, traced.feat_dim, device=dev)
                    else:
                        adm_ids, adm_rows = prev_req.ids, pending.rows()
                    batch, cache, req, stats = gen_fn(
                        device_args, seeds, draws, cache, adm_ids, adm_rows)
                    pending = store.issue(req.ids)
                    prev_req = req
                elif host:
                    batch, req, stats = gen_fn(device_args, seeds, draws)
                    if pending is not None:
                        pending.rows()      # land the previous round first
                    pending = store.issue(req.ids)
                elif cache is not None:
                    batch, cache, stats = gen_fn(device_args, seeds, draws,
                                                 cache)
                else:
                    batch, stats = gen_fn(device_args, seeds, draws)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                s = _sum_stats(stats)
                rec = TraceRecord(
                    n_requests=s["n_requests"], n_unique=s["n_unique"],
                    n_dropped=s["n_dropped"],
                    probe_round_bytes=s["probe_round_bytes"],
                    host_gather_bytes=s["host_gather_bytes"],
                    n_hits=s["n_hits"], n_misses=s["n_misses"],
                    n_l1_hits=s["n_l1_hits"], n_local_hits=s["n_local_hits"],
                    n_shard_hits=s["n_shard_hits"], n_l3_hits=s["n_l3_hits"],
                    n_probe_demoted=s["n_probe_demoted"],
                    probe_hit_peak=s["probe_hit_peak"], wall_time_s=wall)
                records.append(rec)
                if rec.n_hits != (rec.n_l1_hits + rec.n_local_hits
                                  + rec.n_shard_hits):
                    break               # early exit: telemetry is broken
    finally:
        if pending is not None:
            pending.rows()              # drain the in-flight L3 gather
    return Trace(config=traced, records=tuple(records))


class AutotuneResult(NamedTuple):
    """What :func:`autotune_gcn` hands the launcher.

    ``accepted=False`` means the caller must fall back to the
    calibration ladders (``reason`` says why: short/inconsistent trace,
    or the live validator rejected the pick)."""
    accepted: bool
    reason: str
    candidate: Optional[TuneCandidate] = None
    prediction: Optional[Prediction] = None
    trace: Optional[Trace] = None
    measured_step_s: float = 0.0
    #: one ``ValidatedPick`` per candidate the live validator measured
    picks: Tuple["ValidatedPick", ...] = ()
    #: candidates the offline search ranked
    n_searched: int = 0


class ValidatedPick(NamedTuple):
    """One live validation of a ranked pick: its prediction, the measured
    warm step time, the dropped requests and demoted hits of the window,
    and whether it was accepted."""
    prediction: Prediction
    measured_step_s: float
    n_dropped: int
    n_demoted: int
    accepted: bool


def _traced_config(fanouts, w, b, feat_dim, cache_cfg, slack,
                   feature_store) -> TracedConfig:
    """Build the :class:`TracedConfig` for a launcher configuration."""
    cached = cache_cfg is not None and cache_cfg.n_rows > 0
    return TracedConfig(
        fanouts=tuple(fanouts), n_workers=w, batch_per_worker=b,
        feat_dim=feat_dim, itemsize=4,
        mode=cache_cfg.mode if cached else None,
        cache_rows=cache_cfg.n_rows if cached else 0,
        l1_rows=cache_cfg.l1_rows if cached else 0,
        assoc=cache_cfg.assoc if cached else 1,
        wire=cache_cfg.wire if cached else "compact",
        hit_cap=cache_cfg.hit_cap if cached else 0,
        capacity_slack=float(slack), store=feature_store)


def _instrumented_run(device, part, feats, labels, tc: TracedConfig,
                      cache_cfg, probes) -> Trace:
    """Place the data on ``device``, build the ``collect_stats`` generator
    for ``tc``, and record one trace window over ``probes`` (cold
    cache)."""
    from ..core.generation import make_distributed_generator

    cached = tc.mode is not None and tc.cache_rows > 0
    out = make_distributed_generator(
        part, feats, labels, fanouts=tc.fanouts,
        capacity_slack=tc.capacity_slack,
        cache_cfg=cache_cfg if cached else None,
        feature_store=tc.store, collect_stats=True, device=device)
    store = cache = None
    if tc.store == "host" and cached:
        gen_fn, device_args, store, cache = out
    elif tc.store == "host":
        gen_fn, device_args, store = out
    elif cached:
        gen_fn, device_args, cache = out
    else:
        gen_fn, device_args = out
    return record_trace(gen_fn, device_args, probes, tc,
                        cache=cache, store=store)


def autotune_gcn(device, part, feats, labels, *, fanouts, cache_cfg,
                 feature_store, batch_per_worker, seeds_for, draws_for,
                 steps: int = 8, slack: float = 2.0,
                 validator_ratio: float = VALIDATOR_RATIO,
                 validator_probes: int = 3,
                 validator_picks: int = 3) -> AutotuneResult:
    """The full trace -> fit -> search -> validate pass for the GCN run.

    Records a ``steps``-long window at the configured point (round ``t``:
    ``seeds_for(t)`` and ``draws_for(fanouts)(t, W, b)``), fits
    :class:`CostModel`, searches :func:`candidate_grid`, then measures up
    to ``validator_picks`` of the best predicted candidates live for
    ``validator_probes`` rounds each (their draws from
    ``draws_for(candidate fanouts)``).  The first that drops no request,
    demotes no hit and lands within ``validator_ratio`` of
    ``max(predicted, traced)`` step time is accepted; otherwise, or when
    the trace is too short or inconsistent to fit, the result says to
    fall back to the calibration ladders."""
    w = part.n_workers
    b = batch_per_worker
    feat_dim = int(feats.shape[1])
    tc = _traced_config(fanouts, w, b, feat_dim, cache_cfg, slack,
                        feature_store)

    def probes_for(fo, n):
        draws = draws_for(tuple(fo))
        return [(seeds_for(t), draws(t, w, b)) for t in range(n)]

    trace = _instrumented_run(device, part, feats, labels, tc, cache_cfg,
                              probes_for(tc.fanouts, steps))
    try:
        model = CostModel.fit(trace)
    except (TraceTooShort, TraceInconsistent) as e:
        return AutotuneResult(False, f"{type(e).__name__}: {e}",
                              trace=trace)
    grid = candidate_grid(tc, cache_cfg, floors=observed_floors(trace))
    if not grid:
        return AutotuneResult(False, "empty candidate grid after the "
                                     "demotion-floor and validity filters",
                              trace=trace)
    best, ranked = search(model, grid)
    print(f"autotune: searched {len(ranked)} candidates offline; best "
          f"predicted {best.step_time_s * 1e3:.1f} ms/step vs traced "
          f"{model.wall_mean_s * 1e3:.1f}")
    # live validation: the ladders' acceptance rules, walked down the
    # ranking until a pick earns them
    last_reason = "empty ranking"
    picks = []
    for pred in ranked[:max(validator_picks, 1)]:
        cand = pred.candidate
        print(f"autotune: validating fanouts={cand.fanouts} "
              f"rows={cand.cache_rows} l1={cand.l1_rows} "
              f"assoc={cand.assoc} hit_cap={cand.hit_cap} "
              f"slack={cand.capacity_slack} "
              f"(predicted {pred.step_time_s * 1e3:.1f} ms/step)")
        cand_tc = tc._replace(
            fanouts=cand.fanouts, cache_rows=cand.cache_rows,
            l1_rows=cand.l1_rows, assoc=cand.assoc, hit_cap=cand.hit_cap,
            capacity_slack=cand.capacity_slack)
        cand_cfg = (candidate_cache_cfg(cache_cfg, cand)
                    if cand_tc.mode is not None else cache_cfg)
        vtrace = _instrumented_run(device, part, feats, labels, cand_tc,
                                   cand_cfg,
                                   probes_for(cand.fanouts, validator_probes))
        vwarm = vtrace.warm_records() or vtrace.records
        dropped = sum(r.n_dropped for r in vtrace.records)
        demoted = sum(r.n_probe_demoted for r in vtrace.records)
        measured = sum(r.wall_time_s for r in vwarm) / len(vwarm)
        bound = validator_ratio * max(pred.step_time_s, model.wall_mean_s)
        ok = not dropped and not demoted and measured <= bound
        picks.append(ValidatedPick(pred, measured, dropped, demoted, ok))
        print(f"autotune: measured {measured * 1e3:.1f} ms/step warm "
              f"(bound {bound * 1e3:.1f})")
        if ok:
            return AutotuneResult(True, "accepted", candidate=cand,
                                  prediction=pred, trace=trace,
                                  measured_step_s=measured,
                                  picks=tuple(picks),
                                  n_searched=len(ranked))
        last_reason = (
            f"dropped={dropped} demoted={demoted} "
            f"measured={measured * 1e3:.1f} ms > bound "
            f"{bound * 1e3:.1f} ms" if measured > bound else
            f"dropped={dropped} demoted={demoted}")
        print(f"autotune: validator rejected the pick ({last_reason})")
    return AutotuneResult(
        False,
        f"validator rejected {min(max(validator_picks, 1), len(ranked))} "
        f"ranked pick(s); last: {last_reason}",
        candidate=best.candidate, prediction=best, trace=trace,
        measured_step_s=measured, picks=tuple(picks),
        n_searched=len(ranked))
