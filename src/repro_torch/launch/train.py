"""Training driver of the port (``repro/launch/train.py``): ``train_gcn``
for the GCN archs and ``train_lm`` for the LM families.

Synthetic power-law graph -> edge partition -> balance table ->
synchronized subgraph generation + in-memory GCN training (the GraphGen+
pipeline) over ``--workers W`` workers.  ``--dist none`` (the default)
runs them on the stacked worker axis of one process; ``--dist gloo`` or
``nccl`` runs one process per worker (``launch/mesh.py``): this command
spawns the ``W`` ranks itself, or joins a group ``torchrun`` set up
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``).  Every rank builds the
graph and tables on the host from the seed and places only its own
shard; its loss is the mean over its own seeds, and the gradients are
averaged over the ranks (``--grad-sync psum|tree``,
``train/train_loop.py``) before AdamW's global-norm clip.  On the stacked
worker axis ``--per-worker-loss`` does the same arithmetic in one
process: each worker's mean loss differentiated on its own rows, the
gradients averaged by the stacked group's sync.  Every value a
rank branches on (the ladders' drop and demotion counts, the warm miss
peak, the rollback checks, the logged totals) is reduced over the group
first, so every rank picks the stacked run's rungs; rank 0 alone logs
and writes checkpoints.  Every path runs on either backend: the tiered
cache, ``--feature-store host`` (each rank gathers its own staged misses
from its own copy of the host table), ``--export-serve`` (rank 0 gathers
every rank's cache shard and writes the stacked layout), ``--offline``
and ``--autotune`` (every rank traces its own worker; the trace is
reduced over the group, so every rank searches the stacked run's trace
and picks alike).
``--report DIR`` writes each rank's (or the stacked run's) losses,
parameters, Adam moments, chosen rungs, first rounds' batch digests and
stats, kernel launches, step times, collective counters, the L3 store's
telemetry and the autotuner's trace and ranking to ``DIR``.
Before the loop the drop-aware
capacity ladder and the compact-wire hit-cap ladder calibrate the
exchange buffers (each rung from a cold cache), and ``--warm-recalibrate
N`` shrinks the owner exchange to the warm miss peak after ``N`` steps,
rolling back to the calibrated width if a shrunken batch drops requests.
On a card the cache probes, the GCN aggregation and its gradient run the
port's CUDA kernels.

``--feature-store host`` keeps the feature table in host RAM behind the
L3 store (``core/host_store.py``): both ladders are skipped (slack 2.0:
misses stage to the store, not the owner exchange) and the loop runs the
split dispatch, with the gather overlapped (``--host-gather-depth 2``)
or blocking (``1``).  ``--ckpt-dir``/``--ckpt-every`` checkpoint
``(params, opt_state)`` in the reference's layout, ``--resume`` restarts
from the latest one (batch ``start``'s seeds and draws first, a cold
cache), and ``--export-serve DIR`` saves the trained params and the warm
cache for ``repro_torch.launch.serve --warm-from DIR``.  ``offline_gcn``
(``--offline``) runs the same setup through the GraphGen baseline
(``offline_loop``).

``--autotune`` (``--autotune-steps N``, default 8) replaces the ladders
with one instrumented trace window, an offline search against a cost
model fit from it, and a live validation of the best picks
(``launch/autotune.py``); a rejected or unfit trace falls back to the
ladders with a warning.  The validator sees a few rounds only, so a
trained batch that an accepted pick's exchange drops requests from is
regenerated at the traced slack, which the run then keeps.

``train_lm`` (every LM arch the port serves: dense, MoE, VLM, Whisper,
SSM and hybrid) trains on the reference's synthetic batches
(``np.random.default_rng(--seed)``, ``--lm-batch`` x ``--lm-seq`` tokens,
labels the tokens rolled left by one, then the VLM's vision or Whisper's
frame embeddings as float32 normals from the same generator) through
``train/train_loop.py``'s step, with ``--microbatches``; it checkpoints
the ``TrainState`` in the reference's layout (stacked layers) and ``--resume`` restores one written by either
package.  ``--dist gloo|nccl --workers W --model-axis M`` trains over a
``(W / M, M)`` process mesh, rank ``r`` at ``(r // M, r % M)``: the
reference's sharded step (its dry-run's ``train`` program), with FSDP
over ``data``, the batch split over ``data``, and the model axis's
switches of the dry-run, ``--moe gather|ep_a2a``, ``--shard-heads``,
``--seq-parallel``, ``--attn naive|chunked``, ``--remat
keep|none|full|dots`` and ``--compress`` (``train/fsdp.py``); rank 0
logs and writes whole checkpoints, every rank restores its slice.
``--device`` is the one flag the reference lacks.

Examples::

    python -m repro_torch.launch.train --arch graphgen-gcn-deep
    python -m repro_torch.launch.train --arch graphgen-gcn --workers 4
    python -m repro_torch.launch.train --arch graphgen-gcn --workers 4 \
        --dist gloo
    python -m repro_torch.launch.train --arch graphgen-gcn-deep --smoke \\
        --device cpu --nodes 2000 --steps 6 --feature-store host
    python -m repro_torch.launch.train --arch smollm-135m --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \\
        --device cpu --dist gloo --workers 4 --model-axis 2 \\
        --moe ep_a2a --shard-heads --seq-parallel --remat full --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core.balance import balance_table
from ..core.collectives import ProcessWorkers, StackedGroup, WorkerGroup
from ..core.config import TrainConfig, resolve_device
from ..convert import (adam_state_from_numpy, adam_state_to_numpy,
                       gcn_params_from_numpy, gcn_params_to_numpy, lm_leaves)
from ..core.feature_cache import (CacheConfig, init_cache_state, map_state,
                                  state_leaves)
from ..core.generation import (SeededDraws, make_distributed_generator,
                               make_generator_fn, probe_round_capacity)
from ..core.partition import partition_edges
from ..core.pipeline import offline_loop, pipelined_loop
from ..graph.subgraph import slots_per_seed
from ..graph.synthetic import node_features, node_labels, powerlaw_graph
from ..kernels import ops
from ..models import zoo
from ..models.gcn import gcn_loss, init_gcn
from ..train import checkpoint as ckpt
from ..train.fsdp import ShardPlan
from ..train.optimizer import adam_update, init_adam
from ..train.train_loop import (init_state, make_grad_sync, make_step_sync,
                                make_train_step, module_loss)
from . import mesh

#: ascending slack ladder probed by the drop-aware capacity calibration
SLACK_LADDER = (0.25, 0.5, 1.0, 1.5, 2.0)
#: calibration batches per rung
CALIBRATION_PROBES = 3
#: ascending hit-cap ladder (fractions of the probe-round capacity)
HIT_CAP_LADDER = (0.125, 0.25, 0.5)
#: generation rounds whose batches and stats ``--report`` records
REPORT_ROUNDS = 3


def make_gcn_train_fn(tcfg: TrainConfig, group: WorkerGroup = None,
                      per_worker: bool = False):
    """``train_fn(model, opt_state, batch) -> (model, opt_state, loss)``:
    the GCN loss, its gradient with respect to every parameter (in
    ``GCN.leaves()`` order, the optimizer state's), and one
    ``adam_update``, written back into the model's parameters in place.

    On a process ``group`` (one worker per process) the batch is the
    rank's own seeds: the gradients and the loss are averaged over the
    ranks (``tcfg.grad_sync``) before ``adam_update`` clips the global
    gradient, and the loss returned is the global mean.  ``per_worker``
    on the stacked ``group`` does the same in one process: worker ``w``'s
    mean loss is differentiated on a copy of its rows alone, and the
    ``[W, ...]`` gradients and losses are averaged by the stacked group's
    sync (a ``--dist`` run's arithmetic; the default differentiates the
    global mean in one pass)."""
    sync = split = None
    if group is not None and group.local < group.world:
        sync = make_step_sync(group, tcfg.grad_sync)
    elif per_worker:
        if group is None:
            raise ValueError("per_worker needs the stacked group")
        split = make_grad_sync(group, tcfg.grad_sync)

    def per_worker_grads(model, params, batch):
        b = batch.batch_size // group.world
        flats = []
        for w in range(group.world):
            loss = gcn_loss(model, _worker_rows(batch, w * b, b))
            flats.append(torch.cat(
                [g.reshape(-1) for g in torch.autograd.grad(loss, params)]
                + [loss.detach().reshape(1)]))
        out = split([torch.stack(flats)])[0][0]
        parts = torch.split(out, [p.numel() for p in params] + [1])
        return ([q.reshape(p.shape) for q, p in zip(parts, params)],
                parts[-1][0])

    def train_fn(model, opt_state, batch):
        params = model.leaves()
        if split is not None:
            grads, loss = per_worker_grads(model, params, batch)
        else:
            loss = gcn_loss(model, batch)
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
        if sync is not None:
            grads, loss = sync(grads, loss)
        new, opt_state, _ = adam_update(tcfg, params, grads, opt_state)
        with torch.no_grad():
            for p, n in zip(params, new):
                p.copy_(n)
        return model, opt_state, loss
    return train_fn


def _worker_rows(batch, start: int, n: int):
    """Seed rows ``start .. start + n`` of ``batch`` with their hops,
    masks, features and labels, each copied into its own allocation (the
    layout a rank's batch has)."""
    def rows(a):
        return a.narrow(0, start, n).clone()
    return batch._replace(
        seeds=rows(batch.seeds), x_seed=rows(batch.x_seed),
        labels=rows(batch.labels),
        **{k: tuple(rows(a) for a in getattr(batch, k))
           for k in ("hops", "masks", "x_hops")})


def _group_of(device_args, group):
    """``group``, or the stacked group of the placed arrays."""
    if group is not None:
        return group
    return StackedGroup(device_args[0].shape[0], device_args[0].device)


def group_total(group: WorkerGroup, counts: torch.Tensor,
                op: str = "sum") -> int:
    """A per-worker ``[L]`` counter reduced over every worker of the group
    (``op`` "sum" or "max"): the value every rank branches on."""
    return int(group.all_reduce(counts, op)[0])


def group_hit_rate(group: WorkerGroup, batch) -> float:
    """``SubgraphBatch.cache_hit_rate`` over every worker of the group."""
    hits = float(group_total(group, batch.n_cache_hits))
    total = hits + float(group_total(group, batch.n_cache_misses))
    return hits / total if total else 0.0


def _say(group: WorkerGroup, msg: str) -> None:
    """Print on the process that holds worker 0 only."""
    if group.lead:
        print(msg)


def calibrate_capacity_slack(device_args, fanouts, probes,
                             ladder=SLACK_LADDER, cache_cfg=None,
                             group: WorkerGroup = None) -> float:
    """Drop-aware capacity calibration: the smallest slack of ``ladder``
    whose batches drop no request over every probe ``(seeds, draws)``.
    With ``cache_cfg`` the ladder probes the cached generator, each rung
    from a cold cache (the cold-start miss burst is the heaviest owner
    traffic), the cache threading across a rung's probes.  The drops are
    counted over every worker of ``group`` (default: the stacked group of
    ``device_args``)."""
    group = _group_of(device_args, group)
    held = device_args[0].shape[0]
    feat_dim = device_args[2].shape[-1]
    dev = device_args[0].device
    cached = cache_cfg is not None and cache_cfg.n_rows > 0
    with torch.no_grad():
        for slack in ladder:
            gen_fn = make_generator_fn(fanouts=fanouts, capacity_slack=slack,
                                       cache_cfg=cache_cfg if cached else None,
                                       group=group)
            if cached:
                cache = init_cache_state(cache_cfg, feat_dim, held,
                                         device=dev)
            dropped = 0
            for seeds, draws in probes:
                if cached:
                    batch, cache = gen_fn(device_args, seeds, draws, cache)
                else:
                    batch = gen_fn(device_args, seeds, draws)
                dropped += group_total(group, batch.n_dropped)
            if dropped == 0:
                return slack
            _say(group, f"calibration: slack={slack} dropped {dropped} "
                        f"requests over {len(probes)} probes")
    _say(group, f"calibration: even slack={ladder[-1]} drops requests; "
                f"keeping it")
    return ladder[-1]


def calibrate_probe_hit_cap(device_args, fanouts, probes, slack, cache_cfg,
                            ladder=HIT_CAP_LADDER,
                            group: WorkerGroup = None) -> CacheConfig:
    """Compact-wire hit-cap calibration: the ``CacheConfig`` of the
    smallest rung (a fraction of the probe-round capacity) whose probes
    demote no hit, each rung from a cold cache; the dense wire when every
    rung demotes.  Demotions are counted over every worker of ``group``."""
    group = _group_of(device_args, group)
    held = device_args[0].shape[0]
    feat_dim = device_args[2].shape[-1]
    dev = device_args[0].device
    b = probes[0][0].shape[1]
    cap = probe_round_capacity(b * slots_per_seed(fanouts), group.world,
                               slack)
    with torch.no_grad():
        for frac in ladder:
            hc = max(int(cap * frac), 1)
            cfg = cache_cfg._replace(wire="compact", hit_cap=hc)
            gen_fn = make_generator_fn(fanouts=fanouts, capacity_slack=slack,
                                       cache_cfg=cfg, group=group)
            cache = init_cache_state(cfg, feat_dim, held, device=dev)
            demoted = 0
            for seeds, draws in probes:
                batch, cache = gen_fn(device_args, seeds, draws, cache)
                demoted += group_total(group, batch.n_probe_demoted)
            if demoted == 0:
                _say(group, f"probe hit-cap auto-sized to {hc} "
                            f"rows/destination ({frac:.0%} of the {cap}-slot "
                            f"probe round; override with --probe-hit-cap)")
                return cfg
            _say(group, f"hit-cap calibration: hit_cap={hc} demoted "
                        f"{demoted} hits over {len(probes)} probes")
    _say(group, f"hit-cap calibration: even {ladder[-1]:.0%} of the probe "
                f"round demotes hits; falling back to the dense wire")
    return cache_cfg._replace(wire="dense", hit_cap=0)


def warm_capacity(miss_peak: int, w: int, slack: float, rows: int,
                  margin: int = 8) -> int:
    """Steady-state owner-exchange capacity from the warm per-worker miss
    peak: ``ceil(peak / w) * max(slack, 2) + margin``, clamped to
    ``[1, rows]``."""
    cap = int(-(-miss_peak // max(w, 1)) * max(slack, 2.0)) + margin
    return max(min(cap, rows), 1)


def _model_config(args):
    """The arch's config with the command line's overrides applied."""
    cfg = get_config(args.arch)
    if args.fanouts:
        try:
            fo = tuple(int(k) for k in args.fanouts.split(","))
        except ValueError:
            raise SystemExit(
                f"--fanouts expects comma-separated ints (e.g. 15,10,5), "
                f"got {args.fanouts!r}")
        if not fo or any(k < 1 for k in fo):
            raise SystemExit(f"--fanouts entries must be >= 1, got {fo}")
        cfg = dataclasses.replace(cfg, fanouts=fo)
    for flag, field in (("cache_rows", "cache_rows"),
                        ("cache_admit", "cache_admit"),
                        ("cache_assoc", "cache_assoc"),
                        ("cache_mode", "cache_mode"),
                        ("l1_rows", "cache_l1_rows"),
                        ("l1_promote", "cache_l1_promote"),
                        ("probe_wire", "cache_wire"),
                        ("probe_hit_cap", "cache_hit_cap"),
                        ("feature_store", "feature_store"),
                        ("host_gather_depth", "host_gather_depth")):
        if getattr(args, flag) is not None:
            cfg = dataclasses.replace(cfg, **{field: getattr(args, flag)})
    if args.smoke:
        cfg = smoke_config(cfg)
    return cfg


def build_gcn_run(args, group: WorkerGroup = None) -> dict:
    """Everything ``train_gcn`` sets up before its loop, from ``args``:
    the graph and tables, the calibrated (or autotuned) slack and cache
    policy, the ``AutotuneResult`` (None without ``--autotune``), the
    generator (``gen_fn``, ``device_args``, the L3 ``store`` in host mode
    or None, the empty ``cache`` or None), the model at its seeded init,
    the AdamW ``train_fn``, ``seeds_np(t)`` (every worker's ``[W, b]``
    seeds of batch ``t``), ``seeds_for(t)`` and ``draws(t, L, b)`` (the
    held workers' rows) and the worker ``group`` (default: the stacked
    group of ``--workers``)."""
    w = args.workers
    if group is None:
        group = mesh.make_local_group(w, args.device)
    elif group.world != w:
        raise ValueError(f"--workers {w}, but the group has {group.world}")
    dev = group.device
    cfg = _model_config(args)
    fanouts = cfg.fanouts
    host = cfg.feature_store == "host"
    if host and args.warm_recalibrate:
        raise SystemExit("--warm-recalibrate shrinks the owner-exchange "
                         "buffers, which --feature-store host replaces "
                         "with the L3 staging path — drop the flag")
    cache_cfg = CacheConfig.from_model(cfg)
    cached = cache_cfg is not None

    graph = powerlaw_graph(args.nodes, avg_degree=args.avg_degree,
                           n_hot=max(args.nodes // 1000, 1), seed=args.seed)
    part = partition_edges(graph, w)
    feats = node_features(graph.n_nodes, cfg.gcn_in_dim, args.seed,
                          features_on_host=host)
    labels = node_labels(graph.n_nodes, cfg.n_classes, args.seed)
    table = balance_table(np.arange(graph.n_nodes), w, args.seed)

    b = args.batch_per_worker

    def seeds_np(t):
        sw = table.per_worker
        return sw[:, (np.arange(b) + t * b) % sw.shape[1]]

    def seeds_for(t):
        return torch.from_numpy(
            np.ascontiguousarray(group.block(seeds_np(t)))).to(dev)

    res = autotuned = None
    if args.autotune:
        # one trace and an offline search replace the ladders; they stay
        # as the fallback when the validator rejects the pick
        from .autotune import autotune_gcn, candidate_cache_cfg
        res = autotune_gcn(
            dev, part, feats, labels, fanouts=fanouts, cache_cfg=cache_cfg,
            feature_store=cfg.feature_store, batch_per_worker=b,
            seeds_for=seeds_for,
            draws_for=lambda fo: SeededDraws(fo, args.seed + 2, dev,
                                             group=group),
            steps=args.autotune_steps,
            slack=(args.capacity_slack or cfg.capacity_slack or 2.0),
            group=group)
        if res.accepted:
            autotuned = res
            cfg = cfg.with_candidate(res.candidate)
            fanouts = cfg.fanouts
            if cached:
                cache_cfg = candidate_cache_cfg(cache_cfg, res.candidate)
            _say(group, f"autotune: accepted (measured "
                        f"{res.measured_step_s * 1e3:.1f} ms/step warm)")
        else:
            _say(group, f"autotune: WARNING — falling back to the "
                        f"calibration ladders ({res.reason})")
    # the training draws follow the final fanouts
    draws = SeededDraws(fanouts, args.seed + 1, dev, group=group)

    ladders = []
    store = cache = None
    if host:
        # the L3 staging path replaces the owner exchange, and its default
        # staging size never drops: no ladder probes a generator this run
        # does not build
        if args.capacity_slack is not None:
            slack = args.capacity_slack
        elif cfg.capacity_slack is not None:
            slack = cfg.capacity_slack
        else:
            slack = 2.0
        if w > 1 and args.capacity_slack is None \
                and cfg.capacity_slack is None:
            _say(group, "capacity_slack fixed at 2.0 (--feature-store host "
                        "skips the drop-aware ladder: misses stage to the "
                        "L3 store instead of the owner exchange)")
        # every rank keeps its own store on the whole host table and
        # gathers only its own row's staged misses
        gen_fn, device_args, store, *c0 = make_distributed_generator(
            part, feats, labels, fanouts=fanouts, capacity_slack=slack,
            cache_cfg=cache_cfg, feature_store="host",
            host_gather_depth=cfg.host_gather_depth,
            collect_stats=bool(args.report), group=group)
        cache = c0[0] if cached else None
        depth = cfg.host_gather_depth
        _say(group, f"L3 host feature store: {feats.shape[0]}x"
                    f"{feats.shape[1]} f32 table ({feats.nbytes / 1e6:.1f} "
                    f"MB) in host RAM, gather depth {depth} "
                    f"({'overlapped' if depth == 2 else 'synchronous'})")
    else:
        # the compact probe wire needs a hit_cap: calibrate one unless the
        # config pins it or --probe-hit-cap was given (replicated mode
        # and W == 1 run no probe round)
        need_hit_cap = (cached and w > 1 and cache_cfg.mode != "replicated"
                        and cache_cfg.wire == "compact"
                        and cache_cfg.hit_cap == 0
                        and args.probe_hit_cap is None
                        and autotuned is None)
        # the graph and the tables are placed once; every rung of both
        # ladders runs against the same placement
        _, device_args = make_distributed_generator(
            part, feats, labels, fanouts=fanouts, device=dev, group=group)
        probes = [(seeds_for(t), draws(t, group.local, b))
                  for t in range(CALIBRATION_PROBES)]
        if args.capacity_slack is not None:
            slack = args.capacity_slack
        elif cfg.capacity_slack is not None:
            slack = cfg.capacity_slack   # pinned, or the autotuned pick
        elif w == 1:
            slack = 2.0      # the W = 1 fetch is a local gather
        else:
            # the cached generator, a cold cache per rung
            slack = calibrate_capacity_slack(device_args, fanouts, probes,
                                             cache_cfg=cache_cfg, group=group)
            ladders.append("slack")
            _say(group, f"capacity_slack auto-sized to {slack} "
                        f"(override with --capacity-slack)")
        if need_hit_cap:
            cache_cfg = calibrate_probe_hit_cap(device_args, fanouts, probes,
                                                slack, cache_cfg, group=group)
            ladders.append("hit_cap")
        del probes
        gen_fn = make_generator_fn(fanouts=fanouts, capacity_slack=slack,
                                   cache_cfg=cache_cfg, group=group,
                                   collect_stats=bool(args.report))
        if cached:
            cache = init_cache_state(cache_cfg, cfg.gcn_in_dim, group.local,
                                     device=dev)
    if cached:
        line = (f"hot-node cache: {cache_cfg.n_rows} rows/worker "
                f"({cache_cfg.assoc}-way, {cache_cfg.mode}), "
                f"admit-after-{cache_cfg.admit}")
        if cache_cfg.mode == "tiered":
            line += (f" + {cache_cfg.l1_rows}-row replicated L1 "
                     f"(promote-after-{cache_cfg.l1_promote})")
        if cache_cfg.mode != "replicated" and w > 1:
            line += f", {cache_cfg.wire} probe wire"
            if cache_cfg.wire == "compact" and cache_cfg.hit_cap:
                line += f" (hit_cap {cache_cfg.hit_cap})"
        _say(group, line)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       checkpoint_every=args.ckpt_every,
                       grad_sync=args.grad_sync)
    return {"dev": dev, "w": w, "b": b, "cfg": cfg, "cache_cfg": cache_cfg,
            "slack": slack, "ladders": ladders, "autotune": res,
            "gen_fn": gen_fn, "group": group,
            "device_args": device_args, "store": store, "cache": cache,
            "model": init_gcn(cfg, args.seed, device=dev),
            "train_fn": make_gcn_train_fn(tcfg, group,
                                          args.per_worker_loss),
            "tcfg": tcfg,
            "seeds_np": seeds_np, "seeds_for": seeds_for, "draws": draws,
            "table_bytes": feats.nbytes}


def _store_stats(run: dict) -> dict:
    """The L3 store's telemetry of a run (empty for the device store):
    bytes shipped and rows gathered summed over the group, and this
    process's own (``rank_*``)."""
    store = run["store"]
    if store is None:
        return {}
    group = run["group"]
    mine = torch.tensor([[store.bytes_issued, store.rows_issued]],
                        dtype=torch.int64, device=group.device)
    if group.local < group.world:
        total = group.all_reduce(mine)[0].tolist()
    else:
        total = mine[0].tolist()
    return {"host_gather_bytes": total[0], "n_l3_hits": total[1],
            "rank_host_gather_bytes": store.bytes_issued,
            "rank_n_l3_hits": store.rows_issued,
            "table_bytes": run["table_bytes"], "depth": store.depth}


class _RoundRecorder:
    """``--report``'s view of the training generator (built with
    ``collect_stats``): passes each round's return on without its stats
    tail, and keeps the first ``REPORT_ROUNDS`` rounds' batch (with the
    host store: before its L3 rows are patched in), ``FetchStats``,
    ``CacheStats`` and cache state, in call order."""

    def __init__(self, gen_fn, cached: bool):
        self.gen_fn, self.cached, self.rounds = gen_fn, cached, []

    def __call__(self, *args):
        *out, (fstats, cstats) = self.gen_fn(*args)
        cache = out[1] if self.cached else None
        if len(self.rounds) < REPORT_ROUNDS:
            self.rounds.append((out[0], fstats, cstats, cache))
        return tuple(out) if len(out) > 1 else out[0]


def _digest(t: torch.Tensor) -> str:
    """Short sha256 of a tensor's bytes (its bit pattern)."""
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:20]


def cache_digests(group: WorkerGroup, cache) -> dict:
    """Digests of every held worker's cache block (flat or tiered), keyed
    by the global worker index."""
    leaves = list(state_leaves(cache))
    return {str(group.rank + i): {n: _digest(a[i]) for n, a in leaves}
            for i in range(group.local)}


def _round_report(group: WorkerGroup, b: int, batch, fstats, cstats,
                  cache) -> dict:
    """One recorded round, per held worker ``j`` (global index): digests
    of its batch block and cache state, and its stats counters."""
    out = {"batch": {}, "cache": {}, "stats": {}}
    fields = [("seeds", batch.seeds), ("x_seed", batch.x_seed),
              ("labels", batch.labels)]
    for name in ("hops", "masks", "x_hops"):
        fields += [(f"{name}{l}", a)
                   for l, a in enumerate(getattr(batch, name))]
    for i in range(group.local):
        j = group.rank + i
        out["batch"][str(j)] = {n: _digest(a[i * b:(i + 1) * b])
                                for n, a in fields}
    if cache is not None:
        out["cache"] = cache_digests(group, cache)
    for name in ("n_dropped", "n_cache_hits", "n_cache_misses",
                 "n_probe_demoted"):
        out["stats"]["batch." + name] = getattr(batch, name).tolist()
    for prefix, st in (("fetch.", fstats), ("cache.", cstats)):
        for name, a in zip(st._fields, st):
            out["stats"][prefix + name] = a.tolist()
    return out


def _state_arrays(model, opt, suffix: str = "") -> dict:
    """Host copies of the parameters and Adam moments, ``p<i>``, ``m<i>``
    and ``v<i>`` in ``GCN.leaves()`` order (each name + ``suffix``)."""
    out = {}
    for i, p in enumerate(model.leaves()):
        out[f"p{i}{suffix}"] = p.detach().cpu().numpy().copy()
        out[f"m{i}{suffix}"] = opt.m[i].cpu().numpy().copy()
        out[f"v{i}{suffix}"] = opt.v[i].cpu().numpy().copy()
    return out


def _write_report(args, run: dict, res: dict, opt, recorder, step_s,
                  launches, first_state) -> None:
    """``--report DIR``: ``DIR/{rank<r>|stacked}.json`` (losses, rungs,
    the recorded rounds, launches, step times, collective counters) and
    ``.npz`` (losses, parameters, Adam moments and step, and the state
    after the run's first step as ``p<i>@1``, ...)."""
    group = run["group"]
    name = (f"rank{group.rank}" if isinstance(group, ProcessWorkers)
            else "stacked")
    os.makedirs(args.report, exist_ok=True)
    cache_cfg = run["cache_cfg"]
    meta = {
        "world": group.world, "rank": group.rank, "local": group.local,
        "backend": getattr(group, "backend", "stacked"),
        "staged": getattr(group, "staged", False),
        "device": str(group.device), "losses": res["losses"],
        "capacity_slack": run["slack"], "ladders": run["ladders"],
        "wire": cache_cfg.wire if cache_cfg is not None else None,
        "hit_cap": cache_cfg.hit_cap if cache_cfg is not None else None,
        "rounds": [_round_report(group, run["b"], *r)
                   for r in recorder.rounds] if recorder else [],
        "launches": launches, "step_s": step_s,
        "collectives": getattr(group, "stats", None),
        "store": {k: res[k] for k in (
            "host_gather_bytes", "n_l3_hits", "rank_host_gather_bytes",
            "rank_n_l3_hits") if k in res},
        "autotune": autotune_report(run["autotune"]),
        "n_dropped": res["n_dropped"]}
    with open(os.path.join(args.report, name + ".json"), "w") as f:
        json.dump(meta, f)
    arrays = {"losses": np.asarray(res["losses"], np.float64),
              "step": opt.step.cpu().numpy(),
              **_state_arrays(res["model"], opt), **first_state}
    np.savez(os.path.join(args.report, name + ".npz"), **arrays)


def autotune_report(res) -> dict:
    """``--report``'s record of an ``AutotuneResult`` (None without
    ``--autotune``): the trace's records (``wall_time_s`` apart, which is
    the host clock's), the ranking's candidates and costs, and the
    validator's verdicts."""
    if res is None:
        return None
    return {"accepted": res.accepted, "reason": res.reason,
            "candidate": list(res.candidate) if res.candidate else None,
            "records": [{k: v for k, v in r._asdict().items()
                         if k != "wall_time_s"} for r in res.trace.records],
            "wall_time_s": [r.wall_time_s for r in res.trace.records],
            "ranking": [[list(p.candidate), p.cost_s] for p in res.ranking],
            "picks": [{"candidate": list(p.prediction.candidate),
                       "predicted_ms": p.prediction.step_time_s * 1e3,
                       "measured_ms": p.measured_step_s * 1e3,
                       "n_dropped": p.n_dropped, "n_demoted": p.n_demoted,
                       "accepted": p.accepted} for p in res.picks]}


def gather_state(group: WorkerGroup, cache):
    """Every worker's cache state (``[W, ...]`` leaves) on every rank:
    one ``all_gather`` per leaf on a process group, the state itself on
    the stacked one."""
    if group.local == group.world:
        return cache
    return map_state(lambda a: group.all_gather(a[None])[0], cache)


def _check_replicas(group: WorkerGroup, model) -> None:
    """Raise unless every rank holds the same parameters (bit for bit)."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.leaves()])
    every = group.all_gather(flat[None])[0].reshape(group.world, -1)
    if not all(torch.equal(every[r], flat) for r in range(group.world)):
        raise RuntimeError("the ranks' initial parameters differ: every "
                           "rank must build the model from the same seed")


def train_gcn(args, step_hook=None, group: WorkerGroup = None) -> dict:
    """Train a GCN arch for ``args.steps`` pipelined steps; returns the
    losses, the padded nodes per iteration, the wall time, the slack, the
    calibration ladders that ran, the requests dropped by the trained
    batches, the final cache hit rate, the L3 store's telemetry in host
    mode, and the trained model, the cache state and the last batch.
    ``step_hook(t)``, when given, runs after step ``t``'s loss has
    reached the host (a profiler's step marker).

    ``group`` is the worker group: the stacked group of ``--workers``
    when None (``--dist none``), or the rank's ``ProcessWorkers``
    (``main`` joins it for ``--dist gloo|nccl``).  On a process group the
    losses, the dropped count and the hit rate are every worker's, the
    model and cache the rank's own."""
    if group is None and args.dist != "none":
        raise ValueError(f"--dist {args.dist} runs one process per worker: "
                         f"start it through main(), which launches or joins "
                         f"the ranks, or pass their group")
    run = build_gcn_run(args, group)
    group = run["group"]
    dev, w, b = run["dev"], run["w"], run["b"]
    cache_cfg, slack = run["cache_cfg"], run["slack"]
    cached = cache_cfg is not None
    device_args, draws, seeds_for = (run["device_args"], run["draws"],
                                     run["seeds_for"])
    model = run["model"]
    if isinstance(group, ProcessWorkers):
        _check_replicas(group, model)
    opt = init_adam(model.leaves())
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        start = ckpt.latest_step(args.ckpt_dir)
        params_np, opt_np = ckpt.restore(
            args.ckpt_dir, start,
            (gcn_params_to_numpy(model), adam_state_to_numpy(opt)))
        model = gcn_params_from_numpy(params_np, device=dev)
        opt = adam_state_from_numpy(opt_np, device=dev)
        _say(group, f"resumed from step {start}")

    losses = []
    final = {"batch": None}     # the last trained batch
    n_dropped = 0
    miss_peak = 0
    wide_gen = None   # pre-recalibration generator, kept for rollback
    # the autotuner's validator measured its pick on a few rounds only: a
    # trained batch whose exchange that pick drops requests from is
    # regenerated at the traced slack, which the run then keeps
    # (zero-filled features must never train)
    tuned = run["autotune"]
    traced_gen = None
    autotune_rollback = None
    if (tuned is not None and tuned.accepted and run["store"] is None
            and w > 1):
        traced_gen = make_generator_fn(
            fanouts=run["cfg"].fanouts,
            capacity_slack=tuned.trace.config.capacity_slack,
            cache_cfg=cache_cfg, group=group)
    # only the second half of the warm window counts toward the miss peak
    warm_from = start + max(args.warm_recalibrate // 2, 1)
    recorder = None
    first_state = {}
    gen_fn = run["gen_fn"]
    if args.report:
        recorder = gen_fn = _RoundRecorder(gen_fn, cached)
    step_s = []
    t0 = t_step = time.perf_counter()

    def regenerate(gen, t, carry):
        """Batch ``t`` generated again by ``gen`` into the carry."""
        with torch.no_grad():
            if cached:
                batch, cache_now = gen(device_args, seeds_for(t),
                                       draws(t, group.local, b), carry[3])
                return (carry[0], carry[1], batch, cache_now)
            return (carry[0], carry[1],
                    gen(device_args, seeds_for(t), draws(t, group.local, b)))

    def before_step(i, carry, gen_fn):
        nonlocal miss_peak, wide_gen, traced_gen, autotune_rollback
        nonlocal n_dropped, t0
        t = start + i
        if i == 0:
            t0 = time.perf_counter()   # batch `start` is generated
        if cached and args.warm_recalibrate and t >= warm_from:
            miss_peak = max(miss_peak, group_total(
                group, carry[2].n_cache_misses, "max"))
        # every rank rolls back together: the drops are the group's
        if traced_gen is not None and group_total(group,
                                                  carry[2].n_dropped) > 0:
            gen_fn, traced_gen = traced_gen, None
            carry = regenerate(gen_fn, t, carry)
            autotune_rollback = t
            _say(group, f"step {t}: the autotuned exchange dropped "
                        f"requests — regenerated the batch at the traced "
                        f"slack {tuned.trace.config.capacity_slack} and "
                        f"kept it")
        # rollback check first: carry[2] was generated by the shrunken
        # generator only once the shrink below has been installed
        if wide_gen is not None and group_total(group,
                                                carry[2].n_dropped) > 0:
            gen_fn, wide_gen = wide_gen, None
            carry = regenerate(gen_fn, t, carry)
            _say(group, f"step {t}: shrunken capacity dropped requests — "
                        f"regenerated the batch and rolled back to the "
                        f"calibrated width")
        if (args.warm_recalibrate and cached and w > 1
                and t == start + args.warm_recalibrate
                and t + 1 < args.steps):
            rows_pw = device_args[2].shape[1]
            new_cap = warm_capacity(miss_peak, w, slack, rows_pw)
            wide_gen = gen_fn
            gen_fn = make_generator_fn(fanouts=run["cfg"].fanouts,
                                       capacity_slack=slack,
                                       cache_cfg=cache_cfg,
                                       fetch_capacity=new_cap, group=group)
            _say(group, f"warm re-calibration at step {t}: owner-exchange "
                        f"capacity -> {new_cap} slots/destination "
                        f"(peak warm per-worker misses {miss_peak})")
        n_dropped += group_total(group, carry[2].n_dropped)
        return carry, gen_fn

    def after_step(i, carry, loss):
        nonlocal t_step
        t = start + i
        losses.append(float(loss))
        now = time.perf_counter()
        step_s.append(now - t_step)
        t_step = now
        if step_hook is not None:
            step_hook(i)
        if args.report and i == 0:
            first_state.update(_state_arrays(carry[0], carry[1], "@1"))
        if (t + 1) % args.ckpt_every == 0 and group.lead:
            ckpt.save(args.ckpt_dir, t + 1,
                      (gcn_params_to_numpy(carry[0]),
                       adam_state_to_numpy(carry[1])),
                      keep=run["tcfg"].keep_checkpoints)
        if (t + 1) % args.log_every == 0:
            # every rank takes part in the reductions; rank 0 prints
            line = f"step {t + 1}: loss={losses[-1]:.4f}"
            nb = carry[2]
            if cached:
                line += f" cache_hit_rate={group_hit_rate(group, nb):.3f}"
            dropped = group_total(group, nb.n_dropped)
            if dropped:
                line += f" DROPPED={dropped}"
            if cached:
                demoted = group_total(group, nb.n_probe_demoted)
                if demoted:
                    line += f" demoted={demoted}"
            _say(group, line)
        final["batch"] = carry[2]

    cache = run["cache"]
    launches0 = ops.launch_counts()
    if isinstance(group, ProcessWorkers):
        group.reset_stats()
    if start < args.steps:
        # batch t comes from seeds_np(t) and draws(t): a resumed run
        # primes the pipeline at `start`
        schedule = np.stack([group.block(run["seeds_np"](t))
                             for t in range(start, args.steps)])
        t_step = time.perf_counter()
        model, opt, _, *rest = pipelined_loop(
            gen_fn, run["train_fn"], device_args, schedule, model,
            opt, lambda i, *a: draws(start + i, *a), cache=cache,
            before_step=before_step, after_step=after_step,
            host_store=run["store"])
        if cached:
            cache = rest[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    if args.export_serve:
        if not cached:
            raise SystemExit("--export-serve checkpoints params + the warm "
                             "cache state; this run has no cache "
                             "(--cache-rows 0)")
        # the stacked layout: the parameters once, every worker's cache
        full = gather_state(group, cache)
        if group.lead:
            ckpt.save_serving_state(args.export_serve, args.steps, model,
                                    full, cache_cfg=cache_cfg)
            print(f"exported serving state (params + warm cache) to "
                  f"{args.export_serve}")
        # no rank goes on (to a --warm-from server, say) before the file
        # is written
        group.all_reduce(torch.zeros(group.local, 1, dtype=torch.int32,
                                     device=dev))
    n_run = args.steps - start
    nodes_per_iter = (b * w * slots_per_seed(run["cfg"].fanouts))
    out = {"losses": losses, "nodes_per_iter": nodes_per_iter, "wall_s": dt,
           "capacity_slack": slack, "ladders": run["ladders"],
           "n_dropped": n_dropped, "cache_cfg": cache_cfg,
           "fanouts": run["cfg"].fanouts, "autotune": run["autotune"],
           "autotune_rollback": autotune_rollback,
           "model": model, "opt": opt, "step_s": step_s,
           "launches": launches,
           "cache": cache, "batch": final["batch"], "start": start,
           **_store_stats(run)}
    if run["store"] is not None:
        _say(group, f"L3 host gathers shipped "
                    f"{out['host_gather_bytes'] / 1e6:.1f} MB "
                    f"({out['n_l3_hits']} rows)")
    _say(group, f"trained {n_run} steps in {dt:.1f}s "
                f"({nodes_per_iter} padded nodes/iter, "
                f"{n_run * nodes_per_iter / max(dt, 1e-9):,.0f} nodes/s)")
    if cached and final["batch"] is not None:
        out["cache_hit_rate"] = group_hit_rate(group, final["batch"])
        _say(group, f"steady-state cache hit rate: "
                    f"{out['cache_hit_rate']:.3f}")
    if args.report:
        _write_report(args, run, out, opt, recorder, step_s, launches,
                      first_state)
    return out


def offline_gcn(args, group: WorkerGroup = None) -> dict:
    """The GraphGen baseline on ``train_gcn``'s setup: ``offline_loop``
    over the same seeds and draws for ``args.steps`` batches.  Returns the
    losses, ``t_gen`` and ``t_train`` (seconds; on a process group the
    max over the ranks), the trained model and the L3 store's telemetry
    in host mode.  ``group`` as in ``train_gcn``: on a process group each
    rank generates, stores and trains on its own worker's batches, the
    gradients averaged over the ranks.  ``--report DIR`` writes the
    losses and times to ``DIR/{rank<r>|stacked}.json``."""
    if group is None and args.dist != "none":
        raise ValueError(f"--dist {args.dist} runs one process per worker: "
                         f"start it through main(), which launches or joins "
                         f"the ranks, or pass their group")
    run = build_gcn_run(args, group)
    group = run["group"]
    model = run["model"]
    if isinstance(group, ProcessWorkers):
        _check_replicas(group, model)
    schedule = np.stack([group.block(run["seeds_np"](t))
                         for t in range(args.steps)])
    gen_fn = run["gen_fn"]
    if args.report:
        # the report's generator carries stats; the loop takes none
        gen_fn = _RoundRecorder(gen_fn, run["cache"] is not None)
    launches0 = ops.launch_counts()
    model, _, losses, stats, *_ = offline_loop(
        gen_fn, run["train_fn"], run["device_args"], schedule, model,
        init_adam(model.leaves()), run["draws"], cache=run["cache"],
        host_store=run["store"], group=group)
    _say(group, f"offline: generated and stored {args.steps} batches in "
                f"{stats['t_gen']:.3f}s, trained in "
                f"{stats['t_train']:.3f}s")
    out = {"losses": [float(x) for x in losses], "model": model, **stats,
           "launches": {k: v - launches0[k]
                        for k, v in ops.launch_counts().items()},
           **_store_stats(run)}
    if args.report:
        name = (f"rank{group.rank}" if isinstance(group, ProcessWorkers)
                else "stacked")
        os.makedirs(args.report, exist_ok=True)
        meta = {k: v for k, v in out.items() if k != "model"}
        meta["rounds"] = [_round_report(group, run["b"], *r)
                          for r in gen_fn.rounds]
        with open(os.path.join(args.report, name + ".json"), "w") as f:
            json.dump(meta, f)
    return out


def lm_batch(rng: np.random.Generator, cfg, b: int, s: int, device) -> dict:
    """The reference's next LM batch from ``rng``: ``[b, s]`` int32 tokens
    uniform over the vocabulary and labels ``np.roll(tokens, -1, 1)``;
    then, from the same generator, the VLM's ``vision [b,
    n_vision_tokens, d_vision]`` or Whisper's ``frames [b,
    n_audio_frames, d_audio]``, float32 standard normals (the stubbed
    frontends' embeddings)."""
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(device),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1)).to(device)}
    stub = {"vlm": ("vision", cfg.n_vision_tokens, cfg.d_vision),
            "audio": ("frames", cfg.n_audio_frames, cfg.d_audio)}
    if cfg.family in stub:
        key, n, d = stub[cfg.family]
        batch[key] = torch.from_numpy(rng.standard_normal(
            (b, n, d), dtype=np.float32)).to(device)
    return batch


def data_rows(batch: dict, cfg, mesh) -> dict:
    """A data rank's rows of a global LM batch (``zoo.batch_pspecs``: the
    leading axis split over ``data`` where it divides, else whole)."""
    if mesh is None:
        return batch
    specs = zoo.batch_pspecs(cfg, {k: v.shape for k, v in batch.items()},
                             mesh.shape)
    d, r = mesh.data.world, mesh.data.rank
    return {k: (v[r * (v.shape[0] // d):(r + 1) * (v.shape[0] // d)]
                if specs[k][0] else v) for k, v in batch.items()}


def lm_mesh(args, group):
    """``(mesh, lm_config)`` of a ``train_lm`` run: the ``(W / M, M)``
    mesh over ``group`` (None in one process) and the arch's config with
    ``--smoke`` and ``--remat`` applied."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.remat != "keep":
        cfg = dataclasses.replace(cfg, remat=args.remat)
    if group is None:
        if args.model_axis != 1:
            raise ValueError(f"--model-axis {args.model_axis} needs one "
                             f"process per rank: --dist gloo|nccl")
        return None, cfg
    return mesh.make_local_mesh(group.world // args.model_axis,
                                args.model_axis, group), cfg


def lm_settings(args, lmesh, cfg):
    """``zoo.settings`` of a ``train_lm`` run: the mesh's model axis, the
    flags' switches, and the data axis where the batch splits over it
    (the MoE's gather path then dispatches the global batch)."""
    split = lmesh is not None and zoo.batch_pspecs(
        cfg, {"tokens": (args.lm_batch, args.lm_seq)},
        lmesh.shape)["tokens"][0]
    return zoo.settings(None if lmesh is None else lmesh.model,
                        moe_impl=args.moe, shard_heads=args.shard_heads,
                        seq_parallel=args.seq_parallel, attn_impl=args.attn,
                        data=lmesh.data if split else None)


def train_lm(args, step_hook=None, group: WorkerGroup = None,
             state_hook=None) -> dict:
    """Train an LM arch (``repro``'s ``train_lm`` line for line): the
    seeded model of ``zoo.build`` on ``--device``, a ``TrainConfig`` of
    ``--lr``, ``--steps``, ``--microbatches`` and ``--compress``, the
    ``TrainState`` of ``train_loop.init_state`` (the model keeps no
    weights of its own: it is the step's ``meta`` shell), ``--resume``
    from ``--ckpt-dir``, saves every ``--ckpt-every`` steps, the log line
    every ``--log-every``.  With ``group`` (a rank of ``--dist``) it
    trains over the ``(W / M, M)`` mesh (module docstring): the model
    built as the model rank's shard under the switches, the state as the
    rank's slices (``fsdp.ShardPlan``), each step on the data rank's rows
    of the seeded global batch.  ``step_hook(t)``, when given, runs after
    step ``t``'s loss reached the host, ``state_hook(t, state)`` with the
    state after it.  Returns ``{"losses", "wall_s"}`` (the reference's),
    on a mesh also ``grad_norms``, the last ``state``, its ``layout``
    and ``plan``."""
    lmesh, cfg = lm_mesh(args, group)
    dev = resolve_device(args.device) if group is None else group.device
    lead = group is None or group.lead
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       microbatches=args.microbatches,
                       compress_grads=args.compress)
    b, s = args.lm_batch, args.lm_seq
    with lm_settings(args, lmesh, cfg):
        api = zoo.build(cfg, dev)
        model = api.init(args.seed)
        params, layout = lm_leaves(model)
        plan = None if lmesh is None else ShardPlan(layout, lmesh,
                                                    cfg.fsdp_params)
        state = init_state(params, tcfg, layout, plan)
        del params
        model.to_empty(device="meta")
        loss_fn = module_loss(model, api.loss, layout.names)
        step = (make_train_step(loss_fn, tcfg, layout) if plan is None
                else make_train_step(loss_fn, tcfg, layout, mesh=plan))

        start = 0
        if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
            start = ckpt.latest_step(args.ckpt_dir)
            state = ckpt.restore_lm_state(args.ckpt_dir, start, state,
                                          layout, mesh=plan)
            if lead:
                print(f"resumed from step {start}")

        rng = np.random.default_rng(args.seed)
        losses, norms = [], []
        t0 = time.perf_counter()
        for t in range(start, args.steps):
            batch = data_rows(lm_batch(rng, cfg, b, s, dev), cfg, lmesh)
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            if step_hook is not None:
                step_hook(t)
            if state_hook is not None:
                state_hook(t, state)
            if (t + 1) % args.ckpt_every == 0:
                ckpt.save_lm_state(args.ckpt_dir, t + 1, state, layout,
                                   mesh=plan, keep=tcfg.keep_checkpoints)
            if (t + 1) % args.log_every == 0 and lead:
                print(f"step {t+1}: loss={losses[-1]:.4f} "
                      f"gnorm={norms[-1]:.3f}")
    dt = time.perf_counter() - t0
    if lead:
        print(f"trained {args.steps - start} steps in {dt:.1f}s"
              + ("" if lmesh is None else
                 f" over a ({lmesh.data.world}, {lmesh.model.world}) "
                 f"mesh"))
    out = {"losses": losses, "wall_s": dt}
    if plan is not None:
        out.update(grad_norms=norms, state=state, layout=layout, plan=plan)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    """The training flags (``repro``'s, minus ``--cache-probe-impl``,
    plus ``--device`` and the process backend's)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="graphgen-gcn")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--fanouts", default=None,
                    help="comma-separated per-hop fanouts override, e.g. "
                         "15,10,5")
    ap.add_argument("--capacity-slack", type=float, default=None,
                    help="feature-shuffle capacity slack; omit to auto-size "
                         "from a drop-aware calibration step")
    ap.add_argument("--cache-rows", type=int, default=None,
                    help="hot-node feature cache rows/worker (rounded UP to "
                         "a power of two; 0 disables; default from config)")
    ap.add_argument("--cache-admit", type=int, default=None,
                    help="misses before a node id is admitted to the cache")
    ap.add_argument("--cache-assoc", type=int, default=None,
                    choices=[1, 2, 4],
                    help="cache ways per set (1 = direct-mapped)")
    ap.add_argument("--cache-mode", default=None,
                    choices=["replicated", "sharded", "tiered"],
                    help="cache placement: per-worker replicas, id-space "
                         "shards, or a replicated L1 in front of the "
                         "sharded L2")
    ap.add_argument("--l1-rows", type=int, default=None,
                    help="tiered mode: replicated L1 rows/worker (0 "
                         "auto-sizes to cache_rows/8)")
    ap.add_argument("--l1-promote", type=int, default=None,
                    help="tiered mode: observations of a row before it is "
                         "promoted into the local L1")
    ap.add_argument("--probe-wire", default=None,
                    choices=["dense", "compact"],
                    help="shard-probe response wire format")
    ap.add_argument("--probe-hit-cap", type=int, default=None,
                    help="compact wire: pin the probe-response payload rows "
                         "per destination (skips the hit-cap calibration; "
                         "0 = half the probe capacity)")
    ap.add_argument("--feature-store", default=None,
                    choices=["device", "host"],
                    help="where the feature table lives: device row-shards "
                         "it over the workers, host keeps it in host RAM "
                         "behind the async L3 gather")
    ap.add_argument("--host-gather-depth", type=int, default=None,
                    choices=[1, 2],
                    help="host store gather pipeline depth: 2 overlaps the "
                         "gather with the train step (default), 1 gathers "
                         "synchronously")
    ap.add_argument("--autotune", action="store_true",
                    help="replace the calibration ladders with one "
                         "instrumented trace window + an offline cost-model "
                         "search over (fanouts, cache_rows, l1_rows, assoc, "
                         "hit_cap, capacity_slack); a live validator "
                         "accepts the pick or falls back to the ladders")
    ap.add_argument("--autotune-steps", type=int, default=8,
                    help="instrumented steps the autotune trace records "
                         "(the cold half is excluded from the fit; fewer "
                         "than 4 falls back to the calibration ladders)")
    ap.add_argument("--warm-recalibrate", type=int, default=0,
                    help="after N warm steps, shrink the owner-exchange "
                         "capacity to the observed steady-state miss peak "
                         "(0 disables; needs the cache and W > 1)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workers", type=int, default=1,
                    help="workers W: on the stacked worker axis of one "
                         "process (--dist none), or one process each "
                         "(--dist gloo|nccl)")
    ap.add_argument("--dist", default="none", choices=mesh.DIST_BACKENDS,
                    help="worker backend: none = the stacked axis in this "
                         "process; gloo = one process per worker (on a "
                         "card every collective stages through host "
                         "memory); nccl = one process per card (needs W "
                         "visible cards)")
    ap.add_argument("--grad-sync", default="psum", choices=["psum", "tree"],
                    help="--dist (or --per-worker-loss): average the "
                         "workers' gradients by the group's all_reduce or "
                         "by an explicit butterfly")
    ap.add_argument("--per-worker-loss", action="store_true",
                    help="stacked run: differentiate each worker's mean "
                         "loss on its own rows and average the gradients "
                         "as --dist ranks do (their arithmetic in one "
                         "process); a --dist run always does")
    ap.add_argument("--dist-timeout", type=float, default=3600,
                    help="--dist: seconds the launcher waits for its ranks "
                         "before ending them and failing")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="write the run's (each rank's) losses, params, "
                         "Adam moments, rungs, first rounds' digests and "
                         "stats, launches and timings to DIR")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--avg-degree", type=float, default=10.0)
    ap.add_argument("--batch-per-worker", type=int, default=32)
    ap.add_argument("--lm-batch", type=int, default=4)
    ap.add_argument("--lm-seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="LM archs under --dist: the mesh's model axis M "
                         "(the data axis is --workers / M)")
    ap.add_argument("--moe", default="gather", choices=["gather", "ep_a2a"],
                    help="LM archs: the MoE dispatch over the model axis")
    ap.add_argument("--shard-heads", action="store_true",
                    help="LM archs: split attention heads over the model "
                         "axis")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="LM archs: keep a rank's slice of the sequence "
                         "between blocks")
    ap.add_argument("--attn", default="naive", choices=["naive", "chunked"],
                    help="LM archs: the plain attention's form")
    ap.add_argument("--remat", default="keep",
                    choices=["keep", "none", "full", "dots"],
                    help="LM archs: recompute layer bodies in the backward "
                         "(keep: the config's own)")
    ap.add_argument("--compress", action="store_true",
                    help="LM archs: int8 error-feedback gradient "
                         "compression")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"),
                    help="checkpoint directory (the reference's layout)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save (params, opt_state) every N steps")
    ap.add_argument("--resume", action="store_true",
                    help="restart from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--export-serve", default=None, metavar="DIR",
                    help="after training, save the params and the warm "
                         "cache for repro_torch.launch.serve --warm-from DIR")
    ap.add_argument("--offline", action="store_true",
                    help="run the GraphGen baseline (generate and store "
                         "every batch, then train) instead of the pipeline")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    """CLI entry: train a GCN arch (``--offline``: through the GraphGen
    baseline) or an LM arch (``train_lm``; with ``--dist`` over a
    ``(W / M, M)`` mesh, ``M = --model-axis``, which must divide
    ``--workers``).  With ``--dist gloo|nccl`` it spawns the
    ``--workers`` ranks (``launch/mesh.py``) and exits non-zero if any
    fails or outlives ``--dist-timeout``; a rank (or a ``torchrun``
    worker) joins the group and trains."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if get_config(args.arch).family != "gcn":
        if args.model_axis < 1 or args.workers % args.model_axis:
            raise ValueError(f"--model-axis {args.model_axis} must divide "
                             f"--workers {args.workers}")
        if args.dist == "none":
            train_lm(args)
            return
        mesh.launch_or_join("repro_torch.launch.train", argv, args,
                            lambda group: train_lm(args, group=group))
        return
    body = offline_gcn if args.offline else train_gcn
    if args.dist == "none":
        body(args)
        return
    mesh.launch_or_join("repro_torch.launch.train", argv, args,
                        lambda group: body(args, group=group))


if __name__ == "__main__":
    main()
