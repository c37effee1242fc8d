"""GCN training driver of the port (``repro/launch/train.py``'s
``train_gcn``).

Synthetic power-law graph -> edge partition -> balance table ->
synchronized subgraph generation + in-memory GCN training (the GraphGen+
pipeline) on the stacked worker axis.  Before the loop the drop-aware
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
runs the same setup through the GraphGen baseline (``offline_loop``).

``--autotune`` (``--autotune-steps N``, default 8) replaces the ladders
with one instrumented trace window, an offline search against a cost
model fit from it, and a live validation of the best picks
(``launch/autotune.py``); a rejected or unfit trace falls back to the
ladders with a warning.  The validator sees a few rounds only, so a
trained batch that an accepted pick's exchange drops requests from is
regenerated at the traced slack, which the run then keeps.

Waiting for a later slice, and not accepted by this parser: the LM
archs.  ``--device`` is the one flag the reference lacks.

Examples::

    python -m repro_torch.launch.train --arch graphgen-gcn-deep
    python -m repro_torch.launch.train --arch graphgen-gcn --workers 4
    python -m repro_torch.launch.train --arch graphgen-gcn-deep --smoke \\
        --device cpu --nodes 2000 --steps 6 --feature-store host
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core.balance import balance_table
from ..core.config import TrainConfig, resolve_device
from ..convert import (adam_state_from_numpy, adam_state_to_numpy,
                       gcn_params_from_numpy, gcn_params_to_numpy)
from ..core.feature_cache import CacheConfig, init_cache_state
from ..core.generation import (SeededDraws, make_distributed_generator,
                               make_generator_fn, probe_round_capacity)
from ..core.partition import partition_edges
from ..core.pipeline import offline_loop, pipelined_loop
from ..graph.subgraph import slots_per_seed
from ..graph.synthetic import node_features, node_labels, powerlaw_graph
from ..models.gcn import gcn_loss, init_gcn
from ..train import checkpoint as ckpt
from ..train.optimizer import adam_update, init_adam

#: ascending slack ladder probed by the drop-aware capacity calibration
SLACK_LADDER = (0.25, 0.5, 1.0, 1.5, 2.0)
#: calibration batches per rung
CALIBRATION_PROBES = 3
#: ascending hit-cap ladder (fractions of the probe-round capacity)
HIT_CAP_LADDER = (0.125, 0.25, 0.5)


def make_gcn_train_fn(tcfg: TrainConfig):
    """``train_fn(model, opt_state, batch) -> (model, opt_state, loss)``:
    the GCN loss, its gradient with respect to every parameter (in
    ``GCN.leaves()`` order, the optimizer state's), and one
    ``adam_update``, written back into the model's parameters in place."""
    def train_fn(model, opt_state, batch):
        params = model.leaves()
        loss = gcn_loss(model, batch)
        grads = torch.autograd.grad(loss, params)
        new, opt_state, _ = adam_update(tcfg, params, grads, opt_state)
        with torch.no_grad():
            for p, n in zip(params, new):
                p.copy_(n)
        return model, opt_state, loss.detach()
    return train_fn


def calibrate_capacity_slack(device_args, fanouts, probes,
                             ladder=SLACK_LADDER, cache_cfg=None) -> float:
    """Drop-aware capacity calibration: the smallest slack of ``ladder``
    whose batches drop no request over every probe ``(seeds, draws)``.
    With ``cache_cfg`` the ladder probes the cached generator, each rung
    from a cold cache (the cold-start miss burst is the heaviest owner
    traffic), the cache threading across a rung's probes."""
    w = device_args[0].shape[0]
    feat_dim = device_args[2].shape[-1]
    dev = device_args[0].device
    cached = cache_cfg is not None and cache_cfg.n_rows > 0
    with torch.no_grad():
        for slack in ladder:
            gen_fn = make_generator_fn(fanouts=fanouts, capacity_slack=slack,
                                       cache_cfg=cache_cfg if cached else None)
            if cached:
                cache = init_cache_state(cache_cfg, feat_dim, w, device=dev)
            dropped = 0
            for seeds, draws in probes:
                if cached:
                    batch, cache = gen_fn(device_args, seeds, draws, cache)
                else:
                    batch = gen_fn(device_args, seeds, draws)
                dropped += int(batch.n_dropped.sum())
            if dropped == 0:
                return slack
            print(f"calibration: slack={slack} dropped {dropped} requests "
                  f"over {len(probes)} probes")
    print(f"calibration: even slack={ladder[-1]} drops requests; keeping it")
    return ladder[-1]


def calibrate_probe_hit_cap(device_args, fanouts, probes, slack, cache_cfg,
                            ladder=HIT_CAP_LADDER) -> CacheConfig:
    """Compact-wire hit-cap calibration: the ``CacheConfig`` of the
    smallest rung (a fraction of the probe-round capacity) whose probes
    demote no hit, each rung from a cold cache; the dense wire when every
    rung demotes."""
    w = device_args[0].shape[0]
    feat_dim = device_args[2].shape[-1]
    dev = device_args[0].device
    b = probes[0][0].shape[1]
    cap = probe_round_capacity(b * slots_per_seed(fanouts), w, slack)
    with torch.no_grad():
        for frac in ladder:
            hc = max(int(cap * frac), 1)
            cfg = cache_cfg._replace(wire="compact", hit_cap=hc)
            gen_fn = make_generator_fn(fanouts=fanouts, capacity_slack=slack,
                                       cache_cfg=cfg)
            cache = init_cache_state(cfg, feat_dim, w, device=dev)
            demoted = 0
            for seeds, draws in probes:
                batch, cache = gen_fn(device_args, seeds, draws, cache)
                demoted += int(batch.n_probe_demoted.sum())
            if demoted == 0:
                print(f"probe hit-cap auto-sized to {hc} rows/destination "
                      f"({frac:.0%} of the {cap}-slot probe round; override "
                      f"with --probe-hit-cap)")
                return cfg
            print(f"hit-cap calibration: hit_cap={hc} demoted {demoted} "
                  f"hits over {len(probes)} probes")
    print(f"hit-cap calibration: even {ladder[-1]:.0%} of the probe round "
          f"demotes hits; falling back to the dense wire")
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


def build_gcn_run(args) -> dict:
    """Everything ``train_gcn`` sets up before its loop, from ``args``:
    the graph and tables, the calibrated (or autotuned) slack and cache
    policy, the ``AutotuneResult`` (None without ``--autotune``), the
    generator (``gen_fn``, ``device_args``, the L3 ``store`` in host mode
    or None, the empty ``cache`` or None), the model at its seeded init,
    the AdamW ``train_fn``, ``seeds_np(t)`` and ``draws(t, W, b)``."""
    dev = resolve_device(args.device)
    w = args.workers
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
        return torch.from_numpy(np.ascontiguousarray(seeds_np(t))).to(dev)

    res = autotuned = None
    if args.autotune:
        # one trace and an offline search replace the ladders; they stay
        # as the fallback when the validator rejects the pick
        from .autotune import autotune_gcn, candidate_cache_cfg
        res = autotune_gcn(
            dev, part, feats, labels, fanouts=fanouts, cache_cfg=cache_cfg,
            feature_store=cfg.feature_store, batch_per_worker=b,
            seeds_for=seeds_for,
            draws_for=lambda fo: SeededDraws(fo, args.seed + 2, dev),
            steps=args.autotune_steps,
            slack=(args.capacity_slack or cfg.capacity_slack or 2.0))
        if res.accepted:
            autotuned = res
            cfg = cfg.with_candidate(res.candidate)
            fanouts = cfg.fanouts
            if cached:
                cache_cfg = candidate_cache_cfg(cache_cfg, res.candidate)
            print(f"autotune: accepted (measured "
                  f"{res.measured_step_s * 1e3:.1f} ms/step warm)")
        else:
            print(f"autotune: WARNING — falling back to the calibration "
                  f"ladders ({res.reason})")
    # the training draws follow the final fanouts
    draws = SeededDraws(fanouts, args.seed + 1, dev)

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
            print("capacity_slack fixed at 2.0 (--feature-store host skips "
                  "the drop-aware ladder: misses stage to the L3 store "
                  "instead of the owner exchange)")
        gen_fn, device_args, store, *c0 = make_distributed_generator(
            part, feats, labels, fanouts=fanouts, capacity_slack=slack,
            cache_cfg=cache_cfg, feature_store="host",
            host_gather_depth=cfg.host_gather_depth, device=dev)
        cache = c0[0] if cached else None
        print(f"L3 host feature store: {feats.shape[0]}x{feats.shape[1]} "
              f"f32 table ({feats.nbytes / 1e6:.1f} MB) in host RAM, "
              f"gather depth {cfg.host_gather_depth} "
              f"({'overlapped' if cfg.host_gather_depth == 2 else 'synchronous'})")
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
            part, feats, labels, fanouts=fanouts, device=dev)
        probes = [(seeds_for(t), draws(t, w, b))
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
                                             cache_cfg=cache_cfg)
            ladders.append("slack")
            print(f"capacity_slack auto-sized to {slack} "
                  f"(override with --capacity-slack)")
        if need_hit_cap:
            cache_cfg = calibrate_probe_hit_cap(device_args, fanouts, probes,
                                                slack, cache_cfg)
            ladders.append("hit_cap")
        del probes
        gen_fn = make_generator_fn(fanouts=fanouts, capacity_slack=slack,
                                   cache_cfg=cache_cfg)
        if cached:
            cache = init_cache_state(cache_cfg, cfg.gcn_in_dim, w, device=dev)
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
        print(line)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       checkpoint_every=args.ckpt_every)
    return {"dev": dev, "w": w, "b": b, "cfg": cfg, "cache_cfg": cache_cfg,
            "slack": slack, "ladders": ladders, "autotune": res,
            "gen_fn": gen_fn,
            "device_args": device_args, "store": store, "cache": cache,
            "model": init_gcn(cfg, args.seed, device=dev),
            "train_fn": make_gcn_train_fn(tcfg), "tcfg": tcfg,
            "seeds_np": seeds_np, "seeds_for": seeds_for, "draws": draws,
            "table_bytes": feats.nbytes}


def _store_stats(run: dict) -> dict:
    """The L3 store's telemetry of a run (empty for the device store)."""
    store = run["store"]
    if store is None:
        return {}
    return {"host_gather_bytes": store.bytes_issued,
            "n_l3_hits": store.rows_issued,
            "table_bytes": run["table_bytes"], "depth": store.depth}


def train_gcn(args, step_hook=None) -> dict:
    """Train a GCN arch for ``args.steps`` pipelined steps; returns the
    losses, the padded nodes per iteration, the wall time, the slack, the
    calibration ladders that ran, the requests dropped by the trained
    batches, the final cache hit rate, the L3 store's telemetry in host
    mode, and the trained model, the cache state and the last batch.
    ``step_hook(t)``, when given, runs after step ``t``'s loss has
    reached the host (a profiler's step marker)."""
    run = build_gcn_run(args)
    dev, w, b = run["dev"], run["w"], run["b"]
    cache_cfg, slack = run["cache_cfg"], run["slack"]
    cached = cache_cfg is not None
    device_args, draws, seeds_for = (run["device_args"], run["draws"],
                                     run["seeds_for"])
    model = run["model"]
    opt = init_adam(model.leaves())
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        start = ckpt.latest_step(args.ckpt_dir)
        params_np, opt_np = ckpt.restore(
            args.ckpt_dir, start,
            (gcn_params_to_numpy(model), adam_state_to_numpy(opt)))
        model = gcn_params_from_numpy(params_np, device=dev)
        opt = adam_state_from_numpy(opt_np, device=dev)
        print(f"resumed from step {start}")

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
            cache_cfg=cache_cfg)
    # only the second half of the warm window counts toward the miss peak
    warm_from = start + max(args.warm_recalibrate // 2, 1)
    t0 = time.perf_counter()

    def regenerate(gen, t, carry):
        """Batch ``t`` generated again by ``gen`` into the carry."""
        with torch.no_grad():
            if cached:
                batch, cache_now = gen(device_args, seeds_for(t),
                                       draws(t, w, b), carry[3])
                return (carry[0], carry[1], batch, cache_now)
            return (carry[0], carry[1],
                    gen(device_args, seeds_for(t), draws(t, w, b)))

    def before_step(i, carry, gen_fn):
        nonlocal miss_peak, wide_gen, traced_gen, autotune_rollback
        nonlocal n_dropped, t0
        t = start + i
        if i == 0:
            t0 = time.perf_counter()   # batch `start` is generated
        if cached and args.warm_recalibrate and t >= warm_from:
            miss_peak = max(miss_peak, int(carry[2].n_cache_misses.max()))
        if traced_gen is not None and int(carry[2].n_dropped.sum()) > 0:
            gen_fn, traced_gen = traced_gen, None
            carry = regenerate(gen_fn, t, carry)
            autotune_rollback = t
            print(f"step {t}: the autotuned exchange dropped requests — "
                  f"regenerated the batch at the traced slack "
                  f"{tuned.trace.config.capacity_slack} and kept it")
        # rollback check first: carry[2] was generated by the shrunken
        # generator only once the shrink below has been installed
        if wide_gen is not None and int(carry[2].n_dropped.sum()) > 0:
            gen_fn, wide_gen = wide_gen, None
            carry = regenerate(gen_fn, t, carry)
            print(f"step {t}: shrunken capacity dropped requests — "
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
                                       fetch_capacity=new_cap)
            print(f"warm re-calibration at step {t}: owner-exchange "
                  f"capacity -> {new_cap} slots/destination "
                  f"(peak warm per-worker misses {miss_peak})")
        n_dropped += int(carry[2].n_dropped.sum())
        return carry, gen_fn

    def after_step(i, carry, loss):
        t = start + i
        losses.append(float(loss))
        if step_hook is not None:
            step_hook(i)
        if (t + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, t + 1,
                      (gcn_params_to_numpy(carry[0]),
                       adam_state_to_numpy(carry[1])),
                      keep=run["tcfg"].keep_checkpoints)
        if (t + 1) % args.log_every == 0:
            line = f"step {t + 1}: loss={losses[-1]:.4f}"
            nb = carry[2]
            if cached:
                line += f" cache_hit_rate={nb.cache_hit_rate():.3f}"
            dropped = int(nb.n_dropped.sum())
            if dropped:
                line += f" DROPPED={dropped}"
            if cached:
                demoted = int(nb.n_probe_demoted.sum())
                if demoted:
                    line += f" demoted={demoted}"
            print(line)
        final["batch"] = carry[2]

    cache = run["cache"]
    if start < args.steps:
        # batch t comes from seeds_np(t) and draws(t): a resumed run
        # primes the pipeline at `start`
        schedule = np.stack([run["seeds_np"](t)
                             for t in range(start, args.steps)])
        model, _, _, *rest = pipelined_loop(
            run["gen_fn"], run["train_fn"], device_args, schedule, model,
            opt, lambda i, *a: draws(start + i, *a), cache=cache,
            before_step=before_step, after_step=after_step,
            host_store=run["store"])
        if cached:
            cache = rest[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if args.export_serve:
        if not cached:
            raise SystemExit("--export-serve checkpoints params + the warm "
                             "cache state; this run has no cache "
                             "(--cache-rows 0)")
        ckpt.save_serving_state(args.export_serve, args.steps, model, cache,
                                cache_cfg=cache_cfg)
        print(f"exported serving state (params + warm cache) to "
              f"{args.export_serve}")
    n_run = args.steps - start
    nodes_per_iter = (b * w * slots_per_seed(run["cfg"].fanouts))
    out = {"losses": losses, "nodes_per_iter": nodes_per_iter, "wall_s": dt,
           "capacity_slack": slack, "ladders": run["ladders"],
           "n_dropped": n_dropped, "cache_cfg": cache_cfg,
           "fanouts": run["cfg"].fanouts, "autotune": run["autotune"],
           "autotune_rollback": autotune_rollback,
           "model": model,
           "cache": cache, "batch": final["batch"], "start": start,
           **_store_stats(run)}
    if run["store"] is not None:
        print(f"L3 host gathers shipped {out['host_gather_bytes'] / 1e6:.1f} "
              f"MB ({out['n_l3_hits']} rows)")
    print(f"trained {n_run} steps in {dt:.1f}s "
          f"({nodes_per_iter} padded nodes/iter, "
          f"{n_run * nodes_per_iter / max(dt, 1e-9):,.0f} nodes/s)")
    if cached and final["batch"] is not None:
        out["cache_hit_rate"] = final["batch"].cache_hit_rate()
        print(f"steady-state cache hit rate: {out['cache_hit_rate']:.3f}")
    return out


def offline_gcn(args) -> dict:
    """The GraphGen baseline on ``train_gcn``'s setup: ``offline_loop``
    over the same seeds and draws for ``args.steps`` batches.  Returns the
    losses, ``t_gen`` and ``t_train`` (seconds), the trained model and
    the L3 store's telemetry in host mode."""
    run = build_gcn_run(args)
    model = run["model"]
    schedule = np.stack([run["seeds_np"](t) for t in range(args.steps)])
    model, _, losses, stats, *_ = offline_loop(
        run["gen_fn"], run["train_fn"], run["device_args"], schedule, model,
        init_adam(model.leaves()), run["draws"], cache=run["cache"],
        host_store=run["store"])
    print(f"offline: generated and stored {args.steps} batches in "
          f"{stats['t_gen']:.3f}s, trained in {stats['t_train']:.3f}s")
    return {"losses": [float(x) for x in losses], "model": model, **stats,
            **_store_stats(run)}


def parse_args(argv=None) -> argparse.Namespace:
    """The GCN training flags (``repro``'s, minus the LM flags and
    ``--cache-probe-impl``, plus ``--device``)."""
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
                    help="simulated workers on the stacked worker axis")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--avg-degree", type=float, default=10.0)
    ap.add_argument("--batch-per-worker", type=int, default=32)
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
    return ap.parse_args(argv)


def main(argv=None) -> None:
    """CLI entry: train a GCN arch."""
    args = parse_args(argv)
    if get_config(args.arch).family != "gcn":
        raise SystemExit(f"{args.arch}: only GCN archs are ported")
    train_gcn(args)


if __name__ == "__main__":
    main()
