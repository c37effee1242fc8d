"""Serving entry points of the port (``repro/launch/serve.py``): the
graph tier for GCN archs and the LM decode loop for the dense and SSM
LMs.

A frozen GCN answers seed-node requests: a producer thread fills a
bounded request queue; each request is padded to the smallest bucket of
a small shape ladder; subgraph generation runs against the hot-node
cache in its frozen serve view (warmed beforehand by sweeps of the
mutable generator over the degree-ranked Zipf head), then the GCN
forward and an argmax.  On a card the cache probes and the GCN
aggregation run the port's CUDA kernels; ``graphgen-gcn-deep``'s tiered
cache (an L1 in front of the sharded L2) is warmed and frozen the same
way, and at W = 1 its probe is the fused two-tier kernel.

``--dist gloo|nccl`` serves the graph tier with one process per worker
(``launch/mesh.py``): worker 0's rank owns the request queue and the
latency clock and sends every request to the other ranks as a
fixed-shape ``broadcast`` header (a length of -1 ends every rank's
loop); each rank generates and runs the forward on its row of the
request's ``[W, bucket]`` seeds, and the predictions are gathered with
one ``all_gather``.  The LM decode loop runs in one process only.

``compile_count()`` counts the distinct step shapes the server has run:
the ladder is run once at startup, and the request path must add none
(capturing a CUDA graph per bucket is later work).  ``--warm-from DIR``
restores the params and the warm cache that ``repro_torch.launch.train
--export-serve DIR`` (or the reference's) saved, instead of running the
warm-up sweeps; a state warmed under another cache layout is refused.

``serve_lm`` runs batched greedy decode of a dense LM (``smollm-135m``,
``smollm-360m``, with a bfloat16 KV cache) or of the SSM LM
(``mamba2-1.3b``, with its O(1) recurrent state: float32 SSM state and a
bfloat16 conv history), the prompt filled token by token through the
decode path, as the reference's ``serve_lm`` does.

Examples::

    python -m repro_torch.launch.serve --arch graphgen-gcn --workers 4
    python -m repro_torch.launch.serve --arch graphgen-gcn --workers 4 \\
        --dist gloo
    python -m repro_torch.launch.serve --arch graphgen-gcn-deep
    python -m repro_torch.launch.serve --arch smollm-135m --batch 8 \\
        --prompt-len 128 --gen-len 128
    python -m repro_torch.launch.serve --arch mamba2-1.3b --batch 8 \\
        --prompt-len 128 --gen-len 128
    python -m repro_torch.launch.serve --arch graphgen-gcn --smoke \\
        --device cpu --nodes 2000 --requests 16
    python -m repro_torch.launch.serve --arch smollm-135m --smoke \\
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import statistics
import sys
import threading
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core.collectives import ProcessWorkers, WorkerGroup
from ..core.config import resolve_device
from ..core.feature_cache import CacheConfig
from ..core.generation import (SeededDraws, make_distributed_generator,
                               make_generator_fn)
from ..core.partition import partition_edges
from ..graph.synthetic import node_features, node_labels, powerlaw_graph
from ..kernels import ops
from ..models import zoo
from ..models.gcn import init_gcn
from ..train import checkpoint as ckpt
from . import mesh

#: default request-shape ladder: per-worker seed slots per bucket
DEFAULT_BUCKETS = (8, 16, 32)


def bucket_for(n: int, buckets, n_workers: int) -> int:
    """Smallest ladder bucket (per-worker seed slots) whose padded capacity
    ``bucket * n_workers`` holds an ``n``-seed request; raises on an empty
    request or one beyond the top bucket (split it, never truncate)."""
    if n <= 0:
        raise ValueError(f"a request needs at least one seed, got {n}")
    for b in buckets:
        if b * n_workers >= n:
            return b
    raise ValueError(
        f"request of {n} seeds exceeds the bucket ladder's capacity "
        f"{buckets[-1] * n_workers} (buckets {tuple(buckets)} x "
        f"{n_workers} workers) — split the request or widen the ladder")


def warmup_sweep(gen_fn, device_args, cache, head_ids, *, n_workers: int,
                 bucket: int, sweeps: int, draws,
                 group: WorkerGroup = None):
    """Pre-warm a cache state for serving: run the MUTABLE generator over
    the Zipf head before any request arrives.

    Sweep ``t`` feeds the next ``bucket * n_workers`` of ``head_ids``
    (hottest first, wrapping), as ``[W, bucket]`` seeds, with round
    ``t``'s ``draws(t, L, bucket)`` through ``gen_fn(device_args, seeds,
    draws, cache) -> (batch, cache)``; on a process ``group`` every rank
    sweeps in lockstep on its row of the seeds (``group.block``, ``L``
    held workers).  Returns the warmed cache."""
    head = np.asarray(head_ids, np.int32).reshape(-1)
    if head.size == 0:
        raise ValueError("warmup_sweep needs a non-empty head population")
    per = bucket * n_workers
    dev = device_args[0].device
    with torch.no_grad():
        for t in range(sweeps):
            take = (np.arange(per) + t * per) % head.size
            seeds = head[take].reshape(n_workers, bucket)
            if group is not None:
                seeds = group.block(seeds)
            _, cache = gen_fn(
                device_args,
                torch.from_numpy(np.ascontiguousarray(seeds)).to(dev),
                draws(t, seeds.shape[0], bucket), cache)
    return cache


class GraphServer:
    """Read-mostly graph-serving engine: a frozen model, one warm cache
    state and a bucket ladder.

    ``serve(seed_ids)`` pads the request to its bucket, spreads it
    row-major over the worker axis, runs frozen-cache generation + the
    GCN forward with request ``n``'s ``draws(n, L, bucket)``, and
    returns the int32 class predictions of the real seeds.

    ``group`` is the worker group (default: the stacked group of
    ``n_workers``).  On a process group each rank generates and runs the
    forward on its own row of the ``[W, bucket]`` seeds, and the
    predictions come back with one ``all_gather`` of ``[1, bucket]``
    int32; every rank must serve every request, in the same order.
    ``gen_s`` and ``fwd_s`` hold each request's generation and forward
    seconds between marks on the device's timeline (CUDA events on the
    card, the host clock on the CPU), read after the one host sync that
    brings the predictions back."""

    def __init__(self, gen_fn, device_args, model, cache, *, draws,
                 buckets=DEFAULT_BUCKETS, n_workers: int,
                 group: WorkerGroup = None):
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self._buckets or self._buckets[0] <= 0:
            raise ValueError(f"bucket ladder must name positive sizes, "
                             f"got {buckets}")
        self._w = int(n_workers)
        self._gen_fn = gen_fn
        self._device_args = device_args
        self._model = model
        self._cache = cache
        self._draws = draws
        self._device = device_args[0].device
        if group is None:
            group = mesh.make_local_group(self._w, self._device)
        elif group.world != self._w:
            raise ValueError(f"n_workers {self._w}, but the group has "
                             f"{group.world}")
        self._group = group
        self._n_requests = 0
        self._shapes = set()
        self.gen_s, self.fwd_s = [], []

    @property
    def buckets(self) -> tuple:
        """The ladder: per-worker seed slots per bucket, ascending."""
        return self._buckets

    @property
    def capacity(self) -> int:
        """Largest request (seed count) the ladder can hold."""
        return self._buckets[-1] * self._w

    def compile_count(self) -> int:
        """Distinct step shapes run so far; after :meth:`warmup` this is
        ``len(buckets)`` and must not grow on the request path."""
        return len(self._shapes)

    def warmup(self) -> int:
        """Run one synthetic request per bucket (startup cost, paid once);
        returns the step-shape count."""
        for b in self._buckets:
            self.serve(np.zeros(b * self._w, np.int32))
        return self.compile_count()

    @property
    def n_classes(self) -> int:
        """Classes the model predicts (predictions lie in
        ``[0, n_classes)``)."""
        return self._model.w_out.shape[1]

    @property
    def group(self) -> WorkerGroup:
        """The worker group the server runs on."""
        return self._group

    @property
    def cache(self):
        """The warm, read-only cache state (None when uncached)."""
        return self._cache

    def _generate(self, seed_ids):
        """``(batch, n, bucket)`` of one request: the held workers' rows of
        the padded ``[W, bucket]`` seeds, generated; counts as a request."""
        ids = np.asarray(seed_ids, np.int32).reshape(-1)
        n = ids.size
        b = bucket_for(n, self._buckets, self._w)
        padded = np.empty(b * self._w, np.int32)
        padded[:n] = ids
        padded[n:] = ids[n - 1]
        held = np.ascontiguousarray(
            self._group.block(padded.reshape(self._w, b)))
        seeds = torch.from_numpy(held).to(self._device)
        draws = self._draws(self._n_requests, held.shape[0], b)
        self._n_requests += 1
        self._shapes.add(tuple(seeds.shape))
        with torch.no_grad():
            if self._cache is not None:
                batch = self._gen_fn(self._device_args, seeds, draws,
                                     self._cache)
            else:
                batch = self._gen_fn(self._device_args, seeds, draws)
        return batch, n, b

    def generate(self, seed_ids):
        """The subgraph batch of one request, padded to its bucket (the
        held workers' ``bucket`` seeds each, pad slots included); counts
        as a request."""
        return self._generate(seed_ids)[0]

    def _gathered(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """Every worker's rows of a per-seed ``[L * b, ...]`` result, in
        request order (``[W * b, ...]``)."""
        held = x.reshape((self._group.local, b) + tuple(x.shape[1:]))
        return self._group.all_gather(held)[0]

    def logits(self, seed_ids) -> torch.Tensor:
        """Answer one request with the logits ``[n, n_classes]`` of its
        seeds (padded slots sliced off, every worker's rows gathered);
        counts as a request."""
        batch, n, b = self._generate(seed_ids)
        with torch.no_grad():
            return self._gathered(self._model(batch), b)[:n]

    def serve(self, seed_ids) -> np.ndarray:
        """Answer one request: int32 class predictions, one per seed.
        Blocks until they are on the host (end-to-end latency)."""
        m0 = _mark(self._device)
        batch, n, b = self._generate(seed_ids)
        m1 = _mark(self._device)
        with torch.no_grad():
            preds = torch.argmax(self._model(batch), dim=-1).to(torch.int32)
        m2 = _mark(self._device)
        out = self._gathered(preds, b)[:n].cpu().numpy()
        self.gen_s.append(_between(m0, m1))
        self.fwd_s.append(_between(m1, m2))
        return out


def _zipf_request_stream(rng, n_requests, head_order, max_size):
    """Synthetic serve traffic: sizes uniform in ``[1, max_size]``, seed ids
    Zipf(1.5)-ranked over ``head_order`` (the hot head requested most)."""
    n_nodes = head_order.size
    for _ in range(n_requests):
        size = int(rng.integers(1, max_size + 1))
        ranks = np.minimum(rng.zipf(1.5, size=size), n_nodes) - 1
        yield head_order[ranks]


def _say(group: WorkerGroup, msg: str) -> None:
    """Print on the process that holds worker 0 only."""
    if group.lead:
        print(msg)


def build_server(args, group: WorkerGroup = None):
    """Build the graph, the model, the warm cache and the server for
    ``args`` (the ``main`` flags); returns ``(server, head_order)``.

    ``group`` is the worker group (default: the stacked group of
    ``--workers`` on ``--device``); on a process group every rank builds
    the graph on the host from the seed, places its own shard, sweeps its
    row of the warm-up seeds in lockstep with the others (or restores its
    block of a ``--warm-from`` state) and serves its row of every
    request."""
    w = args.workers
    if group is None:
        group = mesh.make_local_group(w, args.device)
    elif group.world != w:
        raise ValueError(f"--workers {w}, but the group has {group.world}")
    dev = group.device
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cache_cfg = CacheConfig.from_model(cfg)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    graph = powerlaw_graph(args.nodes, avg_degree=args.avg_degree,
                           n_hot=max(args.nodes // 1000, 1), seed=args.seed)
    part = partition_edges(graph, w)
    feats = node_features(graph.n_nodes, cfg.gcn_in_dim, args.seed)
    labels = node_labels(graph.n_nodes, cfg.n_classes, args.seed)
    model = init_gcn(cfg, args.seed, device=dev)
    head_order = np.argsort(-np.diff(graph.indptr)).astype(np.int32)
    draws = SeededDraws(cfg.fanouts, args.seed, dev, group=group)

    cache = None
    if cache_cfg is not None:
        gen_mut, device_args, cache0 = make_distributed_generator(
            part, feats, labels, fanouts=cfg.fanouts, cache_cfg=cache_cfg,
            group=group)
        serve_cfg = cache_cfg.serve_view()
        if args.warm_from:
            model, cache = ckpt.restore_serving_state(
                args.warm_from, model, cache0, expect_cache_cfg=serve_cfg,
                group=group)
            _say(group, f"restored serving state from {args.warm_from} "
                        f"(params + warm cache)")
        else:
            head = head_order[:max(buckets[-1] * w,
                                   args.warmup_head or cache_cfg.n_rows)]
            cache = warmup_sweep(gen_mut, device_args, cache0, head,
                                 n_workers=w, bucket=max(buckets),
                                 sweeps=args.warmup_sweeps, draws=draws,
                                 group=group)
            _say(group, f"warmup sweep: {args.warmup_sweeps} sweeps over "
                        f"the {head.size}-node Zipf head")
        gen_serve = make_generator_fn(fanouts=cfg.fanouts,
                                      cache_cfg=serve_cfg, group=group)
    else:
        gen_serve, device_args = make_distributed_generator(
            part, feats, labels, fanouts=cfg.fanouts, group=group)
    server = GraphServer(gen_serve, device_args, model, cache, draws=draws,
                         buckets=buckets, n_workers=w, group=group)
    return server, head_order


def _refuse_dist(args, what: str) -> None:
    """Raise for ``--dist gloo|nccl``: the LM paths run in one process
    (their process backend is tensor parallelism, ROADMAP Queue 1 items
    6 and 7.4)."""
    if args.dist != "none":
        raise NotImplementedError(
            f"--dist {args.dist}: {what} runs in one process only (--dist "
            f"none); the LM paths' process backend (tensor parallelism) "
            f"is ROADMAP Queue 1 items 6 and 7.4")


def _request_channel(group: WorkerGroup, capacity: int):
    """``exchange(ids) -> ids``: worker 0's request (None ends the loop)
    on every rank of a process group, as one fixed-shape ``broadcast``
    header: the length (-1 to stop), then the ids padded to the largest
    bucket.  The identity on the stacked group."""
    if group.local == group.world:
        return lambda ids: ids
    # gloo moves host tensors; NCCL needs the header on the card
    dev = group.device if group.backend == "nccl" else torch.device("cpu")

    def exchange(ids):
        hdr = np.full((1, 1 + capacity), -1, np.int32)
        if ids is not None:
            hdr[0, 0] = len(ids)
            hdr[0, 1:1 + len(ids)] = ids
        got = group.broadcast(torch.from_numpy(hdr).to(dev)).cpu().numpy()[0]
        n = int(got[0])
        return None if n < 0 else got[1:1 + n]
    return exchange


def serve_gcn(args, built=None, group: WorkerGroup = None) -> dict:
    """Graph-serving driver: build the server (or take ``built``, a
    ``build_server(args, group)`` result), run the ladder once, then
    drain ``args.requests`` synthetic Zipf requests through a
    ``args.queue_depth``-bounded queue fed by a producer thread.  Returns
    p50/p99 end-to-end latency (ms), QPS and the step-shape counts (the
    request path must add none), the medians of this process's
    generation and forward per request, its kernel launches, and on a
    process group the bytes and calls per request of each collective.

    On a process ``group`` (``main`` joins it for ``--dist gloo|nccl``)
    worker 0's rank alone owns the producer, the queue and the latency
    clock (the other ranks' ``p50_ms``/``p99_ms``/``qps`` are None); it
    sends every rank each request as a ``broadcast`` header, every rank
    serves its row, and the predictions are gathered on every rank.
    ``--report DIR`` writes this process's results, every served
    prediction and digests of its cache blocks to ``DIR/{rank<r>|
    stacked}.json``."""
    if group is None and args.dist != "none":
        raise ValueError(f"--dist {args.dist} runs one process per worker: "
                         f"start it through main(), which launches or joins "
                         f"the ranks, or pass their group")
    server, head_order = build_server(args, group) if built is None else built
    group = server.group
    lead = group.lead
    n_classes = server.n_classes
    launches0 = ops.launch_counts()
    server.warmup()
    startup_shapes = server.compile_count()
    _say(group, f"bucket ladder {server.buckets} run at startup "
                f"({startup_shapes} step shapes, capacity "
                f"{server.capacity} seeds/request)")
    process = isinstance(group, ProcessWorkers)
    if process:
        group.reset_stats()
    server.gen_s, server.fwd_s = [], []
    exchange = _request_channel(group, server.capacity)

    req_q = queue.Queue(maxsize=args.queue_depth)
    rng = np.random.default_rng(args.seed + 7)

    def _producer():
        for ids in _zipf_request_stream(rng, args.requests, head_order,
                                        server.capacity):
            req_q.put((time.perf_counter(), ids))
        req_q.put(None)

    latencies, answers = [], []
    # only worker 0's rank produces; the others' thread has nothing to do
    producer = threading.Thread(target=_producer if lead else (lambda: None),
                                name="serve-producer")
    producer.start()
    try:
        t0 = time.perf_counter()
        while True:
            item = req_q.get() if lead else None
            ids = exchange(None if item is None else item[1])
            if ids is None:
                break
            preds = server.serve(ids)
            if preds.shape != (len(ids),) or preds.min() < 0 \
                    or preds.max() >= n_classes:
                raise RuntimeError(f"served predictions {preds} for "
                                   f"{len(ids)} seeds outside "
                                   f"[0, {n_classes})")
            if lead:
                latencies.append(time.perf_counter() - item[0])
            answers.append((ids, preds))
        wall = time.perf_counter() - t0
    finally:
        producer.join()

    request_shapes = server.compile_count() - startup_shapes
    n_served = len(answers)
    out = {"p50_ms": None, "p99_ms": None, "qps": None,
           "n_requests": n_served, "wall_s": float(wall),
           "request_path_compiles": int(request_shapes),
           "startup_compiles": int(startup_shapes), "n_classes": n_classes,
           "gen_median_ms": (statistics.median(server.gen_s) * 1e3
                             if server.gen_s else None),
           "fwd_median_ms": (statistics.median(server.fwd_s) * 1e3
                             if server.fwd_s else None),
           "launches": {k: v - launches0[k]
                        for k, v in ops.launch_counts().items()}}
    if process:
        out["collectives_per_request"] = {
            k: {"calls": v["calls"] / max(n_served, 1),
                "bytes": v["bytes"] / max(n_served, 1),
                "seconds": v["seconds"] / max(n_served, 1)}
            for k, v in group.stats.items()}
    if lead:
        p50, p99 = (np.percentile(latencies, [50, 99]) * 1e3
                    if latencies else (0.0, 0.0))
        qps = len(latencies) / wall if wall > 0 else 0.0
        out.update(p50_ms=float(p50), p99_ms=float(p99), qps=float(qps))
        print(f"served {len(latencies)} requests in {wall:.2f}s "
              f"({qps:.1f} req/s): p50 {p50:.2f}ms p99 {p99:.2f}ms, "
              f"{request_shapes} request-path step shapes")
    if request_shapes:
        print(f"WARNING: requests landed on step shapes outside the bucket "
              f"ladder (rank {group.rank})")
    if process and lead:
        print(f"rank 0: median generate {out['gen_median_ms']:.3f} ms, "
              f"forward {out['fwd_median_ms']:.3f} ms per request")
    if getattr(args, "report", None):
        _write_serve_report(args.report, group, server, out, answers)
    return out


def _write_serve_report(path: str, group: WorkerGroup, server, out: dict,
                        answers) -> None:
    """``--report DIR``: ``DIR/{rank<r>|stacked}.json`` with ``out``, the
    served requests and predictions, and digests of the held workers'
    cache blocks (global worker index)."""
    from .train import cache_digests
    name = (f"rank{group.rank}" if isinstance(group, ProcessWorkers)
            else "stacked")
    os.makedirs(path, exist_ok=True)
    meta = {**out, "world": group.world, "rank": group.rank,
            "device": str(group.device),
            "requests": [a.tolist() for a, _ in answers],
            "predictions": [p.tolist() for _, p in answers],
            "cache": (cache_digests(group, server.cache)
                      if server.cache is not None else {})}
    with open(os.path.join(path, name + ".json"), "w") as f:
        json.dump(meta, f)


def _mark(dev: torch.device):
    """A point on ``dev``'s timeline: a CUDA event recorded on the current
    stream on the card (no host sync), the host clock elsewhere."""
    if dev.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def _between(a, b) -> float:
    """Seconds from mark ``a`` to mark ``b`` (events once ``b`` is done)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(args, step_hook=None) -> dict:
    """LM serving: batched greedy decode with the model's cache (the dense
    LM's bfloat16 KV cache, the SSM's recurrent state).

    The prompt (``--prompt-len`` tokens drawn with numpy from ``--seed``)
    is filled token by token through the decode path; with
    ``--prompt-len 0`` generation starts from token 0.  Then
    ``--gen-len`` decode steps are timed, each taking the argmax over the
    padded vocab.  Tokens stay on the device until one sync after the
    timed loop, so tok/s measures decode, not a host sync per token.
    ``step_hook(i)``, if given, runs after the ``i``-th timed step is
    enqueued.  Returns ``tok_s``, the timed loop's ``wall_s`` and the
    generated ``tokens [B, gen_len]`` (int32 numpy)."""
    _refuse_dist(args, "serve_lm")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    api = zoo.build(cfg, dev)
    if api.decode is None:
        raise SystemExit(f"{args.arch} has no decode path")
    model = api.init(args.seed)
    cache = api.init_cache(model, args.batch, args.prompt_len + args.gen_len)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        dtype=np.int32)).to(dev)
    out = []
    with torch.no_grad():
        logits = None
        for p in range(args.prompt_len):
            logits, cache = api.decode(model, cache, prompt[:, p:p + 1], p)
        pos = args.prompt_len
        if logits is None:
            # zero-trip prefill: nothing to argmax, start from a fixed token
            tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
        else:
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        _sync(dev)                      # the clock starts on settled inputs
        t0 = time.perf_counter()
        for i in range(args.gen_len):
            out.append(tok)             # device tensor: no host sync here
            logits, cache = api.decode(model, cache, tok, pos)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            pos += 1
            if step_hook is not None:
                step_hook(i)
        _sync(dev)
        dt = time.perf_counter() - t0
    toks = args.gen_len * args.batch
    tok_s = toks / dt if dt > 0 else 0.0
    print(f"generated {toks} tokens in {dt:.2f}s ({tok_s:.1f} tok/s batched)")
    gen = (torch.cat(out, dim=1).cpu().numpy() if out
           else np.zeros((args.batch, 0), np.int32))
    if gen.size:
        print("sample token ids:", gen[0][:16])
    return {"tok_s": tok_s, "tokens": gen, "wall_s": dt}


def parse_args(argv=None) -> argparse.Namespace:
    """The serving flags (``repro``'s LM decode and graph-serving flags,
    plus ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="graphgen-gcn",
                    help="a gcn arch (graphgen-gcn, graphgen-sage, "
                         "graphgen-gcn-deep) is served by the graph tier; "
                         "a dense (smollm-135m, smollm-360m) or ssm "
                         "(mamba2-1.3b) LM by the decode loop")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    # --- LM decode flags
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    # --- graph-serving flags
    ap.add_argument("--workers", type=int, default=1,
                    help="workers W: on the stacked worker axis of one "
                         "process (--dist none), or one process each "
                         "(--dist gloo|nccl)")
    ap.add_argument("--dist", default="none", choices=mesh.DIST_BACKENDS,
                    help="worker backend of the graph tier: none = the "
                         "stacked axis in this process; gloo = one process "
                         "per worker (on a card every collective stages "
                         "through host memory); nccl = one process per "
                         "card (needs W visible cards).  The LM decode "
                         "loop runs in one process only")
    ap.add_argument("--dist-timeout", type=float, default=3600,
                    help="--dist: seconds the launcher waits for its ranks "
                         "before ending them and failing")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="graph tier: write this run's (each rank's) "
                         "latencies, per-request medians, launches, "
                         "collective counters, predictions and cache "
                         "digests to DIR")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--avg-degree", type=float, default=10.0)
    ap.add_argument("--buckets", default="8,16,32",
                    help="request-shape ladder: per-worker seed slots")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--queue-depth", type=int, default=32)
    ap.add_argument("--warmup-sweeps", type=int, default=8)
    ap.add_argument("--warmup-head", type=int, default=0,
                    help="head population of the warmup sweep "
                         "(0 = the cache's row count)")
    ap.add_argument("--warm-from", default=None, metavar="DIR",
                    help="restore params + warm cache from a serving "
                         "checkpoint (train --export-serve DIR) instead of "
                         "sweeping")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    """CLI entry: dispatch on the arch family — ``gcn`` archs get the
    graph-serving tier, LM archs the decode loop.  With ``--dist
    gloo|nccl`` the graph tier spawns the ``--workers`` ranks
    (``launch/mesh.py``) and exits non-zero if any fails or outlives
    ``--dist-timeout``; a rank (or a ``torchrun`` worker) joins the group
    and serves."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if get_config(args.arch).family != "gcn":
        serve_lm(args)
    elif args.dist == "none":
        serve_gcn(args)
    else:
        mesh.launch_or_join("repro_torch.launch.serve", argv, args,
                            lambda group: serve_gcn(args, group=group))


if __name__ == "__main__":
    main()
