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
import queue
import threading
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core.config import resolve_device
from ..core.feature_cache import CacheConfig
from ..core.generation import (SeededDraws, make_distributed_generator,
                               make_generator_fn)
from ..core.partition import partition_edges
from ..graph.synthetic import node_features, node_labels, powerlaw_graph
from ..models import zoo
from ..models.gcn import init_gcn
from ..train import checkpoint as ckpt

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
                 bucket: int, sweeps: int, draws):
    """Pre-warm a cache state for serving: run the MUTABLE generator over
    the Zipf head before any request arrives.

    Sweep ``t`` feeds the next ``bucket * n_workers`` of ``head_ids``
    (hottest first, wrapping) with round ``t``'s ``draws(t, n_workers,
    bucket)`` through ``gen_fn(device_args, seeds, draws, cache) ->
    (batch, cache)``.  Returns the warmed cache."""
    head = np.asarray(head_ids, np.int32).reshape(-1)
    if head.size == 0:
        raise ValueError("warmup_sweep needs a non-empty head population")
    per = bucket * n_workers
    dev = device_args[0].device
    with torch.no_grad():
        for t in range(sweeps):
            take = (np.arange(per) + t * per) % head.size
            seeds = torch.from_numpy(head[take].reshape(n_workers, bucket))
            _, cache = gen_fn(device_args, seeds.to(dev),
                              draws(t, n_workers, bucket), cache)
    return cache


class GraphServer:
    """Read-mostly graph-serving engine: a frozen model, one warm cache
    state and a bucket ladder.

    ``serve(seed_ids)`` pads the request to its bucket, spreads it
    row-major over the worker axis, runs frozen-cache generation + the
    GCN forward with request ``n``'s ``draws(n, n_workers, bucket)``, and
    returns the int32 class predictions of the real seeds."""

    def __init__(self, gen_fn, device_args, model, cache, *, draws,
                 buckets=DEFAULT_BUCKETS, n_workers: int):
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
        self._n_requests = 0
        self._shapes = set()

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
    def cache(self):
        """The warm, read-only cache state (None when uncached)."""
        return self._cache

    def generate(self, seed_ids):
        """The subgraph batch of one request, padded to its bucket (all
        ``bucket * W`` seeds, pad slots included); counts as a request."""
        ids = np.asarray(seed_ids, np.int32).reshape(-1)
        n = ids.size
        b = bucket_for(n, self._buckets, self._w)
        padded = np.empty(b * self._w, np.int32)
        padded[:n] = ids
        padded[n:] = ids[n - 1]
        seeds = torch.from_numpy(padded.reshape(self._w, b)).to(self._device)
        draws = self._draws(self._n_requests, self._w, b)
        self._n_requests += 1
        self._shapes.add(tuple(seeds.shape))
        with torch.no_grad():
            if self._cache is not None:
                return self._gen_fn(self._device_args, seeds, draws,
                                    self._cache)
            return self._gen_fn(self._device_args, seeds, draws)

    def logits(self, seed_ids) -> torch.Tensor:
        """Answer one request with the logits ``[n, n_classes]`` of its
        seeds (padded slots sliced off); counts as a request."""
        batch = self.generate(seed_ids)
        with torch.no_grad():
            return self._model(batch)[:np.size(seed_ids)]

    def serve(self, seed_ids) -> np.ndarray:
        """Answer one request: int32 class predictions, one per seed.
        Blocks until they are on the host (end-to-end latency)."""
        logits = self.logits(seed_ids)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()


def _zipf_request_stream(rng, n_requests, head_order, max_size):
    """Synthetic serve traffic: sizes uniform in ``[1, max_size]``, seed ids
    Zipf(1.5)-ranked over ``head_order`` (the hot head requested most)."""
    n_nodes = head_order.size
    for _ in range(n_requests):
        size = int(rng.integers(1, max_size + 1))
        ranks = np.minimum(rng.zipf(1.5, size=size), n_nodes) - 1
        yield head_order[ranks]


def build_server(args):
    """Build the graph, the model, the warm cache and the server for
    ``args`` (the ``main`` flags); returns ``(server, head_order)``."""
    dev = resolve_device(args.device)
    w = args.workers
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
    draws = SeededDraws(cfg.fanouts, args.seed, dev)

    cache = None
    if cache_cfg is not None:
        gen_mut, device_args, cache0 = make_distributed_generator(
            part, feats, labels, fanouts=cfg.fanouts, cache_cfg=cache_cfg,
            device=dev)
        serve_cfg = cache_cfg.serve_view()
        if args.warm_from:
            model, cache = ckpt.restore_serving_state(
                args.warm_from, model, cache0, expect_cache_cfg=serve_cfg)
            print(f"restored serving state from {args.warm_from} "
                  f"(params + warm cache)")
        else:
            head = head_order[:max(buckets[-1] * w,
                                   args.warmup_head or cache_cfg.n_rows)]
            cache = warmup_sweep(gen_mut, device_args, cache0, head,
                                 n_workers=w, bucket=max(buckets),
                                 sweeps=args.warmup_sweeps, draws=draws)
            print(f"warmup sweep: {args.warmup_sweeps} sweeps over the "
                  f"{head.size}-node Zipf head")
        gen_serve = make_generator_fn(fanouts=cfg.fanouts,
                                      cache_cfg=serve_cfg)
    else:
        gen_serve, device_args = make_distributed_generator(
            part, feats, labels, fanouts=cfg.fanouts, device=dev)
    server = GraphServer(gen_serve, device_args, model, cache, draws=draws,
                         buckets=buckets, n_workers=w)
    return server, head_order


def _refuse_dist(args, what: str) -> None:
    """Raise for ``--dist gloo|nccl``: the serving tier has no process
    backend yet (ROADMAP Queue 1 item 7.3)."""
    if args.dist != "none":
        raise NotImplementedError(
            f"--dist {args.dist}: {what} runs in one process only (--dist "
            f"none); its process backend is ROADMAP Queue 1 item 7.3")


def serve_gcn(args, built=None) -> dict:
    """Graph-serving driver: build the server (or take ``built``, a
    ``build_server(args)`` result), run the ladder once, then drain
    ``args.requests`` synthetic Zipf requests through a
    ``args.queue_depth``-bounded queue fed by a producer thread.  Returns
    p50/p99 end-to-end latency (ms), QPS and the step-shape counts (the
    request path must add none).  Runs on the stacked worker axis only:
    ``--dist gloo|nccl`` raises."""
    _refuse_dist(args, "serve_gcn")
    server, head_order = build_server(args) if built is None else built
    n_classes = server.n_classes
    server.warmup()
    startup_shapes = server.compile_count()
    print(f"bucket ladder {server.buckets} run at startup "
          f"({startup_shapes} step shapes, capacity "
          f"{server.capacity} seeds/request)")

    req_q = queue.Queue(maxsize=args.queue_depth)
    rng = np.random.default_rng(args.seed + 7)

    def _producer():
        for ids in _zipf_request_stream(rng, args.requests, head_order,
                                        server.capacity):
            req_q.put((time.perf_counter(), ids))
        req_q.put(None)

    latencies = []
    producer = threading.Thread(target=_producer, name="serve-producer")
    producer.start()
    try:
        t0 = time.perf_counter()
        while True:
            item = req_q.get()
            if item is None:
                break
            t_enq, ids = item
            preds = server.serve(ids)
            if preds.shape != (len(ids),) or preds.min() < 0 \
                    or preds.max() >= n_classes:
                raise RuntimeError(f"served predictions {preds} for "
                                   f"{len(ids)} seeds outside "
                                   f"[0, {n_classes})")
            latencies.append(time.perf_counter() - t_enq)
        wall = time.perf_counter() - t0
    finally:
        producer.join()

    request_shapes = server.compile_count() - startup_shapes
    p50, p99 = (np.percentile(latencies, [50, 99]) * 1e3
                if latencies else (0.0, 0.0))
    qps = len(latencies) / wall if wall > 0 else 0.0
    print(f"served {len(latencies)} requests in {wall:.2f}s "
          f"({qps:.1f} req/s): p50 {p50:.2f}ms p99 {p99:.2f}ms, "
          f"{request_shapes} request-path step shapes")
    if request_shapes:
        print("WARNING: requests landed on step shapes outside the bucket "
              "ladder")
    return {"p50_ms": float(p50), "p99_ms": float(p99), "qps": float(qps),
            "n_requests": len(latencies), "wall_s": float(wall),
            "request_path_compiles": int(request_shapes),
            "startup_compiles": int(startup_shapes), "n_classes": n_classes}


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
                    help="workers on the stacked worker axis of this "
                         "process (the serving tier's only backend)")
    ap.add_argument("--dist", default="none",
                    choices=["none", "gloo", "nccl"],
                    help="worker backend; the serving tier runs on the "
                         "stacked axis only (none): gloo and nccl raise")
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
    graph-serving tier, LM archs the decode loop."""
    args = parse_args(argv)
    if get_config(args.arch).family == "gcn":
        serve_gcn(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
