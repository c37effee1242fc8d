#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Phases, each of which fails the run (nonzero exit, no result line):

1. device   — a CUDA card must be present; print ``nvidia-smi``'s name and
              power limit.
2. build    — compile the CUDA kernels (``nvcc``, sm_90a) from the sources
              in this checkout.
3. kernels  — each kernel against its plain-torch twin on the card, at the
              serving shapes and at edge cases (assoc 1/2/4, a single-set
              cache, probe counts off a multiple of 32, -1 ids, hit_cap 1):
              probes exact, fanout_mean within rtol 1e-5 / atol 1e-6 in
              float32 and 2e-2 in bfloat16.
4. serve    — ``serve_gcn`` on graphgen-gcn at full width (128 -> 256 -> 64,
              fanouts (40, 20), 4096-row 4-way sharded compact cache), 20 000
              nodes, 8 warmup sweeps, buckets (8, 16, 32), 64 Zipf requests,
              at W = 1 and at W = 4 on the stacked worker axis.  Launch
              counters are zeroed before each run and read after it: every
              kernel of the path must have launched.  No request may add a
              step shape outside the ladder; every prediction lies in
              [0, 64).
5. agree    — the port on the card against the port on the CPU (the plain
              twins) at a small size, same draws: warm cache states and
              batches exact, logits within rtol/atol 1e-5.
6. timing   — per bucket-32 request: kernel launches, and device busy time
              against wall time from a torch.profiler trace; then each
              kernel at the serve path's own inputs (bucket 32): kernel,
              plain-twin and library-call times (CUDA events, median of 30),
              and the bound (bytes over 3.35 TB/s or operations over the
              peak rate, whichever is larger).

The second-to-last lines are the kernel JSON and ``nvidia-smi``'s line; the
last line is ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
N_NODES, N_REQUESTS = 20_000, 64

KERNEL_META = {
    "fanout_mean": ("src/repro_torch/kernels/csrc/fanout_mean.cu",
                    "src/repro/kernels/gather_reduce.py:38"),
    "cache_probe_gather": ("src/repro_torch/kernels/csrc/cache_probe_gather.cu",
                           "src/repro/kernels/cache_gather.py:79"),
    "cache_probe_compact": ("src/repro_torch/kernels/csrc/cache_probe_compact.cu",
                            "src/repro/kernels/cache_gather.py:170"),
}


def fail(msg):
    """Abort the run: message to stderr, nonzero exit, no result line."""
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    """``fail(msg)`` unless ``cond``."""
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- helpers

def populated_cache(torch, c, d, assoc, seed, dev, dtype=None):
    """A cache block with unique keys per set, its id pool and a numpy rng."""
    import numpy as np
    from repro_torch.core.feature_cache import hash_slots
    rng = np.random.default_rng(seed)
    n_sets = c // assoc
    pool = rng.choice(10 * c, size=c, replace=False).astype(np.int32)
    sets = hash_slots(torch.from_numpy(pool), n_sets).numpy()
    keys = np.full(c, -1, np.int32)
    fill = np.zeros(n_sets, np.int64)
    for pid, s in zip(pool, sets):
        if fill[s] < assoc:
            keys[s * assoc + fill[s]] = pid
            fill[s] += 1
    rows = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    return (torch.from_numpy(keys).to(dev),
            rows.to(dev, dtype or torch.float32), pool, rng)


def probe_ids(rng, pool, shape, c):
    """Half resident ids, half random, ~10% the -1 sentinel."""
    import numpy as np
    ids = np.where(rng.random(shape) < 0.5, rng.choice(pool, size=shape),
                   rng.integers(0, 10 * c, shape)).astype(np.int32)
    ids[rng.random(shape) < 0.1] = -1
    return ids


def gpu_ms(torch, fn, reps=30):
    """Median device time of ``fn`` in ms: the launches are queued behind a
    device-side sleep so host overhead never shows between the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(min(2e9 * host_s * (reps + 4), 2e10)))
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def bound(n_bytes, n_ops):
    """Least time (ms) for the work, and which term sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases

def phase_kernels(torch, dev):
    """Each kernel against its twin on the card, serve shapes + edge cases."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 0
    for (m, k, d), dtype, tol in (((128, 40, 128), torch.float32, None),
                                  ((5120, 20, 128), torch.float32, None),
                                  ((128, 40, 256), torch.float32, None),
                                  ((37, 9, 130), torch.float32, None),
                                  ((5120, 20, 128), torch.bfloat16, 2e-2),
                                  ((37, 9, 130), torch.bfloat16, 2e-2)):
        x = torch.randn((m, k, d), generator=gen, device=dev).to(dtype)
        mask = torch.rand((m, k), generator=gen, device=dev) < 0.7
        mask[:3] = False
        got, want = ops.fanout_mean(x, mask), ref.fanout_mean_ref(x, mask)
        rtol, atol = (1e-5, 1e-6) if tol is None else (tol, tol)
        check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
              f"fanout_mean {m, k, d} {dtype} disagrees with its twin: max "
              f"err {(got.float() - want.float()).abs().max().item()}")
        n += 1
    for c, d, r, assoc, dtype in ((4096, 128, 26912, 4, torch.float32),
                                  (4096, 128, 333, 1, torch.float32),
                                  (256, 40, 1000, 2, torch.float32),
                                  (4, 8, 77, 4, torch.float32),
                                  (256, 130, 333, 4, torch.bfloat16)):
        keys, rows, pool, rng = populated_cache(torch, c, d, assoc, c + r,
                                                dev, dtype)
        ids = torch.from_numpy(probe_ids(rng, pool, (r,), c)).to(dev)
        for a, b in zip(ops.cache_probe_gather(keys, rows, ids, assoc=assoc),
                        ref.cache_probe_gather_ref(keys, rows, ids,
                                                   assoc=assoc)):
            check(torch.equal(a, b), f"cache_probe_gather c={c} r={r} "
                  f"assoc={assoc} {dtype} disagrees with its twin")
        n += 1
    for c, d, h, w, r, assoc, caps in (
            (4096, 128, 4, 4, 13464, 4, (1, 6732, 1 << 20)),
            (4096, 128, 1, 4, 333, 1, (1, 40, 333)),
            (256, 40, 2, 3, 1000, 2, (1, 100)),
            (4, 8, 1, 2, 77, 4, (1, 5))):
        blocks = [populated_cache(torch, c, d, assoc, c + r + i, dev)
                  for i in range(h)]
        keys = torch.stack([bk[0] for bk in blocks])
        rows = torch.stack([bk[1] for bk in blocks])
        ids = torch.from_numpy(np.stack([probe_ids(bk[3], bk[2], (w, r), c)
                                         for bk in blocks])).to(dev)
        for hit_cap in caps:
            for a, b in zip(
                    ops.cache_probe_compact(keys, rows, ids, assoc=assoc,
                                            hit_cap=hit_cap),
                    ref.cache_probe_compact_ref(keys, rows, ids, assoc=assoc,
                                                hit_cap=hit_cap)):
                check(torch.equal(a, b), f"cache_probe_compact c={c} h={h} "
                      f"w={w} r={r} assoc={assoc} hit_cap={hit_cap} "
                      f"disagrees with its twin")
            n += 1
    torch.cuda.synchronize()
    print(f"[kernels] {n} kernel-vs-twin checks passed on the card")


def serve_args(w):
    """graphgen-gcn serving flags of the main path: 20 000 nodes (the
    reference serve driver's default), 8 warmup sweeps, buckets (8, 16, 32),
    64 requests."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", "graphgen-gcn", "--workers", str(w), "--device", "cuda",
        "--nodes", str(N_NODES), "--warmup-sweeps", "8",
        "--buckets", "8,16,32", "--requests", str(N_REQUESTS)])


def phase_serve(torch):
    """build_server + serve_gcn at W = 1 and W = 4 (the warmup sweeps, the
    ladder and the requests all count); returns per-W results, launches
    and the ``(server, head_order)`` each run built and warmed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    path_kernels = {1: ("cache_probe_gather", "fanout_mean"),
                    4: ("cache_probe_compact", "fanout_mean")}
    results = {}
    for w, kernels in path_kernels.items():
        ops.reset_launch_counts()
        args = serve_args(w)
        built = serve.build_server(args)
        res = serve.serve_gcn(args, built)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        res["launches"] = counts
        res["built"] = built
        results[w] = res
        print(f"[serve W={w}] p50 {res['p50_ms']:.3f} ms  p99 "
              f"{res['p99_ms']:.3f} ms  QPS {res['qps']:.2f}  "
              f"({res['n_requests']} requests, {res['wall_s']:.2f} s)  "
              f"launches {counts}")
        for name in kernels:
            check(counts[name] > 0, f"W={w}: kernel {name} never launched "
                  f"on its path")
        check(res["request_path_compiles"] == 0,
              f"W={w}: requests added step shapes outside the ladder")
        check(res["startup_compiles"] == 3, f"W={w}: ladder ran "
              f"{res['startup_compiles']} step shapes, expected 3")
        check(res["n_classes"] == 64, "graphgen-gcn predicts 64 classes")
        check(res["n_requests"] == N_REQUESTS, f"W={w}: served "
              f"{res['n_requests']} of {N_REQUESTS} requests")
    return results


def phase_agree(torch, dev):
    """The port on the card vs on the CPU at a small size, same draws."""
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import (SeededDraws,
                                             make_distributed_generator,
                                             make_generator_fn)
    from repro_torch.core.partition import partition_edges
    from repro_torch.graph.synthetic import (node_features, node_labels,
                                             powerlaw_graph)
    from repro_torch.launch import serve
    from repro_torch.models.gcn import init_gcn

    cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                              cache_rows=64, cache_hit_cap=2)
    cache_cfg = CacheConfig.from_model(cfg)
    cpu_draws = SeededDraws(cfg.fanouts, 3, "cpu")
    g = powerlaw_graph(2000, n_hot=2, seed=3)
    feats, labels = node_features(2000, cfg.gcn_in_dim, 3), node_labels(
        2000, cfg.n_classes, 3)
    head = np.argsort(-np.diff(g.indptr)).astype(np.int32)[:256]
    for w in (1, 4):
        part = partition_edges(g, w)
        sides = {}
        for where in ("cpu", dev):
            def draws(n, nw, b, where=where):
                return tuple((o.to(where), e.to(where))
                             for o, e in cpu_draws(n, nw, b))
            gen_mut, args, cache0 = make_distributed_generator(
                part, feats, labels, fanouts=cfg.fanouts,
                cache_cfg=cache_cfg, device=where)
            warm = serve.warmup_sweep(gen_mut, args, cache0, head,
                                      n_workers=w, bucket=16, sweeps=3,
                                      draws=draws)
            server = serve.GraphServer(
                make_generator_fn(fanouts=cfg.fanouts,
                                  cache_cfg=cache_cfg.serve_view()),
                args, init_gcn(cfg, 3, device=where), warm, draws=draws,
                buckets=(8, 16), n_workers=w)
            sides[where] = server
        for a, b in zip(sides["cpu"].cache, sides[dev].cache):
            check(torch.equal(a, b.cpu()),
                  f"W={w}: warm cache differs between the card and the CPU")
        rng = np.random.default_rng(w)
        demoted = 0
        for size in (5, 16 * w, 3, 11):
            ids = head[rng.integers(0, head.size, size)]
            bc, bg = sides["cpu"].generate(ids), sides[dev].generate(ids)
            for name in ("seeds", "x_seed", "labels", "n_dropped",
                         "n_cache_hits", "n_cache_misses", "n_probe_demoted"):
                check(torch.equal(getattr(bc, name),
                                  getattr(bg, name).cpu()),
                      f"W={w}: batch field {name} differs card vs CPU")
            for name in ("hops", "masks", "x_hops"):
                for x, y in zip(getattr(bc, name), getattr(bg, name)):
                    check(torch.equal(x, y.cpu()),
                          f"W={w}: batch {name} differs card vs CPU")
            demoted += int(bg.n_probe_demoted.sum())
            lc = sides["cpu"].logits(ids)
            lg = sides[dev].logits(ids).cpu()
            check(torch.isfinite(lg).all() and lg.shape == lc.shape,
                  f"W={w}: logits not finite or misshapen")
            check(torch.allclose(lg, lc, rtol=1e-5, atol=1e-5),
                  f"W={w}: logits differ card vs CPU by "
                  f"{(lg - lc).abs().max().item()}")
        print(f"[agree W={w}] card == CPU: warm cache, batches exact, "
              f"logits within 1e-5 (probe demotions {demoted})")


def profile_requests(torch, server, next_ids, w, n=8):
    """Device busy time against wall time over ``n`` bucket-32 requests,
    from a ``torch.profiler`` trace (the profiler's own overhead inflates
    the wall time a little), and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server.serve(next_ids())
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device-side rows only (kernels, copies, sets): a CPU op's row repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if dev_ms <= 0:
        print(f"[profile W={w}] device time not measured (the profiler saw "
              f"no device activity); wall {wall_ms:.3f} ms/request")
        return
    print(f"[profile W={w}] per bucket-32 request: wall {wall_ms:.3f} ms, "
          f"device busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - dev_ms / wall_ms):.1f}%")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"[profile W={w}]   {e.self_device_time_total / 1e3 / n:8.4f} "
              f"ms/request  x{e.count / n:5.1f}  {e.key[:90]}")


def phase_timing(torch, serve_res, launches):
    """Per bucket-32 request, on the servers the serve phase built and
    warmed: kernel launches and a profiler trace; then kernel, twin and
    library-call times at the serve path's own inputs — a bucket-32
    request's batch, its deduplicated probe ids and the warm cache.  W = 1 times the gather probe; W = 4 (global batch 128) times
    fanout_mean at its three layer shapes and the compact probe.  Returns
    one JSON entry per kernel (fanout_mean at its largest shape)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import (dedup_requests, probe_hit_cap,
                                             probe_round_capacity, probe_send)
    from repro_torch.kernels import ops

    cfg = get_config("graphgen-gcn")
    entries = {}
    for w in (1, 4):
        server, head_order = serve_res[w]["built"]
        rng = np.random.default_rng(11)

        def bucket32():
            ranks = np.minimum(rng.zipf(1.5, 32 * w), head_order.size) - 1
            return head_order[ranks]

        ops.reset_launch_counts()
        server.serve(bucket32())
        print(f"[per-request W={w}] launches of one bucket-32 request: "
              f"{ops.launch_counts()}")
        profile_requests(torch, server, bucket32, w)
        batch = server.generate(bucket32())
        need = torch.cat([batch.seeds.reshape(w, -1)] + [
            h.reshape(w, -1) for h in batch.hops], dim=1)
        uniq, _, valid, _ = dedup_requests(need)
        if w == 1:
            items = [("cache_probe_gather", (server.cache.keys[0],
                                             server.cache.rows[0], uniq[0]),
                      {"assoc": cfg.cache_assoc})]
        else:
            k2 = cfg.fanouts[1]
            gen = torch.Generator(device=need.device).manual_seed(5)
            hidden = torch.randn(batch.x_hops[0].shape[:-1] + (cfg.gcn_hidden,),
                                 generator=gen, device=need.device)
            cap = probe_round_capacity(need.shape[1], w, 2.0)
            _, recv = probe_send(uniq, valid, cap, w)
            hc = probe_hit_cap(CacheConfig.from_model(cfg), cap)
            items = [
                ("fanout_mean", (batch.x_hops[1].reshape(-1, k2,
                                                         cfg.gcn_in_dim),
                                 batch.masks[1].reshape(-1, k2)), {}),
                ("fanout_mean", (batch.x_hops[0], batch.masks[0]), {}),
                ("fanout_mean", (hidden, batch.masks[0]), {}),
                ("cache_probe_compact", (server.cache.keys,
                                         server.cache.rows, recv),
                 {"assoc": cfg.cache_assoc, "hit_cap": hc})]
        for name, inputs, kw in items:
            inputs = tuple(t.contiguous() for t in inputs)
            entry = time_kernel(torch, name, inputs, kw)
            entry["launches"] = launches[name]
            entries.setdefault(name, entry)
    return [entries[name] for name in KERNEL_META]


def time_kernel(torch, name, inputs, kw):
    """Times, error and bound of one kernel at ``inputs``.  The bound counts
    each input byte read once and each output byte written once; for the
    probes only the rows the hits need are counted (data-dependent)."""
    from repro_torch.kernels import ops, ref
    kern_fn = getattr(ops, name)
    plain_fn = getattr(ref, name + "_ref")
    kern = lambda: kern_fn(*inputs, **kw)              # noqa: E731
    plain = lambda: plain_fn(*inputs, **kw)            # noqa: E731
    got, want = kern(), plain()
    library_ms = None
    if name == "fanout_mean":
        x, mask = inputs
        m, k, d = x.shape
        err = (got.float() - want.float()).abs().max().item()
        # the one-call yardstick: a batched matmul of the normalised mask
        # with x (the normalisation is precomputed and not timed)
        wts = mask.float() / mask.float().sum(1, keepdim=True).clamp(min=1)
        wts = wts[:, None, :].contiguous()
        library_ms = gpu_ms(torch, lambda: torch.bmm(wts, x))
        n_bytes = x.numel() * x.element_size() + mask.numel() + m * d * 4
        n_ops = 2 * m * k * d + m * d
    elif name == "cache_probe_gather":
        keys, rows, ids = inputs
        for a, b in zip(got, want):
            check(torch.equal(a, b), "gather probe differs from its twin at "
                  "the serve inputs")
        err = (got[1] - want[1]).abs().max().item()
        r, d = ids.shape[0], rows.shape[1]
        n_hit_rows = int(torch.unique(ids[got[0]]).numel())
        n_bytes = (r * 4 + keys.numel() * 4 + n_hit_rows * d * 4
                   + r + r * d * 4)
        n_ops = r * (2 + kw["assoc"])
    else:
        keys, rows, ids = inputs
        for a, b in zip(got, want):
            check(torch.equal(a, b), "compact probe differs from its twin at "
                  "the serve inputs")
        err = (got[2] - want[2]).abs().max().item()
        h, w, r = ids.shape
        d = rows.shape[2]
        n_words, hc = got[0].shape[-1], got[2].shape[-2]
        kept = sum(bin(v & 0xFFFFFFFF).count("1")
                   for v in got[0].reshape(-1).tolist())
        n_bytes = (ids.numel() * 4 + keys.numel() * 4 + kept * d * 4
                   + 2 * h * w * n_words * 4 + h * w * hc * d * 4)
        n_ops = ids.numel() * (2 + kw["assoc"])
    ms = gpu_ms(torch, kern)
    plain_ms = gpu_ms(torch, plain, reps=20)
    b_ms, b_by = bound(n_bytes, n_ops)
    print(f"[timing {name}] shapes {[list(t.shape) for t in inputs]} kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
          f"({b_by}: {n_bytes} B, {n_ops} ops)  library "
          f"{'null' if library_ms is None else f'{library_ms:.4f} ms'}  "
          f"max_abs_err {err}")
    src, replaces = KERNEL_META[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def main():
    """Run every phase; print the result lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (a first bring-up)")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # import the port only now: a directory holding chip_smoke.py and
    # nothing else of the repository fails here
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    phase_kernels(torch, dev)
    if opts.kernels_only:
        print("[kernels-only] stopping after the kernel checks")
        return
    serve_res = phase_serve(torch)
    launches = {name: serve_res[1]["launches"][name]
                + serve_res[4]["launches"][name]
                for name in KERNEL_META}
    phase_agree(torch, dev)
    kernels = phase_timing(torch, serve_res, launches)
    print(json.dumps({"serve": {f"W={w}": {k: r[k] for k in (
        "p50_ms", "p99_ms", "qps", "n_requests", "wall_s", "launches")}
        for w, r in serve_res.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
