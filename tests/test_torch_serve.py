"""The whole serving slice against ``repro``: warm the cache with the
mutable generator, freeze it, serve Zipf requests through the bucket
ladder and the GCN — at W = 1 and at W = 4 on the stacked worker axis.

The reference runs in ONE subprocess per W (forced host devices) and
writes everything compared: its draws, the warm cache state, the served
batches and logits, and its GCN weights.  The port then replays the same
draws on the CPU.  Cache states, batch ids, masks, features and counters
must be equal; logits agree within rtol 1e-5 / atol 1e-5 (float32 matmul
reduction order), and predictions wherever the top-2 margin exceeds
1e-4."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_batch_equal, run_forced,  # noqa: E402
                           torch_draws)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import gcn_params_from_numpy  # noqa: E402
from repro_torch.core.feature_cache import CacheConfig  # noqa: E402
from repro_torch.core.generation import (make_distributed_generator,  # noqa: E402
                                         make_generator_fn)
from repro_torch.core.partition import partition_edges  # noqa: E402
from repro_torch.graph.synthetic import (node_features, node_labels,  # noqa: E402
                                         powerlaw_graph)
from repro_torch.launch import serve  # noqa: E402

N_NODES, SEED, SWEEPS, N_REQ = 400, 0, 3, 4
BUCKETS = (4, 8)
#: graphgen-gcn's smoke config with a cache small enough to evict, and a
#: payload bound small enough that the compact wire demotes hits
OVERRIDES = dict(cache_rows=32, cache_hit_cap=6)

_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.configs import get_config, smoke_config
from repro.core.feature_cache import CacheConfig
from repro.core.generation import make_distributed_generator, make_generator_fn
from repro.core.partition import partition_edges
from repro.graph.synthetic import node_features, node_labels, powerlaw_graph
from repro.launch.mesh import make_mesh
from repro.launch.serve import _zipf_request_stream, bucket_for, warmup_sweep
from repro.models import gcn

W, N, SEED, SWEEPS, N_REQ, BUCKETS = {w}, {n}, {seed}, {sweeps}, {n_req}, {buckets}
cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")), **{overrides})
cache_cfg = CacheConfig.from_model(cfg)
mesh = make_mesh((W,), ("data",))
g = powerlaw_graph(N, n_hot=max(N // 1000, 1), seed=SEED)
part = partition_edges(g, W)
feats = node_features(N, cfg.gcn_in_dim, SEED)
labels = node_labels(N, cfg.n_classes, SEED)
params = gcn.init_gcn(cfg, jax.random.PRNGKey(SEED))
head_order = np.argsort(-np.diff(g.indptr)).astype(np.int32)
out = {{}}
for i, lyr in enumerate(params.layers):
    for name, a in zip(("w_self", "w_nbr", "b"), lyr):
        out[f"p{{i}}_{{name}}"] = np.asarray(a)
out["w_out"], out["b_out"] = np.asarray(params.w_out), np.asarray(params.b_out)

gen_mut, dev_args, cache0 = make_distributed_generator(
    mesh, part, feats, labels, fanouts=cfg.fanouts, cache_cfg=cache_cfg)
head = head_order[:max(BUCKETS[-1] * W, cache_cfg.n_rows)]
rng0 = jax.random.PRNGKey(SEED)
for t in range(SWEEPS):
    for l, (o, e) in enumerate(jax_round_draws(jax.random.fold_in(rng0, t), W,
                                               BUCKETS[-1], cfg.fanouts)):
        out[f"warm{{t}}_offs{{l}}"], out[f"warm{{t}}_e{{l}}"] = o, e
warm = warmup_sweep(gen_mut, dev_args, cache0, head, n_workers=W,
                    bucket=BUCKETS[-1], sweeps=SWEEPS, seed=SEED)
for name, a in zip(("keys", "rows", "tags", "counts"), warm):
    out["warm_" + name] = np.asarray(a)

gen_serve = jax.jit(make_generator_fn(mesh, fanouts=cfg.fanouts,
                                      cache_cfg=cache_cfg.serve_view()))
forward = jax.jit(gcn.gcn_forward)
stream = _zipf_request_stream(np.random.default_rng(SEED + 7), N_REQ,
                              head_order, BUCKETS[-1] * W)
for n, ids in enumerate(stream):
    b = bucket_for(ids.size, BUCKETS, W)
    padded = np.empty(b * W, np.int32)
    padded[:ids.size] = ids
    padded[ids.size:] = ids[-1]
    key = jax.random.fold_in(rng0, n)
    for l, (o, e) in enumerate(jax_round_draws(key, W, b, cfg.fanouts)):
        out[f"req{{n}}_offs{{l}}"], out[f"req{{n}}_e{{l}}"] = o, e
    batch = gen_serve(dev_args, jnp.asarray(padded.reshape(W, b)), key, warm)
    out[f"req{{n}}_ids"] = ids
    out[f"req{{n}}_logits"] = np.asarray(forward(params, batch))[:ids.size]
    for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                 "n_cache_misses", "n_probe_demoted"):
        out[f"req{{n}}_{{name}}"] = np.asarray(getattr(batch, name))
    for name in ("hops", "masks", "x_hops"):
        for l, a in enumerate(getattr(batch, name)):
            out[f"req{{n}}_{{name}}{{l}}"] = np.asarray(a)
np.savez({path!r}, **out)
print("SAVED")
"""


class _Saved:
    """Attribute view of one request's saved reference batch."""

    def __init__(self, ref, n, depth):
        p = f"req{n}_"
        for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                     "n_cache_misses", "n_probe_demoted"):
            setattr(self, name, ref[p + name])
        for name in ("hops", "masks", "x_hops"):
            setattr(self, name, tuple(ref[f"{p}{name}{l}"]
                                      for l in range(depth)))


def _draws(ref, prefix, depth):
    return torch_draws([(ref[f"{prefix}_offs{l}"], ref[f"{prefix}_e{l}"])
                        for l in range(depth)])


@pytest.mark.parametrize("w", [1, 4])
def test_serving_slice_matches_reference(w, tmp_path):
    """Warm state equal after the sweeps; every served batch equal; logits
    allclose; predictions equal wherever the top-2 margin is clear."""
    path = str(tmp_path / "ref.npz")
    out = run_forced(_REFERENCE.format(
        tests=os.path.dirname(__file__), w=w, n=N_NODES, seed=SEED,
        sweeps=SWEEPS, n_req=N_REQ, buckets=BUCKETS, overrides=OVERRIDES,
        path=path), devices=w)
    assert "SAVED" in out
    ref = np.load(path)

    cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                              **OVERRIDES)
    depth = len(cfg.fanouts)
    cache_cfg = CacheConfig.from_model(cfg)
    g = powerlaw_graph(N_NODES, n_hot=max(N_NODES // 1000, 1), seed=SEED)
    part = partition_edges(g, w)
    feats = node_features(N_NODES, cfg.gcn_in_dim, SEED)
    labels = node_labels(N_NODES, cfg.n_classes, SEED)
    head_order = np.argsort(-np.diff(g.indptr)).astype(np.int32)
    gen_mut, args, cache0 = make_distributed_generator(
        part, feats, labels, fanouts=cfg.fanouts, cache_cfg=cache_cfg,
        device="cpu")
    head = head_order[:max(BUCKETS[-1] * w, cache_cfg.n_rows)]
    warm = serve.warmup_sweep(
        gen_mut, args, cache0, head, n_workers=w, bucket=BUCKETS[-1],
        sweeps=SWEEPS, draws=lambda t, *_: _draws(ref, f"warm{t}", depth))
    for name, got in zip(("keys", "rows", "tags", "counts"), warm):
        assert got.numpy().tobytes() == ref["warm_" + name].tobytes(), name

    params = ([tuple(ref[f"p{i}_{k}"] for k in ("w_self", "w_nbr", "b"))
               for i in range(depth)], ref["w_out"], ref["b_out"])
    gen_serve = make_generator_fn(fanouts=cfg.fanouts,
                                  cache_cfg=cache_cfg.serve_view())
    server = serve.GraphServer(
        gen_serve, args, gcn_params_from_numpy(params, device="cpu"), warm,
        draws=lambda n, *_: _draws(ref, f"req{n}", depth),
        buckets=BUCKETS, n_workers=w)
    demoted = 0
    for n in range(N_REQ):
        ids = ref[f"req{n}_ids"]
        b = serve.bucket_for(ids.size, BUCKETS, w)
        padded = np.concatenate([ids, np.full(b * w - ids.size, ids[-1])])
        batch = gen_serve(args, torch.from_numpy(
            padded.astype(np.int32).reshape(w, b)),
            _draws(ref, f"req{n}", depth), warm)
        assert_batch_equal(_Saved(ref, n, depth), batch)
        demoted += int(batch.n_probe_demoted.sum())
        logits = server.logits(ids).numpy()
        want = ref[f"req{n}_logits"]
        np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(logits.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
    # the frozen view never touched the warm state
    for name, got in zip(("keys", "rows", "tags", "counts"), warm):
        assert got.numpy().tobytes() == ref["warm_" + name].tobytes(), name
    assert server.compile_count() <= len(BUCKETS)
    if w > 1:
        assert demoted > 0, "the compact wire's demotion path never ran"


def test_graph_server_ladder_and_determinism():
    """Warmup runs one step shape per bucket and requests add none; two
    same-seed servers answer identically; oversized requests raise."""
    args = serve.parse_args(["--smoke", "--device", "cpu", "--nodes", "300",
                             "--buckets", "4,8", "--warmup-sweeps", "2"])
    servers = [serve.build_server(args)[0] for _ in range(2)]
    assert servers[0].warmup() == 2
    servers[1].warmup()
    rng = np.random.default_rng(0)
    for size in (1, 3, 8, 5):
        ids = rng.integers(0, 300, size)
        pa, pb = servers[0].serve(ids), servers[1].serve(ids)
        np.testing.assert_array_equal(pa, pb)
        assert pa.shape == (size,) and pa.dtype == np.int32
        assert ((pa >= 0) & (pa < 5)).all()
    assert servers[0].compile_count() == 2
    with pytest.raises(ValueError, match="exceeds"):
        servers[0].serve(np.zeros(9, np.int32))


def test_serve_without_card_raises():
    """Asking for cuda where there is none raises; nothing drops to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = serve.parse_args(["--smoke", "--nodes", "300"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve_gcn(args)


@pytest.mark.parametrize("build", ["init_gcn", "gcn_params_from_numpy",
                                   "init_cache_state"])
def test_constructors_default_to_cuda(build):
    """The model and cache-state constructors build on cuda unless asked
    for the CPU: without a card the default raises, ``device="cpu"``
    builds there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.core.feature_cache import init_cache_state
    from repro_torch.models.gcn import init_gcn
    cfg = smoke_config(get_config("graphgen-gcn"))
    cpu_model = init_gcn(cfg, 0, device="cpu")
    params_np = (tuple(tuple(t.detach().numpy() for t in (
        lyr.w_self, lyr.w_nbr, lyr.b)) for lyr in cpu_model.layers),
        cpu_model.w_out.detach().numpy(), cpu_model.b_out.detach().numpy())
    make = {
        "init_gcn": lambda **kw: init_gcn(cfg, 0, **kw),
        "gcn_params_from_numpy": lambda **kw: gcn_params_from_numpy(
            params_np, **kw),
        "init_cache_state": lambda **kw: init_cache_state(
            CacheConfig.from_model(cfg), cfg.gcn_in_dim, 1, **kw),
    }[build]
    with pytest.raises(RuntimeError, match="cuda"):
        make()
    built = make(device="cpu")
    assert all(t.device.type == "cpu" for t in (
        built.parameters() if isinstance(built, torch.nn.Module) else built))


def test_gcn_forward_and_loss_match_reference():
    """The GCN on one random batch with the reference's weights carried
    over by ``convert``: logits and loss within rtol/atol 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.graph.subgraph import SubgraphBatch as JBatch
    from repro.models import gcn as jgcn
    from repro_torch.graph.subgraph import SubgraphBatch
    from repro_torch.models.gcn import gcn_forward, gcn_loss

    cfg = smoke_config(get_config("graphgen-gcn"))
    rng = np.random.default_rng(0)
    b, (k1, k2), d = 6, cfg.fanouts, cfg.gcn_in_dim
    m1 = rng.random((b, k1)) < 0.8
    m2 = (rng.random((b, k1, k2)) < 0.7) & m1[..., None]
    fields = dict(
        seeds=np.arange(b, dtype=np.int32),
        hops=(np.zeros((b, k1), np.int32), np.zeros((b, k1, k2), np.int32)),
        masks=(m1, m2),
        x_seed=rng.standard_normal((b, d)).astype(np.float32),
        x_hops=tuple((rng.standard_normal(m.shape + (d,)) * m[..., None])
                     .astype(np.float32) for m in (m1, m2)),
        labels=rng.integers(0, cfg.n_classes, b).astype(np.int32),
        n_dropped=np.zeros(1, np.int32))
    params = jgcn.init_gcn(cfg, jax.random.PRNGKey(3))
    jb = JBatch(**{k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                   else jnp.asarray(v) for k, v in fields.items()})
    tb = SubgraphBatch(**{k: tuple(map(torch.from_numpy, v))
                          if isinstance(v, tuple) else torch.from_numpy(v)
                          for k, v in fields.items()})
    model = gcn_params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(gcn_forward(model, tb).numpy(),
                                   np.asarray(jgcn.gcn_forward(params, jb)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(gcn_loss(model, tb)),
                                   float(jgcn.gcn_loss(params, jb)),
                                   rtol=1e-5, atol=1e-5)
