"""The port's L3 host-RAM feature store against ``repro``.

Unit checks of ``core/host_store.py`` (validation, the prologue admit,
the gather at both depths, ``patch_batch`` bit-equal to the reference's,
the storage round trip's out-of-band buffers) and of the chunked host
feature table; the host fetch (``fetch_rows(store="host")``) against the
reference's at W = 1; the parity contract of
``tests/test_host_store.py`` (the host and device stores, pipelined and
offline loops: losses ``tobytes()``-equal); the port's host loop against
the reference's fed the same draws; and host generation rounds at W = 4
against the reference in ONE forced-4-device subprocess for the file.
Each tolerance is stated beside its comparison; everything but the
losses against the reference is exact."""
import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_parity import (assert_batch_equal, jax_round_draws,  # noqa: E402
                           run_forced, torch_draws)
from repro.core import feature_cache as jfc  # noqa: E402
from repro.core import generation as jgen  # noqa: E402
from repro.core import host_store as jhs  # noqa: E402
from repro.core.partition import partition_edges  # noqa: E402
from repro.graph import synthetic as jsyn  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import gcn_params_from_numpy  # noqa: E402
from repro_torch.core import feature_cache as tfc  # noqa: E402
from repro_torch.core import generation as tgen  # noqa: E402
from repro_torch.core.balance import balance_table  # noqa: E402
from repro_torch.core.config import TrainConfig  # noqa: E402
from repro_torch.core.host_store import (HostFeatureStore,  # noqa: E402
                                         HostMissRequest, empty_admit,
                                         patch_batch)
from repro_torch.core.pipeline import (_load_roundtrip,  # noqa: E402
                                       _store_roundtrip, offline_loop,
                                       pipelined_loop)
from repro_torch.graph.subgraph import SubgraphBatch  # noqa: E402
from repro_torch.graph.synthetic import (node_features,  # noqa: E402
                                         node_labels, powerlaw_graph)
from repro_torch.launch.train import make_gcn_train_fn  # noqa: E402
from repro_torch.models.gcn import init_gcn  # noqa: E402
from repro_torch.train.optimizer import init_adam  # noqa: E402


def test_store_validation_errors():
    """A 1-D table and a gather depth other than 1 or 2 fail at
    construction; so do a host generator without ``feat_dim``, a frozen
    cache on the host path and ``host_admit`` on the device store."""
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        HostFeatureStore(np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="host_gather_depth"):
        HostFeatureStore(np.zeros((8, 2), np.float32), depth=3)
    with pytest.raises(ValueError, match="feat_dim"):
        tgen.make_generator_fn(fanouts=(2,), feature_store="host")
    cfg = tfc.CacheConfig(16, mode="replicated").validated()
    with pytest.raises(ValueError, match="frozen"):
        tgen.make_generator_fn(fanouts=(2,), feature_store="host",
                               feat_dim=4, cache_cfg=cfg.serve_view())
    ids = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="host_admit"):
        tgen.fetch_rows(torch.zeros((1, 4, 2)), ids,
                        host_admit=empty_admit(1, 2, device="cpu"))
    with pytest.raises(ValueError, match="feat_dim"):
        tgen.fetch_rows(None, ids, store="host")


def test_empty_admit_shapes_admit_nothing():
    """The prologue admission: every id -1, one zero staging row."""
    ids, rows = empty_admit(4, 16, device="cpu")
    assert ids.shape == (4, 1) and rows.shape == (4, 1, 16)
    assert bool((ids == -1).all()) and float(rows.abs().max()) == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_gather_matches_table_and_zero_fills_padding(depth):
    """Both depths land the exact table rows for valid ids and zeros for
    -1 padding, the landed tensor equals the host buffer, and the byte
    and row telemetry accumulate per issue."""
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    store = HostFeatureStore(table, depth=depth)
    ids = torch.tensor([[3, -1, 7], [-1, 0, 9]], dtype=torch.int32)
    h = store.issue(ids)
    dev = h.rows().numpy()
    np.testing.assert_array_equal(dev, h.host_rows())
    want = np.where((ids.numpy() >= 0)[..., None],
                    table[np.clip(ids.numpy(), 0, 9)], 0)
    assert dev.tobytes() == want.astype(np.float32).tobytes()
    first = store.bytes_issued
    assert first == 6 * 4 + 6 * 4 * 4 and store.rows_issued == 4
    store.issue(ids).rows()
    assert store.bytes_issued == 2 * first and store.rows_issued == 8


def _patch_inputs(seed=0, w=2, b=2, fanouts=(3, 2), d=5, s=7):
    """A batch whose masked slots hold ``x * 0`` (``-0.0`` for negative
    x), a request of random slots and patch flags, and a landed buffer."""
    rng = np.random.default_rng(seed)
    masks, shape, parent = [], (w * b,), None
    for k in fanouts:
        shape = shape + (k,)
        m = rng.random(shape) < 0.7
        if parent is not None:
            m &= parent[..., None]
        masks.append(m)
        parent = m
    x_hops = [(rng.standard_normal(m.shape + (d,)).astype(np.float32)
               * m[..., None]) for m in masks]
    r = b * sum(int(np.prod(m.shape[1:])) for m in [np.ones((1,))] + masks)
    fields = dict(
        seeds=np.arange(w * b, dtype=np.int32),
        hops=tuple(np.zeros(m.shape, np.int32) for m in masks),
        masks=tuple(masks),
        x_seed=rng.standard_normal((w * b, d)).astype(np.float32),
        x_hops=tuple(x_hops),
        labels=np.zeros(w * b, np.int32), n_dropped=np.zeros(w, np.int32))
    req = dict(ids=rng.integers(-1, 50, (w, s)).astype(np.int32),
               slot=rng.integers(0, s, (w, r)).astype(np.int32),
               patch=rng.random((w, r)) < 0.4)
    landed = rng.standard_normal((w, s, d)).astype(np.float32)
    assert (np.signbit(x_hops[0]) & (x_hops[0] == 0)).any()
    return fields, req, landed


def test_patch_batch_bit_equal_to_reference():
    """``patch_batch`` on the same arrays as the reference's: every field,
    ``-0.0`` in masked slots included, ``tobytes()``-equal."""
    from repro.graph.subgraph import SubgraphBatch as JBatch
    fields, req, landed = _patch_inputs()
    jb = JBatch(**{k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                   else jnp.asarray(v) for k, v in fields.items()})
    want = jax.jit(jhs.patch_batch)(
        jb, jhs.HostMissRequest(**{k: jnp.asarray(v) for k, v in req.items()}),
        jnp.asarray(landed))
    tb = SubgraphBatch(**{k: tuple(map(torch.from_numpy, v))
                          if isinstance(v, tuple) else torch.from_numpy(v)
                          for k, v in fields.items()})
    got = patch_batch(tb, HostMissRequest(**{k: torch.from_numpy(v)
                                             for k, v in req.items()}),
                      torch.from_numpy(landed))
    assert got.x_seed.numpy().tobytes() == np.asarray(want.x_seed).tobytes()
    for g, w_ in zip(got.x_hops, want.x_hops):
        assert g.is_contiguous()
        assert g.numpy().tobytes() == np.asarray(w_).tobytes()


def test_store_roundtrip_serializes_buffers_out_of_band():
    """The offline storage path hands array bodies back as pickle-5
    out-of-band buffers, keeps them out of the header, and reads tensors
    and numpy leaves back bit-exactly."""
    payload = {"rows": np.arange(4096, dtype=np.float32).reshape(64, 64),
               "ids": torch.arange(64, dtype=torch.int32),
               "flag": (torch.arange(8) > 3, None)}
    header, buffers = _store_roundtrip(payload)
    assert len(buffers) >= 3, "array bodies were inlined, not out-of-band"
    assert len(header) < payload["rows"].nbytes // 2
    back = _load_roundtrip((header, buffers))
    assert torch.equal(back["rows"], torch.from_numpy(payload["rows"]))
    assert torch.equal(back["ids"], payload["ids"])
    assert torch.equal(back["flag"][0], payload["flag"][0])
    assert back["flag"][1] is None


def test_chunked_host_feature_table_is_bitwise_identical():
    """``features_on_host=True`` at chunks of 64, 256 and 65 536 rows:
    ``tobytes()``-equal to the reference's one-shot and chunked tables."""
    want = jsyn.node_features(1000, 8, seed=3)
    for chunk in (64, 256, 1 << 16):
        got = node_features(1000, 8, seed=3, features_on_host=True,
                            chunk_rows=chunk)
        assert got.tobytes() == want.tobytes(), chunk
        assert got.tobytes() == jsyn.node_features(
            1000, 8, seed=3, features_on_host=True,
            chunk_rows=chunk).tobytes(), chunk


def _jax_host_fetch(cfg, d):
    """The reference's host fetch at W = 1: ``(out, cache, fstats, cstats,
    req)`` (cache and cstats None when uncached)."""
    mesh = make_mesh((1,), ("data",))
    if cfg is None:
        def worker(i):
            out, fs, req = jgen.fetch_rows(None, i[0], "data", store="host",
                                           feat_dim=d)
            return out[None], fs, jax.tree.map(lambda a: a[None], req)
        fn = jax.jit(shard_map(worker, mesh=mesh, in_specs=(P("data"),),
                               out_specs=(P("data"), P(), P("data")),
                               check_rep=False))
        return lambda ids, *_: (lambda o, f, r: (o, None, f, None, r))(
            *fn(ids))

    def worker(i, s, ai, ar):
        s = jax.tree.map(lambda a: a[0], s)
        out, s, fs, cs, req = jgen.fetch_rows(
            None, i[0], "data", cache=s, cache_cfg=cfg, store="host",
            feat_dim=d, host_admit=(ai[0], ar[0]))
        return (out[None], jax.tree.map(lambda a: a[None], s), fs, cs,
                jax.tree.map(lambda a: a[None], req))
    return jax.jit(shard_map(worker, mesh=mesh, in_specs=(P("data"),) * 4,
                             out_specs=(P("data"), P("data"), P(), P(),
                                        P("data")), check_rep=False))


def _state_leaves(state):
    return (list(state.l1) + list(state.l2)) if hasattr(state, "l1") \
        else list(state)


@pytest.mark.parametrize("mode", [None, "replicated", "tiered"])
def test_host_fetch_rows_matches_reference(mode):
    """Four host fetches at W = 1 of a recurring stream, each admitting the
    previous one's landed rows: rows (zero holes), the staged request,
    the cache state and every ``FetchStats``/``CacheStats`` field
    (``n_l3_hits``, ``host_gather_bytes`` included) equal the
    reference's; the staged ids equal ``n_l3_hits``, and ``n_l1 +
    n_local + n_shard + n_l3 + n_misses`` is the distinct id count."""
    n, d = 96, 5
    table = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    ids = (np.random.default_rng(3).zipf(1.3, (3, 70)) % n).astype(np.int32)
    cfg = None
    if mode is not None:
        kw = dict(l1_rows=8, l1_promote=2) if mode == "tiered" else {}
        cfg = jfc.CacheConfig(32, admit=1, assoc=2, mode=mode,
                              store="host", **kw).validated()
    jfn = _jax_host_fetch(cfg, d)
    tcfg = tfc.CacheConfig(*cfg) if cfg is not None else None
    jstate = (jax.tree.map(jnp.asarray, jfc.init_cache_state(cfg, d, 1))
              if cfg is not None else None)
    tstate = (tfc.init_cache_state(tcfg, d, 1, device="cpu")
              if cfg is not None else None)
    adm = (np.full((1, 1), -1, np.int32), np.zeros((1, 1, d), np.float32))
    l3 = 0
    for step in range(4):
        batch = ids[step % 3][None]
        out, jstate, fs, cs, req = jfn(jnp.asarray(batch), jstate,
                                       *map(jnp.asarray, adm))
        kw = dict(cache=tstate, cache_cfg=tcfg,
                  host_admit=tuple(map(torch.from_numpy, adm))) \
            if cfg is not None else dict(store="host")
        res = tgen.fetch_rows(None, torch.from_numpy(batch), feat_dim=d,
                              **kw)
        if cfg is not None:
            tout, tstate, tfs, tcs, treq = res
        else:
            (tout, tfs, treq), tcs = res, None
        np.testing.assert_array_equal(tout.numpy(), np.asarray(out))
        for name, a, b in zip(("ids", "slot", "patch"), treq, req):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{step} req.{name}")
        pairs = list(zip(tfs._fields, tfs, fs))
        if cfg is not None:
            pairs += list(zip(tcs._fields, tcs, cs))
            for a, b in zip(_state_leaves(tstate), jax.tree.leaves(jstate)):
                assert a.numpy().tobytes() == np.asarray(b).tobytes()
            n_distinct = int(tgen.dedup_requests(torch.from_numpy(batch))[3])
            assert int(tcs.n_l1_hits + tcs.n_local_hits + tcs.n_shard_hits
                       + tcs.n_l3_hits + tcs.n_misses) == n_distinct
            assert int(tcs.n_l3_hits) == int((treq.ids >= 0).sum())
            l3 += int(tcs.n_l3_hits)
        for name, a, b in pairs:
            assert int(a[0]) == int(b), (step, name)
        assert int(tfs.host_gather_bytes[0]) > 0
        rows = np.where((treq.ids.numpy() >= 0)[..., None],
                        table[np.clip(treq.ids.numpy(), 0, n - 1)], 0)
        adm = (treq.ids.numpy(), rows.astype(np.float32))
    if cfg is not None:
        assert l3 > 0 and int(tcs.n_hits) > 0


def _setup(w, cached, store, depth=2, n=400, fanouts=(4, 3), dim=8,
           classes=5, b=6, steps=4, device="cpu"):
    """One generator + train_fn + schedule for the parity contract."""
    g = powerlaw_graph(n, avg_degree=6, seed=0)
    cc = None
    if cached:
        cc = tfc.CacheConfig(64, admit=1, assoc=2,
                             mode="replicated" if w == 1 else "sharded",
                             hit_cap=24 if w > 1 else 0).validated()
    out = tgen.make_distributed_generator(
        partition_edges(g, w), node_features(n, dim), node_labels(n, classes),
        fanouts=fanouts, cache_cfg=cc, feature_store=store,
        host_gather_depth=depth, device=device)
    cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                              gcn_in_dim=dim, n_classes=classes,
                              fanouts=fanouts)
    table = balance_table(np.arange(n), w, seed=0)
    sched = np.stack([table.per_worker[:, i * b:(i + 1) * b]
                      for i in range(steps)])
    return out, init_gcn(cfg, 0, device=device), sched


@pytest.mark.parametrize("w,cached,depth", [(1, False, 1), (1, False, 2),
                                            (1, True, 1), (1, True, 2),
                                            (4, True, 2)])
def test_host_pipelined_loss_parity_with_device_loops(w, cached, depth):
    """THE parity contract: the host-store pipelined loop (split dispatch,
    double-buffered gather, deferred admission) and the host offline loop
    give per-step losses ``tobytes()``-equal to the device store's
    pipelined and offline loops under the same schedule and draws — the
    L3 tier changes where features live, never a bit of what trains."""
    from repro_torch.core.generation import SeededDraws
    dev_out, model, sched = _setup(w, cached, "device")
    host_out, _, _ = _setup(w, cached, "host", depth)
    draws = SeededDraws((4, 3), 9, "cpu")
    train_fn = make_gcn_train_fn(TrainConfig(learning_rate=5e-3,
                                             total_steps=10))
    losses = {}
    for name, out in (("device", dev_out), ("host", host_out)):
        gen_fn, dargs = out[:2]
        store = out[2] if name == "host" else None
        cache = out[-1] if cached else None
        for loop in (pipelined_loop, offline_loop):
            m = copy.deepcopy(model)
            kw = dict(cache=copy.deepcopy(cache), host_store=store)
            res = loop(gen_fn, train_fn, dargs, sched, m,
                       init_adam(m.leaves()), draws, **kw)
            losses[name, loop.__name__] = res[2].numpy()
    want = losses["device", "pipelined_loop"]
    assert np.isfinite(want).all()
    for key, got in losses.items():
        assert got.tobytes() == want.tobytes(), (key, got, want)
    assert host_out[2].bytes_issued > 0 and host_out[2].rows_issued > 0


def test_host_loop_matches_reference_w1():
    """The port's host-store pipelined loop against the reference's at
    W = 1 (replicated cache, depth 2), fed the reference's weights and
    draws: each generation's counters, staged ids (``n_l3_hits``) and
    cache state exact; the losses within rtol 1e-4, as
    ``test_pipelined_loop_matches_reference`` holds them (float32
    reduction order in the GCN, compounded over the Adam steps)."""
    from repro.core.config import TrainConfig as JTrainConfig
    from repro.core.pipeline import pipelined_loop as jloop
    from repro.models import gcn as jgcn
    from repro.train.optimizer import adam_update, init_adam as jinit_adam
    n, fanouts, dim, classes, b, steps = 400, (4, 3), 8, 5, 6, 4
    g = powerlaw_graph(n, avg_degree=6, seed=0)
    feats, labels = node_features(n, dim), node_labels(n, classes)
    table = balance_table(np.arange(n), 1, seed=0)
    sched = np.stack([table.per_worker[:, i * b:(i + 1) * b]
                      for i in range(steps)])
    cfg = jfc.CacheConfig(64, admit=1, assoc=2, mode="replicated",
                          store="host").validated()
    mesh = make_mesh((1,), ("data",))
    jgen_fn, jargs, jstore, jcache = jgen.make_distributed_generator(
        mesh, partition_edges(g, 1), feats, labels, fanouts=fanouts,
        cache_cfg=cfg, feature_store="host")
    tgen_fn, targs, tstore, tcache = tgen.make_distributed_generator(
        partition_edges(g, 1), feats, labels, fanouts=fanouts,
        cache_cfg=tfc.CacheConfig(*cfg), feature_store="host",
        device="cpu")
    rng = jax.random.PRNGKey(5)
    rngs = jax.random.split(rng, steps + 1)
    hops = [jax_round_draws(rngs[t], 1, b, fanouts) for t in range(steps)]

    def draws(t, *_):
        return torch_draws(hops[t])

    # generation alone, admissions chained as the loops chain them
    ja = jhs.empty_admit(1, dim)
    ta = empty_admit(1, dim, device="cpu")
    jc, tc = jcache, tcache
    for t in range(steps):
        jb, jc, jreq = jgen_fn(jargs, jnp.asarray(sched[t]), rngs[t], jc,
                               *ja)
        tb, tc, treq = tgen_fn(targs, torch.from_numpy(sched[t]), draws(t),
                               tc, *ta)
        assert_batch_equal(jb, tb)
        np.testing.assert_array_equal(treq.ids.numpy(), np.asarray(jreq.ids))
        for a, b_ in zip(tc, jax.tree.leaves(jc)):
            assert a.numpy().tobytes() == np.asarray(b_).tobytes()
        ja = (jreq.ids, jstore.issue(jreq.ids).rows())
        ta = (treq.ids, tstore.issue(treq.ids).rows())
    assert int((treq.ids >= 0).sum()) > 0 and int(tb.n_cache_hits.sum()) > 0

    mcfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                               gcn_in_dim=dim, n_classes=classes,
                               fanouts=fanouts)
    params = jgcn.init_gcn(mcfg, jax.random.PRNGKey(0))
    kw = dict(learning_rate=5e-3, total_steps=10, warmup_steps=0)
    jtcfg = JTrainConfig(**kw)

    def jtrain(p, o, batch):
        loss, grads = jax.value_and_grad(jgcn.gcn_loss)(p, batch)
        p, o, _ = adam_update(jtcfg, p, grads, o)
        return p, o, loss
    *_, jl, _ = jloop(jgen_fn, jtrain, jargs, sched, params,
                      jinit_adam(params), rng, cache=jcache,
                      host_store=jstore)
    model = gcn_params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
    *_, tl, _ = pipelined_loop(
        tgen_fn, make_gcn_train_fn(TrainConfig(**kw)), targs, sched, model,
        init_adam(model.leaves()), draws, cache=tcache, host_store=tstore)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)


_REFERENCE_W4 = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.core import feature_cache as jfc
from repro.core import generation as jgen
from repro.core import host_store as jhs
from repro.core.partition import partition_edges
from repro.graph.synthetic import node_features, node_labels, powerlaw_graph
from repro.launch.mesh import make_mesh

W, fanouts, b = 4, (4, 3), 3
mesh = make_mesh((W,), ("data",))
g = powerlaw_graph(400, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
part = partition_edges(g, W)
feats, labels = node_features(400, 6), node_labels(400, 5)
head = np.argsort(-np.diff(g.indptr)).astype(np.int32)[:40]
out = {{}}
for mode, kw in {modes!r}:
    cfg = jfc.CacheConfig(mode=mode, store="host", **kw).validated()
    gen_fn, dargs, store, state = jgen.make_distributed_generator(
        mesh, part, feats, labels, fanouts=fanouts, cache_cfg=cfg,
        feature_store="host")
    adm = jhs.empty_admit(W, 6)
    rng = np.random.default_rng(4)
    for t in range({rounds}):
        p = f"{{mode}}{{t}}_"
        seeds = rng.choice(head, (W, b)).astype(np.int32)
        key = jax.random.PRNGKey(t)
        out[p + "in"] = seeds
        for l, (o, e) in enumerate(jax_round_draws(key, W, b, fanouts)):
            out[f"{{p}}offs{{l}}"], out[f"{{p}}e{{l}}"] = o, e
        batch, state, req = gen_fn(dargs, jnp.asarray(seeds), key, state,
                                   *adm)
        adm = (req.ids, store.issue(req.ids).rows())
        for name in ("ids", "slot", "patch"):
            out[p + "req_" + name] = np.asarray(getattr(req, name))
        for name in ("seeds", "x_seed", "labels", "n_dropped",
                     "n_cache_hits", "n_cache_misses", "n_probe_demoted"):
            out[p + name] = np.asarray(getattr(batch, name))
        for name in ("hops", "masks", "x_hops"):
            for l, a in enumerate(getattr(batch, name)):
                out[f"{{p}}{{name}}{{l}}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(state)):
            out[f"{{p}}c{{i}}"] = np.asarray(a)
np.savez({path!r}, **out)
print("SAVED")
"""

#: W = 4 host-store cells: graphgen-gcn's sharded cache and
#: graphgen-gcn-deep's tiered one, cut to 64 rows (and a 16-row L1)
_W4_MODES = (("sharded", dict(n_rows=64, admit=1, assoc=4, hit_cap=12)),
             ("tiered", dict(n_rows=64, admit=1, assoc=4, l1_rows=16,
                             l1_promote=2)))
_W4_ROUNDS = 3


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    """The reference's W = 4 host generation rounds (both cache modes) in
    ONE forced-4-device subprocess."""
    path = str(tmp_path_factory.mktemp("host") / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE_W4.format(
        tests=os.path.dirname(__file__), modes=_W4_MODES, rounds=_W4_ROUNDS,
        path=path), devices=4)
    return np.load(path)


class _Saved:
    """Attribute view of one saved reference batch."""

    def __init__(self, ref, p, depth):
        for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                     "n_cache_misses", "n_probe_demoted"):
            setattr(self, name, ref[p + name])
        for name in ("hops", "masks", "x_hops"):
            setattr(self, name, tuple(ref[f"{p}{name}{l}"]
                                      for l in range(depth)))


@pytest.mark.parametrize("mode", [m for m, _ in _W4_MODES])
def test_host_generation_w4_matches_reference(reference_w4, mode):
    """W = 4 host-store generation rounds on the stacked worker axis, each
    admitting the previous round's landed rows (routed to the shard
    holders; into the L2 in tiered mode): batches with their zero holes,
    the staged requests and every worker's cache state exact against the
    reference's ``shard_map``."""
    ref = reference_w4
    kw = dict(_W4_MODES)[mode]
    cfg = tfc.CacheConfig(mode=mode, store="host", **kw).validated()
    g = powerlaw_graph(400, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    fanouts = (4, 3)
    gen_fn, dargs, store, state = tgen.make_distributed_generator(
        partition_edges(g, 4), node_features(400, 6), node_labels(400, 5),
        fanouts=fanouts, cache_cfg=cfg, feature_store="host", device="cpu")
    adm = empty_admit(4, 6, device="cpu")
    for t in range(_W4_ROUNDS):
        p = f"{mode}{t}_"
        draws = torch_draws([(ref[f"{p}offs{l}"], ref[f"{p}e{l}"])
                             for l in range(len(fanouts))])
        batch, state, req = gen_fn(dargs, torch.from_numpy(ref[p + "in"]),
                                   draws, state, *adm)
        adm = (req.ids, store.issue(req.ids).rows())
        assert_batch_equal(_Saved(ref, p, len(fanouts)), batch)
        for name in ("ids", "slot", "patch"):
            np.testing.assert_array_equal(getattr(req, name).numpy(),
                                          ref[p + "req_" + name])
        for i, a in enumerate(_state_leaves(state)):
            assert a.numpy().tobytes() == ref[f"{p}c{i}"].tobytes(), (t, i)
    assert int(batch.n_cache_hits.sum()) > 0 and store.rows_issued > 0


@pytest.mark.cuda
def test_pinned_side_stream_gather_on_card():
    """On the card: the depth-2 gather (worker thread, pinned buffer, copy
    on the store's own stream) lands the same rows as depth 1 and as the
    table, on the device, while the table stays in host RAM; a host loop
    at depth 2 gives the device store's losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.core.generation import SeededDraws
    table = np.random.default_rng(0).standard_normal((5000, 64)).astype(
        np.float32)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        -1, 5000, (4, 3000)).astype(np.int32)).cuda()
    got = {}
    for depth in (1, 2):
        store = HostFeatureStore(table, depth=depth)
        h = store.issue(ids)
        rows = h.rows()
        assert rows.is_cuda and h.host_rows().shape == (4, 3000, 64)
        got[depth] = rows.clone()
    assert torch.equal(got[1], got[2])
    idn = ids.cpu().numpy()
    want = np.where((idn >= 0)[..., None], table[np.clip(idn, 0, None)], 0)
    assert torch.equal(got[2].cpu(), torch.from_numpy(want))
    losses = []
    for kind in ("device", "host"):
        out, model, sched = _setup(1, True, kind, device="cuda")
        train_fn = make_gcn_train_fn(TrainConfig(learning_rate=5e-3,
                                                 total_steps=10))
        res = pipelined_loop(out[0], train_fn, out[1], sched, model,
                             init_adam(model.leaves()),
                             SeededDraws((4, 3), 9, "cuda"), cache=out[-1],
                             host_store=out[2] if kind == "host" else None)
        losses.append(res[2].cpu())
    assert torch.equal(losses[0], losses[1])
