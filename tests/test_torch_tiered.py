"""Parity of the port's tiered cache (a replicated L1 in front of the
sharded L2, ``graphgen-gcn-deep``'s cache) with ``repro``.

``tiered_probe`` against the reference's; cached fetches and whole
generation rounds — the mutable tier over several rounds, then the frozen
serve view — at W = 1 in process and at W = 4 on the stacked worker axis
against the reference in one forced-4-device subprocess.  Both tiers'
keys, tags, counts and rows, every batch field and every ``CacheStats``
field (``n_l1_hits`` included) must be equal: nothing here is floating
point arithmetic, so every comparison is exact."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_parity import (assert_batch_equal, assert_state_equal,  # noqa: E402
                           jax_round_draws, run_forced, torch_draws)
from repro.core import feature_cache as jfc  # noqa: E402
from repro.core import generation as jgen  # noqa: E402
from repro.core.partition import partition_edges  # noqa: E402
from repro.graph.synthetic import (node_features, node_labels,  # noqa: E402
                                   powerlaw_graph)
from repro.launch.mesh import make_mesh  # noqa: E402
from repro_torch.core import feature_cache as tfc  # noqa: E402
from repro_torch.core import generation as tgen  # noqa: E402

#: graphgen-gcn-deep's cache, cut to an L1 of 16 rows and an L2 of 64
#: (the smallest sizes that still evict), promote after 2 observations
_TIERED = dict(n_rows=64, admit=2, mode="tiered", l1_rows=16, l1_promote=2)


def _tiered_cfg(assoc, wire="compact", hit_cap=0):
    return jfc.CacheConfig(assoc=assoc, wire=wire, hit_cap=hit_cap,
                           **_TIERED).validated()


def _assert_tiered_equal(jstate, tstate):
    """Both tiers of a (per-worker or stacked) state equal, bit for bit."""
    assert_state_equal(jstate.l1, tstate.l1)
    assert_state_equal(jstate.l2, tstate.l2)


@pytest.mark.parametrize("assoc", [1, 4])
def test_tiered_probe_matches_reference(assoc):
    """The fused two-tier probe with a valid mask: L1 priority on double
    hits, the L2-only hits, -1 ids masked out, and the layout check."""
    d, rng = 6, np.random.default_rng(assoc)
    cfg = _tiered_cfg(assoc)
    ids_pool = rng.choice(400, 80, replace=False).astype(np.int32)
    state = jfc.init_cache_state(cfg, d, 1)
    state = jax.tree.map(lambda a: jnp.asarray(a[0]), state)
    # populate both tiers through the reference's own insert, so keys are
    # unique per set; the L1's ids are a subset of the L2's (double hits)
    rows = rng.standard_normal((80, d)).astype(np.float32)
    ones = jnp.ones(80, bool)
    l2, _ = jfc.cache_insert(state.l2, jnp.asarray(ids_pool),
                             jnp.asarray(rows), ones,
                             cfg._replace(admit=1).l2_config())
    l1, _ = jfc.cache_insert(state.l1, jnp.asarray(ids_pool[:20]),
                             jnp.asarray(rows[:20] + 1), ones[:20],
                             cfg._replace(l1_promote=1).l1_config())
    jstate = jfc.TieredCache(l1=l1, l2=l2)
    tstate = tfc.TieredCache(*(tfc.FeatureCache(
        *(torch.tensor(np.asarray(a)) for a in tier)) for tier in jstate))
    probe = np.concatenate([ids_pool, rng.integers(400, 800, 30),
                            np.full(7, -1)]).astype(np.int32)
    valid = probe >= 0
    want = jfc.tiered_probe(jstate, jnp.asarray(probe), jnp.asarray(valid),
                            cfg=cfg)
    got = tfc.tiered_probe(tstate, torch.from_numpy(probe),
                           torch.from_numpy(valid), cfg=tfc.CacheConfig(*cfg))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].any() and got[1].any()
    assert not (got[0] & got[1]).any()
    with pytest.raises(ValueError, match="mismatched"):
        tfc.tiered_probe(tstate, torch.from_numpy(probe),
                         cfg=tfc.CacheConfig(*cfg)._replace(l1_rows=32))


def _jax_fetch(cfg):
    mesh = make_mesh((1,), ("data",))

    def worker(t, i, c):
        c = jax.tree.map(lambda a: a[0], c)
        out, c, fs, cs = jgen.fetch_rows(t, i[0], "data", cache=c,
                                         cache_cfg=cfg)
        return (out[None], jax.tree.map(lambda a: a[None], c), fs, cs)
    return jax.jit(shard_map(worker, mesh=mesh,
                             in_specs=(P(), P("data"), P("data")),
                             out_specs=(P("data"), P("data"), P(), P()),
                             check_rep=False))


@pytest.mark.parametrize("assoc", [1, 2, 4])
def test_tiered_fetch_rows_exact_w1(assoc):
    """Five cached fetches of a recurring Zipf stream (four mutable, then
    the frozen serve view): rows, both tiers and every counter equal,
    with L1 hits among them."""
    n, d = 96, 5
    table = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    cfg = _tiered_cfg(assoc)
    jstate = jax.tree.map(jnp.asarray, jfc.init_cache_state(cfg, d, 1))
    tstate = tfc.init_cache_state(tfc.CacheConfig(*cfg), d, 1, device="cpu")
    assert isinstance(tstate, tfc.TieredCache)
    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.3, (3, 70)) % n).astype(np.int32)
    n_l1 = 0
    for step, c in enumerate((cfg,) * 4 + (cfg.serve_view(),)):
        batch = ids[step % 3][None]
        out, jstate, fs, cs = _jax_fetch(c)(jnp.asarray(table),
                                            jnp.asarray(batch), jstate)
        tout, tstate, tfs, tcs = tgen.fetch_rows(
            torch.from_numpy(table)[None], torch.from_numpy(batch),
            cache=tstate, cache_cfg=tfc.CacheConfig(*c))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(out))
        _assert_tiered_equal(jax.tree.map(lambda a: a[0], jstate),
                             tstate.worker(0))
        for name, a, b in zip(fs._fields + cs._fields, tuple(tfs) + tuple(tcs),
                              tuple(fs) + tuple(cs)):
            assert int(a[0]) == int(b), (step, name)
        n_l1 += int(tcs.n_l1_hits[0])
    assert n_l1 > 0, "the L1 never served a hit"


def test_tiered_generation_rounds_exact_w1():
    """graphgen-gcn-deep-shaped rounds at W = 1 (fanouts (4, 3, 2), 4-way
    L2, 2-way L1): four mutable rounds, then two through the frozen serve
    view — batches and both tiers equal round by round."""
    g = powerlaw_graph(400, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    part = partition_edges(g, 1)
    fanouts, b, d = (4, 3, 2), 6, 6
    feats, labels = node_features(400, d), node_labels(400, 5)
    cfg = _tiered_cfg(4)
    mesh = make_mesh((1,), ("data",))
    jgen_fn, jargs, jstate = jgen.make_distributed_generator(
        mesh, part, feats, labels, fanouts=fanouts, cache_cfg=cfg)
    tgen_fn, targs, tstate = tgen.make_distributed_generator(
        part, feats, labels, fanouts=fanouts, cache_cfg=tfc.CacheConfig(*cfg),
        device="cpu")
    jserve = jgen.make_generator_fn(mesh, fanouts=fanouts,
                                    cache_cfg=cfg.serve_view())
    tserve = tgen.make_generator_fn(fanouts=fanouts,
                                    cache_cfg=tfc.CacheConfig(*cfg).serve_view())
    head = np.argsort(-np.diff(g.indptr)).astype(np.int32)[:40]
    rng = np.random.default_rng(4)
    for t in range(6):
        seeds = rng.choice(head, (1, b)).astype(np.int32)
        key = jax.random.PRNGKey(t)
        draws = torch_draws(jax_round_draws(key, 1, b, fanouts))
        if t < 4:
            jb, jstate = jgen_fn(jargs, jnp.asarray(seeds), key, jstate)
            tb, tstate = tgen_fn(targs, torch.from_numpy(seeds), draws,
                                 tstate)
        else:
            jb = jax.jit(jserve)(jargs, jnp.asarray(seeds), key, jstate)
            tb = tserve(targs, torch.from_numpy(seeds), draws, tstate)
        assert_batch_equal(jb, tb)
        _assert_tiered_equal(jax.tree.map(lambda a: a[0], jstate),
                             tstate.worker(0))
    assert int(tb.n_cache_hits[0]) > 0


_REFERENCE_W4 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.core import feature_cache as jfc, generation as jgen
from repro.core.partition import partition_edges
from repro.graph.synthetic import node_features, node_labels, powerlaw_graph
from repro.launch.mesh import make_mesh

W = 4
cfg = jfc.CacheConfig(assoc=4, wire="compact", hit_cap=12,
                      **{tiered!r}).validated()
mesh = make_mesh((W,), ("data",))
out = {{}}

# cached fetches on the stacked worker axis: five mutable, one frozen
n, d = 200, 4
table = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
ids = (np.random.default_rng(6).zipf(1.3, (3, W, 90)) % n).astype(np.int32)

def fetch(c):
    def worker(t, i, s):
        s = jax.tree.map(lambda a: a[0], s)
        o, s, fs, cs = jgen.fetch_rows(t, i[0], "data", cache=s, cache_cfg=c)
        return (o[None], jax.tree.map(lambda a: a[None], s),
                jax.tree.map(lambda a: a[None], fs),
                jax.tree.map(lambda a: a[None], cs))
    return jax.jit(shard_map(worker, mesh=mesh,
                             in_specs=(P("data"), P("data"), P("data")),
                             out_specs=P("data"), check_rep=False))

state = jax.device_put(jfc.init_cache_state(cfg, d, W),
                       NamedSharding(mesh, P("data")))
for step, c in enumerate((cfg,) * 5 + (cfg.serve_view(),)):
    o, state, fs, cs = fetch(c)(jnp.asarray(table), jnp.asarray(ids[step % 3]),
                                state)
    out[f"f{{step}}_out"] = np.asarray(o)
    for name, a in zip(fs._fields + cs._fields, tuple(fs) + tuple(cs)):
        out[f"f{{step}}_{{name}}"] = np.asarray(a)
    for tier in ("l1", "l2"):
        for name, a in zip(("keys", "rows", "tags", "counts"),
                           getattr(state, tier)):
            out[f"f{{step}}_{{tier}}_{{name}}"] = np.asarray(a)

# generation rounds (fanouts (4, 3, 2)): four mutable, two frozen
g = powerlaw_graph(400, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
part = partition_edges(g, W)
feats, labels = node_features(400, 6), node_labels(400, 5)
fanouts, b = (4, 3, 2), 3
gen_fn, dargs, gstate = jgen.make_distributed_generator(
    mesh, part, feats, labels, fanouts=fanouts, cache_cfg=cfg)
serve_fn = jax.jit(jgen.make_generator_fn(mesh, fanouts=fanouts,
                                          cache_cfg=cfg.serve_view()))
head = np.argsort(-np.diff(g.indptr)).astype(np.int32)[:40]
rng = np.random.default_rng(4)
for t in range(6):
    seeds = rng.choice(head, (W, b)).astype(np.int32)
    key = jax.random.PRNGKey(t)
    out[f"g{{t}}_in"] = seeds
    for l, (o, e) in enumerate(jax_round_draws(key, W, b, fanouts)):
        out[f"g{{t}}_offs{{l}}"], out[f"g{{t}}_e{{l}}"] = o, e
    if t < 4:
        batch, gstate = gen_fn(dargs, jnp.asarray(seeds), key, gstate)
    else:
        batch = serve_fn(dargs, jnp.asarray(seeds), key, gstate)
    for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                 "n_cache_misses", "n_probe_demoted"):
        out[f"g{{t}}_{{name}}"] = np.asarray(getattr(batch, name))
    for name in ("hops", "masks", "x_hops"):
        for l, a in enumerate(getattr(batch, name)):
            out[f"g{{t}}_{{name}}{{l}}"] = np.asarray(a)
    for tier in ("l1", "l2"):
        for name, a in zip(("keys", "rows", "tags", "counts"),
                           getattr(gstate, tier)):
            out[f"g{{t}}_{{tier}}_{{name}}"] = np.asarray(a)
np.savez({path!r}, **out)
print("SAVED")
"""


class _Saved:
    """Attribute view of one saved reference batch."""

    def __init__(self, ref, p, depth):
        for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                     "n_cache_misses", "n_probe_demoted"):
            setattr(self, name, ref[p + name])
        for name in ("hops", "masks", "x_hops"):
            setattr(self, name, tuple(ref[f"{p}{name}{l}"]
                                      for l in range(depth)))


def _assert_saved_tiers(ref, prefix, tstate):
    for tier in ("l1", "l2"):
        for name, got in zip(("keys", "rows", "tags", "counts"),
                             getattr(tstate, tier)):
            assert got.numpy().tobytes() == \
                ref[f"{prefix}_{tier}_{name}"].tobytes(), (prefix, tier, name)


def test_tiered_w4_matches_reference(tmp_path):
    """W = 4 on the stacked worker axis against the reference's shard_map:
    six cached fetches (five mutable, one frozen; the compact wire with a
    payload bound small enough to demote) and six generation rounds (four
    mutable, two frozen) — rows, batches, both tiers of every worker and
    every fetch and cache counter equal."""
    path = str(tmp_path / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE_W4.format(
        tests=os.path.dirname(__file__), tiered=_TIERED, path=path),
        devices=4)
    ref = np.load(path)
    w = 4
    cfg = tfc.CacheConfig(assoc=4, wire="compact", hit_cap=12,
                          **_TIERED).validated()

    n, d = 200, 4
    table = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    ids = (np.random.default_rng(6).zipf(1.3, (3, w, 90)) % n).astype(np.int32)
    sharded = torch.from_numpy(tgen.shard_rows(table, w))
    state = tfc.init_cache_state(cfg, d, w, device="cpu")
    totals = {"n_l1_hits": 0, "n_probe_demoted": 0, "n_shard_hits": 0}
    for step, c in enumerate((cfg,) * 5 + (cfg.serve_view(),)):
        o, state, fs, cs = tgen.fetch_rows(sharded,
                                           torch.from_numpy(ids[step % 3]),
                                           cache=state, cache_cfg=c)
        np.testing.assert_array_equal(o.numpy(), ref[f"f{step}_out"])
        for name, a in zip(fs._fields + cs._fields, tuple(fs) + tuple(cs)):
            np.testing.assert_array_equal(a.numpy(), ref[f"f{step}_{name}"],
                                          err_msg=f"fetch {step} {name}")
            if name in totals:
                totals[name] += int(a.sum())
        _assert_saved_tiers(ref, f"f{step}", state)
    assert all(v > 0 for v in totals.values()), totals

    g = powerlaw_graph(400, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    part = partition_edges(g, w)
    feats, labels = node_features(400, 6), node_labels(400, 5)
    fanouts = (4, 3, 2)
    gen_fn, dargs, gstate = tgen.make_distributed_generator(
        part, feats, labels, fanouts=fanouts, cache_cfg=cfg, device="cpu")
    serve_fn = tgen.make_generator_fn(fanouts=fanouts,
                                      cache_cfg=cfg.serve_view())
    for t in range(6):
        seeds = torch.from_numpy(ref[f"g{t}_in"])
        draws = torch_draws([(ref[f"g{t}_offs{l}"], ref[f"g{t}_e{l}"])
                             for l in range(len(fanouts))])
        if t < 4:
            batch, gstate = gen_fn(dargs, seeds, draws, gstate)
        else:
            batch = serve_fn(dargs, seeds, draws, gstate)
        assert_batch_equal(_Saved(ref, f"g{t}_", len(fanouts)), batch)
        _assert_saved_tiers(ref, f"g{t}", gstate)
