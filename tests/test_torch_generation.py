"""Parity of the port's generation engine with ``repro`` at W = 1, fed the
reference's own random draws: candidates, merge, dedup, routing, the
cached fetch and whole generation rounds — ids, masks, features and
counters exact.  At W = 4 (stacked worker axis) the dense probe wire is
held to the compact one, which test_torch_serve.py holds to ``repro``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_parity import (assert_batch_equal, assert_state_equal,  # noqa: E402
                           hop_draws, jax_round_draws, torch_draws)
from repro.core import feature_cache as jfc  # noqa: E402
from repro.core import generation as jgen  # noqa: E402
from repro.core.partition import partition_edges  # noqa: E402
from repro.graph.synthetic import (node_features, node_labels,  # noqa: E402
                                   powerlaw_graph)
from repro.launch.mesh import make_mesh  # noqa: E402
from repro_torch.core import feature_cache as tfc  # noqa: E402
from repro_torch.core import generation as tgen  # noqa: E402


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_graph(300, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    return g, partition_edges(g, 1)


def test_local_candidates_bit_exact(graph):
    """Same draws -> the same sampled ids and the same reservoir keys, bit
    for bit, including frontier nodes without local edges (+inf keys) and
    out-of-range frontier ids (clipped)."""
    _, part = graph
    rng = np.random.default_rng(0)
    frontier = rng.integers(0, 300, 64).astype(np.int32)
    frontier[:3] = [0, 299, 350]
    key = jax.random.PRNGKey(7)
    f = jax.jit(jgen.local_candidates, static_argnames=("k",))
    want = f(jnp.asarray(part.indptr[0]), jnp.asarray(part.indices[0]),
             jnp.asarray(frontier), k=5, rng=key)
    offs, e = hop_draws(key, 64, 5)
    got = tgen.local_candidates(torch.from_numpy(part.indptr[0]),
                                torch.from_numpy(part.indices[0]),
                                torch.from_numpy(frontier), 5,
                                torch.from_numpy(offs), torch.from_numpy(e))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert got.keys.numpy().tobytes() == np.asarray(want.keys).tobytes()


def test_merge_topk_ties_and_inf():
    """The k smallest keys of the union with ties broken toward the lower
    index (lax.top_k's rule) and +inf keys last."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 4, (2, 50, 12)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.3] = np.inf
    ids = rng.integers(0, 1000, keys.shape).astype(np.int32)
    a = [jgen.Candidates(jnp.asarray(ids[i, :, :6]), jnp.asarray(keys[i, :, :6]))
         for i in range(2)]
    want = jgen.merge_topk(*a)
    t = [tgen.Candidates(torch.from_numpy(ids[i, :, :6].copy()),
                         torch.from_numpy(keys[i, :, :6].copy()))
         for i in range(2)]
    got = tgen.merge_topk(*t)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))


@pytest.mark.parametrize("n", [0, 1, 64])
def test_dedup_and_route_plan_exact(n):
    """dedup_requests and the routing plan (slot assignment, overflow,
    the w sentinel) equal the reference's."""
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 20, n).astype(np.int32)
    want = jgen.dedup_requests(jnp.asarray(ids))
    got = tgen.dedup_requests(torch.from_numpy(ids))
    n_u = int(want[3])
    assert int(got[3]) == n_u
    np.testing.assert_array_equal(got[0].numpy()[:n_u], np.asarray(want[0])[:n_u])
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dest = rng.integers(0, 5, n).astype(np.int32)      # 4 = the sentinel
    want = jgen._route_plan(jnp.asarray(dest), 3, 4)
    got = tgen._route_plan(torch.from_numpy(dest), 3, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


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


@pytest.mark.parametrize("mode,assoc", [("replicated", 1), ("sharded", 4)])
def test_cached_fetch_rows_exact(mode, assoc):
    """Four cached fetches (mutable, then the frozen serve view) of a
    recurring stream: rows, new state and every counter equal."""
    n, d = 96, 5
    table = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    cfg = jfc.CacheConfig(32, admit=2, assoc=assoc, mode=mode).validated()
    tcfg = tfc.CacheConfig(*cfg)
    jstate = jax.tree.map(jnp.asarray, jfc.init_cache_state(cfg, d, 1))
    tstate = tfc.init_cache_state(tcfg, d, 1, device="cpu")
    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.3, (3, 70)) % n).astype(np.int32)
    for step, c in enumerate((cfg, cfg, cfg, cfg.serve_view())):
        batch = ids[step % 3][None]
        out, jstate, fs, cs = _jax_fetch(c)(jnp.asarray(table),
                                            jnp.asarray(batch), jstate)
        tout, tstate, tfs, tcs = tgen.fetch_rows(
            torch.from_numpy(table)[None], torch.from_numpy(batch),
            cache=tstate, cache_cfg=tfc.CacheConfig(*c))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(out))
        assert_state_equal(jax.tree.map(lambda a: a[0], jstate),
                           tstate.worker(0))
        for name, a, b in zip(fs._fields + cs._fields, tuple(tfs) + tuple(tcs),
                              tuple(fs) + tuple(cs)):
            assert int(a[0]) == int(b), (step, name)


def test_generation_rounds_exact_w1(graph):
    """Three cached generation rounds at W = 1 (graphgen-gcn's sharded,
    4-way cache, which degenerates to a local probe): batches and cache
    states equal the reference's round by round."""
    g, part = graph
    fanouts, b, d = (4, 3), 8, 6
    feats, labels = node_features(300, d), node_labels(300, 5)
    cfg = jfc.CacheConfig(64, admit=2, assoc=4, mode="sharded").validated()
    mesh = make_mesh((1,), ("data",))
    jgen_fn, jargs, jstate = jgen.make_distributed_generator(
        mesh, part, feats, labels, fanouts=fanouts, cache_cfg=cfg)
    tgen_fn, targs, tstate = tgen.make_distributed_generator(
        part, feats, labels, fanouts=fanouts, cache_cfg=tfc.CacheConfig(*cfg),
        device="cpu")
    rng = np.random.default_rng(4)
    for t in range(3):
        seeds = rng.choice(300, (1, b), replace=False).astype(np.int32)
        key = jax.random.PRNGKey(t)
        jb, jstate = jgen_fn(jargs, jnp.asarray(seeds), key, jstate)
        tb, tstate = tgen_fn(targs, torch.from_numpy(seeds),
                             torch_draws(jax_round_draws(key, 1, b, fanouts)),
                             tstate)
        assert_batch_equal(jb, tb)
        assert_state_equal(jax.tree.map(lambda a: a[0], jstate),
                           tstate.worker(0))
    assert int(tb.n_cache_hits[0]) > 0


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_dense_and_compact_wires_agree_w4(mode):
    """W = 4 on the stacked axis: rows equal the table's, and with a payload
    bound that never demotes the dense and compact probe wires return the
    same rows, hits, cache states and counters (the reference's
    transport-only contract; replicated mode runs no probe round, so
    there the two configs must simply agree)."""
    n, d, w = 200, 4, 4
    table = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    sharded = torch.from_numpy(tgen.shard_rows(table, w))
    ids = torch.from_numpy(
        (np.random.default_rng(6).zipf(1.3, (3, w, 90)) % n).astype(np.int32))
    outs = {}
    for wire in ("dense", "compact"):
        cfg = tfc.CacheConfig(32, admit=1, assoc=2, mode=mode, wire=wire,
                              hit_cap=10**6).validated()
        state = tfc.init_cache_state(cfg, d, w, device="cpu")
        steps = []
        for step in range(3):
            out, state, fs, cs = tgen.fetch_rows(sharded, ids[step],
                                                 cache=state, cache_cfg=cfg)
            np.testing.assert_array_equal(out.numpy(),
                                          table[ids[step].numpy()])
            steps.append((out, fs.n_dropped, cs.n_hits, cs.n_local_hits,
                          cs.n_misses, cs.n_inserted) + tuple(state))
        outs[wire] = steps
        assert int(cs.n_hits.sum()) > 0
    for a, b in zip(outs["dense"], outs["compact"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
