"""Parity of the port's generation engine with ``repro`` at W = 1, fed the
reference's own random draws: candidates, merge, dedup, routing, the
cached fetch and whole generation rounds — ids, masks, features and
counters exact.  At W = 4 (stacked worker axis) the dense probe wire is
held to the compact one, which test_torch_serve.py holds to ``repro``.
The reduce-scatter merge is held to the butterfly at W = 2, 4 and 8, and
to the reference's merge and generation rounds at W = 2 and 4 (one
forced-4-device subprocess for the whole file)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_parity import (assert_batch_equal, assert_state_equal,  # noqa: E402
                           hop_draws, jax_round_draws, run_forced,
                           torch_draws)
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


# ---------------------------------------------------------------------------
# the reduce-scatter merge

def _tied_candidates(w, f, k, seed, cross_ties):
    """Stacked ``Candidates [W, F, k]`` with tied keys: ``+inf`` (invalid
    draws) at 30% of a row's slots, or at 97% in every other row (rows
    whose merge keeps some), and finite keys from a small set, so one
    worker's
    candidates tie among themselves.  With ``cross_ties`` workers share
    the set (finite ties across workers too); without, worker ``i``'s
    finite keys are ``i + W j``, disjoint across workers."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, 4, (w, f, k)).astype(np.float32)
    keys = j if cross_ties else np.arange(w, dtype=np.float32)[:, None,
                                                             None] + w * j
    p_inf = np.where(np.arange(f) % 2, 0.97, 0.3)[None, :, None]
    keys[rng.random(keys.shape) < p_inf] = np.inf
    ids = rng.integers(0, 1000, (w, f, k)).astype(np.int32)
    return ids, keys


@pytest.mark.parametrize("w", [2, 4, 8])
def test_tree_reduce_scatter_equals_butterfly_slice(w):
    """Each worker's reduce-scatter segment equals its rows of the
    butterfly's result, on keys tied within a worker and at ``+inf``:
    keys exact, ids exact wherever the key is finite (the generator
    zeroes the ids of ``+inf`` keys; finite keys tied ACROSS workers are
    where the reference's two merges order sources differently, which
    ``test_tree_reduce_scatter_matches_reference`` holds instead)."""
    from repro_torch.core.tree_reduce import (tree_allreduce,
                                              tree_reduce_scatter)
    f, k = 8 * w, 6
    ids, keys = _tied_candidates(w, f, k, w, cross_ties=False)
    cand = tgen.Candidates(torch.from_numpy(ids), torch.from_numpy(keys))
    seg = tree_reduce_scatter(cand, tgen.merge_topk)
    full = tree_allreduce(cand, tgen.merge_topk)
    rows = f // w
    assert seg.ids.shape == (w, rows, k)
    for i in range(w):
        want = tgen.Candidates(*(a[i, i * rows:(i + 1) * rows]
                                 for a in full))
        assert torch.equal(seg.keys[i], want.keys)
        fin = torch.isfinite(want.keys)
        assert torch.equal(seg.ids[i][fin], want.ids[fin])
    assert bool(torch.isinf(seg.keys).any()) and bool(
        torch.isfinite(seg.keys).any())


def test_tree_reduce_scatter_rejects_non_power_of_two():
    """W = 3 raises, as in the reference (and so does the butterfly)."""
    from repro_torch.core.tree_reduce import tree_reduce_scatter
    cand = tgen.Candidates(torch.zeros((3, 6, 2), dtype=torch.int32),
                           torch.zeros((3, 6, 2)))
    with pytest.raises(ValueError, match="power-of-two"):
        tree_reduce_scatter(cand, tgen.merge_topk)


def test_tree_psum_sums_every_worker():
    """``tree_psum`` over the stacked axis: every worker holds the sum."""
    from repro_torch.core.tree_reduce import tree_psum
    x = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    got = tree_psum((x, x * 2))
    assert torch.equal(got[0], x.sum(0).expand(4, 3))
    assert torch.equal(got[1], 2 * x.sum(0).expand(4, 3))


_RS_FANOUTS, _RS_B, _RS_ROUNDS = (4, 3), 4, 2
#: the W = 4 rounds run graphgen-gcn's sharded, 4-way cache on the
#: compact wire (cut to 64 rows, admitting on the first miss)
_RS_CACHE = dict(n_rows=64, admit=1, assoc=4, mode="sharded", hit_cap=24)

_REFERENCE_RS = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.core import feature_cache as jfc
from repro.core import generation as jgen
from repro.core.partition import partition_edges
from repro.core.tree_reduce import tree_reduce_scatter
from repro.graph.synthetic import node_features, node_labels, powerlaw_graph
from repro.launch.mesh import make_mesh

out = {{}}
cand = np.load({cand!r})
mesh4 = make_mesh((4,), ("data",))

def body(i, k):
    seg = tree_reduce_scatter(jgen.Candidates(i[0], k[0]), jgen.merge_topk,
                              "data")
    return seg.ids[None], seg.keys[None]
ids, keys = shard_map(body, mesh=mesh4, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")), check_rep=False)(
    jnp.asarray(cand["ids"]), jnp.asarray(cand["keys"]))
out["seg_ids"], out["seg_keys"] = np.asarray(ids), np.asarray(keys)

g = powerlaw_graph(300, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
feats, labels = node_features(300, 6), node_labels(300, 5)
fanouts, b = {fanouts!r}, {b}
for W in (2, 4):
    mesh = make_mesh((W,), ("data",))
    part = partition_edges(g, W)
    cfg = jfc.CacheConfig(**{cache!r}).validated() if W == 4 else None
    res = jgen.make_distributed_generator(
        mesh, part, feats, labels, fanouts=fanouts, cache_cfg=cfg,
        merge_mode="reduce_scatter")
    gen_fn, dargs = res[:2]
    state = res[2] if cfg is not None else None
    rng = np.random.default_rng(W)
    for t in range({rounds}):
        p = f"w{{W}}_{{t}}_"
        seeds = rng.choice(300, (W, b), replace=False).astype(np.int32)
        key = jax.random.PRNGKey(10 + t)
        out[p + "in"] = seeds
        for l, (o, e) in enumerate(jax_round_draws(key, W, b, fanouts)):
            out[f"{{p}}offs{{l}}"], out[f"{{p}}e{{l}}"] = o, e
        if state is None:
            batch = gen_fn(dargs, jnp.asarray(seeds), key)
        else:
            batch, state = gen_fn(dargs, jnp.asarray(seeds), key, state)
            for name, a in zip(("keys", "rows", "tags", "counts"), state):
                out[p + "c_" + name] = np.asarray(a)
        for name in ("seeds", "x_seed", "labels", "n_dropped",
                     "n_cache_hits", "n_cache_misses", "n_probe_demoted"):
            out[p + name] = np.asarray(getattr(batch, name))
        for name in ("hops", "masks", "x_hops"):
            for l, a in enumerate(getattr(batch, name)):
                out[f"{{p}}{{name}}{{l}}"] = np.asarray(a)
np.savez({path!r}, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def reference_rs(tmp_path_factory):
    """The reference's reduce-scatter cases, all in ONE forced-4-device
    subprocess: ``tree_reduce_scatter`` at W = 4 on candidates with keys
    tied across workers, and generation rounds at W = 2 (uncached) and
    W = 4 (sharded cache) with ``merge_mode="reduce_scatter"``."""
    d = tmp_path_factory.mktemp("rs")
    ids, keys = _tied_candidates(4, 32, 6, 11, cross_ties=True)
    np.savez(d / "cand.npz", ids=ids, keys=keys)
    path = str(d / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE_RS.format(
        tests=os.path.dirname(__file__), cand=str(d / "cand.npz"),
        fanouts=_RS_FANOUTS, b=_RS_B, cache=_RS_CACHE, rounds=_RS_ROUNDS,
        path=path), devices=4)
    return np.load(path), ids, keys


def test_tree_reduce_scatter_matches_reference(reference_rs):
    """W = 4, finite keys tied across workers and ``+inf`` ties: every
    worker's segment, ids and keys, equals the reference's exactly (the
    same partners, halves and ``merge(keep, recv)`` order)."""
    from repro_torch.core.tree_reduce import tree_reduce_scatter
    ref, ids, keys = reference_rs
    seg = tree_reduce_scatter(
        tgen.Candidates(torch.from_numpy(ids), torch.from_numpy(keys)),
        tgen.merge_topk)
    np.testing.assert_array_equal(seg.ids.numpy(), ref["seg_ids"])
    assert seg.keys.numpy().tobytes() == ref["seg_keys"].tobytes()


class _SavedBatch:
    """Attribute view of one saved reference batch."""

    def __init__(self, ref, p, depth):
        for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                     "n_cache_misses", "n_probe_demoted"):
            setattr(self, name, ref[p + name])
        for name in ("hops", "masks", "x_hops"):
            setattr(self, name, tuple(ref[f"{p}{name}{l}"]
                                      for l in range(depth)))


@pytest.mark.parametrize("w", [2, 4])
def test_reduce_scatter_generation_matches_reference(reference_rs, w):
    """Generation rounds with ``merge_mode="reduce_scatter"`` fed the
    reference's draws: ids, masks, features, labels and counters exact
    against the reference's rounds (W = 4 with the sharded cache, whose
    states are exact too), and equal to the port's own butterfly rounds
    from the same draws and a cold cache."""
    ref = reference_rs[0]
    g = powerlaw_graph(300, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    part = partition_edges(g, w)
    feats, labels = node_features(300, 6), node_labels(300, 5)
    cfg = tfc.CacheConfig(**_RS_CACHE).validated() if w == 4 else None
    gens = {mode: tgen.make_distributed_generator(
        part, feats, labels, fanouts=_RS_FANOUTS, cache_cfg=cfg,
        merge_mode=mode, device="cpu") for mode in tgen.MERGE_MODES}
    states = {mode: (out[2] if cfg is not None else None)
              for mode, out in gens.items()}
    for t in range(_RS_ROUNDS):
        p = f"w{w}_{t}_"
        seeds = torch.from_numpy(ref[p + "in"])
        draws = torch_draws([(ref[f"{p}offs{l}"], ref[f"{p}e{l}"])
                             for l in range(len(_RS_FANOUTS))])
        got = {}
        for mode, (gen_fn, dargs, *_) in gens.items():
            if cfg is None:
                got[mode] = gen_fn(dargs, seeds, draws)
            else:
                got[mode], states[mode] = gen_fn(dargs, seeds, draws,
                                                 states[mode])
        assert_batch_equal(_SavedBatch(ref, p, len(_RS_FANOUTS)),
                           got["reduce_scatter"])
        for a, b in zip(got["butterfly"], got["reduce_scatter"]):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
        if cfg is not None:
            for name, a, b in zip(("keys", "rows", "tags", "counts"),
                                  states["reduce_scatter"],
                                  states["butterfly"]):
                assert a.numpy().tobytes() == ref[p + "c_" + name].tobytes()
                assert torch.equal(a, b), name
    if cfg is not None:
        assert int(got["reduce_scatter"].n_cache_hits.sum()) > 0


def test_unknown_merge_mode_raises():
    """An unknown ``merge_mode`` is refused when the generator is built."""
    with pytest.raises(ValueError, match="merge_mode"):
        tgen.make_generator_fn(fanouts=(2,), merge_mode="ring")
