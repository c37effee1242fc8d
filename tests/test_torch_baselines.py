"""The port's baseline samplers (``core/baselines.py``) against ``repro``'s,
hop by hop: the SQL-like join, the AGL node-centric walk and the
edge-centric sampler, fed the same frontier and the same draws (made with
``jax.random`` in the reference's own key-split order).  Masks are
exact; ids are exact wherever the mask is set.  Ids at masked SQL-like
slots are wherever ``top_k`` put its ``-inf`` ties, which neither package
promises, so they are not compared."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from _torch_parity import hop_draws  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.graph.csr import CSRGraph  # noqa: E402
from repro_torch.graph.synthetic import powerlaw_graph  # noqa: E402

FANOUTS = (4, 3)
N_SEEDS = 64


@pytest.fixture(scope="module")
def graph():
    """A 500-node power-law graph with three hot nodes (degrees up to
    361) whose nodes 0-9 lose their out-edges (degree 0), and a frontier
    of every kind: degree 0, degree below k, the hot nodes, the rest."""
    g = powerlaw_graph(500, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    src, dst = g.edge_list()
    keep = src >= 10
    g = CSRGraph.from_edges(src[keep], dst[keep], 500)
    deg = g.degrees()
    assert (deg == 0).sum() >= 10 and ((deg > 0) & (deg < 4)).sum() > 50
    rng = np.random.default_rng(0)
    hot = np.argsort(-deg)[:3]
    seeds = np.concatenate([np.arange(6), hot,
                            np.flatnonzero((deg > 0) & (deg < 3))[:10],
                            rng.integers(0, 500, N_SEEDS - 19)])
    return g, seeds.astype(np.int32)


def _jax_reservoir_draws(rng, f, max_degree):
    """``node_centric_sample``'s slot draws as the reference makes them:
    ``split(rng, F)`` per node, then ``key, sub = split(key)`` and
    ``randint(sub, (), 0, max(i + 1, 1))`` at every step ``i``."""
    def per(key):
        def body(key, i):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (), 0, jnp.maximum(i + 1, 1))
        return lax.scan(body, key, jnp.arange(max_degree))[1]
    return np.asarray(jax.jit(jax.vmap(per))(jax.random.split(rng, f)))


def _hops(name, g, seeds):
    """Expand both hops with sampler ``name`` in both packages, each hop
    from the same frontier (the reference's previous hop) and the same
    draws; yields ``(level, k, frontier, want, got)`` per hop."""
    indptr, indices = g.indptr, g.indices
    src, dst = g.edge_list()
    max_deg = int(g.degrees().max())
    rngs = jax.random.split(jax.random.PRNGKey(3), 2)
    frontier = seeds

    def t(a):
        return torch.from_numpy(np.array(a))

    for level, k in enumerate(FANOUTS):
        rng, f = rngs[level], frontier.shape[0]
        if name == "sql":
            want = jax.jit(jbase.sql_like_sample, static_argnums=3)(
                jnp.asarray(src), jnp.asarray(dst), jnp.asarray(frontier), k,
                rng)
            pri = np.asarray(jax.random.uniform(rng, (src.shape[0],),
                                                minval=1e-6))
            got = tbase.sql_like_sample(t(src), t(dst), t(frontier), k,
                                        t(pri), block=48)
        elif name == "node":
            want = jax.jit(jbase.node_centric_sample,
                           static_argnums=(3, 5))(
                jnp.asarray(indptr), jnp.asarray(indices),
                jnp.asarray(frontier), k, rng, max_deg)
            j = _jax_reservoir_draws(rng, f, max_deg)
            got = tbase.node_centric_sample(t(indptr), t(indices),
                                            t(frontier), k, t(j), max_deg)
        else:
            want = jax.jit(jbase.edge_centric_sample, static_argnums=3)(
                jnp.asarray(indptr), jnp.asarray(indices),
                jnp.asarray(frontier), k, rng)
            offs, e = hop_draws(rng, f, k)
            got = tbase.edge_centric_sample(t(indptr), t(indices),
                                            t(frontier), k, t(offs), t(e))
        want = tuple(np.asarray(a) for a in want)
        yield level, k, frontier, want, tuple(a.numpy() for a in got)
        frontier = want[0].reshape(-1)


@pytest.mark.parametrize("name", ["sql", "node", "edge"])
def test_sampler_matches_reference_hop_by_hop(graph, name):
    """Each hop: masks equal, ids equal where the mask is set, and the
    mask keeps ``min(deg, k)`` slots per row (edge-centric: every slot of
    a node with an edge); kept ids are out-neighbours of their node."""
    g, seeds = graph
    deg = g.degrees()
    for level, k, frontier, (wid, wm), (gid, gm) in _hops(name, g, seeds):
        assert gid.shape == wid.shape == (frontier.shape[0], k)
        assert gid.dtype == np.int32 and gm.dtype == np.bool_
        np.testing.assert_array_equal(gm, wm, err_msg=f"{name} hop {level}")
        np.testing.assert_array_equal(np.where(gm, gid, -1),
                                      np.where(wm, wid, -1),
                                      err_msg=f"{name} hop {level}")
        d = deg[np.clip(frontier, 0, g.n_nodes - 1)]
        if name == "edge":
            np.testing.assert_array_equal(gm, np.repeat((d > 0)[:, None], k,
                                                        axis=1))
            assert (gid[~gm] == 0).all()
        else:
            np.testing.assert_array_equal(gm.sum(1), np.minimum(d, k))
        for f, row, m in zip(frontier, gid, gm):
            nbrs = set(g.indices[g.indptr[f]:g.indptr[f + 1]].tolist())
            assert set(row[m].tolist()) <= nbrs
        assert (d == 0).any() and ((d > 0) & (d < k)).any()


def test_sql_priorities_distinct_among_matches(graph):
    """The join's top-k is unique only where a node's matches carry
    distinct priorities: assert that they do in this data, for each hop's
    frontier (nothing is hidden by ties)."""
    g, seeds = graph
    src, _ = g.edge_list()
    rngs = jax.random.split(jax.random.PRNGKey(3), 2)
    for level, _k, frontier, _, _ in _hops("edge", g, seeds):
        pri = np.asarray(jax.random.uniform(rngs[level], (src.shape[0],),
                                            minval=1e-6))
        for f in np.unique(frontier):
            p = pri[src == f]
            assert np.unique(p).size == p.size, (level, f)


@pytest.mark.parametrize("name", ["sql", "node", "edge"])
def test_production_draws_are_deterministic(graph, name):
    """The production path (draws from a seeded ``torch.Generator``) gives
    the same ids and masks twice, valid draws in range, and another seed
    other draws."""
    g, seeds = graph
    src, dst = (torch.from_numpy(a) for a in g.edge_list())
    indptr, indices = torch.from_numpy(g.indptr), torch.from_numpy(g.indices)
    frontier = torch.from_numpy(seeds)
    max_deg = int(g.degrees().max())

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        if name == "sql":
            pri = tbase.sql_priorities(gen, src.shape[0], "cpu")
            assert float(pri.min()) >= 1e-6 and float(pri.max()) < 1.0
            return tbase.sql_like_sample(src, dst, frontier, 4, pri)
        if name == "node":
            j = tbase.node_centric_draws(gen, frontier.shape[0], max_deg,
                                         "cpu")
            assert bool((j >= 0).all()) and bool(
                (j <= torch.arange(max_deg)).all())
            return tbase.node_centric_sample(indptr, indices, frontier, 4, j,
                                             max_deg)
        offs, e = tbase.edge_centric_draws(gen, frontier.shape[0], 4, "cpu")
        return tbase.edge_centric_sample(indptr, indices, frontier, 4, offs,
                                         e)

    (a_ids, a_m), (b_ids, b_m), (c_ids, c_m) = run(7), run(7), run(8)
    assert torch.equal(a_m, b_m) and torch.equal(a_ids, b_ids)
    assert torch.equal(a_m, c_m)
    assert not torch.equal(torch.where(a_m, a_ids, -1),
                           torch.where(c_m, c_ids, -1))
