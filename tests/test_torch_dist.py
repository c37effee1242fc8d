"""The port's process backend (``--dist gloo``) on the CPU: one process per
worker, spawned by the package's own launcher (``launch/mesh.py``), each
rank's results held bit for bit against its block of the stacked
backend's (which the other ``test_torch_*`` files hold to ``repro``).

Each world size is spawned once per module (W = 1, 2, 3 and 4, one
thread per process, a file store in a temporary directory, a timeout on
the launcher); every rank runs ``_battery`` and writes its results to an
``.npz`` that the test process compares with the same cases run on the
stacked group.  One W = 4 round is held directly against ``repro`` (one
forced-4-device JAX subprocess), and ``graphgen-gcn`` trains at W = 4
both through the trainer's own launcher (``--grad-sync psum``) and in the
battery's ranks (``tree``).  The test process itself imports no JAX.
"""
import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import run_forced, torch_draws  # noqa: E402
from repro_torch.core import generation as tgen  # noqa: E402
from repro_torch.core.balance import balance_table  # noqa: E402
from repro_torch.core.collectives import StackedGroup  # noqa: E402
from repro_torch.core.feature_cache import CacheConfig  # noqa: E402
from repro_torch.core.partition import partition_edges  # noqa: E402
from repro_torch.core.tree_reduce import (tree_allreduce,  # noqa: E402
                                          tree_psum, tree_reduce_scatter)
from repro_torch.graph.synthetic import (node_features,  # noqa: E402
                                         node_labels, powerlaw_graph)
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.train.train_loop import make_grad_sync  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
#: seconds the launcher waits for a battery's ranks
_TIMEOUT = 300
_FANOUTS, _B, _ROUNDS, _N = (4, 3), 4, 3, 300
#: graphgen-gcn's sharded 4-way cache, cut to 64 rows, admitting on the
#: first miss (so three rounds already hit and evict)
_SHARDED = dict(n_rows=64, admit=1, assoc=4, mode="sharded", hit_cap=24)
GEN_CASES = {
    "butterfly_compact_sharded": ("butterfly", _SHARDED),
    "reduce_scatter_compact_sharded": ("reduce_scatter", _SHARDED),
    "butterfly_dense_sharded": ("butterfly", dict(_SHARDED, wire="dense")),
    "butterfly_replicated": ("butterfly", dict(n_rows=64, admit=1, assoc=2,
                                               mode="replicated")),
}
_TRAIN_ARGV = ["--arch", "graphgen-gcn", "--smoke", "--device", "cpu",
               "--nodes", "2000", "--steps", "6", "--workers", "4",
               "--batch-per-worker", "8", "--log-every", "3"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_TESTS, env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


# ---------------------------------------------------------------------------
# the cases, run alike by every rank and by the stacked group

def _collective_inputs(w):
    """Every dtype the generator ships, as full ``[W, W, ...]`` arrays:
    int32 ids (with -1 sentinels), int32 packed bitmap words (every bit
    pattern), bool masks and float32 rows; small multiples of 1/8 for the
    float sums, so any summation order is exact."""
    rng = np.random.default_rng(100 + w)
    return {
        "ids": rng.integers(-1, 1000, (w, w, 7)).astype(np.int32),
        "words": rng.integers(-2**31, 2**31, (w, w, 3)).astype(np.int32),
        "mask": rng.random((w, w, 5)) < 0.5,
        "rows": (rng.integers(-64, 64, (w, w, 4, 3)) / 8).astype(np.float32),
    }


def _tied(w, f=8, k=5, seed=3):
    """Candidates with keys tied within and across workers and ``+inf``
    ties (invalid draws) in a third of the slots."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4, (w, f * w, k)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.33] = np.inf
    ids = rng.integers(0, 1000, keys.shape).astype(np.int32)
    return ids, keys


def _collectives(group):
    """Every collective of ``group`` on the held blocks of each dtype."""
    w = group.world
    out = {"axis_index": group.axis_index()}
    ring = [(i, (i + 1) % w) for i in range(w)]
    half = [(i, i ^ 1) for i in range(w)] if w % 2 == 0 else [(0, 0)]
    for name, full in _collective_inputs(w).items():
        x = torch.from_numpy(group.block(full).copy())
        out[f"{name}.all_to_all"] = group.all_to_all(x)
        out[f"{name}.all_gather"] = group.all_gather(x)
        out[f"{name}.ppermute_ring"] = group.ppermute(x, ring)
        out[f"{name}.ppermute_pairs"] = group.ppermute(x, half)
        if name in ("ids", "rows"):
            out[f"{name}.psum"] = group.all_reduce(x)
            out[f"{name}.pmax"] = group.all_reduce(x, "max")
    return out


def _merges(group):
    """Both tree merges of ``merge_topk`` and ``tree_psum``, on tied
    candidates; and the grad sync of replicated gradients."""
    ids, keys = _tied(group.world)
    cand = tgen.Candidates(torch.from_numpy(group.block(ids).copy()),
                           torch.from_numpy(group.block(keys).copy()))
    full = tree_allreduce(cand, tgen.merge_topk, group)
    seg = tree_reduce_scatter(cand, tgen.merge_topk, group)
    psum = tree_psum((cand.keys.clamp(max=9.0), cand.ids), group)
    grads = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    rep = [grads.expand((group.local,) + grads.shape)]
    return {"allreduce.ids": full.ids, "allreduce.keys": full.keys,
            "scatter.ids": seg.ids, "scatter.keys": seg.keys,
            "psum.keys": psum[0], "psum.ids": psum[1],
            "grad.psum": make_grad_sync(group, "psum")(rep)[0],
            "grad.tree": make_grad_sync(group, "tree")(rep)[0]}


def _clipped_step(group):
    """One train step of ``graphgen-gcn`` (smoke widths) on each held
    worker's rows of one random global batch, with a clip norm every
    gradient exceeds, so the sync must come before the clip: the Adam
    moments, the parameters and the loss after it."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.graph.subgraph import SubgraphBatch
    from repro_torch.models.gcn import init_gcn
    from repro_torch.train.optimizer import init_adam
    cfg = smoke_config(get_config("graphgen-gcn"))
    rng = np.random.default_rng(9)
    n, shape, masks = 4 * _B, (4 * _B,), []
    for k in cfg.fanouts:
        shape = shape + (k,)
        m = rng.random(shape) < 0.75
        masks.append(m & masks[-1][..., None] if masks else m)
    full = dict(
        seeds=np.arange(n, dtype=np.int32),
        hops=tuple(np.zeros(m.shape, np.int32) for m in masks),
        masks=tuple(masks),
        x_seed=rng.standard_normal((n, cfg.gcn_in_dim)).astype(np.float32),
        x_hops=tuple((rng.standard_normal(m.shape + (cfg.gcn_in_dim,))
                      * m[..., None]).astype(np.float32) for m in masks),
        labels=rng.integers(0, cfg.n_classes, n).astype(np.int32))
    lo, hi = group.rank * _B, (group.rank + group.local) * _B

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
    batch = SubgraphBatch(
        **{k: tuple(map(rows, v)) if isinstance(v, tuple) else rows(v)
           for k, v in full.items()},
        n_dropped=torch.zeros(group.local, dtype=torch.int32))
    model = init_gcn(cfg, 1, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=0, grad_clip=1e-3)
    model, opt, loss = train.make_gcn_train_fn(tcfg, group)(
        model, init_adam(model.leaves()), batch)
    out = {"clip.loss": loss.reshape(1)}
    for i, p in enumerate(model.leaves()):
        out[f"clip.p{i}"] = p.detach()
        out[f"clip.m{i}"], out[f"clip.v{i}"] = opt.m[i], opt.v[i]
    return out


def _graph():
    g = powerlaw_graph(_N, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    return g, node_features(_N, 6), node_labels(_N, 5)


def _rounds(group, merge_mode, cache, prefix):
    """Three cached rounds from ``SeededDraws`` with ``collect_stats``:
    each round's batch block, stats and cache shard."""
    g, feats, labels = _graph()
    part = partition_edges(g, group.world)
    gen_fn, dargs, state = tgen.make_distributed_generator(
        part, feats, labels, fanouts=_FANOUTS, merge_mode=merge_mode,
        cache_cfg=CacheConfig(**cache).validated(), collect_stats=True,
        device="cpu", group=group)
    draws = tgen.SeededDraws(_FANOUTS, 5, "cpu", group=group)
    table = balance_table(np.arange(_N), group.world, 0).per_worker
    out = {}
    for t in range(_ROUNDS):
        seeds = torch.from_numpy(
            group.block(table[:, t * _B:(t + 1) * _B]).copy())
        batch, state, (fs, cs) = gen_fn(dargs, seeds,
                                        draws(t, group.local, _B), state)
        p = f"{prefix}.{t}."
        out.update(_batch_fields(batch, p))
        for st in (fs, cs):
            out.update({p + "stat." + n: a for n, a in zip(st._fields, st)})
        out.update({p + "cache." + n: a
                    for n, a in zip(state._fields, state)})
    return out


def _batch_fields(batch, p):
    out = {}
    for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                 "n_cache_misses", "n_probe_demoted"):
        out[p + name] = getattr(batch, name)
    for name in ("hops", "masks", "x_hops"):
        for level, a in enumerate(getattr(batch, name)):
            out[f"{p}{name}{level}"] = a
    return out


def _reference_round(group, ref_path):
    """One butterfly round on the sharded cache and the compact wire, fed
    ``repro``'s own draws (saved by the reference subprocess) through the
    draws seam."""
    ref = np.load(ref_path)
    part = partition_edges(_graph()[0], group.world)
    gen_fn, dargs, state = tgen.make_distributed_generator(
        part, ref["feats"], ref["labels"], fanouts=_FANOUTS,
        cache_cfg=CacheConfig(**_SHARDED).validated(), device="cpu",
        group=group)
    draws = tuple((group.block(o), group.block(e)) for o, e in torch_draws(
        [(ref[f"offs{l}"], ref[f"e{l}"]) for l in range(len(_FANOUTS))]))
    batch, state = gen_fn(dargs, torch.from_numpy(group.block(ref["in"])),
                          draws, state)
    out = _batch_fields(batch, "ref.")
    out.update({"ref.cache." + n: a for n, a in zip(state._fields, state)})
    return out


def _battery(group, out, ref=None, train_dir=None):
    """A rank's whole share of this module: every case for its world
    size, saved to ``out/rank<r>.npz``."""
    torch.set_num_threads(1)
    if group.world == 3:
        raised = []
        for fn in (tree_allreduce, tree_reduce_scatter):
            try:
                fn(tgen.Candidates(*map(torch.from_numpy, _tied(3))),
                   tgen.merge_topk, group)
            except ValueError as e:
                raised.append(str(e))
        with open(os.path.join(out, f"rank{group.rank}.json"), "w") as f:
            json.dump(raised, f)
        return
    res = {**_collectives(group), **_merges(group)}
    if group.world == 4:
        res.update(_clipped_step(group))
        for case, (merge_mode, cache) in GEN_CASES.items():
            res.update(_rounds(group, merge_mode, cache, case))
        res.update(_reference_round(group, ref))
        train.train_gcn(train.parse_args(
            _TRAIN_ARGV + ["--dist", "gloo", "--grad-sync", "tree",
                           "--report", train_dir]), group=group)
    np.savez(os.path.join(out, f"rank{group.rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})


def _die(group):
    """Rank 1 dies mid-run; rank 0 would outlive the launcher's timeout
    (so only the launcher can end it, and its own exit code never races
    rank 1's)."""
    if group.rank == 1:
        os._exit(3)
    time.sleep(2 * _TIMEOUT)


# ---------------------------------------------------------------------------
# fixtures: each world size spawned once

def _spawn(w, tmp, **kwargs):
    out = tmp / f"w{w}"
    out.mkdir()
    rc = mesh.run("test_torch_dist:_battery", w, device="cpu", kwargs=dict(
        out=str(out), **kwargs), timeout_s=_TIMEOUT, env=_env())
    assert rc == 0, f"W={w} battery failed (exit {rc})"
    return out


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.core import feature_cache as jfc
from repro.core import generation as jgen
from repro.core.partition import PartitionedGraph
from repro.launch.mesh import make_mesh

g = np.load({graph!r})
part = PartitionedGraph(g["indptr"], g["indices"], g["n_local"], {n})
out = dict(feats=g["feats"], labels=g["labels"], seeds=g["seeds"])
gen_fn, dargs, state = jgen.make_distributed_generator(
    make_mesh((4,), ("data",)), part, g["feats"], g["labels"],
    fanouts={fanouts!r}, cache_cfg=jfc.CacheConfig(**{cache!r}).validated())
key = jax.random.PRNGKey(21)
for l, (o, e) in enumerate(jax_round_draws(key, 4, {b}, {fanouts!r})):
    out[f"offs{{l}}"], out[f"e{{l}}"] = o, e
batch, state = gen_fn(dargs, jnp.asarray(g["seeds"]), key, state)
out["in"] = g["seeds"]
for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
             "n_cache_misses", "n_probe_demoted"):
    out["ref." + name] = np.asarray(getattr(batch, name))
for name in ("hops", "masks", "x_hops"):
    for l, a in enumerate(getattr(batch, name)):
        out[f"ref.{{name}}{{l}}"] = np.asarray(a)
for name, a in zip(("keys", "rows", "tags", "counts"), state):
    out["ref.cache." + name] = np.asarray(a)
np.savez({path!r}, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def reference(tmp):
    """``repro``'s W = 4 round (one forced-4-device subprocess) on the
    port's graph, with its draws."""
    g, feats, labels = _graph()
    part = partition_edges(g, 4)
    seeds = balance_table(np.arange(_N), 4, 7).per_worker[:, :_B]
    np.savez(tmp / "graph.npz", indptr=part.indptr, indices=part.indices,
             n_local=part.n_local, feats=feats, labels=labels, seeds=seeds)
    path = str(tmp / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE.format(
        tests=_TESTS, graph=str(tmp / "graph.npz"), n=_N, fanouts=_FANOUTS,
        cache=_SHARDED, b=_B, path=path), devices=4)
    return path


@pytest.fixture(scope="module")
def ranks(tmp, reference):
    """Every rank's saved results, by world size: ``{w: [npz per rank]}``
    for W = 1, 2 and 4, and W = 3's refusals."""
    out = {}
    for w in (1, 2, 3):
        out[w] = _spawn(w, tmp)
    out[4] = _spawn(4, tmp, ref=reference, train_dir=str(tmp / "tree"))
    loaded = {w: [np.load(out[w] / f"rank{r}.npz") for r in range(w)]
              for w in (1, 2, 4)}
    loaded[3] = [json.load(open(out[3] / f"rank{r}.json")) for r in range(3)]
    return loaded


def _assert_blocks(ranks_w, stacked, keys, b=None):
    """Rank ``r``'s saved array equals the stacked result's worker block:
    rows ``r`` of a ``[W, ...]`` result, rows ``r*b .. (r+1)*b`` of a
    global batch field (``b`` given), bit for bit."""
    for key in keys:
        want = stacked[key].numpy()
        for r, res in enumerate(ranks_w):
            lo, hi = (r, r + 1) if (b is None or want.shape[0] == len(
                ranks_w)) else (r * b, (r + 1) * b)
            got = res[key]
            assert got.shape == want[lo:hi].shape, (key, r)
            assert got.tobytes() == want[lo:hi].tobytes(), (key, r)


# ---------------------------------------------------------------------------
# the tests

@pytest.mark.parametrize("w", [1, 2, 4])
def test_collectives_bit_equal_to_stacked(ranks, w):
    """``axis_index``, ``all_to_all``, ``all_gather``, ``ppermute`` (a ring
    and the butterfly's pairs) and ``all_reduce`` (sum, max) over gloo:
    each rank's result is its block of the stacked backend's, for int32
    ids and bitmap words, bool masks and float32 rows."""
    want = _collectives(StackedGroup(w, device="cpu"))
    _assert_blocks(ranks[w], want, want.keys())


@pytest.mark.parametrize("w", [2, 4])
def test_merges_bit_equal_to_stacked(ranks, w):
    """``tree_allreduce`` of ``merge_topk``, ``tree_reduce_scatter`` and
    ``tree_psum`` over gloo, on keys tied within and across workers and
    at ``+inf``: each rank's block bit-equal to the stacked merges'."""
    want = _merges(StackedGroup(w, device="cpu"))
    keys = [k for k in want if not k.startswith("grad.")]
    _assert_blocks(ranks[w], want, keys)


@pytest.mark.parametrize("w", ["stacked", 2, 4])
def test_grad_sync_tree_equals_default(ranks, w):
    """The port of ``test_grad_sync_tree_equals_default``: replicated
    gradients come back unchanged (the sum of ``W`` copies over ``W``),
    and ``tree`` agrees with ``psum``, on the stacked group and on every
    rank."""
    grads = (torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7).numpy()
    if w == "stacked":
        res = _merges(StackedGroup(4, device="cpu"))
        blocks = [{k: res[k][i].numpy() for k in ("grad.psum", "grad.tree")}
                  for i in range(4)]
    else:
        blocks = [{k: r[k][0] for k in ("grad.psum", "grad.tree")}
                  for r in ranks[w]]
    for blk in blocks:
        np.testing.assert_allclose(blk["grad.psum"], grads)
        assert blk["grad.tree"].tobytes() == grads.tobytes()
        np.testing.assert_allclose(blk["grad.tree"], blk["grad.psum"])


def test_non_power_of_two_refused_on_every_rank(ranks):
    """W = 3 processes: both tree merges raise on every rank before any
    exchange, so no rank waits on a partner."""
    for raised in ranks[3]:
        assert len(raised) == 2
        assert all("power-of-two" in msg for msg in raised)


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generation_rounds_bit_equal_to_stacked(ranks, case):
    """Three cached rounds at W = 4 from ``SeededDraws``, per merge, wire
    and cache mode: each rank's batch block, its ``FetchStats`` and
    ``CacheStats`` and its cache shard after every round equal the
    stacked run's worker block."""
    merge_mode, cache = GEN_CASES[case]
    want = _rounds(StackedGroup(4, device="cpu"), merge_mode, cache, case)
    _assert_blocks(ranks[4], want, want.keys(), b=_B)
    last = f"{case}.{_ROUNDS - 1}."
    assert int(want[last + "n_cache_hits"].sum()) > 0
    if cache["mode"] == "sharded" and cache.get("wire") != "dense":
        assert int(want[last + "stat.n_shard_hits"].sum()) > 0


def test_round_matches_reference(ranks, reference):
    """One W = 4 butterfly round on the sharded cache and the compact wire,
    fed ``repro``'s draws: each rank's batch block and cache shard equal
    the reference's worker block."""
    ref = np.load(reference)
    keys = [k for k in ref.files if k.startswith("ref.")]
    want = {k: torch.from_numpy(ref[k]) for k in keys}
    _assert_blocks(ranks[4], want, keys, b=_B)


def test_sync_comes_before_the_clip(ranks):
    """One step whose every gradient exceeds the clip norm: each rank's
    Adam moments, parameters and loss match the stacked step on the
    global batch (the ranks average their gradients, then AdamW clips
    the global one), and are bit-equal across ranks."""
    want = _clipped_step(StackedGroup(4, device="cpu"))
    for key, a in want.items():
        for r, res in enumerate(ranks[4]):
            got = res[key]
            assert got.tobytes() == ranks[4][0][key].tobytes(), (key, r)
            np.testing.assert_allclose(got, a.numpy(), rtol=1e-5,
                                       atol=1e-12, err_msg=key)


@pytest.fixture(scope="module")
def stacked_run(tmp):
    """The stacked run of the training case, with its report."""
    path = str(tmp / "stacked")
    train.train_gcn(train.parse_args(_TRAIN_ARGV + ["--report", path]))
    return path


@pytest.fixture(scope="module")
def psum_run(tmp):
    """The training case through the trainer's own launcher
    (``python -m repro_torch.launch.train --dist gloo``), W = 4."""
    import subprocess
    path = str(tmp / "psum")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *_TRAIN_ARGV,
         "--dist", "gloo", "--grad-sync", "psum", "--report", path,
         "--dist-timeout", str(_TIMEOUT)],
        capture_output=True, text=True, timeout=_TIMEOUT + 60, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[0].startswith(
        "--dist gloo: 4 worker processes on cpu")
    return path, proc.stdout, time.monotonic() - t0


@pytest.mark.parametrize("mode", ["psum", "tree"])
def test_training_matches_stacked(ranks, stacked_run, psum_run, mode):
    """``graphgen-gcn`` (smoke widths), 2000 nodes, 6 steps, W = 4 ranks
    over gloo: both ladders pick the stacked run's rungs, the first
    rounds' batches and stats are the stacked run's worker blocks, the
    per-step losses agree within ``rtol=1e-5`` and the final parameters
    and Adam moments are bit-equal across ranks and within ``rtol=1e-5,
    atol=1e-7`` of the stacked run's (the ranks average per-rank mean
    gradients, the stacked run differentiates the global mean)."""
    path = psum_run[0] if mode == "psum" else os.path.join(
        os.path.dirname(stacked_run), "tree")
    with open(os.path.join(stacked_run, "stacked.json")) as f:
        want = json.load(f)
    want_np = np.load(os.path.join(stacked_run, "stacked.npz"))
    assert want["ladders"] == ["slack", "hit_cap"]
    got = []
    for r in range(4):
        with open(os.path.join(path, f"rank{r}.json")) as f:
            meta = json.load(f)
        for key in ("capacity_slack", "hit_cap", "wire", "ladders"):
            assert meta[key] == want[key], key
        for t, (a, b) in enumerate(zip(want["rounds"], meta["rounds"])):
            assert a["batch"][str(r)] == b["batch"][str(r)], t
            assert a["cache"][str(r)] == b["cache"][str(r)], t
            for name, v in a["stats"].items():
                assert b["stats"][name] == [v[r]], (t, name)
        np.testing.assert_allclose(meta["losses"], want["losses"], rtol=1e-5)
        got.append(np.load(os.path.join(path, f"rank{r}.npz")))
    assert len(want["rounds"]) == 3
    for name in want_np.files:
        if name[0] not in "pmv":
            continue
        for r in range(1, 4):
            assert got[r][name].tobytes() == got[0][name].tobytes(), name
        np.testing.assert_allclose(got[0][name], want_np[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_launcher_prints_and_logs_once(psum_run):
    """The run's first line names the backend; rank 0 alone prints the
    calibration, step and summary lines."""
    out = psum_run[1]
    assert out.count("capacity_slack auto-sized") == 1
    assert out.count("trained 6 steps") == 1
    assert sum(line.startswith("step ") for line in out.splitlines()) == 2


def test_launcher_fails_fast_on_dead_rank(tmp):
    """A rank that dies makes the launcher end the others and return its
    exit code, well inside its timeout; no rank outlives the call."""
    t0 = time.monotonic()
    rc = mesh.run("test_torch_dist:_die", 2, device="cpu",
                  timeout_s=_TIMEOUT, env=_env())
    assert rc == 3
    assert time.monotonic() - t0 < 60


_GCN = ["--smoke", "--device", "cpu", "--nodes", "300", "--workers", "2",
        "--dist", "gloo"]


def test_offline_and_serve_refuse_dist():
    """Called without a group, ``offline_gcn``, ``serve_gcn`` and
    ``serve_lm`` refuse ``--dist`` (it runs one process per worker or
    model-axis rank, which ``main`` launches or joins)."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="one process per worker"):
        train.offline_gcn(train.parse_args(_GCN))
    for fn, arch, err in ((serve.serve_gcn, "graphgen-gcn", ValueError),
                          (serve.serve_lm, "smollm-135m", ValueError)):
        with pytest.raises(err, match="one process"):
            fn(serve.parse_args(["--arch", arch, "--smoke", "--device",
                                 "cpu", "--nodes", "300", "--dist",
                                 "gloo"]))


def test_nccl_without_cards_raises(monkeypatch):
    """``--dist nccl`` raises before any work: off the card, and with fewer
    visible cards than workers (never falling back to gloo)."""
    with pytest.raises(ValueError, match="--device cuda"):
        train.main(["--smoke", "--device", "cpu", "--workers", "2",
                    "--dist", "nccl"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per worker"):
        train.main(["--smoke", "--workers", "2", "--dist", "nccl"])
