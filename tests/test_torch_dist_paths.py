"""Every graph path of the port on the process backend (``--dist gloo``)
on the CPU, held to the stacked run of the same flags: ``serve_gcn``,
the tiered cache (``graphgen-gcn-deep``), the L3 host store at both
gather depths, ``--export-serve`` and a ``--warm-from`` server, the
GraphGen baseline (``--offline``) and ``--autotune``.

Each world size (W = 2, 4) is spawned once by the package's own launcher
(``launch/mesh.py``, one thread per process); every rank runs
``_battery``: each path through its driver with ``--report``, then (at
W = 4) the cases fed ``repro``'s own draws.  The test process runs the
same paths on the stacked group and compares the reports.  ``repro``
runs once, in one forced-4-device JAX subprocess: three tiered rounds,
the warm-up and one served request at W = 4, and a read of the serving
state a W = 2 ``--dist`` run exported.  The test process imports no JAX.

Tolerances are PR 22's: batches, caches, stats, L3 counters, the
autotune trace (wall times apart) and ranking, and predictions are
bit-equal; losses within ``rtol=1e-5``; parameters and Adam moments
bit-equal across ranks and within ``rtol=1e-5, atol=1e-7`` of the
stacked run (the ranks average per-rank mean gradients, the stacked run
differentiates the global mean), and bit-equal to the stacked run with
``--per-worker-loss``, which does the ranks' arithmetic (the deep path
averages by the butterfly at W = 4); logits against ``repro`` within
``rtol=1e-5, atol=1e-5`` (float32 matmul order), and its predictions
wherever the top-2 margin exceeds 1e-4.
"""
import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import run_forced, torch_draws  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import gcn_params_from_numpy  # noqa: E402
from repro_torch.core import generation as tgen  # noqa: E402
from repro_torch.core.balance import balance_table  # noqa: E402
from repro_torch.core.collectives import StackedGroup  # noqa: E402
from repro_torch.core.feature_cache import (CacheConfig,  # noqa: E402
                                            state_leaves)
from repro_torch.core.partition import partition_edges  # noqa: E402
from repro_torch.graph.synthetic import (node_features,  # noqa: E402
                                         node_labels, powerlaw_graph)
from repro_torch.launch import mesh, serve, train  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
#: seconds the launcher waits for a battery's ranks
_TIMEOUT = 300
_REQUESTS = 12
_SERVE = ["--smoke", "--device", "cpu", "--nodes", "2000", "--requests",
          str(_REQUESTS), "--warmup-sweeps", "4", "--buckets", "4,8,16"]
_TRAIN = ["--smoke", "--device", "cpu", "--nodes", "2000", "--steps", "6",
          "--batch-per-worker", "8", "--log-every", "100"]
#: the L3 host store's flags: the fixed slack, the hit cap at half the
#: probe round (no ladder), as chip_smoke's host cells
_HOST = ["--arch", "graphgen-gcn", "--feature-store", "host",
         "--capacity-slack", "2.0", "--probe-hit-cap", "0"]
WIDTHS = (2, 4)
#: the W = 4 reference cases: a tiered cache small enough to admit,
#: promote and evict within three rounds
_FANOUTS, _B, _N, _ROUNDS = (4, 3), 4, 300, 3
_TIERED = dict(n_rows=64, admit=1, assoc=4, mode="tiered", l1_rows=16,
               l1_promote=1, hit_cap=24)
#: the served request: graphgen-gcn's smoke config (test_torch_serve's)
_SRV_N, _SRV_SEED, _SRV_SWEEPS, _SRV_BUCKETS = 400, 0, 3, (4, 8)
_SRV_OVERRIDES = dict(cache_rows=32, cache_hit_cap=6)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_TESTS, env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cases(w, out):
    """Every path's ``(driver, argv)`` at ``W = w``, reporting to
    ``out/<case>``; the warm-started server reads the ``--dist`` run's
    export (``dist_export``), so it runs after it."""
    rep = lambda case: ["--workers", str(w), "--report",  # noqa: E731
                        os.path.join(out, case)]
    return {
        "serve": (serve.serve_gcn, ["--arch", "graphgen-gcn", *_SERVE,
                                    *rep("serve")]),
        "deep": (train.train_gcn, ["--arch", "graphgen-gcn-deep", *_TRAIN,
                                   *rep("deep"), "--export-serve",
                                   os.path.join(out, "export")]
                 + (["--grad-sync", "tree"] if w == 4 else [])),
        "host1": (train.train_gcn, [*_HOST, *_TRAIN, *rep("host1"),
                                    "--host-gather-depth", "1"]),
        "host2": (train.train_gcn, [*_HOST, *_TRAIN, *rep("host2"),
                                    "--host-gather-depth", "2"]),
        "offline": (train.offline_gcn, ["--arch", "graphgen-gcn", *_TRAIN,
                                        "--offline", *rep("offline")]),
        "autotune": (train.train_gcn, ["--arch", "graphgen-gcn", *_TRAIN,
                                       "--autotune", "--autotune-steps",
                                       "4", *rep("autotune")]),
    }


def _warm_case(w, out, export):
    return (serve.serve_gcn, ["--arch", "graphgen-gcn-deep", *_SERVE,
                              "--workers", str(w), "--warm-from", export,
                              "--report", os.path.join(out, "warm")])


def _run(case, group=None):
    fn, argv = case
    module = serve if fn is serve.serve_gcn else train
    if group is None:
        return fn(module.parse_args(argv))
    return fn(module.parse_args(argv + ["--dist", "gloo"]), group=group)


# ---------------------------------------------------------------------------
# the W = 4 cases fed repro's own draws

def _ref_graph():
    g = powerlaw_graph(_N, avg_degree=6, n_hot=3, hot_degree=60, seed=0)
    return g, node_features(_N, 6), node_labels(_N, 5)


def _blocks(group, ref, prefix, depth):
    """The held workers' rows of a saved round's draws."""
    return tuple((group.block(o), group.block(e)) for o, e in torch_draws(
        [(ref[f"{prefix}_offs{l}"], ref[f"{prefix}_e{l}"])
         for l in range(depth)]))


def _tiered_rounds(group, ref):
    """Three tiered rounds from an empty cache on ``repro``'s draws: each
    round's batch block and both tiers' cache blocks."""
    part = partition_edges(_ref_graph()[0], group.world)
    gen_fn, dargs, state = tgen.make_distributed_generator(
        part, ref["feats"], ref["labels"], fanouts=_FANOUTS,
        cache_cfg=CacheConfig(**_TIERED).validated(), device="cpu",
        group=group)
    out = {}
    for t in range(_ROUNDS):
        batch, state = gen_fn(dargs, torch.from_numpy(group.block(
            ref[f"t{t}_in"]).copy()), _blocks(group, ref, f"t{t}", 2), state)
        out.update(_batch_fields(batch, f"t{t}."))
        out.update({f"t{t}.cache.{n}": a for n, a in state_leaves(state)})
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


def _served_request(group, ref):
    """``test_torch_serve``'s W = 4 slice on processes: the warm-up sweeps
    and one request on ``repro``'s draws and weights, the request
    through ``GraphServer`` (generate, logits, gathered predictions)."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                              **_SRV_OVERRIDES)
    depth = len(cfg.fanouts)
    cache_cfg = CacheConfig.from_model(cfg)
    g = powerlaw_graph(_SRV_N, n_hot=max(_SRV_N // 1000, 1), seed=_SRV_SEED)
    part = partition_edges(g, group.world)
    feats = node_features(_SRV_N, cfg.gcn_in_dim, _SRV_SEED)
    labels = node_labels(_SRV_N, cfg.n_classes, _SRV_SEED)
    head_order = np.argsort(-np.diff(g.indptr)).astype(np.int32)
    gen_mut, dargs, cache0 = tgen.make_distributed_generator(
        part, feats, labels, fanouts=cfg.fanouts, cache_cfg=cache_cfg,
        group=group)
    head = head_order[:max(_SRV_BUCKETS[-1] * group.world, cache_cfg.n_rows)]
    warm = serve.warmup_sweep(
        gen_mut, dargs, cache0, head, n_workers=group.world,
        bucket=_SRV_BUCKETS[-1], sweeps=_SRV_SWEEPS, group=group,
        draws=lambda t, *_: _blocks(group, ref, f"warm{t}", depth))
    params = ([tuple(ref[f"p{i}_{k}"] for k in ("w_self", "w_nbr", "b"))
               for i in range(depth)], ref["w_out"], ref["b_out"])
    server = serve.GraphServer(
        tgen.make_generator_fn(fanouts=cfg.fanouts,
                               cache_cfg=cache_cfg.serve_view(), group=group),
        dargs, gcn_params_from_numpy(params, device="cpu"), warm,
        draws=lambda *_: _blocks(group, ref, "req0", depth),
        buckets=_SRV_BUCKETS, n_workers=group.world, group=group)
    ids = ref["req0_ids"]
    out = _batch_fields(server.generate(ids), "req.")
    out.update({"warm." + n: a for n, a in state_leaves(warm)})
    out["req.logits"] = server.logits(ids)
    out["req.preds"] = torch.from_numpy(server.serve(ids))
    return out


def _broadcasts(group):
    """``broadcast`` of each dtype's full ``[W, 3]`` array: every worker
    holds worker 0's row."""
    rng = np.random.default_rng(5)
    full = {"ids": rng.integers(-9, 9, (group.world, 3)).astype(np.int32),
            "mask": rng.random((group.world, 3)) < 0.5,
            "rows": rng.standard_normal((group.world, 3)).astype(np.float32)}
    return {"bcast." + k: group.broadcast(torch.from_numpy(
        group.block(v).copy())) for k, v in full.items()}


def _battery(group, out, ref=None):
    """A rank's whole share of this module: every path of ``_cases`` with
    its report, the warm-started server on this run's export, the
    broadcasts, and at W = 4 the ``repro``-fed cases, saved to
    ``out/rank<r>.npz``."""
    torch.set_num_threads(1)
    for case in _cases(group.world, out).values():
        _run(case, group)
    _run(_warm_case(group.world, out, os.path.join(out, "export")), group)
    res = _broadcasts(group)
    if ref is not None:
        ref = np.load(ref)
        res.update(_tiered_rounds(group, ref))
        res.update(_served_request(group, ref))
    np.savez(os.path.join(out, f"rank{group.rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})


def _die_serving(group):
    """Rank 1 dies on its third request; rank 0 then waits in the next
    header's broadcast, which only the launcher can end."""
    if group.rank == 1:
        real = serve.GraphServer.serve

        def serve_then_die(self, ids):
            if self._n_requests >= len(self.buckets) + 2:
                os._exit(3)
            return real(self, ids)
        serve.GraphServer.serve = serve_then_die
    _run((serve.serve_gcn, ["--arch", "graphgen-gcn", *_SERVE, "--workers",
                            str(group.world)]), group)


# ---------------------------------------------------------------------------
# fixtures

_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.configs import get_config, smoke_config
from repro.core import feature_cache as jfc
from repro.core import generation as jgen
from repro.core.partition import PartitionedGraph, partition_edges
from repro.graph.synthetic import node_features, node_labels, powerlaw_graph
from repro.launch.mesh import make_mesh
from repro.launch.serve import _zipf_request_stream, bucket_for, warmup_sweep
from repro.models import gcn
from repro.train import checkpoint as jckpt

mesh = make_mesh((4,), ("data",))
out = {{}}

def save_batch(p, batch):
    for name in ("seeds", "x_seed", "labels", "n_dropped", "n_cache_hits",
                 "n_cache_misses", "n_probe_demoted"):
        out[p + name] = np.asarray(getattr(batch, name))
    for name in ("hops", "masks", "x_hops"):
        for l, a in enumerate(getattr(batch, name)):
            out[f"{{p}}{{name}}{{l}}"] = np.asarray(a)

def save_state(p, state):
    for tier in ("l1", "l2"):
        for name, a in zip(("keys", "rows", "tags", "counts"),
                           getattr(state, tier)):
            out[f"{{p}}{{tier}}.{{name}}"] = np.asarray(a)

# three tiered rounds on the port's graph
g = np.load({graph!r})
part = PartitionedGraph(g["indptr"], g["indices"], g["n_local"], {n})
out["feats"], out["labels"] = g["feats"], g["labels"]
gen_fn, dargs, state = jgen.make_distributed_generator(
    mesh, part, g["feats"], g["labels"], fanouts={fanouts!r},
    cache_cfg=jfc.CacheConfig(**{tiered!r}).validated())
for t in range({rounds}):
    key = jax.random.PRNGKey(40 + t)
    for l, (o, e) in enumerate(jax_round_draws(key, 4, {b}, {fanouts!r})):
        out[f"t{{t}}_offs{{l}}"], out[f"t{{t}}_e{{l}}"] = o, e
    out[f"t{{t}}_in"] = g["seeds"][t]
    batch, state = gen_fn(dargs, jnp.asarray(g["seeds"][t]), key, state)
    save_batch(f"ref.t{{t}}.", batch)
    save_state(f"ref.t{{t}}.cache.", state)

# the warm-up and one served request (test_torch_serve's slice)
N, SEED, SWEEPS, BUCKETS = {srv_n}, {srv_seed}, {sweeps}, {buckets}
cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                          **{overrides})
cache_cfg = jfc.CacheConfig.from_model(cfg)
sg = powerlaw_graph(N, n_hot=max(N // 1000, 1), seed=SEED)
spart = partition_edges(sg, 4)
params = gcn.init_gcn(cfg, jax.random.PRNGKey(SEED))
for i, lyr in enumerate(params.layers):
    for name, a in zip(("w_self", "w_nbr", "b"), lyr):
        out[f"p{{i}}_{{name}}"] = np.asarray(a)
out["w_out"], out["b_out"] = np.asarray(params.w_out), np.asarray(params.b_out)
head_order = np.argsort(-np.diff(sg.indptr)).astype(np.int32)
gen_mut, sargs, cache0 = jgen.make_distributed_generator(
    mesh, spart, node_features(N, cfg.gcn_in_dim, SEED),
    node_labels(N, cfg.n_classes, SEED), fanouts=cfg.fanouts,
    cache_cfg=cache_cfg)
head = head_order[:max(BUCKETS[-1] * 4, cache_cfg.n_rows)]
rng0 = jax.random.PRNGKey(SEED)
for t in range(SWEEPS):
    for l, (o, e) in enumerate(jax_round_draws(jax.random.fold_in(rng0, t), 4,
                                               BUCKETS[-1], cfg.fanouts)):
        out[f"warm{{t}}_offs{{l}}"], out[f"warm{{t}}_e{{l}}"] = o, e
warm = warmup_sweep(gen_mut, sargs, cache0, head, n_workers=4,
                    bucket=BUCKETS[-1], sweeps=SWEEPS, seed=SEED)
for name, a in zip(("keys", "rows", "tags", "counts"), warm):
    out["ref.warm." + name] = np.asarray(a)
gen_serve = jax.jit(jgen.make_generator_fn(
    mesh, fanouts=cfg.fanouts, cache_cfg=cache_cfg.serve_view()))
ids = next(_zipf_request_stream(np.random.default_rng(SEED + 7), 1,
                                head_order, BUCKETS[-1] * 4))
b = bucket_for(ids.size, BUCKETS, 4)
padded = np.concatenate([ids, np.full(b * 4 - ids.size, ids[-1])])
key = jax.random.fold_in(rng0, 0)
for l, (o, e) in enumerate(jax_round_draws(key, 4, b, cfg.fanouts)):
    out[f"req0_offs{{l}}"], out[f"req0_e{{l}}"] = o, e
batch = gen_serve(sargs, jnp.asarray(padded.astype(np.int32).reshape(4, b)),
                  key, warm)
out["req0_ids"] = ids
save_batch("ref.req.", batch)
out["ref.req.logits"] = np.asarray(gcn.gcn_forward(params, batch))[:ids.size]

# the serving state a W = 2 --dist run exported, read by the reference
dcfg = smoke_config(get_config("graphgen-gcn-deep"))
dcache = jfc.CacheConfig.from_model(dcfg)
jp, jc = jckpt.restore_serving_state(
    {export!r}, gcn.init_gcn(dcfg, jax.random.PRNGKey(0)),
    jfc.init_cache_state(dcache, dcfg.gcn_in_dim, 2),
    expect_cache_cfg=dcache.serve_view())
# written back in the checkpoint layout, so the keys are the port's
import tempfile
again = jckpt.save(tempfile.mkdtemp(), 0, {{"params": jp, "cache": jc}})
with np.load(again + "/arrays.npz") as z:
    for k in z.files:
        out["read." + k] = z[k]
np.savez({path!r}, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("dist_paths")


def _spawn(w, tmp, **kwargs):
    out = tmp / f"w{w}"
    out.mkdir()
    t0 = time.monotonic()
    rc = mesh.run("test_torch_dist_paths:_battery", w, device="cpu",
                  kwargs=dict(out=str(out), **kwargs), timeout_s=_TIMEOUT,
                  env=_env())
    assert rc == 0, f"W={w} battery failed (exit {rc})"
    return out, time.monotonic() - t0


@pytest.fixture(scope="module")
def w2(tmp):
    """The W = 2 ranks' reports and results."""
    return _spawn(2, tmp)[0]


@pytest.fixture(scope="module")
def reference(tmp, w2):
    """``repro``'s W = 4 cases (one forced-4-device subprocess), and its
    read of the W = 2 ``--dist`` run's export."""
    g, feats, labels = _ref_graph()
    part = partition_edges(g, 4)
    table = balance_table(np.arange(_N), 4, 7).per_worker
    seeds = np.stack([table[:, t * _B:(t + 1) * _B]
                      for t in range(_ROUNDS)]).astype(np.int32)
    np.savez(tmp / "graph.npz", indptr=part.indptr, indices=part.indices,
             n_local=part.n_local, feats=feats, labels=labels, seeds=seeds)
    path = str(tmp / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE.format(
        tests=_TESTS, graph=str(tmp / "graph.npz"), n=_N, fanouts=_FANOUTS,
        tiered=_TIERED, rounds=_ROUNDS, b=_B, srv_n=_SRV_N,
        srv_seed=_SRV_SEED, sweeps=_SRV_SWEEPS, buckets=_SRV_BUCKETS,
        overrides=_SRV_OVERRIDES, export=str(w2 / "export"), path=path),
        devices=4)
    return path


@pytest.fixture(scope="module")
def w4(tmp, reference):
    """The W = 4 ranks' reports and results (with the ``repro``-fed
    cases)."""
    return _spawn(4, tmp, ref=reference)[0]


@pytest.fixture(scope="module")
def runs(w2, w4):
    """``{w: (process dir, stacked dir)}``: the stacked group runs every
    path with the same flags (the warm-started server on the ``--dist``
    run's export)."""
    torch.set_num_threads(1)
    out = {}
    for w, pdir in ((2, w2), (4, w4)):
        sdir = pdir.parent / f"stacked{w}"
        for case in _cases(w, str(sdir)).values():
            _run(case)
        _run(_warm_case(w, str(sdir), str(pdir / "export")))
        _run(_split_case(w, str(sdir)))
        out[w] = (pdir, sdir)
    return out


def _split_case(w, out):
    """The deep path on the stacked group with ``--per-worker-loss`` (the
    ranks' arithmetic in one process), reporting to ``out/deep_split``."""
    fn, argv = _cases(w, out)["deep"]
    i = argv.index("--export-serve")
    argv = argv[:i] + argv[i + 2:] + ["--per-worker-loss"]
    argv[argv.index("--report") + 1] = os.path.join(out, "deep_split")
    return fn, argv


def _reports(runs, w, case):
    """``(stacked report, [rank reports])`` of one path."""
    pdir, sdir = runs[w]

    def load(d, name):
        with open(os.path.join(d, case, name + ".json")) as f:
            return json.load(f)
    return load(sdir, "stacked"), [load(pdir, f"rank{r}") for r in range(w)]


def _arrays(d, case, name):
    return np.load(os.path.join(d, case, name + ".npz"))


def _assert_rounds(want, got, r):
    """The recorded rounds' batch and cache digests and stats of worker
    ``r`` equal the stacked run's."""
    assert len(want["rounds"]) == 3 and len(got["rounds"]) == 3
    for t, (a, b) in enumerate(zip(want["rounds"], got["rounds"])):
        assert a["batch"][str(r)] == b["batch"][str(r)], (t, r)
        assert a["cache"].get(str(r)) == b["cache"].get(str(r)), (t, r)
        for name, v in a["stats"].items():
            assert b["stats"][name] == [v[r]], (t, r, name)


def _assert_trained(runs, w, case):
    """PR 22's gates: the rungs, the first rounds bit-equal per worker,
    losses within rtol 1e-5, parameters and Adam moments bit-equal across
    ranks and within rtol 1e-5 / atol 1e-7 of the stacked run's."""
    want, ranks = _reports(runs, w, case)
    pdir, sdir = runs[w]
    want_np = _arrays(sdir, case, "stacked")
    got_np = [_arrays(pdir, case, f"rank{r}") for r in range(w)]
    for r, meta in enumerate(ranks):
        for key in ("capacity_slack", "hit_cap", "wire", "ladders"):
            assert meta[key] == want[key], (key, r)
        _assert_rounds(want, meta, r)
        np.testing.assert_allclose(meta["losses"], want["losses"], rtol=1e-5)
        assert meta["n_dropped"] == want["n_dropped"] == 0
    for name in want_np.files:
        if name[0] not in "pmv":
            continue
        for r in range(1, w):
            assert got_np[r][name].tobytes() == got_np[0][name].tobytes()
        np.testing.assert_allclose(got_np[0][name], want_np[name],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    return want, ranks


# ---------------------------------------------------------------------------
# the tests

@pytest.mark.parametrize("w", WIDTHS)
def test_serve_matches_stacked(runs, w):
    """``serve_gcn --dist gloo``: every request's predictions equal the
    stacked server's, each rank's warm cache block is the stacked one's,
    no rank adds a step shape on the request path, and the stop header
    ends every rank's loop after the last request (one broadcast per
    request, plus the stop)."""
    want, ranks = _reports(runs, w, "serve")
    assert want["n_requests"] == _REQUESTS
    for r, meta in enumerate(ranks):
        assert meta["requests"] == want["requests"], r
        assert meta["predictions"] == want["predictions"], r
        assert meta["cache"][str(r)] == want["cache"][str(r)], r
        assert meta["request_path_compiles"] == 0, r
        assert meta["startup_compiles"] == 3, r
        assert meta["n_requests"] == _REQUESTS, r
        bc = meta["collectives_per_request"]["broadcast"]
        assert bc["calls"] * _REQUESTS == _REQUESTS + 1, r
        gathered = meta["collectives_per_request"]["all_gather"]["calls"]
        assert gathered * _REQUESTS >= _REQUESTS, r
    assert ranks[0]["p50_ms"] > 0 and ranks[0]["qps"] > 0
    assert all(m["p50_ms"] is None for m in ranks[1:])


@pytest.mark.parametrize("w", WIDTHS)
def test_tiered_training_matches_stacked(runs, w):
    """``graphgen-gcn-deep`` (the tiered cache) on processes: three rounds
    bit-equal per worker in both tiers (batch, L1 and L2 digests, stats),
    and PR 22's loss and state gates."""
    want, ranks = _assert_trained(runs, w, "deep")
    r0 = want["rounds"][0]["cache"]["0"]
    assert {k.split(".")[0] for k in r0} == {"l1", "l2"}
    last = want["rounds"][-1]["stats"]
    assert sum(last["cache.n_shard_hits"]) + sum(last["cache.n_local_hits"]) \
        > 0


@pytest.mark.parametrize("w", WIDTHS)
def test_per_worker_loss_reproduces_the_ranks(runs, w):
    """``train --per-worker-loss`` on the stacked group does the ranks'
    arithmetic (each worker's mean loss differentiated on its own rows,
    the gradients averaged by the group's sync): every parameter and
    Adam moment, after step 1 and at the end, is bit-equal to the gloo
    ranks', and its losses equal theirs.  At W = 2 the all-reduce is one
    addition; at W = 4 the deep path averages by the butterfly
    (``--grad-sync tree``), whose order one process repeats."""
    pdir, sdir = runs[w]
    got = _arrays(pdir, "deep", "rank0")
    want = _arrays(sdir, "deep_split", "stacked")
    leaves = [k for k in want.files if k[0] in "pmv"]
    assert len(leaves) == 2 * 3 * (3 * 3 + 2)
    for name in leaves:
        assert got[name].tobytes() == want[name].tobytes(), name
    with open(os.path.join(pdir, "deep", "rank0.json")) as f:
        losses = json.load(f)["losses"]
    with open(os.path.join(sdir, "deep_split", "stacked.json")) as f:
        assert json.load(f)["losses"] == losses


@pytest.mark.parametrize("w,depth", [(w, d) for w in WIDTHS for d in (1, 2)])
def test_host_store_matches_stacked(runs, w, depth):
    """``--feature-store host`` at both gather depths: the rounds (before
    the L3 patch), losses and state under PR 22's gates, each rank
    gathering its own staged misses: the L3 rows and bytes summed over
    the ranks equal the stacked run's, and the per-rank shares add up."""
    want, ranks = _assert_trained(runs, w, f"host{depth}")
    total = want["store"]
    assert total["n_l3_hits"] > 0
    for key in ("n_l3_hits", "host_gather_bytes"):
        assert all(m["store"][key] == total[key] for m in ranks), key
        assert sum(m["store"]["rank_" + key] for m in ranks) == total[key]


@pytest.mark.parametrize("w", WIDTHS)
def test_export_matches_stacked(runs, w):
    """``--export-serve`` on processes writes the stacked layout: the
    parameters once, every worker's cache as ``[W, ...]`` (rank 0
    gathers it), byte-equal to the stacked run's cache leaves and within
    rtol 1e-5 / atol 1e-7 in the parameters."""
    pdir, sdir = runs[w]

    def load(d):
        [f] = glob.glob(os.path.join(d, "export", "step_*", "arrays.npz"))
        return np.load(f)
    got, want = load(pdir), load(sdir)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        if key.startswith("cache/"):
            assert got[key].shape[0] == w, key
            assert got[key].tobytes() == want[key].tobytes(), key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)


@pytest.mark.parametrize("w", WIDTHS)
def test_warm_started_server_matches_stacked(runs, w):
    """A ``--dist`` server warm-started from the ``--dist`` export answers
    every request as a stacked server warm-started from the same file,
    each rank holding its block of the file's cache."""
    want, ranks = _reports(runs, w, "warm")
    for r, meta in enumerate(ranks):
        assert meta["predictions"] == want["predictions"], r
        assert meta["cache"][str(r)] == want["cache"][str(r)], r
        assert meta["request_path_compiles"] == 0, r


@pytest.mark.parametrize("w", WIDTHS)
def test_offline_matches_stacked(runs, w):
    """``offline_gcn`` on processes: the first rounds bit-equal per
    worker, losses within rtol 1e-5, and ``t_gen``/``t_train`` reduced by
    max, so every rank reports the same."""
    want, ranks = _reports(runs, w, "offline")
    for r, meta in enumerate(ranks):
        _assert_rounds(want, meta, r)
        np.testing.assert_allclose(meta["losses"], want["losses"], rtol=1e-5)
        for key in ("t_gen", "t_train"):
            assert meta[key] == ranks[0][key] > 0, (key, r)


@pytest.mark.parametrize("w", WIDTHS)
def test_autotune_trace_and_ranking_match_stacked(runs, w):
    """``--autotune`` on processes: the trace reduced over the ranks
    equals the stacked trace in every field but the wall time (which is
    every rank's max), the offline ranking's candidates and costs are
    bit-equal, and every rank reaches the same verdicts."""
    want, ranks = _reports(runs, w, "autotune")
    a = want["autotune"]
    assert len(a["records"]) == 4 and len(a["ranking"]) > 1
    for r, meta in enumerate(ranks):
        b = meta["autotune"]
        assert b["records"] == a["records"], r
        assert b["ranking"] == a["ranking"], r
        assert b["wall_time_s"] == ranks[0]["autotune"]["wall_time_s"], r
        assert b["picks"] == ranks[0]["autotune"]["picks"], r
        assert b["accepted"] == ranks[0]["autotune"]["accepted"], r
        np.testing.assert_allclose(meta["losses"], ranks[0]["losses"],
                                   rtol=0, atol=0)


def test_broadcast_matches_stacked(runs):
    """``broadcast`` over gloo (int32, bool, float32): every rank holds
    worker 0's row, as the stacked group's every row does."""
    for w in WIDTHS:
        want = _broadcasts(StackedGroup(w, device="cpu"))
        for r in range(w):
            got = np.load(runs[w][0] / f"rank{r}.npz")
            for key, a in want.items():
                assert got[key].tobytes() == a[r:r + 1].numpy().tobytes()


def test_tiered_rounds_match_reference(runs, reference):
    """Three W = 4 tiered rounds on processes, fed ``repro``'s draws:
    each rank's batch block and both tiers' cache blocks equal the
    reference's worker block after every round, and the rounds reach
    both tiers."""
    ref = np.load(reference)
    got = [np.load(runs[4][0] / f"rank{r}.npz") for r in range(4)]
    keys = [k[4:] for k in ref.files if k.startswith("ref.t")]
    assert len(keys) == _ROUNDS * (7 + 3 * len(_FANOUTS) + 8)
    for key in keys:
        want = ref["ref." + key]
        per_worker = ".cache." in key or key.split(".")[-1].startswith("n_")
        for r in range(4):
            lo, hi = (r, r + 1) if per_worker else (r * _B, (r + 1) * _B)
            assert got[r][key].tobytes() == want[lo:hi].tobytes(), (key, r)
    last = f"ref.t{_ROUNDS - 1}."
    assert int(ref[last + "n_cache_hits"].sum()) > 0
    assert int((ref[last + "cache.l1.keys"] >= 0).sum()) > 0


def test_served_request_matches_reference(runs, reference):
    """The W = 4 warm-up and one served request on processes, fed
    ``repro``'s draws and weights: each rank's warm cache block and
    request batch block equal the reference's, the gathered logits agree
    within rtol 1e-5 / atol 1e-5, and the gathered predictions equal the
    reference's wherever its top-2 margin exceeds 1e-4."""
    ref = np.load(reference)
    got = [np.load(runs[4][0] / f"rank{r}.npz") for r in range(4)]
    n = ref["req0_ids"].size
    b = got[0]["req.seeds"].shape[0]
    for key in [k[4:] for k in ref.files if k.startswith("ref.warm.")]:
        for r in range(4):
            assert got[r][key].tobytes() == ref["ref." + key][r:r + 1] \
                .tobytes(), (key, r)
    for key in [k[4:] for k in ref.files if k.startswith("ref.req.")
                and k != "ref.req.logits"]:
        want = ref["ref." + key]
        for r in range(4):
            lo, hi = ((r, r + 1) if key.split(".")[-1].startswith("n_")
                      else (r * b, (r + 1) * b))
            assert got[r][key].tobytes() == want[lo:hi].tobytes(), (key, r)
    want = ref["ref.req.logits"]
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    for r in range(4):
        np.testing.assert_allclose(got[r]["req.logits"], want, rtol=1e-5,
                                   atol=1e-5)
        preds = got[r]["req.preds"]
        assert preds.shape == (n,)
        assert preds.tobytes() == got[0]["req.preds"].tobytes()
        np.testing.assert_array_equal(preds[clear], want.argmax(-1)[clear])
    assert clear.sum() > 0


def test_reference_reads_the_dist_export(runs, reference):
    """``repro``'s ``restore_serving_state`` reads the W = 2 ``--dist``
    run's serving state, layout-checked, to the arrays the port wrote."""
    ref = np.load(reference)
    [f] = glob.glob(os.path.join(runs[2][0], "export", "step_*",
                                 "arrays.npz"))
    wrote = np.load(f)
    read = sorted(k for k in ref.files if k.startswith("read."))
    assert len(read) == len(wrote.files) > 8
    for key in read:
        assert ref[key].dtype == wrote[key[5:]].dtype, key
        assert ref[key].tobytes() == wrote[key[5:]].tobytes(), key


def test_serve_lm_still_refuses_dist():
    """``serve_lm --dist`` raises before any work, naming the ROADMAP
    items that will port the LM paths across processes."""
    with pytest.raises(NotImplementedError, match="items 6 and 7.4"):
        serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                    "--dist", "gloo", "--workers", "2"])


def test_launcher_fails_fast_on_a_dead_serving_rank():
    """A serving rank that dies mid-stream makes the launcher end the
    others (rank 0 waits in the next header's broadcast) and return its
    exit code, well inside its timeout."""
    t0 = time.monotonic()
    rc = mesh.run("test_torch_dist_paths:_die_serving", 2, device="cpu",
                  timeout_s=_TIMEOUT, env=_env())
    assert rc == 3
    assert time.monotonic() - t0 < 60


def test_entry_points_take_the_card_by_default(monkeypatch):
    """``make_local_group()``, ``mesh.run``'s default and
    ``StackedGroup(w)`` ask for ``cuda``: where no card is present each
    raises ``resolve_device``'s error (no rank is spawned) instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mesh.make_local_group(),
                 lambda: mesh.make_local_group(4),
                 lambda: StackedGroup(2),
                 lambda: mesh.run("test_torch_dist_paths:_die_serving", 2,
                                  env=_env())):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()
    assert mesh.make_local_group(2, "cpu").device.type == "cpu"
