"""The training slice against ``repro``: the GCN loss and its gradients,
AdamW, the pipelined generate-while-train loop (with the cache threaded
through it) and the ``repro_torch.launch.train`` driver.

The reference's pipelined loop runs in ONE subprocess per W (forced host
devices) and writes its draws, its initial and final weights, its losses,
the generation counters and cache states, and its state after three
steps; the port then replays the same seeds and draws on the CPU.  Each
tolerance is stated beside the comparison that uses it."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import run_forced, torch_draws  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import (adam_state_from_numpy,  # noqa: E402
                                 cache_state_from_numpy,
                                 gcn_params_from_numpy)
from repro_torch.core.config import TrainConfig  # noqa: E402
from repro_torch.core.feature_cache import CacheConfig  # noqa: E402
from repro_torch.core.generation import make_distributed_generator  # noqa: E402
from repro_torch.core.partition import partition_edges  # noqa: E402
from repro_torch.core.pipeline import pipelined_loop  # noqa: E402
from repro_torch.graph.subgraph import SubgraphBatch, slots_per_seed  # noqa: E402
from repro_torch.graph.synthetic import (node_features, node_labels,  # noqa: E402
                                         powerlaw_graph)
from repro_torch.launch.train import make_gcn_train_fn  # noqa: E402
from repro_torch.models.gcn import gcn_loss  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _random_batch(fanouts, b, d, n_classes, seed):
    """One padded batch of random features and chained masks, as numpy."""
    rng = np.random.default_rng(seed)
    masks, shape, parent = [], (b,), None
    for k in fanouts:
        shape = shape + (k,)
        m = rng.random(shape) < 0.75
        if parent is not None:
            m &= parent[..., None]
        masks.append(m)
        parent = m
    return dict(
        seeds=np.arange(b, dtype=np.int32),
        hops=tuple(np.zeros(m.shape, np.int32) for m in masks),
        masks=tuple(masks),
        x_seed=rng.standard_normal((b, d)).astype(np.float32),
        x_hops=tuple((rng.standard_normal(m.shape + (d,)) * m[..., None])
                     .astype(np.float32) for m in masks),
        labels=rng.integers(0, n_classes, b).astype(np.int32),
        n_dropped=np.zeros(1, np.int32))


@pytest.mark.parametrize("arch", ["graphgen-gcn-deep", "graphgen-gcn"])
def test_gcn_loss_and_grads_match_reference(arch):
    """Loss and every parameter gradient on one random batch (3-hop and
    2-hop), weights carried over by ``convert``: within rtol 1e-5 — the
    float32 matmuls and sums reduce in another order — with an absolute
    floor of 1e-7 for entries that cancel to near zero."""
    from repro.graph.subgraph import SubgraphBatch as JBatch
    from repro.models import gcn as jgcn
    cfg = smoke_config(get_config(arch))
    fields = _random_batch(cfg.fanouts, 6, cfg.gcn_in_dim, cfg.n_classes,
                           len(cfg.fanouts))
    params = jgcn.init_gcn(cfg, jax.random.PRNGKey(3))
    jb = JBatch(**{k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                   else jnp.asarray(v) for k, v in fields.items()})
    want_loss, want_grads = jax.value_and_grad(jgcn.gcn_loss)(params, jb)
    tb = SubgraphBatch(**{k: tuple(map(torch.from_numpy, v))
                          if isinstance(v, tuple) else torch.from_numpy(v)
                          for k, v in fields.items()})
    model = gcn_params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
    loss = gcn_loss(model, tb)
    grads = torch.autograd.grad(loss, model.leaves())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = jax.tree.leaves(want_grads)
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7, err_msg=f"grad leaf {i}")
    # the gradient reached the first layer through every fanout_mean
    assert all(float(g.abs().sum()) > 0 for g in grads)


@pytest.mark.parametrize("warmup", [0, 3])
def test_adam_update_matches_reference(warmup):
    """Five AdamW steps fed identical gradients (some clipped, some not),
    with the warmup inside and past ``warmup_steps``: the learning rate,
    the params, both moments and the step within rtol 1e-6 — the global
    norm sums in another order and cos/pow/fused multiply-adds may round
    an ulp apart, and nothing else differs.  ``0.9 m + 0.1 g`` and
    ``p - lr u`` cancel to near zero in a few entries, where such an ulp
    is large relative to the entry itself; those are bounded by an
    absolute floor of 1e-6 times the array's largest entry."""
    from repro.core.config import TrainConfig as JTrainConfig
    from repro.train import optimizer as jopt
    rng = np.random.default_rng(warmup)
    shapes = [(16, 32), (16, 32), (32,), (32, 5), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=1e-2, warmup_steps=warmup, total_steps=8)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init_adam(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init_adam(tp)
    for step in range(5):
        scale = 0.05 if step % 2 else 3.0       # clipped on even steps
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        jp, js, jn = jopt.adam_update(jcfg, jp, [jnp.asarray(g) for g in grads],
                                      js)
        tp, ts, tn = topt.adam_update(tcfg, tp,
                                      [torch.from_numpy(g) for g in grads], ts)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(
            float(topt.lr_schedule(tcfg, ts.step)),
            float(jopt.lr_schedule(jcfg, js.step)), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for name, a, b in (("param", tp, jp), ("m", ts.m, js.m),
                           ("v", ts.v, js.v)):
            for i, (x, y) in enumerate(zip(a, b)):
                y = np.asarray(y)
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-6,
                                           atol=1e-6 * np.abs(y).max(),
                                           err_msg=f"step {step} {name} {i}")


N_NODES, SEED, STEPS, B = 500, 0, 5, 4
#: per arch: workers, the smoke config's overrides (graphgen-gcn-deep's
#: tiered cache cut to an L1 of 16 rows and an L2 of 64; graphgen-gcn's
#: sharded cache with a pinned payload bound, so no calibration runs)
PIPELINES = {
    "graphgen-gcn-deep": (1, dict(cache_rows=64, cache_l1_rows=16,
                                  cache_l1_promote=2)),
    "graphgen-gcn": (4, dict(cache_rows=64, cache_hit_cap=24)),
}

_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from _torch_parity import jax_round_draws
from repro.configs import get_config, smoke_config
from repro.core.balance import balance_table
from repro.core.config import TrainConfig
from repro.core.feature_cache import CacheConfig
from repro.core.generation import make_distributed_generator
from repro.core.partition import partition_edges
from repro.core.pipeline import make_pipelined_step, pipelined_loop
from repro.graph.synthetic import node_features, node_labels, powerlaw_graph
from repro.launch.mesh import make_mesh
from repro.models import gcn
from repro.train.optimizer import adam_update, init_adam

ARCH, W, N, SEED, STEPS, B = {arch!r}, {w}, {n}, {seed}, {steps}, {b}
cfg = dataclasses.replace(smoke_config(get_config(ARCH)), **{overrides!r})
cache_cfg = CacheConfig.from_model(cfg)
mesh = make_mesh((W,), ("data",))
g = powerlaw_graph(N, n_hot=max(N // 1000, 1), seed=SEED)
part = partition_edges(g, W)
feats = node_features(N, cfg.gcn_in_dim, SEED)
labels = node_labels(N, cfg.n_classes, SEED)
table = balance_table(np.arange(N), W, SEED)
cols = [(np.arange(B) + t * B) % table.per_worker.shape[1] for t in range(STEPS)]
schedule = np.stack([table.per_worker[:, c] for c in cols])
gen_fn, dargs, cache0 = make_distributed_generator(
    mesh, part, feats, labels, fanouts=cfg.fanouts, cache_cfg=cache_cfg)
tcfg = TrainConfig(learning_rate=5e-3, total_steps=STEPS, warmup_steps=0)

def train_fn(params, opt, batch):
    loss, grads = jax.value_and_grad(gcn.gcn_loss)(params, batch)
    params, opt, _ = adam_update(tcfg, params, grads, opt)
    return params, opt, loss

out = {{"schedule": schedule}}
def save_tree(prefix, tree):
    for i, a in enumerate(jax.tree.leaves(tree)):
        out[f"{{prefix}}{{i}}"] = np.asarray(a)

params = gcn.init_gcn(cfg, jax.random.PRNGKey(SEED))
save_tree("p0_", params)
step = jax.jit(make_pipelined_step(gen_fn, train_fn, cached=True))
train_step = jax.jit(train_fn)
rng = jax.random.PRNGKey(SEED + 1)
rngs = jax.random.split(rng, STEPS + 1)
for t in range(STEPS):
    for l, (o, e) in enumerate(jax_round_draws(rngs[t], W, B, cfg.fanouts)):
        out[f"d{{t}}_offs{{l}}"], out[f"d{{t}}_e{{l}}"] = o, e
# generation alone over the same seeds and draws: the batch counters and
# cache states the loop's generation goes through (they do not depend on
# the weights)
cache = cache0
for t in range(STEPS):
    batch, cache = gen_fn(dargs, jnp.asarray(schedule[t]), rngs[t], cache)
    for name in ("n_dropped", "n_cache_hits", "n_cache_misses",
                 "n_probe_demoted"):
        out[f"b{{t}}_{{name}}"] = np.asarray(getattr(batch, name))
    save_tree(f"c{{t}}_", cache)
p, o, losses, cache = pipelined_loop(
    gen_fn, train_fn, dargs, schedule, params, init_adam(params), rng,
    step=step, train_step=train_step, cache=cache0)
out["losses"] = np.asarray(losses)
save_tree("pf_", p)
save_tree("cf_", cache)
# three steps, the state at that point, then two more from it
rng3 = jax.random.PRNGKey(SEED + 2)
p3, o3, l3, cache3 = pipelined_loop(
    gen_fn, train_fn, dargs, schedule[:3], params, init_adam(params), rng3,
    step=step, train_step=train_step, cache=cache0)
save_tree("p3_", p3)
out["o3_step"] = np.asarray(o3.step)
save_tree("o3m_", o3.m)
save_tree("o3v_", o3.v)
save_tree("c3_", cache3)
rng5 = jax.random.PRNGKey(SEED + 3)
for t, key in enumerate(jax.random.split(rng5, 3)[:2]):
    for l, (oo, e) in enumerate(jax_round_draws(key, W, B, cfg.fanouts)):
        out[f"r{{t}}_offs{{l}}"], out[f"r{{t}}_e{{l}}"] = oo, e
p5, o5, l5, cache5 = pipelined_loop(
    gen_fn, train_fn, dargs, schedule[3:], p3, o3, rng5,
    step=step, train_step=train_step, cache=cache3)
out["losses_resumed"] = np.asarray(l5)
save_tree("p5_", p5)
np.savez({path!r}, **out)
print("SAVED")
"""


def _leaves(ref, prefix):
    n = sum(1 for k in ref.files if k.startswith(prefix)
            and k[len(prefix):].isdigit())
    return [ref[f"{prefix}{i}"] for i in range(n)]


def _params_tree(leaves, depth):
    return ([tuple(leaves[3 * i:3 * i + 3]) for i in range(depth)],
            leaves[-2], leaves[-1])


def _cache_tree(leaves):
    """Flat leaves -> ``(keys, rows, tags, counts)`` or ``(l1, l2)``."""
    if len(leaves) == 8:
        return (tuple(leaves[:4]), tuple(leaves[4:]))
    return tuple(leaves)


def _state_leaves(state):
    if hasattr(state, "l1"):
        return list(state.l1) + list(state.l2)
    return list(state)


@pytest.mark.parametrize("arch", list(PIPELINES))
def test_pipelined_loop_matches_reference(arch, tmp_path):
    """Five pipelined steps (graphgen-gcn-deep-shaped at W = 1 with the
    tiered cache, graphgen-gcn-shaped at W = 4 with the sharded cache on
    the compact wire), the reference's weights, seeds and draws:

    * the batch counters and the cache state after every generation, and
      the cache threaded out of the loop: exact (generation never reads
      the weights);
    * the losses: rtol 1e-4 per step (float32 reduction order in the GCN,
      compounded over the Adam steps);
    * the final params: allclose rtol 1e-4, atol 1e-5.  Adam turns a
      gradient's direction into a step of up to ``lr`` (5e-3) whatever its
      size, so an entry whose gradient sits near zero could move by a
      fraction of ``lr`` on a reduction-order difference; on these seeds
      none does (the largest gap is 2e-6), and ``warmup_steps=0`` keeps
      the schedule itself out of it.

    Then the port starts from the reference's params, optimizer state and
    cache state after three steps (``convert``) and runs two more: losses
    and params held the same way."""
    w, overrides = PIPELINES[arch]
    path = str(tmp_path / "ref.npz")
    assert "SAVED" in run_forced(_REFERENCE.format(
        tests=os.path.dirname(__file__), arch=arch, w=w, n=N_NODES, seed=SEED,
        steps=STEPS, b=B, overrides=overrides, path=path), devices=w)
    ref = np.load(path)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **overrides)
    depth = len(cfg.fanouts)
    cache_cfg = CacheConfig.from_model(cfg)
    g = powerlaw_graph(N_NODES, n_hot=max(N_NODES // 1000, 1), seed=SEED)
    part = partition_edges(g, w)
    gen_fn, dargs, cache0 = make_distributed_generator(
        part, node_features(N_NODES, cfg.gcn_in_dim, SEED),
        node_labels(N_NODES, cfg.n_classes, SEED), fanouts=cfg.fanouts,
        cache_cfg=cache_cfg, device="cpu")
    batches = []

    def recording_gen(*a):
        out = gen_fn(*a)
        batches.append(out[0])
        return out

    def draws(prefix):
        return lambda t, *_: torch_draws(
            [(ref[f"{prefix}{t}_offs{l}"], ref[f"{prefix}{t}_e{l}"])
             for l in range(depth)])

    tcfg = TrainConfig(learning_rate=5e-3, total_steps=STEPS, warmup_steps=0)
    train_fn = make_gcn_train_fn(tcfg)
    model = gcn_params_from_numpy(_params_tree(_leaves(ref, "p0_"), depth),
                                  device="cpu")
    schedule = ref["schedule"]
    model, opt, losses, cache = pipelined_loop(
        recording_gen, train_fn, dargs, schedule, model,
        topt.init_adam(model.leaves()), draws("d"), cache=cache0)
    np.testing.assert_allclose(losses.numpy(), ref["losses"], rtol=1e-4)
    assert len(batches) == STEPS
    for t, batch in enumerate(batches):
        for name in ("n_dropped", "n_cache_hits", "n_cache_misses",
                     "n_probe_demoted"):
            np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                          ref[f"b{t}_{name}"],
                                          err_msg=f"step {t} {name}")
    for got, want in zip(_state_leaves(cache), _leaves(ref, "cf_")):
        assert got.numpy().tobytes() == want.tobytes()
    assert sum(int(b.n_cache_hits.sum()) for b in batches) > 0
    for got, want in zip(model.leaves(), _leaves(ref, "pf_")):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5)

    # resume from the reference's state after three steps
    model3 = gcn_params_from_numpy(_params_tree(_leaves(ref, "p3_"), depth),
                                   device="cpu")
    opt3 = adam_state_from_numpy(
        (ref["o3_step"], _params_tree(_leaves(ref, "o3m_"), depth),
         _params_tree(_leaves(ref, "o3v_"), depth)), device="cpu")
    cache3 = cache_state_from_numpy(_cache_tree(_leaves(ref, "c3_")),
                                    device="cpu")
    assert type(cache3) is type(cache0)
    model5, _, losses5, _ = pipelined_loop(
        gen_fn, train_fn, dargs, schedule[3:], model3, opt3, draws("r"),
        cache=cache3)
    np.testing.assert_allclose(losses5.numpy(), ref["losses_resumed"],
                               rtol=1e-4)
    for got, want in zip(model5.leaves(), _leaves(ref, "p5_")):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5)


def test_gcn_pipeline_learns_feature_rule():
    """Labels derived from node features -> pipelined GCN training in the
    port cuts the loss well below chance (the port of
    ``tests/test_system.py::test_gcn_pipeline_learns_feature_rule``)."""
    from repro_torch.core.balance import balance_table
    from repro_torch.core.generation import SeededDraws
    from repro_torch.models.gcn import init_gcn
    n, dim, classes = 600, 16, 4
    g = powerlaw_graph(n, avg_degree=6, seed=1)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    w_true = rng.standard_normal((dim, classes))
    labels = np.argmax(feats @ w_true, axis=1).astype(np.int32)
    gen, dev = make_distributed_generator(partition_edges(g, 1), feats,
                                          labels, fanouts=(4, 3),
                                          device="cpu")
    cfg = dataclasses.replace(
        smoke_config(get_config("graphgen-gcn")), gcn_in_dim=dim,
        n_classes=classes, gcn_hidden=32, fanouts=(4, 3))
    model = init_gcn(cfg, 0, device="cpu")
    tcfg = TrainConfig(learning_rate=5e-3, total_steps=60, warmup_steps=0)
    table = balance_table(np.arange(n), 1, seed=0)
    schedule = np.stack([
        table.per_worker[:, (t * 32) % (n - 32):(t * 32) % (n - 32) + 32]
        for t in range(61)])
    _, _, losses = pipelined_loop(
        gen, make_gcn_train_fn(tcfg), dev, schedule, model,
        topt.init_adam(model.leaves()),
        SeededDraws((4, 3), 7, "cpu"))
    losses = losses.numpy()
    assert np.mean(losses[:5]) > np.mean(losses[-5:]) + 0.3
    assert np.mean(losses[-5:]) < np.log(classes) * 0.8


@pytest.mark.parametrize("arch,workers", [("graphgen-gcn-deep", 1),
                                          ("graphgen-gcn", 4)])
def test_train_cli_smoke_on_cpu(arch, workers):
    """``python -m repro_torch.launch.train --smoke --device cpu``: finite
    losses and the padded node count ``batch x slots_per_seed``; at W = 4
    both calibration ladders run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--nodes", "1500", "--steps", "4",
         "--workers", str(workers), "--batch-per-worker", "8",
         "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fanouts = smoke_config(get_config(arch)).fanouts
    nodes = 8 * workers * slots_per_seed(fanouts)
    assert f"trained 4 steps" in proc.stdout
    assert f"({nodes} padded nodes/iter" in proc.stdout
    losses = [float(line.split("loss=")[1].split()[0])
              for line in proc.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 4 and np.isfinite(losses).all()
    if workers > 1:
        assert "capacity_slack auto-sized" in proc.stdout
        assert "hit-cap" in proc.stdout


@pytest.mark.parametrize("shrink_to", [None, 1])
def test_train_warm_recalibrate_and_rollback(shrink_to, monkeypatch, capsys):
    """``--warm-recalibrate 2`` at W = 4 on the CPU: the owner exchange is
    shrunk before step 2 through ``pipelined_loop``'s ``before_step``
    hook.  Shrunk to one slot per destination (``shrink_to=1``), batch 3
    drops requests, so the driver regenerates it at the calibrated width
    and rolls back; either way no trained batch drops a request and every
    loss is finite."""
    from repro_torch.launch import train
    if shrink_to is not None:
        monkeypatch.setattr(train, "warm_capacity",
                            lambda *a, **k: shrink_to)
    res = train.train_gcn(train.parse_args([
        "--arch", "graphgen-gcn", "--smoke", "--device", "cpu", "--nodes",
        "1500", "--steps", "5", "--workers", "4", "--batch-per-worker", "8",
        "--warm-recalibrate", "2", "--log-every", "1"]))
    out = capsys.readouterr().out
    assert "warm re-calibration at step 2" in out
    assert ("rolled back to the calibrated width" in out) == (shrink_to == 1)
    assert res["n_dropped"] == 0
    assert len(res["losses"]) == 5 and np.isfinite(res["losses"]).all()
    assert res["batch"].nodes_per_iteration() == res["nodes_per_iter"]


def test_train_without_card_raises():
    """The trainer defaults to the card; without one it raises rather than
    dropping to the CPU."""
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_gcn(train.parse_args(["--smoke", "--nodes", "300"]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["graphgen-gcn-deep", "graphgen-gcn"])
def test_gradients_card_vs_cpu(arch):
    """The same batch and weights on the card and on the CPU: loss and
    every parameter gradient within rtol 1e-4 / atol 1e-6 (float32
    reduction order), and the backward kernel launched once for each
    aggregation of a hidden level — a missing ``grad_fn`` on the card
    would leave the deeper layers' gradients at zero or wrong."""
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_config(arch))
    fields = _random_batch(cfg.fanouts, 16, cfg.gcn_in_dim, cfg.n_classes, 5)
    from repro_torch.models.gcn import init_gcn
    out = {}
    for dev in ("cpu", "cuda"):
        tb = SubgraphBatch(**{k: tuple(torch.from_numpy(a).to(dev) for a in v)
                              if isinstance(v, tuple)
                              else torch.from_numpy(v).to(dev)
                              for k, v in fields.items()})
        model = init_gcn(cfg, 1, device=dev)
        ops.reset_launch_counts()
        loss = gcn_loss(model, tb)
        grads = torch.autograd.grad(loss, model.leaves())
        out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads],
                    ops.launch_counts())
    (lc, gc, _), (lg, gg, counts) = out["cpu"], out["cuda"]
    depth = len(cfg.fanouts)
    assert counts["fanout_mean"] == depth * (depth + 1) // 2
    assert counts["fanout_mean_bwd"] == depth * (depth - 1) // 2
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
