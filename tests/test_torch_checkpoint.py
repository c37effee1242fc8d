"""The port's checkpoints (``repro_torch/train/checkpoint.py``) against
``repro/train/checkpoint.py``.

The on-disk layout is the reference's — ``step_<10 digits>/arrays.npz``
under the reference's pytree paths, ``meta.json``, bfloat16 as a tagged
``uint16`` view — so a checkpoint written by either package restores in
the other: the training ``(params, opt_state)`` and the serving
``{"params", "cache"}`` bundles, each read back bit-exact.  Then the CPU
train entry point: ``--ckpt-every`` and ``--resume`` against an uninterrupted
run, and ``--export-serve`` then ``serve --warm-from`` against the
in-process server.  Every comparison here is exact."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import feature_cache as jfc  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.optimizer import init_adam as jinit_adam  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import (adam_state_from_numpy,  # noqa: E402
                                 adam_state_to_numpy, cache_state_from_numpy,
                                 cache_state_to_numpy, gcn_params_from_numpy,
                                 gcn_params_to_numpy)
from repro_torch.core import feature_cache as tfc  # noqa: E402
from repro_torch.models.gcn import init_gcn  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import init_adam  # noqa: E402

_CFG = smoke_config(get_config("graphgen-gcn-deep"))


def _model(seed=0):
    return init_gcn(_CFG, seed, device="cpu")


def _warm_cache(cfg, w=2, d=16, seed=0):
    """A stacked cache state of random contents, as a numpy tree."""
    rng = np.random.default_rng(seed)
    state = cache_state_to_numpy(tfc.init_cache_state(cfg, d, w,
                                                      device="cpu"))

    def fill(t):
        return tfc.FeatureCache(
            keys=rng.integers(-1, 500, t.keys.shape).astype(np.int32),
            rows=rng.standard_normal(t.rows.shape).astype(np.float32),
            tags=rng.integers(-1, 500, t.tags.shape).astype(np.int32),
            counts=rng.integers(0, 4, t.counts.shape).astype(np.int32))
    if hasattr(state, "l1"):
        return tfc.TieredCache(fill(state.l1), fill(state.l2))
    return fill(state)


def _leaves_equal(a, b):
    a, b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_atomic_commit_keep_last_and_latest_step(tmp_path):
    """A leftover ``tmp.<step>`` (a torn write) is never taken for a
    checkpoint; only the newest ``keep`` commits stay; ``latest_step`` is
    None for a missing or empty directory."""
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    os.makedirs(os.path.join(d, "tmp.9"))
    assert ckpt.latest_step(d) is None
    tree = {"a": np.arange(4, dtype=np.float32)}
    for step in (1, 2, 3, 4):
        path = ckpt.save(d, step, tree, keep=2)
        assert path.endswith(f"step_{step:010d}")
    assert ckpt.latest_step(d) == 4
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_0000000003", "step_0000000004"]
    assert "tmp.9" in os.listdir(d) and "tmp.4" not in os.listdir(d)


def test_bfloat16_round_trips_between_packages(tmp_path):
    """bfloat16 leaves travel as a tagged ``uint16`` view: a torch bf16
    tensor saved by the port restores bit-exact in the port and in the
    reference (as ml_dtypes bf16), and the reference's bf16 restores in
    the port as a torch bf16 tensor."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    ckpt.save(str(tmp_path / "p"), 1, {"w": x, "n": np.int32(7)})
    back = ckpt.restore(str(tmp_path / "p"), 1,
                        {"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                         "n": np.int32(0)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    assert int(back["n"]) == 7
    ref = jckpt.restore(str(tmp_path / "p"), 1,
                        {"w": jnp.zeros((5, 3), jnp.bfloat16),
                         "n": jnp.int32(0)})
    assert np.asarray(ref["w"]).view(np.uint16).tobytes() == \
        x.view(torch.int16).numpy().view(np.uint16).tobytes()
    y = np.random.default_rng(0).standard_normal((4, 2)).astype(
        ml_dtypes.bfloat16)
    jckpt.save(str(tmp_path / "j"), 1, {"w": jnp.asarray(y)})
    got = ckpt.restore(str(tmp_path / "j"), 1,
                       {"w": torch.zeros(4, 2, dtype=torch.bfloat16)})["w"]
    assert got.view(torch.int16).numpy().view(np.uint16).tobytes() == \
        y.view(np.uint16).tobytes()


def test_train_state_restores_bit_exact_across_packages(tmp_path):
    """The training checkpoint ``(params, opt_state)``: the port's GCN and
    AdamW state (nonzero moments, step 3) restore bit-exact in the port,
    the reference restores the port's under its own pytree structure,
    and the port restores the reference's."""
    model = _model(1)
    opt = init_adam(model.leaves())
    rng = np.random.default_rng(2)
    opt = opt._replace(step=torch.tensor(3, dtype=torch.int32),
                       m=[torch.from_numpy(rng.standard_normal(p.shape)
                                           .astype(np.float32))
                          for p in opt.m],
                       v=[torch.from_numpy(rng.random(p.shape)
                                           .astype(np.float32))
                          for p in opt.v])
    tree = (gcn_params_to_numpy(model), adam_state_to_numpy(opt))
    d = str(tmp_path / "port")
    ckpt.save(d, 3, tree)
    like = (gcn_params_to_numpy(_model(9)),
            adam_state_to_numpy(init_adam(_model(9).leaves())))
    p_np, o_np = ckpt.restore(d, 3, like)
    back, back_opt = gcn_params_from_numpy(p_np, device="cpu"), \
        adam_state_from_numpy(o_np, device="cpu")
    _leaves_equal(back.leaves(), model.leaves())
    assert int(back_opt.step) == 3
    _leaves_equal(back_opt.m + back_opt.v, opt.m + opt.v)

    from repro.models import gcn as jgcn
    jparams = jgcn.init_gcn(_CFG, jax.random.PRNGKey(0))
    jtree = jckpt.restore(d, 3, (jparams, jinit_adam(jparams)))
    _leaves_equal(jtree, tree)
    jd = str(tmp_path / "ref")
    jckpt.save(jd, 5, jtree)
    assert ckpt.latest_step(jd) == 5
    _leaves_equal(ckpt.restore(jd, 5, like), tree)


def test_layout_mismatch_raises(tmp_path):
    """A serving state restored under a cache of another ``n_rows``,
    ``assoc``, ``mode`` or ``l1_rows`` raises; a leaf whose shape does
    not fit its target raises; a frozen serve view of the same layout is
    accepted."""
    cfg = tfc.CacheConfig.from_model(_CFG)
    model = _model()
    cache = cache_state_from_numpy(_warm_cache(cfg, w=1), device="cpu")
    d = str(tmp_path / "s")
    ckpt.save_serving_state(d, 2, model, cache, cache_cfg=cfg)
    for change in (dict(n_rows=2 * cfg.n_rows), dict(assoc=2),
                   dict(l1_rows=cfg.l1_rows // 2)):
        with pytest.raises(ValueError, match="layout mismatch"):
            ckpt.restore_serving_state(
                d, model, cache, expect_cache_cfg=cfg._replace(**change))
    with pytest.raises(ValueError, match="layout mismatch"):
        ckpt.restore_serving_state(
            d, model, cache, expect_cache_cfg=cfg._replace(mode="sharded",
                                                           l1_rows=0))
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore_serving_state(d, model, tfc.init_cache_state(
            cfg, 16, 2, device="cpu"))
    got_model, got_cache = ckpt.restore_serving_state(
        d, model, cache, expect_cache_cfg=cfg.serve_view())
    _leaves_equal(got_model.leaves(), model.leaves())
    _leaves_equal(got_cache, cache)


@pytest.mark.parametrize("mode", ["sharded", "tiered"])
def test_serving_state_crosses_packages(tmp_path, mode):
    """The reference writes a serving state (GCN params and a stacked W = 2
    cache) and the port restores params and cache equal to ``convert``'s
    from the same arrays; the port writes one and the reference restores
    it, layout-checked, equal to the port's tensors."""
    from repro.models import gcn as jgcn
    cfg = tfc.CacheConfig.from_model(_CFG)
    if mode == "sharded":
        cfg = cfg._replace(mode="sharded", l1_rows=0).validated()
    jcfg = jfc.CacheConfig(*cfg)
    jparams = jgcn.init_gcn(_CFG, jax.random.PRNGKey(4))
    warm = _warm_cache(cfg, w=2, seed=3)
    jcache = jax.tree.map(jnp.asarray, warm)
    d = str(tmp_path / "from_ref")
    jckpt.save_serving_state(d, 7, jparams, jcache, cache_cfg=jcfg)
    empty = tfc.init_cache_state(cfg, 16, 2, device="cpu")
    model, cache = ckpt.restore_serving_state(
        d, _model(), empty, expect_cache_cfg=cfg.serve_view())
    _leaves_equal(model.leaves(), gcn_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu").leaves())
    _leaves_equal(cache, cache_state_from_numpy(warm, device="cpu"))
    assert type(cache) is type(empty)

    d2 = str(tmp_path / "from_port")
    port_model = _model(6)
    ckpt.save_serving_state(d2, 8, port_model, cache, cache_cfg=cfg)
    jp, jc = jckpt.restore_serving_state(
        d2, jparams, jax.tree.map(jnp.zeros_like, jcache),
        expect_cache_cfg=jcfg.serve_view())
    _leaves_equal(jp, gcn_params_to_numpy(port_model))
    _leaves_equal(jc, cache)


def _train_args(tmp, steps, *extra):
    from repro_torch.launch import train
    return train.parse_args([
        "--arch", "graphgen-gcn-deep", "--smoke", "--device", "cpu",
        "--nodes", "600", "--batch-per-worker", "6", "--steps", str(steps),
        "--log-every", "100", "--ckpt-dir", os.path.join(tmp, "ck"), *extra])


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Six CPU train steps exported for serving, checkpointing never."""
    from repro_torch.launch import train
    tmp = str(tmp_path_factory.mktemp("run"))
    res = train.train_gcn(_train_args(
        tmp, 6, "--ckpt-every", "100", "--export-serve",
        os.path.join(tmp, "serve")))
    return res, tmp


def test_train_cli_resume_matches_uninterrupted(uninterrupted, tmp_path):
    """The CPU train entry point, 4 steps with ``--ckpt-every 2``, then
    ``--resume`` to 6: the resumed steps' losses and the final params
    equal the uninterrupted run's (the resume primes batch 4's seeds and
    draws; its cold cache changes hits, not features, while nothing
    drops)."""
    from repro_torch.launch import train
    full, _ = uninterrupted
    tmp = str(tmp_path)
    first = train.train_gcn(_train_args(tmp, 4, "--ckpt-every", "2"))
    assert sorted(os.listdir(os.path.join(tmp, "ck"))) == [
        "step_0000000002", "step_0000000004"]
    resumed = train.train_gcn(_train_args(tmp, 6, "--ckpt-every", "2",
                                          "--resume"))
    assert resumed["start"] == 4 and len(resumed["losses"]) == 2
    assert first["losses"] + resumed["losses"] == full["losses"]
    assert resumed["n_dropped"] == first["n_dropped"] == 0
    _leaves_equal(resumed["model"].leaves(), full["model"].leaves())


def test_export_serve_then_warm_from(uninterrupted):
    """``--export-serve DIR`` then ``serve --warm-from DIR``: the server
    comes up with the trained params and warm cache, answers requests
    with the in-process server's logits on the same draws, adds no step
    shape on the request path, and ``serve_gcn`` runs on it."""
    from repro_torch.core.generation import SeededDraws
    from repro_torch.launch import serve
    full, tmp = uninterrupted
    args = serve.parse_args([
        "--arch", "graphgen-gcn-deep", "--smoke", "--device", "cpu",
        "--nodes", "600", "--requests", "4",
        "--warm-from", os.path.join(tmp, "serve")])
    warm, head = serve.build_server(args)
    _leaves_equal(warm._model.leaves(), full["model"].leaves())
    _leaves_equal(warm.cache, full["cache"])
    live = serve.GraphServer(warm._gen_fn, warm._device_args, full["model"],
                             full["cache"],
                             draws=SeededDraws(_CFG.fanouts, 0, "cpu"),
                             buckets=warm.buckets, n_workers=1)
    rng = np.random.default_rng(3)
    for s in (warm, live):
        s.warmup()
    for ids in serve._zipf_request_stream(rng, 4, head, warm.capacity):
        assert torch.equal(warm.logits(ids), live.logits(ids))
    assert warm.compile_count() == live.compile_count() == 3
    res = serve.serve_gcn(args, (warm, head))
    assert res["request_path_compiles"] == 0 and res["n_requests"] == 4
