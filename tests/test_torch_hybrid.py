"""The port's Zamba2 hybrid (``repro_torch.models.hybrid``) against the
reference (``repro.models.hybrid``).

On the CPU, inputs made by numpy from a seed, weights carried across by
``repro_torch.convert.hybrid_params_from_numpy``:

* zamba2-1.2b's config and its smoke config field by field, and the
  layer schedule (6 sites of 6 Mamba layers and 2 tail layers at full
  size; 2 sites of 2 and 1 tail layer in the smoke config);
* the smoke model in float32 compute (``COMPUTE_DTYPE`` in both
  packages): forward, loss and decode from the reference's cache, every
  cache leaf compared (the SSM state, the conv history and each site's
  K/V) (``_torch_parity.check_lm_parity``);
* the flash case at L = 128: the port's ``ops.flash_attention`` (its
  plain twin here) at both sites against the reference's Pallas kernel in
  interpret mode, logits within rtol 1e-5 / atol 1e-6, with one
  ``ops.ssd_scan`` call per Mamba layer and one flash call per site;
* ``serve_lm`` on the CPU and the entry points' default device.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (check_lm_parity, ref_params,  # noqa: E402
                           set_compute)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import hybrid, layers, ssm, zoo  # noqa: E402

ARCH = "zamba2-1.2b"


@pytest.fixture
def f32(monkeypatch):
    """float32 compute in both packages."""
    set_compute(monkeypatch, "float32")


def _smoke(flash=False):
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                              use_flash_attention=flash)
    jcfg = dataclasses.replace(jsmoke_config(jget_config(ARCH)),
                               use_flash_attention=flash)
    return cfg, jcfg


def test_hybrid_config_and_schedule():
    """The full and smoke configs carry the reference's value in every
    field the port has; the SSM dims are the reference's; the schedule
    runs the shared block after every ``attn_every``-th Mamba layer, then
    the tail (zamba2-1.2b: 6 sites, 2 tail layers)."""
    for a, b in ((get_config(ARCH), jget_config(ARCH)), _smoke()):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert hybrid.grouped(a) == JH._grouped(b)
    assert hybrid.grouped(get_config(ARCH)) == (6, 2)
    model = hybrid.Zamba2LM(_smoke()[0], "cpu")
    assert model.schedule() == [("mamba", 0), ("mamba", 1), ("attn", 0),
                                ("mamba", 2), ("mamba", 3), ("attn", 1),
                                ("mamba", 4)]
    with pytest.raises(ValueError, match="hybrid config"):
        hybrid.Zamba2LM(smoke_config(get_config("mamba2-1.3b")), "cpu")


def test_hybrid_matches_reference(f32):
    """The smoke model (two sites and a tail layer) on the reference's
    weights: forward, loss and six decode steps from the reference's
    cache, every leaf compared."""
    cfg, jcfg = _smoke()
    params = ref_params(JH.init_zamba2, jcfg, seed=1)
    model = convert.hybrid_params_from_numpy(params, cfg, device="cpu")
    check_lm_parity(JH, jcfg, params, model, convert.hybrid_cache_from_numpy)


def test_hybrid_flash_case_at_128(f32, monkeypatch):
    """With flash on and L = 128, every site runs ``ops.flash_attention``
    and every Mamba layer ``ops.ssd_scan`` (counted through the dispatch);
    the logits match the reference's, whose sites run the Pallas kernel
    in interpret mode."""
    cfg, jcfg = _smoke(flash=True)
    params = ref_params(JH.init_zamba2, jcfg, seed=2)
    model = convert.hybrid_params_from_numpy(params, cfg, device="cpu")
    calls = {"flash_attention": 0, "ssd_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32)
    got = zoo.forward_logits(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert calls == {"flash_attention": 2, "ssd_scan": 5}
    want = jax.jit(lambda p, t: JH.forward_train(jcfg, p, t))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_serve_lm_hybrid_cpu_smoke():
    """serve_lm --arch zamba2-1.2b --smoke --device cpu: tokens in the
    padded vocab, one seed the same tokens twice; the cache has the
    reference's layout and dtypes."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    toks = serve.serve_lm(serve.parse_args(argv))["tokens"]
    cfg, jcfg = _smoke()
    assert toks.shape == (2, 4)
    assert toks.min() >= 0 and toks.max() < layers.padded_vocab(cfg)
    np.testing.assert_array_equal(
        serve.serve_lm(serve.parse_args(argv))["tokens"], toks)
    api = zoo.build(cfg, "cpu")
    cache = api.init_cache(api.init(0), 2, 9)
    want = JH.init_cache(jcfg, 2, 9)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert ssm.dims(cfg)[1:] == (8, 16, 16)


@pytest.mark.parametrize("entry", ["model", "init", "zoo", "serve"])
def test_hybrid_entry_points_default_to_the_card(entry, monkeypatch):
    """Zamba2LM, init_zamba2, zoo.build and serve_lm run on the card unless
    asked for the CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _smoke()[0]
    call = {"model": lambda: hybrid.Zamba2LM(cfg),
            "init": lambda: hybrid.init_zamba2(cfg),
            "zoo": lambda: zoo.build(cfg),
            "serve": lambda: serve.serve_lm(serve.parse_args(
                ["--arch", ARCH, "--smoke"]))}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()
