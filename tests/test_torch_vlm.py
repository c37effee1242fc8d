"""The port's Llama-3.2-Vision VLM (``repro_torch.models.vlm``) against
the reference (``repro.models.vlm``).

On the CPU, inputs made by numpy from a seed, weights carried across by
``repro_torch.convert.vlm_params_from_numpy``; the gates are 0 at the
reference's init, so every check of the cross path also runs with the
gates set from a seed to non-zero values (``_torch_parity.open_gates``):

* llama-3.2-vision-11b's config and its smoke config field by field, and
  the grouping (8 sites of 5 layers; 2 of 2 in the smoke config);
* the smoke model in float32 compute (``COMPUTE_DTYPE`` in both
  packages): forward and loss with seeded vision embeddings, and decode
  from the reference's cache with the per-site vision keys and values
  filled as ``tests/test_models_smoke.py`` fills them, every cache leaf
  compared (``_torch_parity.check_lm_parity``; logits rtol 1e-5 / atol
  1e-6, loss rtol 1e-4, decode rtol/atol 1e-5);
* the flash case at L = 128: ``ops.flash_attention`` (its plain twin
  here) at every self layer and at no cross site (8 vision tokens), the
  logits against the reference's, whose self layers run the Pallas kernel
  in interpret mode;
* ``convert.lm_leaves``' layout is the reference's pytree order
  (``embed``, ``vproj``, ``layers/...``, ``cross/{attn,gate,ln}``);
* ``serve_lm`` on the CPU (decoding against the zero vision caches, as
  the reference's does) and the entry points' default device.

Gradients and training steps are in ``tests/test_torch_train_lm.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_layout_matches, check_lm_parity,  # noqa: E402
                           open_gates, ref_params, set_compute,
                           stub_inputs)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import vlm as JV  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, vlm, zoo  # noqa: E402

ARCH = "llama-3.2-vision-11b"


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


def _model(jcfg, cfg, seed, gates):
    params = ref_params(JV.init_vlm, jcfg, seed=seed)
    if gates == "open":
        open_gates(params, seed)
    return params, convert.vlm_params_from_numpy(params, cfg, device="cpu")


def test_vlm_config_and_sites():
    """The full and smoke configs carry the reference's value in every
    field the port has; 8 sites of 5 layers at full size, 2 of 2 in the
    smoke config; a depth that is not a multiple of the period is
    refused."""
    for a, b in ((get_config(ARCH), jget_config(ARCH)), _smoke()):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert vlm.n_sites(a) == JV._n_sites(b)
    assert vlm.n_sites(get_config(ARCH)) == 8
    cfg = _smoke()[0]
    model = vlm.VisionLM(cfg, "cpu")
    assert len(model.layers) == 4 and len(model.cross) == 2
    assert not any(bool(c.gate.any()) for c in model.cross)
    with pytest.raises(ValueError, match="multiple of cross_attn_every"):
        vlm.VisionLM(dataclasses.replace(cfg, n_layers=5), "cpu")


@pytest.mark.parametrize("gates", ["init", "open"])
def test_vlm_matches_reference(f32, gates):
    """The smoke model on the reference's weights: forward, loss and six
    decode steps from the reference's cache (vision caches filled), every
    leaf compared; with the gates at 0 and set non-zero."""
    cfg, jcfg = _smoke()
    params, model = _model(jcfg, cfg, 1, gates)
    check_lm_parity(JV, jcfg, params, model, convert.vlm_cache_from_numpy)


def test_vlm_flash_case_at_128(f32, monkeypatch):
    """With flash on and L = 128, every self layer runs
    ``ops.flash_attention`` and no cross site does (8 vision tokens are
    not a multiple of 128); the logits match the reference's (open
    gates)."""
    cfg, jcfg = _smoke(flash=True)
    params, model = _model(jcfg, cfg, 2, "open")
    calls = {"flash_attention": 0}
    real = ops.flash_attention

    def counted(*a, **kw):
        calls["flash_attention"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32)
    vision = stub_inputs(cfg, 1, 4)["vision"]
    got = zoo.forward_logits(cfg, model, {
        "tokens": torch.from_numpy(tokens),
        "vision": torch.from_numpy(vision)})
    assert calls == {"flash_attention": cfg.n_layers}
    want = jax.jit(lambda p, t, v: JV.forward_train(jcfg, p, t, v))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(vision))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_vlm_leaf_layout_is_the_references():
    """``lm_leaves``' paths are the reference's flatten order and
    ``lm_params_to_numpy`` gives back the reference's tree."""
    cfg, jcfg = _smoke()
    params, model = _model(jcfg, cfg, 3, "open")
    assert_layout_matches(model, params)
    assert list(params) == ["cross", "embed", "layers", "vproj"]


def test_serve_lm_vlm_cpu_smoke():
    """serve_lm --arch llama-3.2-vision-11b --smoke --device cpu: tokens
    in the padded vocab, one seed the same tokens twice, the vision caches
    still zero (no vision prefill on this path, as in the reference); the
    cache has the reference's layout and dtypes."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    toks = serve.serve_lm(serve.parse_args(argv))["tokens"]
    cfg, jcfg = _smoke()
    assert toks.shape == (2, 4)
    assert toks.min() >= 0 and toks.max() < layers.padded_vocab(cfg)
    np.testing.assert_array_equal(
        serve.serve_lm(serve.parse_args(argv))["tokens"], toks)
    api = zoo.build(cfg, "cpu")
    model = api.init(0)
    cache = api.init_cache(model, 2, 9)
    want = JV.init_cache(jcfg, 2, 9)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    _, cache = api.decode(model, cache, torch.zeros((2, 1), dtype=torch.int32),
                          0)
    assert not cache["vis_k"].any() and not cache["vis_v"].any()


@pytest.mark.parametrize("entry", ["model", "init", "zoo", "serve"])
def test_vlm_entry_points_default_to_the_card(entry, monkeypatch):
    """VisionLM, init_vlm, zoo.build and serve_lm run on the card unless
    asked for the CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _smoke()[0]
    call = {"model": lambda: vlm.VisionLM(cfg),
            "init": lambda: vlm.init_vlm(cfg),
            "zoo": lambda: zoo.build(cfg),
            "serve": lambda: serve.serve_lm(serve.parse_args(
                ["--arch", ARCH, "--smoke"]))}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()
