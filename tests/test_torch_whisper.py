"""The port's Whisper (``repro_torch.models.whisper``) against the
reference (``repro.models.whisper``).

On the CPU, inputs made by numpy from a seed, weights carried across by
``repro_torch.convert.whisper_params_from_numpy``:

* whisper-small's config and its smoke config field by field;
* the encoder alone against ``whisper.encode`` (frames cast to the
  compute dtype before ``aproj``; non-causal self-attention roped at the
  frame positions), float32 rtol 1e-5 / atol 1e-6;
* the smoke model in float32 compute (``COMPUTE_DTYPE`` in both
  packages): forward and loss with seeded frames, and decode from the
  reference's cache with ``enc`` filled by ``whisper.encode`` as
  ``tests/test_models_smoke.py`` fills it, every cache leaf compared
  (``_torch_parity.check_lm_parity``; logits rtol 1e-5 / atol 1e-6, loss
  rtol 1e-4, decode rtol/atol 1e-5); decode hands ``enc`` back as it
  was;
* the flash case at L = 128: ``ops.flash_attention`` (its plain twin
  here) at every decoder self-attention and nowhere else (12 frames), the
  logits against the reference's, whose decoder runs the Pallas kernel in
  interpret mode;
* ``convert.lm_leaves``' layout is the reference's pytree order
  (``aproj``, ``decoder/...``, ``embed``, ``encoder/...``);
* ``serve_lm`` on the CPU (decoding against the zero ``enc`` cache, as
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
                           ref_params, set_compute, stub_inputs)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, whisper, zoo  # noqa: E402

ARCH = "whisper-small"


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


def _model(jcfg, cfg, seed):
    params = ref_params(JW.init_whisper, jcfg, seed=seed)
    return params, convert.whisper_params_from_numpy(params, cfg,
                                                     device="cpu")


def test_whisper_config():
    """The full and smoke configs carry the reference's value in every
    field the port has (whisper-small: 12 + 12 layers, 1 500 frames of
    768; smoke: 2 + 2 layers, 12 frames of 24)."""
    for a, b in ((get_config(ARCH), jget_config(ARCH)), _smoke()):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    model = whisper.WhisperLM(_smoke()[0], "cpu")
    assert len(model.encoder) == 2 and len(model.decoder) == 2
    assert model.head is not None
    with pytest.raises(ValueError, match="audio config"):
        whisper.WhisperLM(smoke_config(get_config("smollm-135m")), "cpu")


def test_whisper_encoder_matches(f32):
    """The encoder alone: the reference's ``encode`` on the same frames."""
    cfg, jcfg = _smoke()
    params, model = _model(jcfg, cfg, 5)
    frames = stub_inputs(cfg, 2, 5)["frames"]
    with torch.no_grad():
        got = model.encode(torch.from_numpy(frames))
    want = JW.encode(jcfg, jax.tree.map(jnp.asarray, params),
                     jnp.asarray(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_whisper_matches_reference(f32):
    """The smoke model on the reference's weights: forward, loss and six
    decode steps from the reference's cache (``enc`` filled), every leaf
    compared; the port's decode returns ``enc`` untouched."""
    cfg, jcfg = _smoke()
    params, model = _model(jcfg, cfg, 1)
    check_lm_parity(JW, jcfg, params, model,
                    convert.whisper_cache_from_numpy)
    cache = model.init_cache(2, 4)
    cache["enc"].normal_(generator=torch.Generator().manual_seed(0))
    enc = cache["enc"].clone()
    with torch.no_grad():
        _, out = model.forward_decode(cache, torch.zeros((2, 1),
                                                         dtype=torch.int32), 0)
    assert torch.equal(out["enc"], enc)


def test_whisper_flash_case_at_128(f32, monkeypatch):
    """With flash on and L = 128, every decoder self-attention runs
    ``ops.flash_attention`` and nothing else does (the encoder's 12 frames
    and the cross sites take the plain path); the logits match the
    reference's."""
    cfg, jcfg = _smoke(flash=True)
    params, model = _model(jcfg, cfg, 2)
    calls = {"flash_attention": 0}
    real = ops.flash_attention

    def counted(*a, **kw):
        calls["flash_attention"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32)
    frames = stub_inputs(cfg, 1, 4)["frames"]
    got = zoo.forward_logits(cfg, model, {
        "tokens": torch.from_numpy(tokens),
        "frames": torch.from_numpy(frames)})
    assert calls == {"flash_attention": cfg.n_layers}
    want = jax.jit(lambda p, t, f: JW.forward_train(jcfg, p, t, f))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_whisper_leaf_layout_is_the_references():
    """``lm_leaves``' paths are the reference's flatten order and
    ``lm_params_to_numpy`` gives back the reference's tree."""
    cfg, jcfg = _smoke()
    params, model = _model(jcfg, cfg, 3)
    assert_layout_matches(model, params)
    assert list(params) == ["aproj", "decoder", "embed", "encoder"]


def test_serve_lm_whisper_cpu_smoke():
    """serve_lm --arch whisper-small --smoke --device cpu: tokens in the
    padded vocab, one seed the same tokens twice; the cache has the
    reference's layout and dtypes, and its ``enc`` stays zero (no audio
    prefill on this path, as in the reference)."""
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
    want = JW.init_cache(jcfg, 2, 9)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    _, cache = api.decode(model, cache, torch.zeros((2, 1), dtype=torch.int32),
                          0)
    assert not cache["enc"].any()


@pytest.mark.parametrize("entry", ["model", "init", "zoo", "serve"])
def test_whisper_entry_points_default_to_the_card(entry, monkeypatch):
    """WhisperLM, init_whisper, zoo.build and serve_lm run on the card
    unless asked for the CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _smoke()[0]
    call = {"model": lambda: whisper.WhisperLM(cfg),
            "init": lambda: whisper.init_whisper(cfg),
            "zoo": lambda: zoo.build(cfg),
            "serve": lambda: serve.serve_lm(serve.parse_args(
                ["--arch", ARCH, "--smoke"]))}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()
