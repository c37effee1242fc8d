"""The port's dense LM against the reference (``repro.models``).

On the CPU, with inputs made by numpy from a seed and weights carried
across by ``repro_torch.convert``:

* ``rmsnorm``, ``apply_rope`` and ``mlp_forward`` against
  ``repro.models.layers`` in float32 (rtol 1e-5 / atol 1e-6: one op or a
  short f32 sum apart);
* the flash twin (``kernels.ref.flash_attention_ref``) against the Pallas
  kernel in interpret mode, whose arithmetic it follows (float32 within
  rtol/atol 1e-5, the online softmax's summation order; bfloat16 within
  one output ulp, atol/rtol 8e-3, since both round the same float32 value
  once), and against the jnp oracle ``ref.flash_attention_ref`` (float32
  1e-5; bfloat16 5e-2, the oracle forms bf16 logits);
* ``gqa_attention`` on both branches, the full-sequence forward at the
  dense smoke config in float32 compute (``COMPUTE_DTYPE`` set to float32
  in both packages; logits within rtol 1e-5 / atol 1e-6, 4 layers of f32
  matmuls in another order, 1.8e-7 seen) and in bfloat16 (atol 1e-2 on
  logits of scale ~0.5, 3.9e-3 seen: bf16 activations differ by an ulp
  where XLA and torch round at other places, which also flips ~1% of
  the argmaxes), and 8 greedy decode steps from the reference's own cache
  with equal tokens in float32;
* the untied dense configs (stablelm-12b, llama3-405b) at their smoke
  configs in float32: forward, loss and decode from the reference's cache
  (``_torch_parity.check_lm_parity``);
* ``serve_lm`` on the CPU, and the dispatch's refusals.

On a card (marked ``cuda``): the CUDA kernel against its twin, Dh 64,
128 and 160.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import check_lm_parity, set_compute  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.config import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, zoo  # noqa: E402

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.fixture
def compute(monkeypatch, request):
    """Set both packages' ``COMPUTE_DTYPE`` to the parametrized dtype."""
    tdt, jdt = _DT[request.param]
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", tdt)
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jdt)
    return request.param


def _smoke(flash=True):
    """The dense smoke config of smollm-135m in both packages."""
    cfg = dataclasses.replace(smoke_config(get_config("smollm-135m")),
                              use_flash_attention=flash)
    jcfg = dataclasses.replace(jsmoke_config(jget_config("smollm-135m")),
                               use_flash_attention=flash)
    return cfg, jcfg


def _ref_model(jcfg, cfg, seed=0):
    """Reference params (numpy) and the port's DenseLM holding them."""
    params = jax.tree.map(np.asarray, JT.init_lm(jcfg,
                                                 jax.random.PRNGKey(seed)))
    return params, convert.lm_params_from_numpy(params, cfg, device="cpu")


# ------------------------------------------------------------------ configs

def test_lm_configs_match_reference():
    """The dense configs (smollm-135m/360m, stablelm-12b, llama3-405b) and
    their smoke variants carry the reference's values in every field the
    port has; the registry holds every LM arch of the reference."""
    from repro.configs import ASSIGNED_ARCHS
    from repro_torch.configs import REGISTRY
    assert set(ASSIGNED_ARCHS) <= set(REGISTRY)
    for name in ("smollm-135m", "smollm-360m", "stablelm-12b",
                 "llama3-405b"):
        for a, b in ((get_config(name), jget_config(name)),
                     (smoke_config(get_config(name)),
                      jsmoke_config(jget_config(name)))):
            for f in dataclasses.fields(a):
                assert getattr(a, f.name) == getattr(b, f.name), (name,
                                                                 f.name)
            assert a.resolved_head_dim == b.resolved_head_dim


@pytest.mark.parametrize("vocab", [512, 1000, 49152, 50257])
def test_padded_vocab(vocab):
    """Vocab padding to a multiple of 256, as the reference pads it."""
    cfg = ModelConfig(name="x", family="dense", vocab_size=vocab)
    assert layers.padded_vocab(cfg) == JL.padded_vocab(cfg)
    assert layers.padded_vocab(cfg) % 256 == 0


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    """rmsnorm: float32 statistics, cast back (bf16: one output ulp)."""
    tdt, jdt = _DT[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = layers.rmsnorm(torch.from_numpy(w), torch.from_numpy(x).to(tdt))
    want = JL.rmsnorm(jnp.asarray(w), _j(x, jdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_rope_matches_rotate_half():
    """apply_rope: rotate-half layout at integer positions, and position 0
    is the identity."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    zero = layers.apply_rope(torch.from_numpy(x), torch.zeros(2, 7,
                                                              dtype=torch.int32),
                             10_000.0)
    np.testing.assert_array_equal(zero.numpy(), x)


def test_mlp_and_loss_match():
    """SwiGLU MLP and the cross entropy over the padded vocab, float32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = {n: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("wg", (64, 128)), ("wu", (64, 128)),
                      ("wd", (128, 64)))}
    got = layers.mlp_forward(types.SimpleNamespace(
        **{n: torch.from_numpy(a) for n, a in w.items()}), torch.from_numpy(x))
    want = JL.mlp_forward({n: jnp.asarray(a) for n, a in w.items()},
                          jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32)
    labels = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.lm_loss(torch.from_numpy(logits),
                       torch.from_numpy(labels)).item(),
        float(JL.lm_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


# -------------------------------------------------------------- flash twin

FLASH_CASES = [  # b, hq, hkv, lq, lk, dh, causal
    (1, 3, 1, 128, 128, 64, True),      # GQA 3:1, the forward's shape
    (2, 6, 2, 128, 128, 16, False),
    (1, 3, 1, 64, 192, 32, True),       # Lq < Lk: causal offset Lk - Lq
    (1, 2, 2, 64, 128, 64, False),
]


def _qkv(b, hq, hkv, lq, lk, dh, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_twin_matches_pallas_and_oracle(case, dtype):
    """The twin against the Pallas kernel (interpret mode) tightly and the
    jnp oracle at the looser bf16 bound; the GQA order is
    repeat_interleave's (query head h reads KV head h // group)."""
    b, hq, hkv, lq, lk, dh, causal = case
    tdt, jdt = _DT[dtype]
    q, k, v = _qkv(b, hq, hkv, lq, lk, dh)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tdt and got.shape == tq.shape
    jq, jk, jv = (_j(a, jdt) for a in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal,
                                    block_q=64, block_k=64)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    tight, loose = (1e-5, 1e-5) if dtype == "float32" else (8e-3, 5e-2)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32),
                               rtol=tight, atol=tight)
    np.testing.assert_allclose(_np(got), np.asarray(oracle, np.float32),
                               rtol=loose, atol=loose)
    group = hq // hkv
    rep = ref.flash_attention_ref(
        tq, tk.repeat_interleave(group, dim=1),
        tv.repeat_interleave(group, dim=1), causal=causal)
    torch.testing.assert_close(got, rep, rtol=0, atol=0)


def test_flash_dispatch_refuses():
    """ops never guesses a device; the kernel's wrapper refuses a head dim
    it is not built for (DeepSeek's 192-wide q/k heads) and lengths off
    its tile;
    the flash path refuses autograd rather than drop the gradient."""
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.flash_attention(q, torch.zeros(1, 2, 64, 64, device="meta"),
                            torch.zeros(1, 2, 64, 64))
    with pytest.raises(ValueError, match="head dims"):
        flash_mod.flash_attention_cuda(torch.zeros(1, 2, 64, 192),
                                       torch.zeros(1, 2, 64, 192),
                                       torch.zeros(1, 2, 64, 192))
    with pytest.raises(ValueError, match="multiples of 64"):
        flash_mod.flash_attention_cuda(torch.zeros(1, 2, 96, 64),
                                       torch.zeros(1, 2, 96, 64),
                                       torch.zeros(1, 2, 96, 64))
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_mod.flash_attention_cuda(q, q, q)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), q.detach(), q.detach())
    assert "flash_attention" in ops.KERNELS


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("compute", ["float32", "bfloat16"], indirect=True)
def test_gqa_attention_both_branches(compute):
    """gqa_attention's flash branch (lengths multiples of 128, no cache)
    and its decode branch (kv_valid_len) against the reference's."""
    tdt, jdt = _DT[compute]
    rng = np.random.default_rng(5)
    tol = 1e-5 if compute == "float32" else 2e-2
    for lq, lk, use_flash, valid in ((128, 128, True, None),
                                     (1, 24, True, 9), (5, 24, False, 13)):
        q = rng.standard_normal((2, lq, 3, 16)).astype(np.float32)
        k = rng.standard_normal((2, lk, 1, 16)).astype(np.float32)
        v = rng.standard_normal((2, lk, 1, 16)).astype(np.float32)
        causal = valid is None
        got = layers.gqa_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
            use_flash=use_flash, kv_valid_len=valid)
        want = JL.gqa_attention(
            *(_j(a, jdt) for a in (q, k, v)), causal=causal,
            use_flash=use_flash,
            kv_valid_len=None if valid is None else jnp.int32(valid))
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_branch_runs_the_kernel_dispatch(monkeypatch):
    """The predicate sends a 128-multiple, cache-free attention through
    ops.flash_attention and everything else through the plain path; the
    operands arrive as [B, H, L, Dh] views of the [B, L, H, Dh] inputs
    (their strides, no copy in between)."""
    calls = []
    real = ops.flash_attention

    def record(*a, **kw):
        calls.append((a[0].shape,) + tuple(t.stride() for t in a[:3]))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", record)
    x = torch.zeros(1, 128, 3, 16)
    kv = torch.zeros(1, 128, 1, 16)
    layers.gqa_attention(x, kv, kv, causal=True, use_flash=True)
    layers.gqa_attention(x, kv, kv, causal=True, use_flash=False)
    layers.gqa_attention(x[:, :1], kv, kv, causal=False, use_flash=True,
                         kv_valid_len=3)
    layers.gqa_attention(x[:, :64], kv[:, :64], kv[:, :64], causal=True,
                         use_flash=True)
    assert calls == [(torch.Size([1, 3, 128, 16]), (6144, 16, 48, 1),
                      (2048, 16, 16, 1), (2048, 16, 16, 1))]


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"], indirect=True)
def test_forward_logits_matches(compute, flash):
    """forward_logits at the dense smoke config, B = 2, S = 128, on the
    reference's weights: float32 compute within rtol 1e-5 / atol 1e-6,
    bfloat16 within atol 1e-2 (logits ~0.5); and the model's loss against
    ``loss_fn`` (rtol 1e-4, a mean over 256 positions) on the plain
    path."""
    cfg, jcfg = _smoke(flash)
    params, model = _ref_model(jcfg, cfg)
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    got = zoo.forward_logits(cfg, model, {"tokens": torch.from_numpy(tokens)})
    want = jax.jit(lambda p, t: JT.forward_train(jcfg, p, t))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (2, 128, layers.padded_vocab(cfg))
    want = np.asarray(want)
    if not flash:
        labels = np.roll(tokens, -1, axis=1)
        with torch.no_grad():
            loss = zoo.build(cfg, "cpu").loss(
                model, {"tokens": torch.from_numpy(tokens),
                        "labels": torch.from_numpy(labels)})
        jloss = JT.loss_fn(jcfg, jax.tree.map(jnp.asarray, params),
                           {"tokens": jnp.asarray(tokens),
                            "labels": jnp.asarray(labels)})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("compute", ["float32"], indirect=True)
def test_decode_from_reference_cache(compute):
    """Five prompt steps in the reference, then 8 greedy decode steps in
    both packages from the reference's own cache (the port's starts from
    ``lm_cache_from_numpy``): tokens equal, logits within 1e-5, and the
    bf16 caches after the run within one bf16 ulp (2^-7 relative: keys
    one f32 ulp apart can round to neighbouring bf16 values)."""
    cfg, jcfg = _smoke(True)
    params, model = _ref_model(jcfg, cfg, seed=1)
    jp = jax.tree.map(jnp.asarray, params)
    decode = jax.jit(lambda p, c, t, pos: JT.forward_decode(jcfg, p, c, t,
                                                            pos))
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jcache = JT.init_cache(jcfg, 2, 16)
    for p in range(5):
        logits, jcache = decode(jp, jcache, jnp.asarray(prompt[:, p:p + 1]),
                                jnp.int32(p))
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        device="cpu")
    jtok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    tok = torch.from_numpy(np.array(jtok))
    jtoks, toks = [], []
    with torch.no_grad():
        for pos in range(5, 13):
            jl, jcache = decode(jp, jcache, jtok, jnp.int32(pos))
            tl, cache = model.forward_decode(cache, tok, pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                       atol=1e-5)
            jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
            tok = torch.argmax(tl, dim=-1)[:, None].to(torch.int32)
            jtoks.append(np.asarray(jtok))
            toks.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache[name].to(torch.float32).numpy(),
            np.asarray(jcache[name], np.float32), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("prompt_len", [0, 6])
def test_serve_lm_cpu_smoke(prompt_len):
    """serve_lm --device cpu --smoke: the family dispatch reaches the
    decode loop; tokens lie in the padded vocab; --prompt-len 0 starts
    from token 0; one seed gives the same tokens twice."""
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", str(prompt_len), "--gen-len", "5"]
    res = serve.serve_lm(serve.parse_args(argv))
    toks = res["tokens"]
    assert toks.shape == (3, 5) and toks.dtype == np.int32
    v_pad = layers.padded_vocab(smoke_config(get_config("smollm-135m")))
    assert toks.min() >= 0 and toks.max() < v_pad
    if prompt_len == 0:
        assert (toks[:, 0] == 0).all()
    assert res["tok_s"] > 0
    np.testing.assert_array_equal(
        serve.serve_lm(serve.parse_args(argv))["tokens"], toks)
    serve.main(argv)


def test_zoo_refuses_unported_families():
    """Every family of the reference builds (none is left to port); a
    family the reference lacks is refused by name; the GCN family builds
    without a decode path and ``forward_logits`` refuses it, as the
    reference's does."""
    from repro_torch.configs import REGISTRY
    for cfg in REGISTRY.values():
        api = zoo.build(smoke_config(cfg), device="cpu")
        assert (api.decode is None) == (cfg.family == "gcn")
    with pytest.raises(ValueError, match="unknown family 'x'"):
        zoo.build(ModelConfig(name="y", family="x"), device="cpu")
    gcn_cfg = get_config("graphgen-gcn")
    api = zoo.build(gcn_cfg, device="cpu")
    assert api.decode is None and api.init_cache is None
    with pytest.raises(ValueError, match="LM config"):
        zoo.forward_logits(gcn_cfg, None, {})


@pytest.mark.parametrize("arch", ["stablelm-12b", "llama3-405b"])
def test_untied_dense_matches_reference(monkeypatch, arch):
    """stablelm-12b and llama3-405b at their smoke configs (untied read-out
    ``embed/head``; llama3's rope theta 5e5) on the reference's weights in
    float32: forward, loss and six decode steps from the reference's
    cache (``check_lm_parity``)."""
    set_compute(monkeypatch, "float32")
    cfg = smoke_config(get_config(arch))
    jcfg = jsmoke_config(jget_config(arch))
    assert not cfg.tie_embeddings
    params, model = _ref_model(jcfg, cfg, seed=4)
    assert model.head is not None and "head" in params["embed"]
    check_lm_parity(JT, jcfg, params, model, convert.lm_cache_from_numpy)


def test_forward_logits_refuses_another_config():
    """forward_logits runs the model's own config: a cfg whose flash
    switch differs from the model's is refused, not silently ignored."""
    cfg, _ = _smoke(flash=True)
    model = zoo.build(cfg, "cpu").init(0)
    tokens = {"tokens": torch.zeros((1, 128), dtype=torch.int32)}
    with pytest.raises(ValueError, match="model's own"):
        zoo.forward_logits(dataclasses.replace(cfg, use_flash_attention=False),
                           model, tokens)
    assert zoo.forward_logits(cfg, model, tokens).shape == (
        1, 128, layers.padded_vocab(cfg))


# ------------------------------------------------------------------ on a card

@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES[:1] + [
    (2, 9, 3, 256, 256, 64, True), (1, 4, 2, 128, 320, 128, True),
    (1, 4, 1, 192, 128, 128, False), (2, 32, 8, 256, 256, 160, True),
    (1, 4, 2, 128, 320, 160, True), (1, 4, 1, 192, 128, 160, False)])
def test_flash_kernel_on_card(cuda, case, dtype):
    """The CUDA kernel against its twin on the card: float32 within 1e-5;
    bfloat16 (the tensor-core route, p rounded to bf16 before P V) within
    ``flash_attention.bf16_error_bound``."""
    b, hq, hkv, lq, lk, dh, causal = case
    tdt = _DT[dtype][0]
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _qkv(b, hq, hkv, lq, lk, dh))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        bound = flash_mod.bf16_error_bound(q, k, v, want, causal=causal)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
