"""The port's Mamba-2 SSM LM and its SSD scan against the reference
(``repro.models.ssm``, ``repro.kernels``).

On the CPU, with inputs made by numpy from a seed and weights carried
across by ``repro_torch.convert``:

* the ``ssd_scan`` twin (``kernels.ref.ssd_scan_ref``, which ``ops``
  sends CPU tensors to) against ``repro.models.ssm.ssd_chunked`` and
  ``ssd_scan_pallas`` in interpret mode within rtol 1e-5 plus 1e-5 of the
  output's largest magnitude (float32 sums in another order; 2.4e-6 of
  it seen), and against the sequential oracle ``repro.kernels.ref.
  ssd_scan_ref`` within the reference test's own 2e-3; on the reference
  test's inputs (``dt = softplus(N(0, 1))``) and on small-dt inputs (dt in
  [0.005, 0.05]), each with the carry across chunks shown to hold a
  share of the output (the same scan with every chunk started from a
  zero state differs by more than 1e-3 of it);
* bfloat16 x, b and c through ``ops.ssd_scan`` on the CPU against
  ``ssd_scan_pallas`` in interpret mode on the same bf16 arrays (both
  return bf16: one float32 result rounded once) within one bf16 ulp of
  |y| plus 1e-5 of the largest |y|; the output dtype follows x; the
  operand dtypes are checked on both devices;
* the bf16 route's gate (``ssd_scan.bf16_error_bound``) holds the
  tensor-core route's arithmetic written in plain torch (scores, x . w and
  the state's copy rounded to bf16) and rejects a dropped carry and a
  causal mask one column off;
* the bf16 route's refusals (a shape it does not take, a view TMA cannot
  read) before any device work;
* ``causal_conv`` and ``softplus`` against the reference's;
* the whole model at the ssm smoke config (4 layers, d_model 64, state
  16, head_dim 16, chunk 8), at the reference's own init (``a = -1``,
  ``dt_bias = 0``: the state decays by ~exp(-6) over a chunk) and at a
  carry-exercising init (``dt_bias = -4``, ``a_log ~ N(0, 0.5)``, set in
  the numpy tree before conversion): ``forward_logits`` in float32
  compute within rtol 1e-5 / atol 1e-6 (9e-8 seen on logits ~0.33) and
  in bfloat16 within atol 1e-2 (2e-3 seen); ``serve_lm``'s decode steps
  against ``repro``'s ``forward_decode`` in float32 (logits within 1e-5
  at every step, greedy tokens equal, the final float32 state within
  rtol 1e-5 and the bfloat16 conv history within one bf16 ulp); the
  port's prefill against its own decode (within atol 2e-3: the decode
  keeps the conv history in bfloat16);
* the model hands the scan bf16 views of its conv output, and its CPU
  logits are bit-equal to the call it made before (float32 operands in,
  the result rounded after) in both compute dtypes;
* the dispatch's refusals (autograd, ``L`` off the chunk, a device mix)
  and the entry points' default to the card.

On a card (marked ``cuda``): the float32 kernel against its twin, and the
bf16 tensor-core kernel under the gate at the mamba2 and zamba2 shapes,
chunks of 128 and 64, on conv-output views.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.config import ModelConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, ssm, zoo  # noqa: E402

ARCH = "mamba2-1.3b"
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def compute(monkeypatch, request):
    """Set both packages' ``COMPUTE_DTYPE`` to the parametrized dtype."""
    tdt, jdt = _DT[request.param]
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", tdt)
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jdt)
    return request.param


def _smoke():
    return smoke_config(get_config(ARCH)), jsmoke_config(jget_config(ARCH))


def _ref_params(jcfg, init, seed=0):
    """``repro``'s init_mamba2 tree as writable numpy arrays; with
    ``init="carry"`` dt_bias is -4 and a_log is drawn from N(0, 0.5), so
    the state survives a chunk (the reference's init lets it decay by
    ~exp(-6) over the smoke chunk and ~1e-44 over a full 128-row one)."""
    params = jax.tree.map(np.array, JS.init_mamba2(jcfg,
                                                   jax.random.PRNGKey(seed)))
    if init == "carry":
        lay = params["layers"]
        lay["dt_bias"][:] = -4.0
        lay["a_log"][:] = np.random.default_rng(seed + 5).normal(
            0.0, 0.5, lay["a_log"].shape).astype(np.float32)
    return params


# ------------------------------------------------------------------ configs

def test_ssm_configs_match_reference():
    """mamba2-1.3b and its smoke config carry the reference's values in
    every field the port has (heads, kv heads, head_dim and d_ff 0 for a
    config without attention); the VLM's smoke config, once refused, is
    now the reference's."""
    for a, b in ((get_config(ARCH), jget_config(ARCH)), _smoke()):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert ssm.dims(a) == JS._dims(b)
    small = _smoke()[0]
    assert (small.n_heads, small.n_kv_heads, small.head_dim, small.d_ff) \
        == (0, 0, 0, 0)
    vlm_cfg = smoke_config(get_config("llama-3.2-vision-11b"))
    want = jsmoke_config(jget_config("llama-3.2-vision-11b"))
    for f in dataclasses.fields(vlm_cfg):
        assert getattr(vlm_cfg, f.name) == getattr(want, f.name), f.name


# -------------------------------------------------------------- ssd twin

def _ssd_inputs(b, l, h, p, n, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    if kind == "ref":
        dt = np.logaddexp(rng.standard_normal((b, l, h)), 0.0)
    else:
        dt = rng.uniform(0.005, 0.05, (b, l, h))
    a = -np.exp(rng.standard_normal(h))
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dt.astype(np.float32), a.astype(np.float32), bm, cm


def _drop_carry(x, dt, a, bm, cm, chunk=128):
    """The scan with every chunk started from a zero state (the sequence
    cut into chunk-long ones)."""
    b, l, h, p = x.shape
    q = min(chunk, l)
    y = ref.ssd_scan_ref(x.reshape(-1, q, h, p), dt.reshape(-1, q, h), a,
                         bm.reshape(-1, q, bm.shape[-1]),
                         cm.reshape(-1, q, cm.shape[-1]), chunk=q)
    return y.reshape(x.shape)


def _carry_share(ins, chunk):
    """Share of the largest |y| that the carry across chunks holds."""
    ins = [torch.from_numpy(v) for v in ins]
    y = ref.ssd_scan_ref(*ins, chunk=chunk)
    return ((y - _drop_carry(*ins, chunk=chunk)).abs().max()
            / y.abs().max()).item()


def _close(got, want, rel=1e-5):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


SSD_CASES = [  # b, l, h, p, n, chunk (the first two are the reference test's)
    (2, 64, 3, 16, 8, 16),
    (2, 48, 2, 8, 4, 8),
    (1, 96, 4, 16, 8, 32),
]


@pytest.mark.parametrize("kind", ["ref", "small"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_twin_matches_references(case, kind):
    """ops.ssd_scan on the CPU (the twin) against ssd_chunked and the
    Pallas kernel (interpret) within 1e-5 of the largest |y|, and the
    sequential oracle within 2e-3; the carry across chunks holds more
    than 1e-3 of the output, so a scan that dropped it would fail."""
    *shape, chunk = case
    ins = _ssd_inputs(*shape, kind, seed=sum(case))
    got = ops.ssd_scan(*(torch.from_numpy(v) for v in ins), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ins[0].shape
    got = got.numpy()
    jins = [jnp.asarray(v) for v in ins]
    _close(got, np.asarray(JS.ssd_chunked(*jins, chunk)))
    _close(got, np.asarray(ssd_scan_pallas(*jins, chunk=chunk)))
    np.testing.assert_allclose(got, np.asarray(jref.ssd_scan_ref(*jins)),
                               rtol=2e-3, atol=2e-3)
    assert _carry_share(ins, chunk) > 1e-3


@pytest.mark.parametrize("l,chunk", [(32, 32), (16, 32)])
def test_ssd_twin_single_chunk(l, chunk):
    """L equal to (or below) the chunk is one chunk of L rows, the full
    quadratic path with no carry, as in the Pallas kernel."""
    ins = _ssd_inputs(1, l, 2, 8, 4, "small", seed=l)
    got = ops.ssd_scan(*(torch.from_numpy(v) for v in ins), chunk=chunk)
    jins = [jnp.asarray(v) for v in ins]
    _close(got.numpy(), np.asarray(ssd_scan_pallas(*jins, chunk=chunk)))
    _close(got.numpy(), np.asarray(JS.ssd_chunked(*jins, chunk)))


def test_ssd_scan_refuses():
    """L off a multiple of the chunk raises (the Pallas kernel asserts);
    autograd raises on the CPU as on the card (no backward yet); the CUDA
    wrapper refuses CPU operands; ops refuses a device mix."""
    ins = [torch.from_numpy(v) for v in _ssd_inputs(1, 24, 2, 8, 4, "ref", 1)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*ins, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_mod.chunk_len(24, 16)
    assert ssd_mod.chunk_len(24, 8) == 8 and ssd_mod.chunk_len(24, 128) == 24
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_scan(ins[0].clone().requires_grad_(), *ins[1:], chunk=8)
    with torch.no_grad():
        ops.ssd_scan(ins[0].clone().requires_grad_(), *ins[1:], chunk=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_mod.ssd_scan_cuda(*ins, chunk=8)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.ssd_scan(ins[0].to("meta"), *ins[1:], chunk=8)
    assert "ssd_scan" in ops.KERNELS


def _bf16(ins):
    """The numpy operands as torch tensors, x, b and c rounded to bf16."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in ins)
    return (x.to(torch.bfloat16), dt, a, bm.to(torch.bfloat16),
            cm.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["ref", "small"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_bf16_matches_pallas(case, kind):
    """bf16 x, b and c through ops.ssd_scan on the CPU (the twin) against
    ssd_scan_pallas (interpret) on the same bf16 arrays: both upcast to
    float32 inside and round the float32 result to bf16 once, so they
    differ by at most one bf16 ulp of |y| (2^-7 |y|) where their float32
    sums round apart, plus 1e-5 of the largest |y|."""
    *shape, chunk = case
    ins = _bf16(_ssd_inputs(*shape, kind, seed=sum(case) + 1))
    got = ops.ssd_scan(*ins, chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == ins[0].shape
    want = np.asarray(ssd_scan_pallas(
        *(jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
          for t in ins), chunk=chunk))
    assert want.dtype == jnp.bfloat16
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_output_dtype_follows_x(dtype):
    """y comes back in x's dtype; x, b and c must share one dtype (float32
    or bfloat16) and dt and a be float32, on the CPU as on the card."""
    tdt = _DT[dtype][0]
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                        _ssd_inputs(1, 16, 2, 8, 4, "ref", 3))
    x, bm, cm = x.to(tdt), bm.to(tdt), cm.to(tdt)
    y = ops.ssd_scan(x, dt, a, bm, cm, chunk=8)
    assert y.dtype == tdt and y.shape == x.shape
    with pytest.raises(TypeError, match="dt and a in float32"):
        ops.ssd_scan(x, dt.double(), a, bm, cm, chunk=8)
    other = torch.float32 if tdt == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x, dt, a, bm.to(other), cm, chunk=8)
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x.half(), dt, a, bm.half(), cm.half(), chunk=8)


def _tensor_core_arith(x, dt, a, bm, cm, chunk, shift=0, carry=True):
    """The bf16 route's arithmetic in plain torch, chunk by chunk: float32
    cum (a float64 running sum rounded once), decays, products and state;
    the scores, x . w and the copy of the state the inter term reads
    rounded to bf16; y rounded to bf16 once.  ``shift`` moves the causal
    diagonal (row i sees j <= i + shift); ``carry=False`` starts every
    chunk from a zero state."""
    f32 = torch.float32

    def rnd(t):
        return t.to(torch.bfloat16).to(f32)
    bsz, l, h, p = x.shape
    q = min(chunk, l)
    xf, bf, cf = x.to(f32), bm.to(f32), cm.to(f32)
    ii = torch.arange(q)
    vis = (ii[:, None] + shift >= ii[None, :])[None, :, :, None]
    state = torch.zeros(bsz, h, p, bm.shape[-1])
    out = []
    for c0 in range(0, l, q):
        xc, dtc = xf[:, c0:c0 + q], dt[:, c0:c0 + q]
        bc, cc = bf[:, c0:c0 + q], cf[:, c0:c0 + q]
        cum = torch.cumsum((a * dtc).double(), dim=1).to(f32)    # [B,Q,H]
        seg = torch.where(vis, cum[:, :, None] - cum[:, None], 0.0)
        decay = torch.where(vis, torch.exp(seg) * dtc[:, None], 0.0)
        scores = rnd((cc @ bc.transpose(1, 2))[..., None] * decay)
        inter = torch.einsum("bin,bhpn->bihp", cc, rnd(state))
        y = inter * torch.exp(cum)[..., None] + torch.einsum(
            "bijh,bjhp->bihp", scores, xc)
        out.append(y)
        w = dtc * torch.exp(cum[:, -1:] - cum)
        upd = torch.einsum("bjhp,bjn->bhpn", rnd(xc * w[..., None]), bc)
        state = (state * torch.exp(cum[:, -1])[..., None, None] + upd
                 if carry else torch.zeros_like(state))
    return torch.cat(out, dim=1).to(x.dtype)


@pytest.mark.parametrize("case", SSD_CASES)
def test_bf16_gate_holds_rounding_and_rejects_faults(case):
    """The gate covers the bf16 route's three roundings (which move the
    outputs) and still catches a dropped carry and a causal mask one
    column off, on bf16 inputs whose carry matters."""
    *shape, chunk = case
    ins = _bf16(_ssd_inputs(*shape, "small", seed=sum(case) + 2))
    want = ref.ssd_scan_ref(*ins, chunk=chunk)
    bound = ssd_mod.bf16_error_bound(*ins, chunk=chunk)
    assert bound.dtype == torch.float32 and bound.shape == want.shape

    def within(y):
        return bool(((y.float() - want.float()).abs() <= bound).all())
    got = _tensor_core_arith(*ins, chunk)
    assert got.dtype == torch.bfloat16 and not torch.equal(got, want)
    assert within(got)
    assert not within(_tensor_core_arith(*ins, chunk, carry=False))
    assert not within(_tensor_core_arith(*ins, chunk, shift=1))


def _bad_views():
    """bf16 ``(x, b, c)`` the tensor-core route refuses, by fault, with the
    message it raises; the good ones are views of one [1, 128, 64 + 2 * 128]
    conv output."""
    bf = torch.bfloat16
    x, bm, cm = ssm.ssd_operands(torch.zeros(1, 128, 64 + 256, dtype=bf),
                                 1, 64, 128)
    odd = torch.zeros(1, 128, 64 + 260, dtype=bf)[..., :128]
    shifted = torch.zeros(128 * 128 + 1, dtype=bf)[1:].view(1, 128, 128)
    return {
        "head dim": ((torch.zeros(1, 128, 2, 32, dtype=bf), bm, cm),
                     "head dim 64"),
        "state": ((x, bm[..., :96], cm[..., :96]), "state"),
        "last stride": ((x, torch.zeros(1, 128, 256, dtype=bf)[..., ::2], cm),
                        "stride 1"),
        "row stride": ((x, bm, odd), "multiples of 16 bytes"),
        "base": ((x, shifted, cm), "16-byte boundary"),
    }


@pytest.mark.parametrize("fault", ["head dim", "state", "last stride",
                                   "row stride", "base", "chunk"])
def test_bf16_route_refuses_what_it_cannot_take(fault):
    """A shape outside the tensor-core kernel's (head dim 64, state 64 or
    128, chunk 64 or 128), or a bf16 view TMA cannot read, raises
    ``ValueError`` naming the limit before the wrapper looks for a card
    (these tensors lie on the CPU); no fallback to the float32 route."""
    views = _bad_views()
    if fault == "chunk":
        (x, _, _), _ = views["base"]
        (_, bm, cm), _ = views["head dim"]
        msg, chunk = "chunk", 32
    else:
        (x, bm, cm), msg = views[fault]
        chunk = 128
    l, h = x.shape[1], x.shape[2]
    dt, a = torch.full((1, l, h), 0.1), -torch.ones(h)
    with pytest.raises(ValueError, match=msg):
        ssd_mod.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk)


def test_conv_and_softplus_match():
    """causal_conv in the reference's order and softplus as logaddexp(x,
    0) (above torch's threshold of 20 too), float32."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    k = rng.standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        np.asarray(JS._causal_conv(jnp.asarray(x), jnp.asarray(k))))
    v = np.array([-30.0, -3.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=0)


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("init", ["reference", "carry"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"], indirect=True)
def test_forward_logits_matches(compute, init, monkeypatch):
    """forward_logits at the ssm smoke config, B 2, S 32 (4 chunks of 8),
    on the reference's weights: float32 compute within rtol 1e-5 / atol
    1e-6, bfloat16 within atol 1e-2; the model's loss against ``loss_fn``
    (rtol 1e-4).  At the carry init, a scan that dropped the carry moves
    the float32 logits by more than 10x the tolerance (~60x seen: at a
    random init the blocks add little to the embedding's residual)."""
    cfg, jcfg = _smoke()
    params = _ref_params(jcfg, init)
    model = convert.mamba_params_from_numpy(params, cfg, device="cpu")
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    got = zoo.forward_logits(cfg, model, batch)
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax.jit(lambda p, t: JS.forward_train(jcfg, p, t))(
        jp, jnp.asarray(tokens)))
    assert got.dtype == torch.float32
    assert got.shape == (2, 32, layers.padded_vocab(cfg))
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        labels = np.roll(tokens, -1, axis=1)
        with torch.no_grad():
            loss = zoo.build(cfg, "cpu").loss(
                model, {"tokens": batch["tokens"],
                        "labels": torch.from_numpy(labels)})
        jloss = JS.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels)})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        if init == "carry":
            monkeypatch.setattr(ops, "ssd_scan", _drop_carry)
            cut = zoo.forward_logits(cfg, model, batch).numpy()
            assert np.abs(cut - want).max() > 10 * (1e-6 + 1e-5 * np.abs(
                want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"], indirect=True)
def test_forward_logits_bit_equal_to_the_upcast_call(compute, monkeypatch):
    """The model hands ops.ssd_scan x, b and c as views of one conv output
    in the compute dtype, and its CPU logits are bit-equal (tobytes) to the
    call the model made before: float32 operands in, the result rounded to
    the compute dtype after."""
    cfg, jcfg = _smoke()
    model = convert.mamba_params_from_numpy(_ref_params(jcfg, "carry"), cfg,
                                            device="cpu")
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    real, calls = ops.ssd_scan, []

    def record(x, dt, a, bm, cm, chunk):
        calls.append((x, bm, cm))
        return real(x, dt, a, bm, cm, chunk=chunk)
    monkeypatch.setattr(ops, "ssd_scan", record)
    got = zoo.forward_logits(cfg, model, batch)
    assert len(calls) == cfg.n_layers
    tdt = layers.COMPUTE_DTYPE
    for x, bm, cm in calls:
        assert x.dtype == bm.dtype == cm.dtype == tdt
        assert x._base is not None and x._base is bm._base is cm._base

    def upcast(x, dt, a, bm, cm, chunk):
        f32 = torch.float32
        return real(x.to(f32), dt, a, bm.to(f32), cm.to(f32),
                    chunk=chunk).to(x.dtype)
    monkeypatch.setattr(ops, "ssd_scan", upcast)
    want = zoo.forward_logits(cfg, model, batch)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def _serve_args(prompt, gen, batch=2):
    return serve.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", str(batch), "--prompt-len",
                             str(prompt), "--gen-len", str(gen)])


def _record_serve(monkeypatch, model, args):
    """serve_lm(args) on ``model``; returns the tokens, every decode
    step's logits ``[steps, B, V_pad]`` and the final cache."""
    monkeypatch.setattr(ssm, "init_mamba2", lambda cfg, seed, dev: model)
    real = ssm.Mamba2LM.forward_decode
    logits, last = [], {}

    def record(self, cache, tokens, pos):
        out, cache = real(self, cache, tokens, pos)
        logits.append(out.clone())
        last.update({k: v.clone() for k, v in cache.items()})
        return out, cache
    monkeypatch.setattr(ssm.Mamba2LM, "forward_decode", record)
    toks = serve.serve_lm(args)["tokens"]
    return toks, torch.stack(logits).numpy(), last


@pytest.mark.parametrize("init", ["reference", "carry"])
@pytest.mark.parametrize("compute", ["float32"], indirect=True)
def test_serve_lm_decode_matches(compute, init, monkeypatch):
    """serve_lm's decode (a 12-token prompt filled token by token, then 6
    greedy steps) against ``repro.models.ssm.forward_decode`` driven the
    same way on the same prompt: every step's logits within 1e-5, greedy
    tokens equal, the final float32 state within rtol 1e-5 / atol 1e-7 and
    the bfloat16 conv history within one bf16 ulp (2^-7 relative)."""
    cfg, jcfg = _smoke()
    params = _ref_params(jcfg, init, seed=1)
    model = convert.mamba_params_from_numpy(params, cfg, device="cpu")
    args = _serve_args(12, 6)
    toks, logits, cache = _record_serve(monkeypatch, model, args)

    jp = jax.tree.map(jnp.asarray, params)
    decode = jax.jit(lambda p, c, t: JS.forward_decode(jcfg, p, c, t, 0))
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    jcache = JS.init_cache(jcfg, args.batch, 18)
    jlogits, jtoks = [], []
    for t in range(args.prompt_len):
        jl, jcache = decode(jp, jcache, jnp.asarray(prompt[:, t:t + 1]))
        jlogits.append(np.asarray(jl))
    for _ in range(args.gen_len):
        tok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        jl, jcache = decode(jp, jcache, tok)
        jlogits.append(np.asarray(jl))
    np.testing.assert_allclose(logits, np.stack(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(toks, np.concatenate(jtoks, axis=1))
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(jcache["ssm"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cache["conv"].float().numpy(),
                               np.asarray(jcache["conv"], np.float32),
                               rtol=2 ** -7, atol=0)
    carried = convert.mamba_cache_from_numpy(
        jax.tree.map(np.asarray, jcache), device="cpu")
    assert carried["conv"].dtype == torch.bfloat16
    torch.testing.assert_close(carried["ssm"], cache["ssm"], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("init", ["reference", "carry"])
@pytest.mark.parametrize("compute", ["float32"], indirect=True)
def test_prefill_matches_decode(compute, init, monkeypatch):
    """Two paths to one function in the port: forward_logits over a
    24-token prompt (3 chunks) against serve_lm's decode-filled logits at
    every prompt position, the last included, within atol 2e-3 on logits
    ~0.3 (the decode keeps the conv history in bfloat16, the prefill in
    float32)."""
    cfg, jcfg = _smoke()
    model = convert.mamba_params_from_numpy(_ref_params(jcfg, init, seed=2),
                                            cfg, device="cpu")
    args = _serve_args(24, 1)
    _, logits, _ = _record_serve(monkeypatch, model, args)
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    pre = zoo.forward_logits(cfg, model, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(pre.numpy().transpose(1, 0, 2),
                               logits[:args.prompt_len], rtol=0, atol=2e-3)


# ------------------------------------------------------- entry points

@pytest.mark.parametrize("prompt_len", [0, 9])
def test_serve_lm_ssm_cpu_smoke(prompt_len):
    """serve --arch mamba2-1.3b --smoke --device cpu: the family dispatch
    reaches the decode loop; tokens lie in the padded vocab; one seed gives
    the same tokens twice."""
    args = _serve_args(prompt_len, 5, batch=3)
    res = serve.serve_lm(args)
    toks = res["tokens"]
    v_pad = layers.padded_vocab(_smoke()[0])
    assert toks.shape == (3, 5) and toks.min() >= 0 and toks.max() < v_pad
    if prompt_len == 0:
        assert (toks[:, 0] == 0).all()
    np.testing.assert_array_equal(serve.serve_lm(args)["tokens"], toks)


@pytest.mark.parametrize("entry", ["model", "init", "zoo", "serve"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Mamba2LM, init_mamba2, zoo.build and serve_lm run on the card
    unless asked for the CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _smoke()[0]
    call = {"model": lambda: ssm.Mamba2LM(cfg),
            "init": lambda: ssm.init_mamba2(cfg),
            "zoo": lambda: zoo.build(cfg),
            "serve": lambda: serve.serve_lm(serve.parse_args(
                ["--arch", ARCH, "--smoke"]))}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()


def test_zoo_builds_ssm_and_refuses_others():
    """The ssm family builds with a decode path and an O(1) cache; the
    model refuses a config of another family; forward_logits refuses a
    config other than the model's own; a family the reference lacks
    raises."""
    cfg = _smoke()[0]
    api = zoo.build(cfg, "cpu")
    model = api.init(0)
    cache = api.init_cache(model, 2, 1000)
    d_in, h, p, n = ssm.dims(cfg)
    assert cache["ssm"].shape == (cfg.n_layers, 2, h, p, n)
    assert cache["conv"].shape == (cfg.n_layers, 2, cfg.conv_width - 1,
                                   d_in + 2 * n)
    assert cache["conv"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="ssm config"):
        ssm.Mamba2LM(get_config("smollm-135m"), "cpu")
    with pytest.raises(ValueError, match="model's own"):
        zoo.forward_logits(dataclasses.replace(cfg, ssm_chunk=4), model,
                           {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    with pytest.raises(ValueError, match="unknown family"):
        zoo.build(ModelConfig(name="x", family="x"), device="cpu")
    with pytest.raises(ValueError, match="untied"):
        layers.lm_head(model.tok, model.norm_f, torch.zeros(1, 1, 64), cfg)


# ------------------------------------------------------------------ on a card

@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ref", "small"])
@pytest.mark.parametrize("case", SSD_CASES + [(2, 512, 8, 64, 128, 128),
                                              (1, 128, 4, 64, 128, 128)])
def test_ssd_scan_kernel_on_card(cuda, case, kind):
    """The CUDA kernel against its twin on the card, within rtol 1e-5 plus
    1e-5 of the largest |y|; one launch per call."""
    *shape, chunk = case
    ins = [torch.from_numpy(v).to(cuda)
           for v in _ssd_inputs(*shape, kind, seed=sum(case))]
    ops.reset_launch_counts()
    got = ops.ssd_scan(*ins, chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == 1
    want = ref.ssd_scan_ref(*ins, chunk=chunk)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def _conv_operands(b, l, h, n, kind, seed, device):
    """Seeded bf16 ``(x, dt, a, b, c)`` on ``device``, x, b and c views of
    one ``[B, L, 64 H + 2N]`` conv output, as the SSM passes them."""
    x, dt, a, bm, cm = _ssd_inputs(b, l, h, 64, n, kind, seed)
    conv = torch.from_numpy(np.concatenate(
        [x.reshape(b, l, h * 64), bm, cm], axis=-1)).to(device, torch.bfloat16)
    xv, bv, cv = ssm.ssd_operands(conv, h, 64, n)
    return (xv, torch.from_numpy(dt).to(device), torch.from_numpy(a).to(device),
            bv, cv)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ref", "small"])
@pytest.mark.parametrize("case", [(2, 512, 8, 128, 128),    # mamba2's widths
                                  (2, 512, 8, 64, 128),     # zamba2's state
                                  (1, 128, 4, 128, 128),    # L = chunk
                                  (2, 256, 4, 128, 64),     # chunk 64
                                  (1, 64, 4, 64, 64)])      # L = chunk 64
def test_ssd_bf16_route_on_card(cuda, case, kind):
    """bf16 views of a conv output through the tensor-core route only (one
    launch per call, none on the float32 route), within the derived gate
    ``bf16_error_bound`` of the twin, elementwise."""
    b, l, h, n, chunk = case
    ins = _conv_operands(b, l, h, n, kind, sum(case), cuda)
    ops.reset_launch_counts()
    got = ops.ssd_scan(*ins, chunk=chunk)
    assert ops.ssd_route_counts() == {"tensor_core": 1, "float32": 0}
    assert got.dtype == torch.bfloat16 and got.shape == ins[0].shape
    want = ref.ssd_scan_ref(*ins, chunk=chunk)
    bound = ssd_mod.bf16_error_bound(*ins, chunk=chunk)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
