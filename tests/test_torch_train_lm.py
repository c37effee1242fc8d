"""The port's LM training (``repro_torch.train``, ``launch/train.py::
train_lm``) against the reference (``repro``).

On the CPU, inputs made by numpy from a seed, weights made by the port's
seeded init and carried to the reference by ``convert.lm_params_to_numpy``
(whose tree is the reference's: the gradient trees are compared for
structure first), ``COMPUTE_DTYPE`` float32 in both packages unless
stated:

* each LM family at its smoke config (the untied dense configs
  stablelm-12b and llama3-405b, the VLM with seeded vision embeddings and
  Whisper with seeded frames among them): the loss and every reference
  leaf's gradient against ``jax.value_and_grad`` of ``api.loss`` (loss
  rtol 1e-6; each leaf within 1e-5 of its largest |g|, 1.4e-6 seen; the
  VLM also with its gates set non-zero from a seed, since at the init's
  zero gates only the gates themselves get a cross-path gradient), and
  mamba2 in bfloat16 compute (loss rtol 1e-5, each leaf within 0.15 of
  its largest |g|: 0.073 seen, the skip weight ``d_skip`` whose gradient
  sums bf16 products in another order);
* ``SSDScan``'s vjp against ``jax.grad`` of ``ssd_chunked`` on inputs
  whose carry across chunks holds over 10% of the output (float32 within
  1e-5 of each gradient's largest magnitude; bf16 x, b and c, whose
  gradients come back in bf16, within two bf16 ulps of it);
* ``make_train_step`` over 3 steps of the dense smoke model, microbatches
  1 and 2, compression off and on: loss and grad_norm rtol 1e-5, step
  equal; params, moments and the residual within the bounds of
  ``_check_state`` (without compression 1e-5 of each leaf's largest
  entry; with it, an int8 code can land one step apart where the two
  packages' float32 gradients straddle a rounding boundary: each
  residual element within 1.25 quantization steps of its leaf, at most
  1% of them over 1e-2 of a step apart, and elsewhere the params and
  moments within 1e-5 of each leaf's largest entry, the params within
  the three steps' summed learning rates everywhere); and three steps,
  2 microbatches, compressing, of each new config (stablelm-12b,
  llama3-405b, the VLM with open gates, Whisper), whose compression
  quantizes per reference leaf through the VLM's and Whisper's layouts;
* ``train_lm``'s batches, the VLM's ``vision`` and Whisper's ``frames``
  drawn after the tokens from the same generator, bit for bit the
  reference's;
* ``quantize``, ``compress_grads`` and ``data/tokens.py`` bit-exact;
  ``nan_guard``; ``train_lm`` of both packages resumed from one step-0
  ``TrainState`` checkpoint that ``repro`` wrote (losses over 4 steps
  rtol 1e-5), the port's step-4 checkpoint read by ``repro``; ``--dist
  gloo --workers 2 --model-axis 2`` logging one process's losses, and
  ``--model-axis`` without ``--dist`` refused; and the MoE layer's gradient on the slot ``cap - 1`` hand
  case (the overwritten kept row gets none, as under the reference's
  ``.at[].set``).
"""
import argparse
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import open_gates, set_compute, stub_inputs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import tokens as JT  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import zoo as JZ  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro.train import train_loop as JTL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.config import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.core.config import TrainConfig  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import moe, ssm, zoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train import train_loop as TL  # noqa: E402

ARCHS = ["smollm-135m", "mamba2-1.3b", "zamba2-1.2b", "qwen3-moe-30b-a3b",
         "deepseek-v2-236b", "stablelm-12b", "llama3-405b",
         "llama-3.2-vision-11b", "whisper-small"]
#: the configs this slice added: the untied dense LMs, the VLM, Whisper
NEW_ARCHS = ARCHS[5:]


@pytest.fixture
def f32(monkeypatch):
    """float32 compute in both packages."""
    set_compute(monkeypatch, "float32")


def _setup(arch, seed=0, n_layers=None, gates=False):
    """``(cfg, jcfg, model, flat, layout, params_np)``: the smoke config in
    both packages (``n_layers`` cutting its depth) and the port's seeded
    model, its flat parameters and their reference tree; ``gates`` sets
    the VLM's cross gates from ``seed`` to non-zero values
    (``_torch_parity.open_gates``) in the model and the tree."""
    cfg = smoke_config(get_config(arch))
    jcfg = jsmoke_config(jget_config(arch))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    model = zoo.build(cfg, "cpu").init(seed)
    if gates:
        gate = open_gates(convert.lm_params_to_numpy(model),
                          seed)["cross"]["gate"]
        with torch.no_grad():
            for site, g in zip(model.cross, gate):
                site.gate.copy_(torch.from_numpy(g))
    flat, layout = convert.lm_leaves(model)
    return cfg, jcfg, model, flat, layout, convert.lm_params_to_numpy(model)


def _batch(cfg, b, s, seed):
    """Seeded tokens, their labels and the family's stub inputs (the
    VLM's vision embeddings, Whisper's frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            **stub_inputs(cfg, b, seed)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _paths(tree):
    """``{keystr: numpy leaf}`` of a tree."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_leaves(got, want, rel, label=""):
    """Same tree structure, every leaf within ``rel`` of its largest
    |entry|; returns the worst share seen."""
    assert jax.tree.structure(got) == jax.tree.structure(want), label
    worst = 0.0
    w_p = _paths(want)
    for key, g in _paths(got).items():
        w = w_p[key].astype(np.float32)
        g = g.astype(np.float32)
        assert g.shape == w.shape, (label, key)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        worst = max(worst, err)
        assert err <= rel, f"{label}{key}: {err:.3e} of {scale:.3e}"
    return worst


def _port_grads(arch, model, flat, layout, batch):
    api = zoo.build(model.cfg, "cpu")
    loss, grads = TL.value_and_grad(
        TL.module_loss(model, api.loss, layout.names), flat, _torch(batch))
    return loss, convert.flat_to_numpy(grads, layout)


@pytest.mark.parametrize("arch,n_layers", [(a, None) for a in ARCHS]
                         + [("zamba2-1.2b", 1)])
def test_family_loss_and_grads(f32, arch, n_layers):
    """loss and every leaf's gradient against ``jax.value_and_grad``; the
    hybrid cut to one layer (below ``attn_every``: no site runs the shared
    block, whose gradients are then zero in both packages)."""
    cfg, jcfg, model, flat, layout, params_np = _setup(arch,
                                                       n_layers=n_layers)
    batch = _batch(cfg, 2, 32, seed=1)
    loss, grads = _port_grads(arch, model, flat, layout, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(JZ.build(jcfg).loss))(
        _jax(params_np), _jax(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    _close_leaves(grads, jax.tree.map(np.asarray, jgrads), 1e-5, arch)
    if n_layers is not None:
        assert not any(np.asarray(g).any()
                       for g in jax.tree.leaves(grads["shared"]))


def test_vlm_grads_with_gates_open(f32):
    """The VLM with its gates set non-zero from the seed: the loss and
    every leaf's gradient (the cross sites' ``wq``..``wo`` and ``ln``
    among them, all zero at the init's closed gates) against
    ``jax.value_and_grad``."""
    cfg, jcfg, model, flat, layout, params_np = _setup(
        "llama-3.2-vision-11b", gates=True)
    assert np.abs(params_np["cross"]["gate"]).min() >= 0.5
    batch = _batch(cfg, 2, 32, seed=1)
    loss, grads = _port_grads("llama-3.2-vision-11b", model, flat, layout,
                              batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(JZ.build(jcfg).loss))(
        _jax(params_np), _jax(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    _close_leaves(grads, jax.tree.map(np.asarray, jgrads), 1e-5, "vlm")
    assert all(np.abs(grads["cross"]["attn"][w]).max() > 0
               for w in ("wq", "wk", "wv", "wo"))


def test_bf16_grads_mamba2(monkeypatch):
    """mamba2's smoke model in bfloat16 compute (the SSD's bf16 operands
    through ``SSDScan``): the wider bound of the module docstring."""
    set_compute(monkeypatch, "bfloat16")
    cfg, jcfg, model, flat, layout, params_np = _setup("mamba2-1.3b")
    batch = _batch(cfg, 2, 32, seed=1)
    loss, grads = _port_grads("mamba2-1.3b", model, flat, layout, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(JZ.build(jcfg).loss))(
        _jax(params_np), _jax(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _close_leaves(grads, jax.tree.map(np.asarray, jgrads), 0.15, "bf16 ")


def _ssd_inputs(seed, b=2, l=32, h=3, p=4, n=5):
    """SSD operands with small dt: the state carries across chunks."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32),
            rng.uniform(0.005, 0.05, (b, l, h)).astype(np.float32),
            (-np.exp(rng.standard_normal(h))).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_vjp_matches_jax(dtype):
    """``SSDScan`` (forward: the twin; backward: the vjp of the ported
    ``ssd_chunked``) against ``jax.grad`` of the reference's
    ``ssd_chunked`` with the casts of ``mamba_train``, chunk 8 over 32
    rows; the port's ``ssd_chunked`` itself against the reference's; and
    ``ops.ssd_scan`` still refuses autograd."""
    chunk = 8
    ins = _ssd_inputs(4)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tins = [torch.from_numpy(v) for v in ins]
    for i in (0, 3, 4):
        tins[i] = tins[i].to(tdt)
    tins = [t.requires_grad_() for t in tins]
    y = ssm.SSDScan.apply(*tins, chunk)
    cot = np.random.default_rng(5).standard_normal(y.shape).astype(
        np.float32)
    grads = torch.autograd.grad(y, tins, torch.from_numpy(cot).to(tdt))

    def ref(x, dt, a, bm, cm):
        f = jnp.float32
        out = JS.ssd_chunked(x.astype(f), dt, a, bm.astype(f), cm.astype(f),
                             chunk)
        return out.astype(x.dtype)
    jins = [jnp.asarray(v) for v in ins]
    for i in (0, 3, 4):
        jins[i] = jins[i].astype(jdt)
    jgrads = jax.jit(lambda c, *a: jax.vjp(ref, *a)[1](c))(
        jnp.asarray(cot).astype(jdt), *jins)

    @jax.jit
    def full_and_cut(*a):
        cut = JS.ssd_chunked(*[j.reshape((-1, chunk) + j.shape[2:])
                               if j.ndim > 1 else j for j in a], chunk)
        return JS.ssd_chunked(*a, chunk), cut.reshape(a[0].shape)
    full, cut = full_and_cut(*(jnp.asarray(v) for v in ins))
    # the carry matters: dropping it moves y by over 10% of its scale
    assert float(jnp.abs(full - cut).max()) > 0.1 * float(
        jnp.abs(full).max())
    rel = 1e-5 if dtype == "float32" else 2 * 2 ** -7
    for name, g, w, t in zip("x dt a b c".split(), grads, jgrads, tins):
        assert g.dtype == t.dtype, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=name)
    f32_ins = [torch.from_numpy(v) for v in ins]
    np.testing.assert_allclose(
        ssm.ssd_chunked(*f32_ins, chunk).numpy(),
        np.asarray(full), rtol=0, atol=1e-5 * float(jnp.abs(full).max()))
    with pytest.raises(NotImplementedError, match="SSDScan"):
        from repro_torch.kernels import ops
        ops.ssd_scan(*tins, chunk=chunk)


def test_ssd_chunked_backward_has_no_nan_where_the_decay_overflows():
    """A chunk whose decay passes e^88 (dt 1, a -3, 64 rows): the port's
    gradient is finite (the masked exponents are -inf before ``exp``),
    where ``jax.grad`` of the reference's form is NaN in dt and a (its
    ``where`` meets ``0 * exp(+inf)``); elsewhere the two agree."""
    np_ins = list(_ssd_inputs(6, b=1, l=64, h=2))
    np_ins[1] = np.ones_like(np_ins[1])
    np_ins[2] = np.full_like(np_ins[2], -3.0)
    ins = [torch.from_numpy(v).requires_grad_() for v in np_ins]
    y = ssm.SSDScan.apply(*ins, 64)
    grads = torch.autograd.grad(y.sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    jgrads = jax.jit(jax.grad(lambda *a: JS.ssd_chunked(*a, 64).sum(),
                              argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(v) for v in np_ins))
    nan = [bool(jnp.isnan(g).any()) for g in jgrads]
    assert nan == [False, True, True, False, False]
    for i in (0, 3, 4):
        w = np.asarray(jgrads[i])
        np.testing.assert_allclose(grads[i].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _check_state(state, jstate, layout, compress, lrs):
    """The port's ``TrainState`` against the reference's: params, m, v and
    error (see the module docstring for the bounds)."""
    got = convert.train_state_to_numpy(state, layout)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got.opt.step) == int(want.opt.step)
    if not compress:
        for name in ("params", "m", "v"):
            part = got.params if name == "params" else getattr(got.opt, name)
            wpart = (want.params if name == "params"
                     else getattr(want.opt, name))
            _close_leaves(part, wpart, 1e-5, f"{name} ")
        assert got.error is None and want.error is None
        return
    w_err, w_par = _paths(want.error), _paths(want.params)
    w_m, w_v = _paths(want.opt.m), _paths(want.opt.v)
    g_par, g_m, g_v = (_paths(got.params), _paths(got.opt.m),
                       _paths(got.opt.v))
    flipped = n = 0
    for key, e in _paths(got.error).items():
        # one quantization step of the leaf, max |g + e| / 127: a residual
        # lies within half a step of zero, so 2 max|e| is one step
        unit = 2 * max(float(np.abs(w_err[key]).max()),
                       float(np.abs(e).max()))
        gap = np.abs(e - w_err[key])
        assert float(gap.max()) <= 1.25 * unit, key
        # a code one step apart: the residual differs by about a step;
        # elsewhere by float32 rounding, ~1e-4 of a step
        moved = gap > 1e-2 * unit
        flipped += int(moved.sum())
        n += moved.size
        kept = ~moved
        for label, got_p, want_p, bound in (
                ("params", g_par, w_par, sum(lrs) * 1.01),
                ("m", g_m, w_m, None), ("v", g_v, w_v, None)):
            d = np.abs(got_p[key] - want_p[key])
            scale = float(np.abs(want_p[key]).max())
            assert float(d[kept].max(initial=0.0)) <= 1e-5 * scale, \
                (label, key)
            if bound is not None:
                assert float(d.max()) <= bound, (label, key)
    # a dropped or stale residual moves almost every element
    assert flipped <= 1e-2 * n, (flipped, n)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("micro", [1, 2])
def test_make_train_step_three_steps(f32, micro, compress):
    """Three steps of ``make_train_step`` on the dense smoke model in both
    packages from one state and the same batches."""
    cfg, jcfg, model, flat, layout, params_np = _setup("smollm-135m")
    kw = dict(learning_rate=1e-3, total_steps=10, microbatches=micro,
              compress_grads=compress)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    api = zoo.build(cfg, "cpu")
    step = TL.make_train_step(TL.module_loss(model, api.loss, layout.names),
                              tcfg, layout)
    jstep = jax.jit(JTL.make_train_step(JZ.build(jcfg).loss, jtcfg))
    state = TL.init_state(flat, tcfg, layout)
    jstate = JTL.init_state(_jax(params_np), jtcfg)
    lrs = []
    for t in range(3):
        batch = _batch(cfg, 4, 16, seed=10 + t)
        state, m = step(state, _torch(batch))
        jstate, jm = jstep(jstate, _jax(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert int(m["step"]) == int(jm["step"]) == t + 1
        lrs.append(1e-3 * (t + 1) / tcfg.warmup_steps)
    _check_state(state, jstate, layout, compress, lrs)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_make_train_step_three_steps_new_configs(f32, arch):
    """Three steps of ``make_train_step``, 2 microbatches, compressing,
    for each config this slice added (the VLM with open gates, its and
    Whisper's stub inputs split with the tokens) in both packages from
    one state and the same batches."""
    cfg, jcfg, model, flat, layout, params_np = _setup(
        arch, gates=arch == "llama-3.2-vision-11b")
    kw = dict(learning_rate=1e-3, total_steps=10, microbatches=2,
              compress_grads=True)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    api = zoo.build(cfg, "cpu")
    step = TL.make_train_step(TL.module_loss(model, api.loss, layout.names),
                              tcfg, layout)
    jstep = jax.jit(JTL.make_train_step(JZ.build(jcfg).loss, jtcfg))
    state = TL.init_state(flat, tcfg, layout)
    jstate = JTL.init_state(_jax(params_np), jtcfg)
    lrs = []
    for t in range(3):
        batch = _batch(cfg, 4, 16, seed=10 + t)
        state, m = step(state, _torch(batch))
        jstate, jm = jstep(jstate, _jax(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert int(m["step"]) == int(jm["step"]) == t + 1
        lrs.append(1e-3 * (t + 1) / tcfg.warmup_steps)
    _check_state(state, jstate, layout, True, lrs)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_train_lm_batches_bit_exact(monkeypatch, tmp_path, arch):
    """The batches both ``train_lm``s hand their step over 3 steps (the
    steps replaced by recorders): tokens, labels and the VLM's
    ``vision`` or Whisper's ``frames``, bit for bit."""
    got, want = [], []

    def port_step(loss_fn, tcfg, layout):
        def step(state, batch):
            got.append({k: v.numpy() for k, v in batch.items()})
            return state, {"loss": torch.zeros(()),
                           "grad_norm": torch.zeros(())}
        return step

    def ref_step(loss_fn, tcfg):
        def step(state, batch):
            want.append({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss": 0.0, "grad_norm": 0.0}
        return step

    class NoJit:
        """``jax`` as ``repro.launch.train`` sees it, with ``jit`` the
        identity (so the recorder sees arrays, not tracers)."""
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **kw):
            return fn
    monkeypatch.setattr(train, "make_train_step", port_step)
    monkeypatch.setattr(jtrain, "make_train_step", ref_step)
    monkeypatch.setattr(jtrain, "jax", NoJit())
    jtrain.train_lm(_jargs(arch, str(tmp_path / "j"), steps=3))
    train.train_lm(train.parse_args([
        "--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
        "--seed", "0", "--ckpt-dir", str(tmp_path / "t"), "--lm-batch", "2",
        "--lm-seq", "32"]))
    stub = "vision" if arch == "llama-3.2-vision-11b" else "frames"
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(["tokens", "labels", stub])
        for k in w:
            _bit_equal(g[k], w[k], k)


def test_microbatches_split_the_batch(f32):
    """``microbatch_grads`` over 2 microbatches equals the mean of the two
    halves' ``value_and_grad``, accumulated as ``acc + g / 2`` from
    zeros, bit for bit; against one pass over the whole batch within
    float32 rounding."""
    cfg, _, model, flat, layout, _ = _setup("smollm-135m")
    loss_fn = TL.module_loss(model, zoo.build(cfg, "cpu").loss, layout.names)
    batch = _torch(_batch(cfg, 4, 16, seed=3))
    loss, grads = TL.microbatch_grads(loss_fn, flat, batch, 2)
    halves = [TL.value_and_grad(loss_fn, flat, {k: v[i * 2:(i + 1) * 2]
                                                for k, v in batch.items()})
              for i in range(2)]
    want = torch.zeros(())
    for h in halves:
        want = want + h[0] / 2
    assert torch.equal(loss, want)
    for i, g in enumerate(grads):
        acc = torch.zeros_like(g)
        for h in halves:
            acc = acc + h[1][i] / 2
        assert torch.equal(g, acc)
    whole, wgrads = TL.value_and_grad(loss_fn, flat, batch)
    np.testing.assert_allclose(loss.item(), whole.item(), rtol=1e-6)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def _bit_equal(got, want, label=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, label
    assert got.tobytes() == want.tobytes(), label


def test_quantize_and_compress_bit_exact():
    """``quantize``, ``dequantize`` and ``compress_grads`` /
    ``decompress_grads`` bit-equal to the reference's on leaves of mixed
    scales: an all-zero leaf, a leaf of halves (ties that round half to
    even), a stacked [L, ...] leaf, and a second round carrying the
    residual.  The reference op by op, each jnp op rounding once as
    written; under ``jax.jit`` XLA contracts the residual's ``gf - q *
    scale`` into one fused multiply-add on the CPU, so there q and the
    scale stay bit-equal and the residual lies within one float32 ulp of
    ``q * scale``."""
    rng = np.random.default_rng(7)
    leaves = [rng.standard_normal((3, 16, 8)).astype(np.float32),
              np.zeros((5,), np.float32),
              (np.arange(-254, 255, dtype=np.float32) / 2),
              (rng.standard_normal((40,)) * 1e-6).astype(np.float32)]
    jquant = jax.jit(lambda g: (*JC.quantize(g), JC.dequantize(
        *JC.quantize(g))))
    for g in leaves:
        q, s = compression.quantize(torch.from_numpy(g))
        jq, js, jd = jquant(jnp.asarray(g))
        _bit_equal(q, jq, "q")
        _bit_equal(s, js, "scale")
        _bit_equal(compression.dequantize(q, s), jd, "dequantize")
    error = compression.init_error([torch.from_numpy(g) for g in leaves])
    jerror = JC.init_error([jnp.asarray(g) for g in leaves])
    for rnd in range(2):
        grads = [g * (1.5 ** rnd) for g in leaves]
        jin = [jnp.asarray(g) for g in grads]
        jitted = jax.jit(JC.compress_grads)(jin, jerror)
        packed, error = compression.compress_grads(
            [torch.from_numpy(g) for g in grads], error)
        jpacked, jerror = JC.compress_grads(jin, jerror)
        for (q, s), (jq, js), (kq, ks) in zip(packed, jpacked, jitted[0]):
            for a, b in ((q, jq), (s, js), (q, kq), (s, ks)):
                _bit_equal(a, b)
        for e, je, ke, d in zip(error, jerror, jitted[1],
                                compression.decompress_grads(packed)):
            _bit_equal(e, je, f"error round {rnd}")
            assert (np.abs(e.numpy() - np.asarray(ke))
                    <= np.spacing(np.abs(d.numpy()))).all()
        for d, jd in zip(compression.decompress_grads(packed),
                         JC.decompress_grads(jpacked)):
            _bit_equal(d, jd, "decompress")


def test_compression_groups_the_reference_leaves(f32):
    """The step quantizes each reference leaf (all layers of a weight
    under one scale): its int8 codes and scales equal the reference's
    ``compress_grads`` of the stacked gradients bit for bit, its residual
    is ``g - dequantize(q, scale)`` exactly, and quantizing each layer
    alone would give another residual."""
    cfg, _, model, flat, layout, _ = _setup("smollm-135m")
    loss_fn = TL.module_loss(model, zoo.build(cfg, "cpu").loss, layout.names)
    _, grads = TL.value_and_grad(loss_fn, flat, _torch(_batch(cfg, 2, 16, 2)))
    tcfg = TrainConfig(compress_grads=True)
    state = TL.init_state(flat, tcfg, layout)
    new, _ = TL.apply_grads(tcfg, state, torch.zeros(()), grads, layout)
    leaves = layout.group(grads)
    jpacked, _ = jax.jit(JC.compress_grads)(
        [jnp.asarray(g.numpy()) for g in leaves],
        JC.init_error([jnp.asarray(g.numpy()) for g in leaves]))
    for g, e, (jq, js) in zip(leaves, new.error, jpacked):
        q, s = compression.quantize(g)
        _bit_equal(q, jq)
        _bit_equal(s, js)
        assert torch.equal(e, g - compression.dequantize(q, s))
    j = layout.paths.index(("layers", "attn", "wq"))
    per_layer = compression.compress_grads(
        list(leaves[j]), compression.init_error(list(leaves[j])))[1]
    assert not torch.equal(torch.stack(per_layer), new.error[j])


def test_tokens_bit_exact():
    """``synthetic_token_batch`` and ``token_shard_schedule`` bit-equal to
    the reference's."""
    cfg = smoke_config(get_config("smollm-135m"))
    jcfg = jsmoke_config(jget_config("smollm-135m"))
    shape = ShapeConfig("t", "train", 24, 6)
    got = tokens.synthetic_token_batch(cfg, shape, seed=3, device="cpu")
    want = JT.synthetic_token_batch(jcfg, JShapeConfig("t", "train", 24, 6),
                                    seed=3)
    for k in ("tokens", "labels"):
        _bit_equal(got[k], want[k], k)
    for args in ((103, 4, 5, 7, 2), (16, 3, 2, 4, 0), (9, 1, 3, 20, 5)):
        _bit_equal(tokens.token_shard_schedule(*args),
                   JT.token_shard_schedule(*args), str(args))


def test_nan_guard():
    """A finite loss takes the new state leaf by leaf, a NaN or inf loss
    keeps the old one (error None passes through)."""
    old = TL.TrainState(params=[torch.zeros(2), torch.zeros(3)],
                        opt=TL.init_adam([torch.zeros(2), torch.zeros(3)]),
                        error=None)
    new = TL.TrainState(params=[torch.ones(2), torch.ones(3)],
                        opt=TL.AdamState(step=torch.ones((), dtype=torch.int32),
                                         m=[torch.ones(2), torch.ones(3)],
                                         v=[torch.ones(2), torch.ones(3)]),
                        error=None)
    for loss, pick in ((1.0, new), (float("nan"), old), (float("inf"), old)):
        got = TL.nan_guard(old, new, {"loss": torch.tensor(loss)})
        assert got.error is None
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, tuple(got))),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     tuple(pick)))):
            np.testing.assert_array_equal(a, b)


def _jargs(arch, ckpt_dir, steps=4):
    """The reference ``train_lm``'s arguments (its parser lives in
    ``main``)."""
    return argparse.Namespace(
        arch=arch, smoke=True, lr=1e-3, steps=steps, microbatches=1,
        seed=0, resume=True, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=1,
        lm_batch=2, lm_seq=32)


def test_train_lm_resumes_from_the_reference_checkpoint(f32, tmp_path,
                                                         capsys):
    """Both ``train_lm``s resume from one step-0 ``TrainState`` that
    ``repro.train.checkpoint.save`` wrote (mamba2's smoke model, the
    port's seeded weights): the same batches (the reference's rng), the
    losses over 4 steps within rtol 1e-5, the same log lines; the port's
    step-4 checkpoint restores in ``repro`` as its own step-4 state (within
    1e-4 of each leaf's largest entry), and the reference's in the port."""
    arch = "mamba2-1.3b"
    cfg, jcfg, model, flat, layout, params_np = _setup(arch)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jstate0 = JTL.init_state(_jax(params_np), JTrainConfig())
    jckpt.save(jdir, 0, jstate0)
    shutil.copytree(jdir, tdir)
    jres = jtrain.train_lm(_jargs(arch, jdir))
    jout = capsys.readouterr().out
    res = train.train_lm(train.parse_args([
        "--arch", arch, "--smoke", "--device", "cpu", "--lr", "1e-3",
        "--steps", "4", "--seed", "0", "--resume", "--ckpt-dir", tdir,
        "--ckpt-every", "2", "--log-every", "1", "--lm-batch", "2",
        "--lm-seq", "32"]))
    out = capsys.readouterr().out
    assert set(res) == {"losses", "wall_s"}
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-5)
    assert len(res["losses"]) == 4

    def lines(text):
        return [ln.split(":")[0] for ln in text.splitlines()
                if ln.startswith(("step", "resumed"))]
    assert lines(out) == lines(jout) and "resumed from step 0" in out
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    # the port's checkpoint, read by repro, against repro's own
    jwant = jckpt.restore(jdir, 4, jstate0)
    jgot = jckpt.restore(tdir, 4, jstate0)
    assert int(jgot.opt.step) == 4
    for part in ("params", "opt"):
        _close_leaves(jax.tree.map(np.asarray, getattr(jgot, part)),
                      jax.tree.map(np.asarray, getattr(jwant, part)),
                      1e-4, part)
    # repro's step-4 checkpoint, read by the port
    like = TL.init_state(flat, TrainConfig(), layout)
    back = ckpt.restore_lm_state(jdir, 4, like, layout)
    _close_leaves(convert.flat_to_numpy(back.params, layout),
                  jax.tree.map(np.asarray, jwant.params), 0.0, "back ")


def test_lm_state_checkpoint_round_trip(tmp_path):
    """A compressing state (with its residual) saved by the port and read
    back by the port and by ``repro`` (under the reference's keys:
    ``.params/embed/tok``, ``.opt/.step``, ``.error/...``), exactly."""
    cfg, jcfg, model, flat, layout, params_np = _setup("zamba2-1.2b")
    tcfg = TrainConfig(compress_grads=True)
    rng = np.random.default_rng(9)
    state = TL.init_state(flat, tcfg, layout)
    state = state._replace(error=[torch.from_numpy(
        rng.standard_normal(tuple(e.shape)).astype(np.float32))
        for e in state.error])
    path = ckpt.save_lm_state(str(tmp_path), 3, state, layout)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        keys = set(z.files)
    assert {".params/embed/tok", ".opt/.step", ".error/shared/attn/wq",
            ".opt/.m/mamba/w_in"} <= keys
    back = ckpt.restore_lm_state(str(tmp_path), 3, state, layout)
    for a, b in zip(back.params + back.error, state.params + state.error):
        assert torch.equal(a, b)
    jlike = JTL.init_state(_jax(params_np), JTrainConfig(compress_grads=True))
    jback = jckpt.restore(str(tmp_path), 3, jlike)
    want = convert.train_state_to_numpy(state, layout)
    _close_leaves(jax.tree.map(np.asarray, jback.error), want.error, 0.0)
    with pytest.raises(ValueError, match="does not fit"):
        other = TL.init_state(convert.lm_leaves(zoo.build(
            dataclasses.replace(cfg, d_model=32), "cpu").init(0))[0],
            tcfg, layout)
        ckpt.restore_lm_state(str(tmp_path), 3, other, layout)


def test_train_lm_refuses_dist():
    """``train_lm --dist gloo --workers 2 --model-axis 2`` (the CLI: two
    gloo ranks on a (1, 2) mesh, every weight whole on both) trains and
    logs one process's losses, digit for digit; ``--model-axis 2`` with
    ``--dist none`` is refused."""
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--steps", "3", "--log-every", "1"]
    want = [f"step {t + 1}: loss={x:.4f}"
            for t, x in enumerate(train.train_lm(train.parse_args(argv))
                                  ["losses"])]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv, "--dist",
         "gloo", "--workers", "2", "--model-axis", "2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [ln.split(" gnorm")[0] for ln in proc.stdout.splitlines()
           if ln.startswith("step ")]
    assert got == want
    assert "over a (1, 2) mesh" in proc.stdout
    with pytest.raises(ValueError, match="one process per rank"):
        train.main(argv + ["--workers", "2", "--model-axis", "2"])


def test_moe_overflow_hand_case_gradient(f32):
    """The slot ``cap - 1`` hand case (five tokens, top-1 of 2 experts, all
    to expert 0, capacity 3): the gradient of the layer's output with
    respect to the input and every weight against ``jax.grad`` of the
    reference's ``moe_forward`` (rtol 1e-5 / atol 1e-6).  Token 2, kept
    but overwritten by the dropped rows' writes, gets no gradient through
    the experts, as tokens 3 and 4; only the router's path reaches it."""
    jcfg = JModelConfig(name="hand", family="moe", d_model=4, n_experts=2,
                        top_k=1, d_ff_expert=4)
    cfg = ModelConfig(name="hand", family="moe", d_model=4, n_experts=2,
                      top_k=1, d_ff_expert=4)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.5, 1.5, (1, 5, 4)).astype(np.float32)
    leaves = jax.tree.map(lambda a: np.array(a[0]), JM.init_moe_mlp(
        jax.random.PRNGKey(4), jcfg, 1))
    leaves["router"] = np.array([[1.0, 0.0]] * 4, np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JM.moe_forward(p, xx, jcfg) * cot)
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jax(leaves),
                                                         jnp.asarray(x))
    mod = moe.MoEMLP(cfg)
    with torch.no_grad():
        for n in ("router", "wg", "wu", "wd"):
            getattr(mod, n).copy_(torch.from_numpy(leaves[n]))
    xt = torch.from_numpy(x).requires_grad_()
    out = moe.moe_forward(mod, xt, cfg)
    names = ("router", "wg", "wu", "wd")
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xt] + [getattr(mod, n) for n in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    # expert 0's input gradient comes from tokens 0 and 1 only
    assert np.abs(grads[2].numpy()[0]).sum() > 0
    probe = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        mod.router.zero_()            # no router path: experts only
    g = torch.autograd.grad(moe.moe_forward(mod, probe, cfg).sum(), probe)[0]
    assert (g[0, 2:] == 0).all() and (g[0, :2] != 0).any()
