"""The port's mixture-of-experts LMs (``repro_torch.models.moe``,
``repro_torch.models.deepseek``) against the reference
(``repro.models.moe``, ``repro.models.deepseek``).

On the CPU, inputs made by numpy from a seed, weights carried across by
``repro_torch.convert``, ``COMPUTE_DTYPE`` float32 in both packages:

* the configs of qwen3-moe-30b-a3b and deepseek-v2-236b, full and smoke,
  field by field;
* ``moe_forward``'s dispatch at a shape where experts overflow (drop rate
  above 0, so the slot ``cap - 1`` collision runs) and at one where none
  does: expert assignments, sort order, ranks and kept mask exact,
  outputs within rtol 1e-5 / atol 1e-6, ``moe_drop_rate`` bit-equal;
* the reference's collision on a hand case of 5 assignments to one
  expert of capacity 3: the kept assignment in slot 2 comes back zero in
  both packages;
* flash's refusal of a v head dim unlike q's and k's (MLA), on every
  device;
* each smoke model's forward, loss and decode from the reference's cache
  (``_torch_parity.check_lm_parity``); ``serve_lm`` and the entry points.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from _torch_parity import (check_lm_parity, ref_params,  # noqa: E402
                           set_compute)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models import deepseek as JD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.config import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import deepseek, layers, moe, zoo  # noqa: E402

QWEN, DEEPSEEK = "qwen3-moe-30b-a3b", "deepseek-v2-236b"
FAMILY = {QWEN: (JM, JM.init_qwen3_moe, convert.moe_params_from_numpy,
                 convert.moe_cache_from_numpy),
          DEEPSEEK: (JD, JD.init_deepseek, convert.deepseek_params_from_numpy,
                     convert.deepseek_cache_from_numpy)}


@pytest.fixture
def f32(monkeypatch):
    """float32 compute in both packages."""
    set_compute(monkeypatch, "float32")


def _smoke(name):
    return smoke_config(get_config(name)), jsmoke_config(jget_config(name))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", [QWEN, DEEPSEEK])
def test_moe_configs_match_reference(name):
    """The full and smoke configs carry the reference's value in every
    field the port has; the family key splits on MLA."""
    for a, b in ((get_config(name), jget_config(name)), _smoke(name)):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
    assert zoo._family_key(get_config(name)) == (
        "moe_deepseek" if name == DEEPSEEK else "moe_qwen")


# ------------------------------------------------------------ the dispatch

def _layer(name, router):
    """The smoke config's MoE layer in both packages: the reference's
    ``init_moe_mlp`` leaves (numpy) with ``router`` put in, and the port's
    ``MoEMLP`` holding them."""
    cfg, jcfg = _smoke(name)
    leaves = jax.tree.map(np.array, JM.init_moe_mlp(jax.random.PRNGKey(2),
                                                    jcfg, 1))
    leaves = jax.tree.map(lambda a: a[0], leaves)
    leaves["router"] = router.astype(np.float32)
    mod = moe.MoEMLP(cfg)
    with torch.no_grad():
        for n in ("router", "wg", "wu", "wd"):
            getattr(mod, n).copy_(torch.from_numpy(leaves[n]))
        if mod.shared is not None:
            for n in ("wg", "wu", "wd"):
                getattr(mod.shared, n).copy_(
                    torch.from_numpy(leaves["shared"][n]))
    return cfg, jcfg, leaves, mod


def _ref_dispatch(router, x, jcfg):
    """The reference's routing and capacity plan, line for line from
    ``repro/models/moe.py::moe_forward`` (its ``:166-178``)."""
    b, s, d = x.shape
    t, k, e = b * s, jcfg.top_k, jcfg.n_experts
    cap = max(int(t * k / e * JM.CAPACITY_FACTOR), 1)
    logits = (x.reshape(t, d) @ router).astype(jnp.float32)
    topv, topi = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    rank = jnp.arange(t * k, dtype=jnp.int32) - jnp.searchsorted(
        se, se, side="left")
    return {"topi": topi, "order": order, "se": se, "rank": rank,
            "keep": rank < cap, "cap": cap}


def _dispatch_case(name, case):
    """``(router, x)``: "overflow" draws a router N(0, 1) with expert 0's
    column raised by 0.1 over inputs of mean 0.5, so expert 0 is in most
    tokens' top k, past its capacity; "balanced" routes token t
    to experts t mod E and t + 1 mod E exactly, each expert taking
    ``T k / E`` = 8 of its capacity 10."""
    cfg = _smoke(name)[0]
    d, e = cfg.d_model, cfg.n_experts
    rng = np.random.default_rng(11)
    if case == "overflow":
        router = rng.normal(size=(d, e))
        router[:, 0] += 0.1
        return router, (rng.normal(size=(2, 16, d)) + 0.5).astype(np.float32)
    router = np.eye(d, e)
    t = np.arange(32)
    x = rng.normal(scale=0.01, size=(32, d))
    x[t, t % e] += 3.0
    x[t, (t + 1) % e] += 2.0
    return router, x.reshape(2, 16, d).astype(np.float32)


@pytest.mark.parametrize("case", ["overflow", "balanced"])
@pytest.mark.parametrize("name", [QWEN, DEEPSEEK])
def test_moe_dispatch_exact(f32, name, case):
    """``route`` against the reference's plan (assignments, sort order,
    ranks, kept mask exact; the stable sort and top-k ties as the
    reference's); ``moe_forward`` within rtol 1e-5 / atol 1e-6 (DeepSeek
    with its shared expert); ``moe_drop_rate`` bit-equal, above 0 where
    experts overflow and 0 where none does; ``tally`` counts the drops
    and the zeroed slots."""
    router, x = _dispatch_case(name, case)
    cfg, jcfg, leaves, mod = _layer(name, router)
    xt = torch.from_numpy(x)
    r = moe.route(mod.router, xt.reshape(-1, cfg.d_model), cfg)
    want = _ref_dispatch(jnp.asarray(leaves["router"]), jnp.asarray(x), jcfg)
    assert r.cap == want["cap"]
    for key in ("topi", "order", "se", "rank", "keep"):
        np.testing.assert_array_equal(getattr(r, key).numpy(),
                                      np.asarray(want[key]), err_msg=key)
    with torch.no_grad(), moe.tally() as counts:
        got = moe.moe_forward(mod, xt, cfg)
    jp = jax.tree.map(jnp.asarray, leaves)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JM.moe_forward(jp, jnp.asarray(x), jcfg)),
        rtol=1e-5, atol=1e-6)
    rate = moe.moe_drop_rate(mod, xt, cfg)
    jrate = JM.moe_drop_rate(jp, jnp.asarray(x), jcfg)
    assert rate.dtype == torch.float32
    assert rate.numpy().tobytes() == np.asarray(jrate).tobytes()
    dropped = int((~r.keep).sum())
    over = int((r.count > r.cap).sum())
    assert counts == {"calls": 1, "assignments": r.keep.numel(),
                      "dropped": dropped, "zeroed": over}
    if case == "overflow":
        assert rate.item() > 0 and over > 0
    else:
        assert rate.item() == 0 and over == 0


def test_cap_collision_hand_case(f32):
    """Five tokens, top-1 of 2 experts, all routed to expert 0: capacity
    ``int(5 / 2 * 1.25)`` = 3 keeps ranks 0-2 and drops 3 and 4, whose
    clipped writes land in slot 2 after the kept one.  The reference's
    last write wins, so token 2 (kept) gets a zero row and a zero output,
    as the dropped tokens 3 and 4 do; tokens 0 and 1 get their expert's
    output.  The port gives the same five rows, and counts 2 dropped and
    1 zeroed."""
    jcfg = JModelConfig(name="hand", family="moe", d_model=4, n_experts=2,
                        top_k=1, d_ff_expert=4)
    cfg = ModelConfig(name="hand", family="moe", d_model=4, n_experts=2,
                      top_k=1, d_ff_expert=4)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.5, 1.5, (1, 5, 4)).astype(np.float32)
    leaves = jax.tree.map(lambda a: np.array(a[0]), JM.init_moe_mlp(
        jax.random.PRNGKey(4), jcfg, 1))
    leaves["router"] = np.array([[1.0, 0.0]] * 4, np.float32)
    want = np.asarray(JM.moe_forward(jax.tree.map(jnp.asarray, leaves),
                                     jnp.asarray(x), jcfg))
    mod = moe.MoEMLP(cfg)
    with torch.no_grad():
        for n in ("router", "wg", "wu", "wd"):
            getattr(mod, n).copy_(torch.from_numpy(leaves[n]))
        with moe.tally() as counts:
            got = moe.moe_forward(mod, torch.from_numpy(x), cfg).numpy()
    assert (want[0, 2:] == 0).all() and (np.abs(want[0, :2]) > 0).all()
    assert (got[0, 2:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (counts["dropped"], counts["zeroed"]) == (2, 1)
    assert moe.moe_drop_rate(mod, torch.from_numpy(x), cfg).item() \
        == pytest.approx(0.4)


# ------------------------------------------------------------- flash guard

def test_flash_refuses_unequal_head_dims(f32):
    """``ops.flash_attention`` raises ValueError when v's head dim differs
    from q's and k's, before it dispatches to a device (meta tensors reach
    the check too); MLA with flash switched on raises through
    ``gqa_attention`` rather than run a kernel on 192-wide q/k heads over
    128-wide values."""
    q = torch.zeros(1, 2, 128, 192)
    v = torch.zeros(1, 2, 128, 128)
    with pytest.raises(ValueError, match="one head dim"):
        ops.flash_attention(q, q, v)
    meta = [t.to("meta") for t in (q, q, v)]
    with pytest.raises(ValueError, match="one head dim"):
        ops.flash_attention(*meta)
    cfg = dataclasses.replace(_smoke(DEEPSEEK)[0], use_flash_attention=True)
    model = zoo.build(cfg, "cpu").init(0)
    with pytest.raises(ValueError, match="one head dim"):
        zoo.forward_logits(cfg, model,
                           {"tokens": torch.zeros((1, 128), dtype=torch.int32)})


# ------------------------------------------------------------ whole models

@pytest.mark.parametrize("name", [QWEN, DEEPSEEK])
def test_model_matches_reference(f32, name):
    """The smoke model on the reference's weights: forward, loss and six
    decode steps from the reference's cache, every cache leaf compared
    (qwen3's k/v; DeepSeek's latent ``c_kv`` and roped ``k_r`` of its
    dense and MoE layers)."""
    jmod, init, params_from, cache_from = FAMILY[name]
    cfg, jcfg = _smoke(name)
    params = ref_params(init, jcfg, seed=1)
    model = params_from(params, cfg, device="cpu")
    check_lm_parity(jmod, jcfg, params, model, cache_from)


@pytest.mark.parametrize("name", [QWEN, DEEPSEEK])
def test_serve_lm_cpu_smoke(name):
    """serve_lm --smoke --device cpu reaches the family's decode loop:
    tokens in the padded vocab, one seed the same tokens twice; the cache
    has the reference's layout."""
    argv = ["--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen-len", "4"]
    toks = serve.serve_lm(serve.parse_args(argv))["tokens"]
    cfg, jcfg = _smoke(name)
    assert toks.shape == (2, 4)
    assert toks.min() >= 0 and toks.max() < layers.padded_vocab(cfg)
    np.testing.assert_array_equal(
        serve.serve_lm(serve.parse_args(argv))["tokens"], toks)
    api = zoo.build(cfg, "cpu")
    cache = api.init_cache(api.init(0), 2, 8)
    want = FAMILY[name][0].init_cache(jcfg, 2, 8) if name == DEEPSEEK \
        else JM.init_cache(jcfg, 2, 8)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.bfloat16 for v in cache.values())


@pytest.mark.parametrize("entry", ["qwen", "deepseek", "zoo", "serve"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The models, zoo.build and serve_lm run on the card unless asked for
    the CPU, and raise where there is none; each model refuses a config
    of the other family."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"qwen": lambda: moe.init_qwen3_moe(_smoke(QWEN)[0]),
            "deepseek": lambda: deepseek.DeepSeekLM(_smoke(DEEPSEEK)[0]),
            "zoo": lambda: zoo.build(_smoke(QWEN)[0]),
            "serve": lambda: serve.serve_lm(serve.parse_args(
                ["--arch", DEEPSEEK, "--smoke"]))}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    with pytest.raises(ValueError, match="without MLA"):
        moe.Qwen3MoeLM(_smoke(DEEPSEEK)[0], "cpu")
    with pytest.raises(ValueError, match="with MLA"):
        deepseek.DeepSeekLM(_smoke(QWEN)[0], "cpu")
