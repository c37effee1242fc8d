"""The LM's model axis in the port (``repro_torch.models.layers``'s mesh
context, ``moe.moe_forward_ep``, head-split attention and MLA, sequence
parallelism, ``chunked_attention``) against the reference's mesh
variants (``repro.models.moe.moe_forward_ep``, ``shard_heads``,
``SEQ_PARALLEL``, ``chunked_attention``).

Inputs are numpy from a seed; the weights are the reference's init trees
as numpy, handed to both packages; ``COMPUTE_DTYPE`` is float32 on both
sides.  The reference's mesh outputs come from ONE module-scoped
subprocess with 8 forced host devices (as ``tests/test_perf_variants.py``
runs them); the port's ranks are gloo processes on the CPU, one
module-scoped launch at W = 2 and one at W = 4 (both started once the
reference has written its file, side by side).  Each rank also runs the
unsharded port on the same inputs in its own process, so "bit-equal to
the unsharded port" compares two runs of one process.

* EP on meshes (1, 2) and (2, 4) (the port runs each batch half over its
  M = 4 axis): qwen3 and DeepSeek smoke layers (DeepSeek's shared
  expert), and a skewed router of 32 experts that overflows the
  destination capacity ``cap`` at (2, 4) and the local capacity ``c2``
  at both.  Every dispatch integer (top-k experts, both sorts, slots,
  kept masks, the received expert ids and marks) and the drop counts
  bit-equal to the reference's own lines; outputs within rtol 1e-5 /
  atol 1e-6.
* The predicate's fallbacks (a sequence M does not divide, experts M
  does not divide, decode's one token): the reference's output, and
  bit-equal to the unsharded port.
* The gather path with the experts split (a skewed router, so the slot
  ``cap - 1`` collision runs): bit-equal to the unsharded port.
* Heads split at M = 2 for the dense LM (smollm's 2 / 1 heads: the kv
  head whole; stablelm's 8 / 2: both split), qwen3 (8 / 1, and 8 / 2)
  and DeepSeek's MLA (32 heads): ``forward_logits`` and 8 decode steps,
  each from the reference's cache of that step, against the reference
  and the unsharded port within rtol 1e-5 / atol 1e-6 (a step's logits
  atol 1e-4: its bf16 cache write), the rank's cache against that slice
  of the reference's and of the unsharded port's (one bf16 ulp plus
  1e-4).
* Sequence parallelism: the reference's ``test_seq_parallel_matches_
  baseline`` setup (smollm smoke, mesh (2, 4)) in float32 against the
  reference's sequence-parallel and baseline logits and the unsharded
  port, rtol 1e-5 / atol 1e-6.
* ``chunked_attention`` in this process against the reference's at
  blocks 128/256/512 and ``lq`` 1024 and at irregular lengths, through
  ``gqa_attention``'s predicate, and its gradient against the plain
  attention's (rtol 1e-4 / atol 1e-5).
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import run_forced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import deepseek as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import layers, moe, zoo  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
_TIMEOUT = 300
QWEN, DEEPSEEK = "qwen3-moe-30b-a3b", "deepseek-v2-236b"
SMOLLM, STABLELM = "smollm-135m", "stablelm-12b"
#: EP cases: arch, config overrides, x's (B, S), the meshes (dp, m)
EP = {"qwen": (QWEN, {}, (4, 8), ((1, 2), (2, 4))),
      "deepseek": (DEEPSEEK, {}, (4, 8), ((1, 2), (2, 4))),
      "skewed": (QWEN, {"n_experts": 32}, (4, 64), ((1, 2), (2, 4)))}
#: the predicate's fallbacks: S % m, E % m, decode
FALLBACK = {"seq": (QWEN, {}, (4, 7), ((1, 2),)),
            "experts": (QWEN, {"n_experts": 6}, (4, 8), ((1, 4),)),
            "decode": (QWEN, {}, (4, 1), ((1, 2),))}
#: heads split at M = 2: arch, config overrides
HEADS = {"smollm": (SMOLLM, {}), "stablelm": (STABLELM, {}),
         "qwen": (QWEN, {}), "qwen_kv2": (QWEN, {"n_kv_heads": 2}),
         "deepseek": (DEEPSEEK, {})}
B, S, PROMPT, STEPS = 2, 16, 4, 8


def _cfgs(name, over):
    """The smoke config of ``name`` with ``over`` in both packages."""
    return (dataclasses.replace(smoke_config(get_config(name)), **over),
            dataclasses.replace(jsmoke_config(jget_config(name)), **over))


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _nest(z, prefix):
    """The nested dict of ``z``'s arrays under ``prefix/``."""
    tree = {}
    for key in z.files:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            d = tree
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = np.array(z[key])
    return tree


def _router(case, cfg, rng):
    """The router of an EP case: the skewed case favours experts 0 and 1
    (both on rank 0) for every token, the others the init's."""
    r = rng.normal(scale=0.3, size=(cfg.d_model, cfg.n_experts))
    if case == "skewed":
        r *= 0.01
        r[:, 0] += 1.0
        r[:, 1] += 0.9
    return r.astype(np.float32)


def _draw(shapes, rng):
    """Seeded numpy leaves of a reference init tree's ``shapes``
    (``jax.eval_shape``'s): norms (``ln*``, ``norm_f``) ones, every other
    leaf normal x 0.02."""
    if isinstance(shapes, dict):
        return {k: (np.ones(v.shape, np.float32)
                    if k.startswith(("ln", "norm")) else _draw(v, rng))
                for k, v in shapes.items()}
    return (rng.normal(size=shapes.shape) * 0.02).astype(np.float32)


def _inputs(path):
    """Every case's seeded numpy inputs as one ``.npz``: the MoE layers
    (the reference's ``init_moe_mlp`` tree, the router drawn per case)
    and their ``x``, the models' params (the reference's init trees) and
    the tokens."""
    out = {}
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(0)
    for tag, (name, over, (b, s), _) in {**EP, **FALLBACK}.items():
        cfg, jcfg = _cfgs(name, over)
        leaves = jax.tree.map(lambda a: a[0], _draw(jax.eval_shape(
            lambda k: JM.init_moe_mlp(k, jcfg, 1), key), rng))
        leaves["router"] = _router(tag, cfg, rng)
        _flat(leaves, f"ep/{tag}/p", out)
        out[f"ep/{tag}/x"] = (rng.normal(size=(b, s, cfg.d_model))
                              + (0.5 if tag == "skewed" else 0.0)
                              ).astype(np.float32)
    for tag, (name, over) in {**HEADS, "sp": (SMOLLM, {})}.items():
        cfg, jcfg = _cfgs(name, over)
        init = (JD.init_deepseek if cfg.kv_lora_rank else
                JM.init_qwen3_moe if cfg.family == "moe" else JT.init_lm)
        _flat(_draw(jax.eval_shape(lambda k: init(jcfg, k), key), rng),
              f"model/{tag}", out)
    out["tokens"] = rng.integers(0, 512, (B, S)).astype(np.int32)
    np.savez(path, **out)


_REFERENCE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from repro.configs import get_config, smoke_config
from repro.launch.mesh import make_mesh
from repro.models import deepseek as D, layers as L, moe as M, transformer as T
L.COMPUTE_DTYPE = jnp.float32
z = np.load({inputs!r})
EP, FALLBACK, HEADS = {ep!r}, {fallback!r}, {heads!r}
PROMPT, STEPS = {prompt}, {steps}
out = {{}}

def nest(prefix):
    tree = {{}}
    for key in z.files:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            d = tree
            for p in path:
                d = d.setdefault(p, {{}})
            d[leaf] = jnp.asarray(z[key])
    return tree

def cfg_of(name, over):
    return dataclasses.replace(smoke_config(get_config(name)), **over)

def first(router, xf, k, m, e_loc):
    # the reference's dispatch, line for line from moe_forward_ep's body
    # (repro/models/moe.py:83-112), for one device's tokens
    tl = xf.shape[0]
    logits = (xf @ router.astype(xf.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = lax.top_k(probs, k)
    fe = topi.reshape(-1)
    dest = fe // e_loc
    cap = max(int(tl * k / m * 2.0) + 8, 8)
    order = jnp.argsort(dest)
    sd = dest[order]
    first = jnp.searchsorted(sd, sd, side="left")
    slot = jnp.arange(tl * k, dtype=jnp.int32) - first
    ok = slot < cap
    slot_c = jnp.where(ok, slot, cap)
    send_e = jnp.zeros((m, cap), jnp.int32).at[sd, slot_c].set(
        fe[order] % e_loc, mode="drop")
    send_m = jnp.zeros((m, cap), xf.dtype).at[sd, slot_c].set(
        jnp.ones((), xf.dtype), mode="drop")
    return dict(topi=topi, order=order, dest=sd, slot=slot, ok=ok), send_e, send_m

def second(re_, rm, m, e_loc):
    cap = re_.shape[0] // m
    c2 = max(int(m * cap / e_loc * 2.0) + 8, 8)
    key2 = re_ + (1 - rm.astype(jnp.int32)) * e_loc
    order2 = jnp.argsort(key2)
    sk2 = key2[order2]
    first2 = jnp.searchsorted(sk2, sk2, side="left")
    slot2 = jnp.arange(m * cap, dtype=jnp.int32) - first2
    ok2 = jnp.logical_and(slot2 < c2, sk2 < e_loc)
    return dict(recv_e=re_, recv_m=rm, order2=order2, slot2=slot2, ok2=ok2,
                dropped2=jnp.logical_and(sk2 < e_loc, ~ok2).sum())

first = jax.jit(first, static_argnums=(2, 3, 4))
second = jax.jit(second, static_argnums=(2, 3))

def ep_ints(p, x, cfg, dp, m, tag):
    # per device; the all_to_all of the expert ids and marks as the
    # transpose of the devices' send blocks
    b, s, d = x.shape
    e_loc, k = cfg.n_experts // m, cfg.top_k
    bl, sl = b // dp, s // m
    sends = {{}}
    for di in range(dp):
        for r in range(m):
            xf = x[di * bl:(di + 1) * bl, r * sl:(r + 1) * sl].reshape(-1, d)
            ints, se, sm = first(p["router"], xf, k, m, e_loc)
            sends[di, r] = (se, sm)
            key = f"ep/{{tag}}/{{dp}}x{{m}}/d{{di}}r{{r}}/"
            for n, a in ints.items():
                out[key + n] = np.asarray(a)
            out[key + "cap"] = np.asarray(se.shape[1])
    for di in range(dp):
        for r in range(m):
            re_ = jnp.concatenate([sends[di, j][0][r] for j in range(m)])
            rm = jnp.concatenate([sends[di, j][1][r] for j in range(m)])
            ints = second(re_, rm, m, e_loc)
            key = f"ep/{{tag}}/{{dp}}x{{m}}/d{{di}}r{{r}}/"
            for n, a in ints.items():
                out[key + n] = np.asarray(a)
            cap = re_.shape[0] // m
            out[key + "c2"] = np.asarray(max(int(m * cap / e_loc * 2.0) + 8, 8))
            out[key + "dropped"] = np.asarray(
                (~out[key + "ok"]).sum() + out[key + "dropped2"])

M.set_moe_impl("ep_a2a")
for tag, (name, over, shape, meshes) in {{**EP, **FALLBACK}}.items():
    cfg = cfg_of(name, over)
    p, x = nest(f"ep/{{tag}}/p"), jnp.asarray(z[f"ep/{{tag}}/x"])
    for dp, m in meshes:
        L.set_mesh(make_mesh((dp, m), ("data", "model")))
        y = jax.jit(lambda p, x: M.moe_forward(p, x, cfg))(p, x)
        out[f"ep/{{tag}}/{{dp}}x{{m}}/y"] = np.asarray(y)
        L.set_mesh(None)
        if tag in EP:
            ep_ints(p, x, cfg, dp, m, tag)
M.set_moe_impl("gather")

tokens = jnp.asarray(z["tokens"])
for tag, (name, over) in HEADS.items():
    cfg = cfg_of(name, over)
    mod = D if cfg.kv_lora_rank else M if cfg.family == "moe" else T
    params = nest(f"model/{{tag}}")
    out[f"heads/{{tag}}/logits"] = np.asarray(
        jax.jit(lambda p, t: mod.forward_train(cfg, p, t))(params, tokens))
    step = jax.jit(lambda p, c, t, pos: mod.forward_decode(cfg, p, c, t, pos))
    cache = mod.init_cache(cfg, tokens.shape[0], PROMPT + STEPS)
    for pos in range(PROMPT):
        logits, cache = step(params, cache, tokens[:, pos:pos + 1],
                             jnp.int32(pos))
    for i in range(STEPS):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        for n, a in cache.items():
            out[f"heads/{{tag}}/step{{i}}/cache/{{n}}"] = np.asarray(
                a.astype(jnp.float32))
        out[f"heads/{{tag}}/step{{i}}/tok"] = np.asarray(tok)
        logits, cache = step(params, cache, tok, jnp.int32(PROMPT + i))
        out[f"heads/{{tag}}/step{{i}}/logits"] = np.asarray(logits)
    for n, a in cache.items():
        out[f"heads/{{tag}}/step{{STEPS}}/cache/{{n}}"] = np.asarray(
            a.astype(jnp.float32))

cfg = cfg_of("smollm-135m", {{}})
params = nest("model/sp")
out["sp/base"] = np.asarray(jax.jit(
    lambda p, t: T.forward_train(cfg, p, t))(params, tokens))
L.set_mesh(make_mesh((2, 4), ("data", "model")))
L.set_seq_parallel(True)
out["sp/logits"] = np.asarray(jax.jit(
    lambda p, t: T.forward_train(cfg, p, t))(params, tokens))
L.set_mesh(None)
L.set_seq_parallel(False)
np.savez({path!r}, **out)
print("SAVED")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_TESTS, env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


# ------------------------------------------------------------ the ranks

def _moe_layer(tag, z, cfg):
    """The case's ``MoEMLP`` built under the installed axis, holding the
    rank's slice of the numpy leaves."""
    p = _nest(z, f"ep/{tag}/p")
    mod = moe.MoEMLP(cfg)
    with torch.no_grad():
        for n in ("router", "wg", "wu", "wd"):
            w = getattr(mod, n)
            w.copy_(torch.from_numpy(layers.take(w, p[n])))
        if mod.shared is not None:
            for n in ("wg", "wu", "wd"):
                getattr(mod.shared, n).copy_(torch.from_numpy(
                    p["shared"][n]))
    return mod


def _ep_cases(group, z, out):
    """EP and its fallbacks at the group's M: for each case and each of
    its meshes of this M, the output of each batch half (of the ``dp``)
    over the axis, the dispatch plans and drops, and the unsharded port's
    gather path (the fallbacks' bit-equality)."""
    m, r = group.world, group.rank
    for tag, (name, over, _, meshes) in {**EP, **FALLBACK}.items():
        cfg = _cfgs(name, over)[0]
        x = torch.from_numpy(z[f"ep/{tag}/x"])
        for dp, mm in meshes:
            if mm != m:
                continue
            key = f"ep/{tag}/{dp}x{m}"
            with zoo.settings(group, moe_impl="ep_a2a"):
                mod = _moe_layer(tag, z, cfg)
                halves = []
                with moe.tally(plans=True) as t:
                    for xh in x.chunk(dp, dim=0):
                        halves.append(moe.moe_forward(mod, xh, cfg))
            out[key + "/y"] = torch.cat(halves).numpy()
            for di, plan in enumerate(t["plans"]):
                for n, a in plan.items():
                    out[f"{key}/d{di}r{r}/{n}"] = np.asarray(a)
            out[key + "/dropped"] = np.asarray(t["dropped"])
            out[key + "/calls"] = np.asarray(t["calls"])
            with zoo.settings(None):
                out[key + "/y_whole"] = moe.moe_forward(
                    _moe_layer(tag, z, cfg), x, cfg).numpy()
    # the gather path with split experts, the skewed router: overflow and
    # the slot cap - 1 collision
    cfg = _cfgs(QWEN, {"n_experts": 32})[0]
    x = torch.from_numpy(z["ep/skewed/x"])
    for axis in (group, None):
        with zoo.settings(axis), moe.tally() as t:
            y = moe.moe_forward(_moe_layer("skewed", z, cfg), x, cfg)
        tag = "split" if axis is not None else "whole"
        out[f"gather/{tag}/y"] = y.numpy()
        out[f"gather/{tag}/zeroed"] = np.asarray(t["zeroed"])


def _heads_cases(group, z, ref, out):
    """Each HEADS model at M = 2 with its heads split: ``forward_logits``
    and the decode steps from the reference's caches, and the unsharded
    port on the same inputs."""
    tokens = torch.from_numpy(z["tokens"].astype(np.int64))
    for tag, (name, over) in HEADS.items():
        cfg = _cfgs(name, over)[0]
        params = _nest(z, f"model/{tag}")
        for axis in (group, None):
            side = "split" if axis is not None else "whole"
            with zoo.settings(axis, shard_heads=True):
                model = convert.params_from_numpy(params, cfg, "cpu")
                key = f"heads/{tag}/{side}"
                out[key + "/logits"] = zoo.forward_logits(
                    cfg, model, {"tokens": tokens}).numpy()
                for i in range(STEPS):
                    whole = {n[len(f"heads/{tag}/step{i}/cache/"):]:
                             torch.from_numpy(ref[n]).to(torch.bfloat16)
                             for n in ref.files
                             if n.startswith(f"heads/{tag}/step{i}/cache/")}
                    cache = {n: a.clone() for n, a in
                             convert.cache_slice(whole, model).items()}
                    tok = torch.from_numpy(ref[f"heads/{tag}/step{i}/tok"])
                    logits, cache = model.forward_decode(cache, tok,
                                                         PROMPT + i)
                    out[f"{key}/step{i}/logits"] = logits.numpy()
                    for n, a in cache.items():
                        out[f"{key}/step{i}/cache/{n}"] = a.float().numpy()


def _sp_case(group, z, out):
    """Sequence parallelism at M = 4 (smollm smoke), and the unsharded
    port."""
    cfg = _cfgs(SMOLLM, {})[0]
    tokens = torch.from_numpy(z["tokens"].astype(np.int64))
    for axis in (group, None):
        with zoo.settings(axis, seq_parallel=True):
            model = convert.params_from_numpy(_nest(z, "model/sp"), cfg,
                                              "cpu")
            out[f"sp/{'split' if axis else 'whole'}"] = zoo.forward_logits(
                cfg, model, {"tokens": tokens}).numpy()


def _ranks(group, inputs, ref, out):
    """A rank's share (``launch.mesh``'s target): the cases of its M,
    written to ``out/rank<r>.npz``."""
    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    z = np.load(inputs)
    res = {}
    with torch.no_grad():
        _ep_cases(group, z, res)
        if group.world == 2:
            _heads_cases(group, z, np.load(ref), res)
        else:
            _sp_case(group, z, res)
    np.savez(os.path.join(out, f"rank{group.rank}.npz"), **res)


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, {m: [rank arrays]})``: the reference's subprocess,
    then the W = 2 and W = 4 launches side by side."""
    tmp = tmp_path_factory.mktemp("model_axis")
    inputs, ref = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    _inputs(inputs)
    assert "SAVED" in run_forced(_REFERENCE.format(
        inputs=inputs, ep=EP, fallback=FALLBACK, heads=HEADS, prompt=PROMPT,
        steps=STEPS, path=ref), devices=8)
    codes = {}

    def launch(w):
        (tmp / f"w{w}").mkdir()
        codes[w] = mesh.run("test_torch_model_axis:_ranks", w, device="cpu",
                            kwargs=dict(inputs=inputs, ref=ref,
                                        out=str(tmp / f"w{w}")),
                            timeout_s=_TIMEOUT, env=_env())
    threads = [threading.Thread(target=launch, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert codes == {2: 0, 4: 0}, codes
    return np.load(ref), {w: [np.load(tmp / f"w{w}" / f"rank{r}.npz")
                              for r in range(w)] for w in (2, 4)}


# ----------------------------------------------------------------- EP

def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 4)])
@pytest.mark.parametrize("case", list(EP))
def test_ep_dispatch_bit_exact(runs, case, mesh_shape):
    """Every rank's dispatch integers (top-k experts, the stable sort by
    destination, slots, kept masks, the received expert ids and marks,
    the local sort, its slots and kept mask, both capacities) equal the
    reference's, and the drops sum to the reference's."""
    ref, ranks = runs
    dp, m = mesh_shape
    key = f"ep/{case}/{dp}x{m}"
    dropped = 0
    for r, rank in enumerate(ranks[m]):
        for di in range(dp):
            pre = f"{key}/d{di}r{r}/"
            for n in ("topi", "order", "dest", "slot", "ok", "recv_e",
                      "order2", "slot2", "ok2", "cap", "c2"):
                np.testing.assert_array_equal(
                    rank[pre + n].astype(np.int64),
                    ref[pre + n].astype(np.int64), err_msg=pre + n)
            np.testing.assert_array_equal(rank[pre + "recv_m"],
                                          ref[pre + "recv_m"])
            dropped += int(ref[pre + "dropped"])
        assert int(rank[key + "/calls"]) == dp
    assert sum(int(rank[key + "/dropped"]) for rank in ranks[m]) == dropped
    if case == "skewed":
        # the case overflows c2 on both meshes and cap where m = 4 (at
        # m = 2, cap = T k + 8 holds every assignment)
        pre = [f"{key}/d{di}r{r}/" for di in range(dp) for r in range(m)]
        over_cap = sum(int((~ref[p + "ok"]).sum()) for p in pre)
        over_c2 = sum(int(ref[p + "recv_m"].sum() - ref[p + "ok2"].sum())
                      for p in pre)
        assert over_c2 > 0 and (over_cap > 0) == (m == 4)
        assert over_cap + over_c2 == dropped


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 4)])
@pytest.mark.parametrize("case", list(EP))
def test_ep_output_matches_reference(runs, case, mesh_shape):
    """The layer's output on every rank within rtol 1e-5 / atol 1e-6 of
    the reference's ``moe_forward_ep`` (DeepSeek's with its shared
    expert)."""
    ref, ranks = runs
    dp, m = mesh_shape
    key = f"ep/{case}/{dp}x{m}/y"
    for rank in ranks[m]:
        _close(rank[key], ref[key])


@pytest.mark.parametrize("case", list(FALLBACK))
def test_ep_predicate_falls_back_to_the_gather_path(runs, case):
    """Where M does not divide the sequence or the experts, or in decode,
    ``moe_forward`` under ``ep_a2a`` takes the gather path: the
    reference's output, and bit-equal to the unsharded port."""
    ref, ranks = runs
    (dp, m), = FALLBACK[case][3]
    key = f"ep/{case}/{dp}x{m}"
    for rank in ranks[m]:
        _close(rank[key + "/y"], ref[key + "/y"])
        assert rank[key + "/y"].tobytes() == rank[key + "/y_whole"].tobytes()
        assert int(rank[key + "/calls"]) == dp      # counted, no EP plan


def test_gather_path_with_split_experts_is_bit_equal(runs):
    """The gather path with the experts split over M = 2 and M = 4: every
    rank's output bit-equal to the unsharded port, with the slot
    ``cap - 1`` collision zeroing rows."""
    for ranks in runs[1].values():
        for rank in ranks:
            assert int(rank["gather/whole/zeroed"]) > 0
            assert int(rank["gather/split/zeroed"]) == int(
                rank["gather/whole/zeroed"])
            assert (rank["gather/split/y"].tobytes()
                    == rank["gather/whole/y"].tobytes())


# -------------------------------------------------------------- heads

@pytest.mark.parametrize("tag", list(HEADS))
def test_heads_split_forward_matches(runs, tag):
    """``forward_logits`` with the heads split over M = 2 on both ranks
    within rtol 1e-5 / atol 1e-6 of the reference's ``forward_train`` and
    of the unsharded port."""
    ref, ranks = runs
    for rank in ranks[2]:
        got = rank[f"heads/{tag}/split/logits"]
        _close(got, ref[f"heads/{tag}/logits"])
        _close(got, rank[f"heads/{tag}/whole/logits"])


@pytest.mark.parametrize("tag", list(HEADS))
def test_heads_split_decode_matches(runs, tag):
    """8 decode steps, each from the reference's cache of that step: the
    logits within rtol 1e-5 / atol 1e-4 of the reference's and the
    unsharded port's (the step's own key, written to the bfloat16 cache
    and read back, can round to the neighbouring bf16 number where the
    float32 projections differ in their last bit: 6.5e-5 at logits of
    ~0.7 in this data, in the unsharded port too), the same greedy
    tokens, and the rank's cache after the step against that
    slice of the reference's and the unsharded port's
    (``assert_cache_close``; a whole cache where the kv heads do not
    split).  The split itself: smollm's and qwen3's single kv head stays
    whole, stablelm's, qwen3's 2 and MLA's heads split."""
    ref, ranks = runs
    cfg = _cfgs(*HEADS[tag])[0]
    hd = cfg.resolved_head_dim
    kv_split = not cfg.kv_lora_rank and cfg.n_kv_heads % 2 == 0
    for r, rank in enumerate(ranks[2]):
        for i in range(STEPS):
            pre = f"heads/{tag}/split/step{i}/"
            got = rank[pre + "logits"]
            want = ref[f"heads/{tag}/step{i}/logits"]
            for other in (want, rank[f"heads/{tag}/whole/step{i}/logits"]):
                np.testing.assert_allclose(got, other, rtol=1e-5, atol=1e-4)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            names = [n[len(pre + "cache/"):] for n in rank.files
                     if n.startswith(pre + "cache/")]
            cache = {n: rank[pre + "cache/" + n] for n in names}
            for src in (f"heads/{tag}/step{i + 1}/cache/",
                        f"heads/{tag}/whole/step{i}/cache/"):
                table = ref if src.startswith(f"heads/{tag}/step") else rank
                whole = {n: table[src + n] for n in names}
                if kv_split:
                    n_kv = cfg.n_kv_heads // 2
                    lo, hi = r * n_kv * hd, (r + 1) * n_kv * hd
                    whole = {n: a[..., lo:hi] if n in ("k", "v") else a
                             for n, a in whole.items()}
                for n in names:
                    np.testing.assert_allclose(cache[n], whole[n],
                                               rtol=2 ** -7, atol=1e-4,
                                               err_msg=f"{src}{n}")


# ------------------------------------------------------------ sequence

def test_seq_parallel_matches_reference(runs):
    """The reference's ``test_seq_parallel_matches_baseline`` setup
    (smollm smoke, mesh (2, 4): here M = 4 over the whole batch), in
    float32: every rank's logits within rtol 1e-5 / atol 1e-6 of the
    reference's sequence-parallel and baseline logits and of the
    unsharded port."""
    ref, ranks = runs
    for rank in ranks[4]:
        for want in (ref["sp/logits"], ref["sp/base"], rank["sp/whole"]):
            _close(rank["sp/split"], want)


def test_seq_parallel_slices_the_residual():
    """``shard_batch`` keeps the rank's slice only where the switch is on
    and M divides the sequence (a no-op otherwise, as the reference's);
    ``gather_seq`` is the identity on a whole sequence."""
    class Axis:
        world, rank, local = 4, 2, 1
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    with zoo.settings(Axis(), seq_parallel=True):
        assert torch.equal(layers.shard_batch(x), x[:, 4:6])
        assert layers.shard_batch(x[:, :6]).shape[1] == 6
        assert layers.gather_seq(x, 8) is x
    with zoo.settings(Axis()):
        assert layers.shard_batch(x) is x
    assert layers.shard_batch(x) is x


# ------------------------------------------------------------- chunked

def _qkv(lq, lk=None, hq=4, hkv=2, dh=32, seed=0):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return [rng.normal(size=s).astype(np.float32) for s in
            ((2, lq, hq, dh), (2, lk, hkv, dh), (2, lk, hkv, dh))]


@pytest.mark.parametrize("block", [128, 256, 512])
def test_chunked_attention_matches_reference(block):
    """``chunked_attention`` at ``lq`` 1024 against the reference's at
    the same block, rtol 1e-5 / atol 1e-6, causal and not."""
    arrs = _qkv(1024)
    for causal in (True, False):
        want = JL.chunked_attention(*map(jnp.asarray, arrs), causal=causal,
                                    block=block)
        got = layers.chunked_attention(*map(torch.from_numpy, arrs),
                                       causal=causal, block=block)
        _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lq,lk", [(600, 600), (768, 768), (640, 1024)])
def test_chunked_attention_irregular_and_predicate(monkeypatch, lq, lk):
    """Irregular lengths (one block where 512 does not divide ``lq``; a
    causal offset ``lk - lq``) and ``gqa_attention``'s predicate: with
    ``ATTN_IMPL = "chunked"`` on both sides, the reference's
    ``gqa_attention`` within rtol 1e-5 / atol 1e-6."""
    arrs = _qkv(lq, lk, seed=1)
    monkeypatch.setattr(JL, "ATTN_IMPL", "chunked")
    want = JL.gqa_attention(*map(jnp.asarray, arrs), causal=True)
    calls = []
    real = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with zoo.settings(attn_impl="chunked"):
        got = layers.gqa_attention(*map(torch.from_numpy, arrs), causal=True)
    assert calls == [1]
    _close(got.numpy(), np.asarray(want))
    # 512 queries or fewer take the plain path, as in the reference
    with zoo.settings(attn_impl="chunked"):
        layers.gqa_attention(*map(torch.from_numpy, _qkv(512)), causal=True)
    assert calls == [1]


def test_chunked_attention_gradient_matches_plain():
    """The gradients of q, k and v through ``chunked_attention`` (each
    block recomputed in the backward) within rtol 1e-4 / atol 1e-5 of
    the plain attention's, and finite."""
    grads = []
    for impl in ("chunked", "naive"):
        qkv = [torch.from_numpy(a).requires_grad_() for a in _qkv(1024)]
        with zoo.settings(attn_impl=impl):
            out = layers.gqa_attention(*qkv, causal=True)
        (out * out).sum().backward()
        grads.append([t.grad for t in qkv])
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
