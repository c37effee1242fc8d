"""LM training over a ``(data, model)`` process mesh in the port
(``launch/train.py::train_lm --dist``, ``train/fsdp.py``, the model
axis's collectives under autograd) against the reference's sharded
train program (``repro/launch/dryrun.py``'s: ``jax.jit`` of
``make_train_step`` with the in/out shardings of ``zoo.param_pspecs``
and ``zoo.batch_pspecs``) on ``make_local_mesh(d, m)``.

``COMPUTE_DTYPE`` is float32 on both sides.  Each case's weights are the
port's seeded single-process init (``convert.lm_params_to_numpy``), the
batches ``train_lm``'s seeded ones (bit for bit the reference's).  The
reference runs in ONE module-scoped subprocess with 8 forced host
devices; the port's ranks are gloo processes on the CPU, one launch at
W = 4 (mesh (2, 2)) and one at W = 2 (mesh (1, 2)), started beside the
reference.  Each rank drives ``train_lm`` itself (``group=``), 3 steps
of batch 4 x 16 tokens:

* smollm with its heads split (its one kv head whole) and ``--remat``
  none, full and dots; qwen3 with ``--moe ep_a2a``, heads split,
  ``--seq-parallel`` and ``--remat full`` (the acceptance command's
  flags), and with the gather path (the global batch's dispatch);
  DeepSeek's MLA with EP; smollm with ``--compress``; zamba2 at (1, 2)
  with ``--seq-parallel`` and ``--remat dots``.
* Per step: the loss and grad norm within rtol 1e-5 of the reference's;
  every rank's param, ``m``, ``v`` (and residual) slice against that
  slice of the reference's state, cut as the rank stores it (its model
  cut, then its data cut: ``fsdp.ShardPlan``), each leaf within 1e-5 of
  its largest entry (the widest gap seen is printed by
  ``test_state_slices_match``: ~1e-6; compressed, ``_check_compressed``'s
  bounds, as ``tests/test_torch_train_lm.py``'s); EP's dispatch
  integers of every layer call bit-equal to the reference's, recomputed
  from the inputs its ``moe_forward_ep`` saw (``jax.debug.callback``).

Also here: ``param_pspec``/``batch_pspecs`` against the reference's for
every leaf of the ten LM configs at meshes (2, 2), (4, 2) and (16, 16);
the gradient of ``moe_forward_ep`` against ``jax.grad`` of the
reference's at (1, 2) and (2, 4) (rtol 1e-5 / atol 1e-6); a sharded
``compress_grads`` of one fixed gradient bit-equal to the unsharded one,
in one process and across the W = 4 ranks; and the checkpoint round
trip: a (1, 2) run's step-2 checkpoint resumed in one process and read
by ``repro.train.checkpoint.restore``, and a one-process checkpoint
resumed over the mesh, each matching an uninterrupted run's losses.
"""
import dataclasses
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import run_forced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.config import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import zoo as JZ  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import train_loop as JTL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, smoke_config  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.models import layers, moe, zoo  # noqa: E402
from repro_torch.train import compression, fsdp  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
_TIMEOUT = 400
SMOLLM, QWEN = "smollm-135m", "qwen3-moe-30b-a3b"
DEEPSEEK, ZAMBA = "deepseek-v2-236b", "zamba2-1.2b"
LR, STEPS, B, S, SEED = 1e-3, 3, 4, 16, 0
M_AXIS = 2
#: tag -> (arch, W, train_lm flags); the mesh is (W / 2, 2)
CASES = {
    "smollm_none": (SMOLLM, 4, ["--shard-heads", "--remat", "none"]),
    "smollm_full": (SMOLLM, 4, ["--shard-heads", "--remat", "full"]),
    "smollm_dots": (SMOLLM, 4, ["--shard-heads", "--remat", "dots"]),
    "qwen_ep": (QWEN, 4, ["--moe", "ep_a2a", "--shard-heads",
                          "--seq-parallel", "--remat", "full"]),
    "qwen_gather": (QWEN, 4, ["--shard-heads", "--seq-parallel"]),
    "deepseek_ep": (DEEPSEEK, 4, ["--moe", "ep_a2a", "--shard-heads"]),
    "compress": (SMOLLM, 4, ["--shard-heads", "--compress"]),
    "zamba2_sp": (ZAMBA, 2, ["--shard-heads", "--seq-parallel", "--remat",
                             "dots"]),
}
#: EP's gradient: meshes (dp, m), the layer's x (B, S)
EP_MESHES, EP_X = ((1, 2), (2, 4)), (4, 8)
LM_ARCHS = [n for n, c in REGISTRY.items() if c.family != "gcn"]
PSPEC_MESHES = ((2, 2), (4, 2), (16, 16))


def _flags(tag):
    """``(moe, shard_heads, seq_parallel, remat, compress)`` of a case."""
    flags = CASES[tag][2]

    def value(name, default):
        return flags[flags.index(name) + 1] if name in flags else default
    return (value("--moe", "gather"), "--shard-heads" in flags,
            "--seq-parallel" in flags, value("--remat", "keep"),
            "--compress" in flags)


def _cfg(tag):
    arch = CASES[tag][0]
    remat = _flags(tag)[3]
    cfg = smoke_config(get_config(arch))
    return cfg if remat == "keep" else dataclasses.replace(cfg, remat=remat)


def _argv(arch, flags, steps=STEPS, extra=()):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--steps",
            str(steps), "--lm-batch", str(B), "--lm-seq", str(S), "--lr",
            str(LR), "--seed", str(SEED), "--model-axis", str(M_AXIS),
            "--log-every", "100", "--ckpt-every", "100", *flags, *extra]


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _ep_layer_inputs():
    """The EP gradient's seeded layer (the reference's ``init_moe_mlp``
    shapes, normal x 0.02, the router x 0.3), input and cotangent."""
    cfg = smoke_config(get_config(QWEN))
    rng = np.random.default_rng(11)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": rng.normal(scale=0.3, size=(d, e)),
         "wg": rng.normal(scale=0.02, size=(e, d, f)),
         "wu": rng.normal(scale=0.02, size=(e, d, f)),
         "wd": rng.normal(scale=0.02, size=(e, f, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=EP_X + (d,)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return p, x, cot


def _inputs(path):
    """Every case's initial params (the port's single-process init) and
    the EP gradient's layer, as one ``.npz``."""
    out = {}
    for tag in CASES:
        cfg = _cfg(tag)
        model = zoo.build(cfg, "cpu").init(SEED)
        _flat(convert.lm_params_to_numpy(model), f"{tag}/params", out)
    p, x, cot = _ep_layer_inputs()
    _flat(p, "epgrad/p", out)
    out["epgrad/x"], out["epgrad/cot"] = x, cot
    np.savez(path, **out)


_REFERENCE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, smoke_config
from repro.core.config import TrainConfig
from repro.launch.mesh import make_local_mesh, make_mesh
from repro.models import layers as L, moe as M, zoo
from repro.train.train_loop import init_state, make_train_step
L.COMPUTE_DTYPE = jnp.float32
z = np.load({inputs!r})
CASES = {cases!r}
LR, STEPS, B, S, SEED = {lr!r}, {steps}, {b}, {s}, {seed}
EP_MESHES = {ep_meshes!r}
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

SEEN = []
ORIG_EP = M.moe_forward_ep

def seen(router, x):
    SEEN.append((np.asarray(router), np.asarray(x)))

def ep_spy(p, x, cfg):
    jax.debug.callback(seen, p["router"], x)
    return ORIG_EP(p, x, cfg)
M.moe_forward_ep = ep_spy

def first(router, xf, k, m, e_loc):
    # moe_forward_ep's dispatch (repro/models/moe.py:83-112), one device
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
    key2 = re_ + (1 - rm.astype(jnp.int32)) * e_loc
    order2 = jnp.argsort(key2)
    sk2 = key2[order2]
    first2 = jnp.searchsorted(sk2, sk2, side="left")
    slot2 = jnp.arange(m * cap, dtype=jnp.int32) - first2
    c2 = max(int(m * cap / e_loc * 2.0) + 8, 8)
    ok2 = jnp.logical_and(slot2 < c2, sk2 < e_loc)
    return dict(recv_e=re_, recv_m=rm, order2=order2, slot2=slot2, ok2=ok2)

def ep_ints(router, x, cfg, dp, m, key):
    b, s, d = x.shape
    e_loc, k = cfg.n_experts // m, cfg.top_k
    bl, sl = b // dp, s // m
    sends = {{}}
    for di in range(dp):
        for r in range(m):
            xf = x[di * bl:(di + 1) * bl, r * sl:(r + 1) * sl].reshape(-1, d)
            ints, se, sm = first(router, jnp.asarray(xf), k, m, e_loc)
            sends[di, r] = (se, sm)
            for n, a in ints.items():
                out[f"{{key}}d{{di}}r{{r}}/{{n}}"] = np.asarray(a)
    for di in range(dp):
        for r in range(m):
            re_ = jnp.concatenate([sends[di, j][0][r] for j in range(m)])
            rm = jnp.concatenate([sends[di, j][1][r] for j in range(m)])
            for n, a in second(re_, rm, m, e_loc).items():
                out[f"{{key}}d{{di}}r{{r}}/{{n}}"] = np.asarray(a)

def leaves(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield prefix + "/".join(str(getattr(k, "key", k)) for k in path), leaf

for tag, (arch, w, flags) in CASES.items():
    val = lambda n, dflt: flags[flags.index(n) + 1] if n in flags else dflt
    moe_impl, remat = val("--moe", "gather"), val("--remat", "keep")
    cfg = smoke_config(get_config(arch))
    if remat != "keep":
        cfg = dataclasses.replace(cfg, remat=remat)
    compress = "--compress" in flags
    dp, m = w // 2, 2
    M.set_moe_impl(moe_impl)
    L.set_shard_heads("--shard-heads" in flags)
    L.set_seq_parallel("--seq-parallel" in flags)
    mesh = make_local_mesh(dp, m)
    L.set_mesh(mesh)
    api = zoo.build(cfg)
    params = nest(f"{{tag}}/params")
    tcfg = TrainConfig(learning_rate=LR, total_steps=STEPS,
                       compress_grads=compress)
    state = init_state(params, tcfg)
    pspecs = zoo.param_pspecs(cfg, params, mesh)
    state_specs = type(state)(params=pspecs, opt=type(state.opt)(
        step=P(), m=pspecs, v=pspecs), error=pspecs if compress else None)
    bshape = {{k: jax.ShapeDtypeStruct((B, S), jnp.int32)
              for k in ("tokens", "labels")}}
    bspecs = zoo.batch_pspecs(cfg, bshape, mesh)
    step = jax.jit(make_train_step(api.loss, tcfg, mesh),
                   in_shardings=(zoo.to_shardings(mesh, state_specs),
                                 zoo.to_shardings(mesh, bspecs)),
                   out_shardings=(zoo.to_shardings(mesh, state_specs), None))
    rng = np.random.default_rng(SEED)
    for t in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        batch = {{"tokens": toks, "labels": np.roll(toks, -1, axis=1)}}
        SEEN.clear()
        state, metrics = step(state, batch)
        jax.block_until_ready(state)
        key = f"{{tag}}/step{{t}}/"
        out[key + "loss"] = np.asarray(metrics["loss"])
        out[key + "grad_norm"] = np.asarray(metrics["grad_norm"])
        for part, tree in (("params", state.params), ("m", state.opt.m),
                           ("v", state.opt.v), ("error", state.error)):
            if tree is not None:
                for name, leaf in leaves(tree, key + part + "/"):
                    out[name] = np.asarray(leaf)
        if moe_impl == "ep_a2a":
            # the forward's calls first; remat full calls each again in
            # the backward
            n_moe = cfg.n_layers - cfg.first_dense_layers
            assert len(SEEN) == n_moe * (2 if remat == "full" else 1), (
                tag, len(SEEN))
            for i, (router, x) in enumerate(SEEN[:n_moe]):
                ep_ints(router, x, cfg, dp, m, f"{{key}}ep{{i}}/")
    L.set_mesh(None)
    M.set_moe_impl("gather")
    L.set_shard_heads(False)
    L.set_seq_parallel(False)

cfg = smoke_config(get_config("qwen3-moe-30b-a3b"))
p, x, cot = nest("epgrad/p"), jnp.asarray(z["epgrad/x"]), jnp.asarray(z["epgrad/cot"])
M.set_moe_impl("ep_a2a")
for dp, m in EP_MESHES:
    L.set_mesh(make_mesh((dp, m), ("data", "model")))
    loss = lambda p, x: jnp.sum(M.moe_forward(p, x, cfg) * cot)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    for n, a in gp.items():
        out[f"epgrad/{{dp}}x{{m}}/{{n}}"] = np.asarray(a)
    out[f"epgrad/{{dp}}x{{m}}/x"] = np.asarray(gx)
    L.set_mesh(None)
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

def _np(t):
    return t.detach().cpu().numpy().copy()


def _train_case(group, tag, res):
    """``train_lm`` of a case on this rank: per step the state's slices,
    the metrics, EP's plans; the rank's cuts of every leaf."""
    arch, w, flags = CASES[tag]
    args = train.parse_args(_argv(arch, flags) + [
        "--dist", "gloo", "--workers", str(w)])
    snaps = []

    def hook(t, state):
        parts = {"params": state.params, "m": state.opt.m,
                 "v": state.opt.v, "error": state.error or []}
        snaps.append({k: [_np(x) for x in v] for k, v in parts.items()})
    with moe.tally(plans=True) as tally:
        out = train.train_lm(args, group=group, state_hook=hook)
    plan = out["plan"]
    for t, snap in enumerate(snaps):
        for part, arrays in snap.items():
            for lf, a in zip(plan.leaves, arrays):
                res[f"{tag}/step{t}/{part}/{'/'.join(lf.path)}"] = a
    for lf in plan.leaves:
        cut = [-1 if d is None else d for d in (lf.model_cut, lf.data_dim)]
        res[f"{tag}/cut/{'/'.join(lf.path)}"] = np.asarray(cut)
    res[f"{tag}/losses"] = np.asarray(out["losses"])
    res[f"{tag}/grad_norms"] = np.asarray(out["grad_norms"])
    res[f"{tag}/coords"] = np.asarray(plan.mesh.coords)
    for i, pl in enumerate(tally.get("plans", [])):
        for n, a in pl.items():
            res[f"{tag}/plan{i}/{n}"] = np.asarray(a)
    return plan


def _ep_grad(group, z, dp, res):
    """``moe_forward_ep``'s gradient over the whole group as the model
    axis (each of ``dp`` batch halves in turn): the rank's experts', the
    router's (this rank's share, summed over the ranks by the test) and
    its slice of x's."""
    cfg = smoke_config(get_config(QWEN))
    m, r = group.world, group.rank
    cot = torch.from_numpy(z["epgrad/cot"])
    with zoo.settings(group, moe_impl="ep_a2a"):
        mod = moe.MoEMLP(cfg)
        with torch.no_grad():
            for n in ("router", "wg", "wu", "wd"):
                w = getattr(mod, n)
                w.copy_(torch.from_numpy(layers.take(w, z[f"epgrad/p/{n}"])))
        x = torch.from_numpy(z["epgrad/x"]).requires_grad_()
        total = 0
        for xh, ch in zip(x.chunk(dp, 0), cot.chunk(dp, 0)):
            sl = xh.shape[1] // m
            xs = xh[:, r * sl:(r + 1) * sl]
            total = total + torch.sum(
                moe.moe_forward(mod, xs, cfg, xh.shape[1])
                * ch[:, r * sl:(r + 1) * sl])
        total.backward()
    key = f"epgrad/{dp}x{m}/"
    for n in ("router", "wg", "wu", "wd"):
        res[key + n] = _np(getattr(mod, n).grad)
    res[key + "x"] = _np(x.grad)


def _compress_case(plan, res):
    """A fixed seeded gradient, whole and as this rank's slices:
    ``compress_grads`` of the slices with the mesh's max (``plan.amax``)
    against the rank's slices of the whole leaves' compression."""
    rng = np.random.default_rng(3)
    whole = [torch.from_numpy(rng.normal(size=lf.full).astype(np.float32))
             for lf in plan.leaves]
    zeros = compression.init_error(whole)
    mine = [plan.take(lf, g).contiguous() for lf, g in zip(plan.leaves,
                                                           whole)]
    packed, err = compression.compress_grads(
        mine, compression.init_error(mine), plan.amax)
    wpacked, werr = compression.compress_grads(whole, zeros)
    same = all(
        torch.equal(q, plan.take(lf, wq)) and torch.equal(s, ws)
        and torch.equal(e, plan.take(lf, we))
        for lf, (q, s), (wq, ws), e, we in zip(plan.leaves, packed, wpacked,
                                               err, werr))
    res["compress_sharded_equal"] = np.asarray(same)


def _ranks(group, inputs, out, ckpt):
    """A rank's share (``launch.mesh``'s target): the cases of its W,
    EP's gradient, and (W = 4) the sharded compression or (W = 2) the
    checkpoint round trip; results to ``out/rank<r>.npz``."""
    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    z = np.load(inputs)
    res = {}
    plans = {tag: _train_case(group, tag, res)
             for tag, (_, w, _) in CASES.items() if w == group.world}
    if group.world == 4:
        _ep_grad(group, z, 2, res)
        _compress_case(plans["compress"], res)
    else:
        _ep_grad(group, z, 1, res)
        base = _argv(SMOLLM, ["--shard-heads"]) + [
            "--dist", "gloo", "--workers", "2"]
        # mesh -> one process: the (1, 2) run's step-2 checkpoint
        train.train_lm(train.parse_args(base + [
            "--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
            os.path.join(ckpt, "mesh")]), group=group)
        # one process -> mesh: resume the one-process step-2 checkpoint
        got = train.train_lm(train.parse_args(base + [
            "--steps", "4", "--resume", "--ckpt-dir",
            os.path.join(ckpt, "one")]), group=group)
        res["resumed_losses"] = np.asarray(got["losses"])
    np.savez(os.path.join(out, f"rank{group.rank}.npz"), **res)


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, {W: [rank arrays]}, ckpt dir)``: the reference's
    subprocess and the W = 4 and W = 2 launches side by side (the
    one-process checkpoint the W = 2 ranks resume written first)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs, ref = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    ckpt = tmp / "ckpt"
    layers_dtype = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        _inputs(inputs)
        train.train_lm(train.parse_args(_argv(SMOLLM, ["--shard-heads"]) + [
            "--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
            str(ckpt / "one"), "--model-axis", "1"]))
    finally:
        layers.COMPUTE_DTYPE = layers_dtype
    codes, outs = {}, {}

    def reference():
        outs["ref"] = run_forced(_REFERENCE.format(
            inputs=inputs, cases=CASES, lr=LR, steps=STEPS, b=B, s=S,
            seed=SEED, ep_meshes=EP_MESHES, path=ref), devices=8)

    def launch(w):
        (tmp / f"w{w}").mkdir()
        codes[w] = mesh.run("test_torch_train_mesh:_ranks", w, device="cpu",
                            kwargs=dict(inputs=inputs, out=str(tmp / f"w{w}"),
                                        ckpt=str(ckpt)),
                            timeout_s=_TIMEOUT, env=_env())
    threads = [threading.Thread(target=reference)] + [
        threading.Thread(target=launch, args=(w,)) for w in (4, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert "SAVED" in outs.get("ref", ""), "the reference's run failed"
    assert codes == {4: 0, 2: 0}, codes
    return (np.load(ref), {w: [np.load(tmp / f"w{w}" / f"rank{r}.npz")
                               for r in range(w)] for w in (4, 2)}, ckpt)


@pytest.fixture
def f32(monkeypatch):
    """float32 compute in this process (the one-process runs)."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


# -------------------------------------------------------------- per step

@pytest.mark.parametrize("tag", list(CASES))
def test_loss_and_grad_norm_match(runs, tag):
    """Every rank's loss and grad norm of each of the 3 steps within rtol
    1e-5 of the reference's sharded step (the same on every rank)."""
    ref, ranks, _ = runs
    for rank in ranks[CASES[tag][1]]:
        for t in range(STEPS):
            for name, key in (("losses", "loss"),
                              ("grad_norms", "grad_norm")):
                np.testing.assert_allclose(
                    rank[f"{tag}/{name}"][t],
                    float(ref[f"{tag}/step{t}/{key}"]), rtol=1e-5,
                    err_msg=f"{tag} step {t} {key}")


def _cut(a, dim, n, i):
    if dim < 0:
        return a
    k = a.shape[dim] // n
    return np.take(a, np.arange(i * k, (i + 1) * k), axis=dim)


def _slices(ref, rank, tag, t, part):
    """``{leaf: (the rank's slice, that slice of the reference's)}``."""
    w = CASES[tag][1]
    d = w // M_AXIS
    dr, mr = (int(c) for c in rank[f"{tag}/coords"])
    pre = f"{tag}/step{t}/{part}/"
    out = {}
    for key in rank.files:
        if key.startswith(pre):
            leaf = key[len(pre):]
            mdim, ddim = (int(c) for c in rank[f"{tag}/cut/{leaf}"])
            want = _cut(_cut(ref[key], mdim, M_AXIS, mr), ddim, d, dr)
            out[leaf] = (rank[key], want)
    return out


def _check_compressed(ref, rank, tag, t, lrs):
    """The compressed case's bounds (``tests/test_torch_train_lm.py``'s
    ``_check_state``): each residual element within 1.25 quantization
    steps of the reference's, at most 1% of them over 1e-2 of a step
    apart (an int8 code one step apart, where the two float32 gradients
    straddle a rounding boundary); elsewhere params and moments within
    1e-5 of each leaf's largest entry, the params within the summed
    learning rates everywhere."""
    err = _slices(ref, rank, tag, t, "error")
    parts = {p: _slices(ref, rank, tag, t, p) for p in ("params", "m", "v")}
    flipped = n = 0
    for leaf, (e, we) in err.items():
        unit = 2 * max(float(np.abs(we).max()), float(np.abs(e).max()))
        gap = np.abs(e - we)
        assert float(gap.max()) <= 1.25 * unit, leaf
        moved = gap > 1e-2 * unit
        flipped += int(moved.sum())
        n += moved.size
        for part, bound in (("params", sum(lrs) * 1.01), ("m", None),
                            ("v", None)):
            g, w = parts[part][leaf]
            dist = np.abs(g - w)
            scale = float(np.abs(w).max())
            assert float(dist[~moved].max(initial=0.0)) <= 1e-5 * scale, \
                (part, leaf)
            if bound is not None:
                assert float(dist.max()) <= bound, (part, leaf)
    assert flipped <= 1e-2 * n, (flipped, n)


@pytest.mark.parametrize("tag", list(CASES))
def test_state_slices_match(runs, tag):
    """Every rank's slice of every leaf's params, ``m`` and ``v`` after
    each step within 1e-5 of that leaf's largest entry of the
    reference's, sliced as the rank stores it (compressed: the bounds of
    ``_check_compressed``)."""
    ref, ranks, _ = runs
    worst = 0.0
    lrs = [LR * min(t + 1, 100) / 100 for t in range(STEPS)]
    for rank in ranks[CASES[tag][1]]:
        for t in range(STEPS):
            if _flags(tag)[4]:
                _check_compressed(ref, rank, tag, t, lrs[:t + 1])
                continue
            for part in ("params", "m", "v"):
                pairs = _slices(ref, rank, tag, t, part)
                assert pairs, (tag, part)
                for leaf, (got, want) in pairs.items():
                    assert got.shape == want.shape, (tag, part, leaf)
                    scale = max(float(np.abs(want).max()), 1e-30)
                    err = float(np.abs(got - want).max()) / scale
                    worst = max(worst, err)
                    assert err <= 1e-5, (tag, t, part, leaf, err)
    if not _flags(tag)[4]:
        print(f"{tag}: widest state gap {worst:.3e} of a leaf's largest "
              f"entry")


@pytest.mark.parametrize("tag", [t for t in CASES if _flags(t)[0] == "ep_a2a"])
def test_ep_dispatch_integers_match(runs, tag):
    """Every rank's EP dispatch integers of every layer call of every
    step (top-k experts, both sorts, slots, kept masks, the received
    expert ids and marks) equal to the reference's, recomputed from the
    inputs its ``moe_forward_ep`` saw on the same mesh."""
    ref, ranks, _ = runs
    cfg = _cfg(tag)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    for rank in ranks[CASES[tag][1]]:
        dr, mr = (int(c) for c in rank[f"{tag}/coords"])
        for t in range(STEPS):
            for i in range(n_moe):
                plan = f"{tag}/plan{t * n_moe + i}/"
                want = f"{tag}/step{t}/ep{i}/d{dr}r{mr}/"
                for n in ("topi", "order", "dest", "slot", "ok", "recv_e",
                          "recv_m", "order2", "slot2", "ok2"):
                    np.testing.assert_array_equal(
                        rank[plan + n].astype(np.int64),
                        ref[want + n].astype(np.int64),
                        err_msg=f"step {t} layer {i} {n}")


# ------------------------------------------------------ the other pieces

@pytest.mark.parametrize("mesh_shape", EP_MESHES)
def test_ep_gradient_matches_jax_grad(runs, mesh_shape):
    """``moe_forward_ep``'s gradient (the all_to_all's backward, the
    router through ``topv``, the split experts) against ``jax.grad`` of
    the reference's on the same mesh: each rank's experts and its slice
    of x, and the router summed over the ranks, within rtol 1e-5 / atol
    1e-6."""
    ref, ranks, _ = runs
    dp, m = mesh_shape
    key = f"epgrad/{dp}x{m}/"
    group = ranks[m]
    e_loc = ref[key + "wg"].shape[0] // m
    router = sum(rank[key + "router"] for rank in group)
    np.testing.assert_allclose(router, ref[key + "router"], rtol=1e-5,
                               atol=1e-6)
    sl = EP_X[1] // m
    for r, rank in enumerate(group):
        for n in ("wg", "wu", "wd"):
            np.testing.assert_allclose(
                rank[key + n], ref[key + n][r * e_loc:(r + 1) * e_loc],
                rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank[key + "x"][:, r * sl:(r + 1) * sl],
                                   ref[key + "x"][:, r * sl:(r + 1) * sl],
                                   rtol=1e-5, atol=1e-6)


def test_sharded_compression_is_bit_equal(runs):
    """``compress_grads`` of every rank's slices of one fixed gradient,
    the scale the mesh's max of each leaf (``ShardPlan.amax``): the
    codes, scales and residuals bit-equal to the rank's slices of the
    whole leaves' compression, on all four ranks."""
    for rank in runs[1][4]:
        assert bool(rank["compress_sharded_equal"])


def test_sharded_compression_one_process():
    """The same in one process: each leaf cut in 4 along each axis, the
    scale the max over the cuts: every cut's code and residual bit-equal
    to that cut of the whole leaf's."""
    rng = np.random.default_rng(1)
    whole = [torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32)
                              * s) for s in (1.0, 1e-3, 40.0)]
    packed, err = compression.compress_grads(whole,
                                             compression.init_error(whole))
    for dim in (0, 1):
        for i in range(4):
            cuts = [g.chunk(4, dim)[i].contiguous() for g in whole]
            maxima = torch.stack([g.abs().amax() for g in whole])
            got, gerr = compression.compress_grads(
                cuts, compression.init_error(cuts), lambda _: maxima)
            for (q, s), e, (wq, ws), we in zip(got, gerr, packed, err):
                assert torch.equal(q, wq.chunk(4, dim)[i])
                assert torch.equal(s, ws)
                assert torch.equal(e, we.chunk(4, dim)[i])


def _resume(ckpt_dir, steps=4):
    return train.train_lm(train.parse_args(_argv(SMOLLM, ["--shard-heads"])
                                           + ["--steps", str(steps),
                                              "--resume", "--ckpt-dir",
                                              str(ckpt_dir),
                                              "--model-axis", "1"]))


def test_checkpoint_round_trip(runs, f32):
    """A (1, 2) run's step-2 checkpoint (rank 0 writes whole leaves),
    resumed in one process: steps 3-4's losses within rtol 1e-5 of the
    one-process run resumed from its own step-2 checkpoint (``train_lm``
    draws its batches from the seed again on a resume, as the
    reference's does); read by ``repro.train.checkpoint.restore`` into
    the reference's ``TrainState``, every leaf within 1e-5 of its
    largest entry of the one-process checkpoint's.  And the reverse: the
    one-process checkpoint resumed over the (1, 2) mesh, its losses
    within rtol 1e-5 of the same."""
    _, ranks, ckpt = runs
    want = _resume(ckpt / "one")["losses"]
    np.testing.assert_allclose(_resume(ckpt / "mesh")["losses"], want,
                               rtol=1e-5)
    for rank in ranks[2]:
        np.testing.assert_allclose(rank["resumed_losses"], want, rtol=1e-5)
    jparams = jax.eval_shape(JZ.build(_jsmoke(SMOLLM)).init,
                             jax.random.PRNGKey(0))
    like = JTL.init_state(jax.tree.map(lambda s: np.zeros(s.shape,
                                                          np.float32),
                                       jparams), JTrainConfig())
    mesh_state = jckpt.restore(str(ckpt / "mesh"), 2, like)
    one_state = jckpt.restore(str(ckpt / "one"), 2, like)
    for a, b in zip(jax.tree.leaves(mesh_state), jax.tree.leaves(one_state)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= 1e-5 * scale


def _jsmoke(name):
    """The reference's smoke config of ``name``."""
    return jsmoke_config(jget_config(name))


# ------------------------------------------------------------- the rules

def _fake_mesh(d, m):
    return types.SimpleNamespace(shape={"data": d, "model": m},
                                 axis_names=("data", "model"))


def _meta_model(cfg):
    from repro_torch.models import (deepseek, hybrid, ssm, transformer,
                                    vlm, whisper)
    cls = {"dense": transformer.DenseLM, "moe_qwen": moe.Qwen3MoeLM,
           "moe_deepseek": deepseek.DeepSeekLM, "ssm": ssm.Mamba2LM,
           "hybrid": hybrid.Zamba2LM, "vlm": vlm.VisionLM,
           "audio": whisper.WhisperLM}[zoo._family_key(cfg)]
    return cls(cfg, "meta")


@pytest.mark.parametrize("mesh_shape", PSPEC_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_batch_pspecs_match(arch, mesh_shape):
    """``zoo.param_pspecs`` over the port's own leaves (a ``meta`` model:
    the reference's paths and stacked shapes, ``convert.lm_leaves``) and
    ``batch_pspecs`` equal to the reference's rules for every leaf of the
    full config, and ``ShardPlan`` reads the same spec from the
    layout."""
    d, m = mesh_shape
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm = _fake_mesh(d, m)
    jshapes = jax.eval_shape(JZ.build(jcfg).init, jax.random.PRNGKey(0))
    want = {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                JZ.param_pspecs(jcfg, jshapes, jm),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}
    _, layout = convert.lm_leaves(_meta_model(cfg))
    shapes = {path: ((n,) if st else ()) + shape for path, n, st, shape in
              zip(layout.paths, layout.counts, layout.stacked,
                  layout.shapes)}
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jshapes)[0]}
    assert shapes == jflat
    got = zoo.param_pspecs(cfg, shapes, {"data": d, "model": m})
    assert got == want

    class Axis:
        def __init__(self, world):
            self.world, self.rank = world, 0
    plan = fsdp.ShardPlan(layout, types.SimpleNamespace(
        shape={"data": d, "model": m}, data=Axis(d), model=Axis(m)))
    assert {lf.path: lf.spec for lf in plan.leaves} == want
    jb = JZ.input_specs(jcfg, JShapeConfig("t", "train", 64, 2 * d))
    bwant = {k: tuple(v) for k, v in JZ.batch_pspecs(jcfg, jb, jm).items()}
    assert zoo.batch_pspecs(cfg, {k: v.shape for k, v in jb.items()},
                            {"data": d, "model": m}) == bwant
    one = {k: tuple(v) for k, v in JZ.batch_pspecs(jcfg, {
        "tokens": jax.ShapeDtypeStruct((1, 8), jnp.int32)}, jm).items()}
    assert zoo.batch_pspecs(cfg, {"tokens": (1, 8)}, jm) == one
