"""The port's dry-run (``repro_torch/launch/dryrun.py``, ``sweep.py``,
``roofline.py``) and what it stands on against the reference's.

Everything the reference needs forced host devices for runs in ONE
module-scoped subprocess (512 devices: the production meshes, the GCN
step's HLO at W = 4, the smoke LM steps' HLO on one device), started
beside a gloo launch of ``train_lm --dist`` at mesh (2, 2) (four CPU
ranks); the tests that need neither run first, while both work.

Exact: ``SHAPES``, ``param_count``/``active_param_count`` of every
config, ``input_specs``/``prefill_specs`` and the cache's shapes,
dtypes and ``cache_pspecs`` at the production mesh for every LM arch
and shape, the production meshes' shapes and axes, ``sweep.cells()``,
the ``long_500k`` skip policy, the GCN pipelined step's ``all-to-all``,
``collective-permute`` and ``all-gather`` bytes per device at W = 4
against ``collective_bytes`` of the reference's compiled step under
both merges (both sides issue them explicitly at the same static
capacities), ``FakeWorkers``' counts of a ``train_lm --dist`` step at
(2, 2) against the ``ProcessWorkers.stats`` of the real gloo run, and
``roofline.analyse``/``markdown_table`` against the reference's on the
same records under the port's constants (patched into the reference's
module by this test only).

FLOPs: a train step and a prefill of the smollm and qwen3-moe smoke
configs (``--attn naive``) equal ``trip_weighted_cost`` of the
reference's compiled program to the FLOP (2% would be allowed); with flash
on, the kernel counts the causal pairs only, which the test states in
closed form against the naive count.

Three production cells trace to ``status == "ok"`` at 16x16.
"""
import dataclasses
import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _torch_parity import run_forced  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import sweep as jsweep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.config import (LINK_BW, SHAPES, MeshConfig,  # noqa: E402
                                     ShapeConfig)
from repro_torch.kernels.flash_attention import causal_pairs  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline, sweep, train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
FLOP_ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b")
FLOP_B, FLOP_S = 2, 64
#: the GCN step at W = 4: a small graph, the paper config's fanouts and
#: cache mode at small widths
GCN_W, GCN_B, GCN_NODES, GCN_EDGES = 4, 8, 2000, 16000
GCN_DIMS = {"gcn_in_dim": 16, "gcn_hidden": 32, "n_classes": 5}
GCN_CACHE_ROWS = 256
MERGES = ("butterfly", "reduce_scatter")
#: the real-vs-fake collective count: qwen3's smoke config at (2, 2)
MESH_ARCH, MESH_B, MESH_S = "qwen3-moe-30b-a3b", 4, 16
MESH_FLAGS = {"moe_impl": "ep_a2a", "shard_heads": True, "seq_parallel": True}

_REFERENCE = """
import dataclasses, json
import jax, jax.numpy as jnp
from repro.configs import REGISTRY, get_config, smoke_config
from repro.core.config import SHAPES, ShapeConfig, TrainConfig
from repro.core.feature_cache import CacheConfig, cache_state_specs
from repro.core.generation import make_generator_fn
from repro.core.pipeline import make_pipelined_step
from repro.graph.subgraph import batch_specs
from repro.launch.hlo_analysis import collective_bytes, trip_weighted_cost
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.models import gcn as gcn_mod
from repro.models import zoo
from repro.train.optimizer import adam_update, init_adam
from repro.train.train_loop import init_state, make_train_step

out = {{}}

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out[f"mesh/{{int(mp)}}"] = [list(m.axis_names),
                                [m.shape[a] for a in m.axis_names]]
prod = make_production_mesh()
for name, cfg in REGISTRY.items():
    if cfg.family == "gcn":
        continue
    api = zoo.build(cfg)
    for sname, shape in SHAPES.items():
        for kind, fn in (("in", zoo.input_specs), ("pre", zoo.prefill_specs)):
            out[f"{{kind}}/{{name}}/{{sname}}"] = {{
                k: [list(v.shape), str(v.dtype)]
                for k, v in fn(cfg, shape).items()}}
        if shape.kind != "decode":
            continue
        cache = jax.eval_shape(
            lambda: api.init_cache(shape.global_batch, shape.seq_len))
        specs = zoo.cache_pspecs(cfg, cache, prod)
        flat = jax.tree_util.tree_flatten_with_path(cache)[0]
        sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        out[f"cache/{{name}}/{{sname}}"] = {{
            "/".join(str(getattr(k, "key", k)) for k in path):
            [list(leaf.shape), str(leaf.dtype), spec(p)]
            for (path, leaf), p in zip(flat, sflat)}}

for arch in {flop_archs}:
    cfg = smoke_config(get_config(arch))
    api = zoo.build(cfg)
    ps = jax.eval_shape(api.init, jax.random.key(0))
    tcfg = TrainConfig()
    st = jax.eval_shape(lambda p: init_state(p, tcfg), ps)
    shp = ShapeConfig("t", "train", {s}, {b})
    c = jax.jit(make_train_step(api.loss, tcfg)).lower(
        st, zoo.input_specs(cfg, shp)).compile()
    out[f"flops/train/{{arch}}"] = trip_weighted_cost(c.as_text())["flops"]
    shp = ShapeConfig("p", "prefill", {s}, {b})
    c = jax.jit(lambda p, b: zoo.forward_logits(cfg, p, b)).lower(
        ps, zoo.prefill_specs(cfg, shp)).compile()
    out[f"flops/prefill/{{arch}}"] = trip_weighted_cost(c.as_text())["flops"]

w, b, n_nodes, n_edges = {w}, {gb}, {nodes}, {edges}
mesh = make_mesh((w, 1), ("data", "model"))
cfg = dataclasses.replace(get_config("graphgen-gcn"), cache_rows={rows},
                          **{dims})
cache_cfg = CacheConfig.from_model(cfg)
d = cfg.gcn_in_dim
rows, e_pad = -(-n_nodes // w), -(-n_edges // w)
s = jax.ShapeDtypeStruct
i32, f32 = jnp.int32, jnp.float32
tcfg = TrainConfig()

def train_fn(params, opt, batch):
    loss, grads = jax.value_and_grad(gcn_mod.gcn_loss)(params, batch)
    params, opt, _ = adam_update(tcfg, params, grads, opt)
    return params, opt, loss

params = jax.eval_shape(lambda: gcn_mod.init_gcn(cfg, jax.random.PRNGKey(0)))
opt = jax.eval_shape(lambda: init_adam(params))
batch0 = batch_specs(w * b, cfg.fanouts, d, n_workers=w)
cache0 = cache_state_specs(cache_cfg, d, n_workers=w)
args = ((s((w, n_nodes + 1), i32), s((w, e_pad), i32),
         s((w * rows, d), f32), s((w * rows, 1), f32)),
        s((w, b), i32), jax.eval_shape(lambda: jax.random.PRNGKey(0)))
for merge in {merges}:
    gen_fn = make_generator_fn(mesh, fanouts=cfg.fanouts, axis_name="data",
                               merge_mode=merge, capacity_slack=2.0,
                               cache_cfg=cache_cfg)
    step = make_pipelined_step(gen_fn, train_fn, cached=True)
    c = jax.jit(step).lower((params, opt, batch0, cache0), *args).compile()
    out[f"gcn/{{merge}}"] = collective_bytes(c.as_text())
with open({path!r}, "w") as f:
    json.dump(out, f)
print("SAVED")
"""


def _mesh_rank(group, out):
    """A rank of the real run: one ``train_lm --dist`` step of the smoke
    qwen3 at (2, 2) with EP, split heads and sequence parallelism; each
    mesh axis's ``ProcessWorkers.stats`` (calls and bytes) to
    ``out/rank<r>.json``."""
    torch.set_num_threads(1)
    args = train.parse_args([
        "--arch", MESH_ARCH, "--smoke", "--device", "cpu", "--steps", "1",
        "--lm-batch", str(MESH_B), "--lm-seq", str(MESH_S), "--dist",
        "gloo", "--workers", "4", "--model-axis", "2", "--moe", "ep_a2a",
        "--shard-heads", "--seq-parallel"])
    res = train.train_lm(args, group=group)
    stats = {axis: {k: [v["calls"], v["bytes"]] for k, v in g.stats.items()}
             for axis, g in res["plan"].mesh.groups().items()}
    with open(os.path.join(out, f"rank{group.rank}.json"), "w") as f:
        json.dump(stats, f)


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The reference's subprocess and the gloo launch, started at once;
    ``get()`` waits for both and returns ``(reference dict, rank 0's
    stats)``."""
    tmp = tmp_path_factory.mktemp("dryrun")
    path = str(tmp / "ref.json")
    outs, codes = {}, {}

    def reference():
        outs["ref"] = run_forced(_REFERENCE.format(
            flop_archs=FLOP_ARCHS, s=FLOP_S, b=FLOP_B, w=GCN_W, gb=GCN_B,
            nodes=GCN_NODES, edges=GCN_EDGES, rows=GCN_CACHE_ROWS,
            dims=GCN_DIMS, merges=MERGES, path=path), devices=512)

    def launch():
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_TESTS, env.get("PYTHONPATH", "")) if p)
        env["OMP_NUM_THREADS"] = "1"
        codes["mesh"] = mesh.run("test_torch_dryrun:_mesh_rank", 4,
                                 device="cpu", kwargs={"out": str(tmp)},
                                 timeout_s=300, env=env)
    threads = [threading.Thread(target=reference),
               threading.Thread(target=launch)]
    for t in threads:
        t.start()

    def get():
        for t in threads:
            t.join()
        assert "SAVED" in outs.get("ref", ""), "the reference's run failed"
        assert codes == {"mesh": 0}, codes
        with open(path) as f, open(tmp / "rank0.json") as g:
            return json.load(f), json.load(g)
    return get


_CELLS = {}


def _cell(arch, shape, **kw):
    """``dryrun.lower_cell`` at the production mesh, each cell traced once
    per module."""
    key = (arch, shape, tuple(sorted(kw.items())))
    if key not in _CELLS:
        _CELLS[key] = dryrun.lower_cell(arch, shape, **kw)
    return _CELLS[key]


@pytest.fixture(scope="module")
def ref(background):
    """The reference's results (``background``'s first half)."""
    return background()[0]


# ------------------------------------------- the tests that need neither --

def test_shapes_mesh_config_and_param_counts(background):
    """``SHAPES``, ``MeshConfig`` and every config's parameter counts
    equal the reference's (``background`` starts the reference and the
    gloo launch now, so they run beside the tests before theirs)."""
    assert set(SHAPES) == set(jcfg.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            jcfg.SHAPES[name])
    for mp in (False, True):
        mine, theirs = MeshConfig(mp), jcfg.MeshConfig(mp)
        assert (mine.shape, mine.axes, mine.n_devices) == (
            theirs.shape, theirs.axes, theirs.n_devices)
    assert set(configs.REGISTRY) == set(jconfigs.REGISTRY)
    for name, cfg in configs.REGISTRY.items():
        jc = jconfigs.REGISTRY[name]
        assert cfg.param_count() == jc.param_count(), name
        assert cfg.active_param_count() == jc.active_param_count(), name
        small = configs.smoke_config(cfg)
        assert small.param_count() == jconfigs.smoke_config(jc).param_count()
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC


def test_sweep_cells_and_production_meshes():
    """``sweep.cells()`` is the reference's list; the production meshes
    have its shapes and axes (the reference's own, read in the
    subprocess, are checked in ``test_production_meshes_match``)."""
    assert list(sweep.cells()) == list(jsweep.cells())
    for mp in (False, True):
        m = mesh.make_production_mesh(mp, device="cpu")
        cfg = MeshConfig(mp)
        assert tuple(m.shape) == cfg.axes
        assert tuple(m.shape.values()) == cfg.shape
        assert m.world.world == cfg.n_devices
        assert m.dp.world == cfg.n_devices // 16


def test_long500k_skip_policy_and_cli(tmp_path, monkeypatch):
    """``tests/test_dryrun.py::test_long500k_skip_policy`` on the port,
    through the sweep's subprocess runner and the CLI: a quadratic arch
    skips ``long_500k`` and the record says why; a subquadratic one
    would run it."""
    out = str(tmp_path / "cells.jsonl")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (os.path.join(_TESTS, "..", "src"),
                    os.environ.get("PYTHONPATH", "")) if p))
    r = sweep.run_cell("llama3-405b", "long_500k", False, out, 300)
    assert r["status"] == "ok"
    rec = json.loads(open(out).read().strip().splitlines()[-1])
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
    assert rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert "mamba2-1.3b" in configs.SUBQUADRATIC


@pytest.mark.parametrize("arch,shape,kw", [
    ("graphgen-gcn", "train_4k", {}),
    ("smollm-135m", "decode_32k", {}),
    ("qwen3-moe-30b-a3b", "train_4k", {"moe_impl": "ep_a2a"}),
])
def test_production_cells_trace(arch, shape, kw):
    """Three production cells trace one rank's step at 16x16 to ``ok``
    with every key of the reference's record that has a meaning here."""
    rec = _cell(arch, shape, **kw)
    assert rec["status"] == "ok"
    assert (rec["chips"], rec["mesh"]) == (256, "16x16")
    for key in ("arch", "shape", "variant", "kind", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device", "memory",
                "t_lower_s", "params", "active_params", "tokens", "kernels"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert rec["flops_per_device"] > 0
    if arch == "graphgen-gcn":
        assert rec["tokens"] > 1_000_000
        assert coll["all-to-all"] > 0 and coll["collective-permute"] > 0
        assert rec["kernels"]["fanout_mean"]["calls"] == 3
        assert rec["cache_mode"] == "sharded"
        assert "feature_store" in rec and "collect_stats" in rec
    if "ep_a2a" in kw.values():
        assert coll["all-to-all"] > 0


def test_flash_counts_the_causal_pairs():
    """With flash on, the prefill's attention is the kernel's count: the
    causal pairs, ``4 B Hq Dh`` FLOPs each; the naive path multiplies the
    full ``L x L`` scores (the reference's count under ``--attn naive``).
    The gap per layer is ``4 B Hq Dh (L^2 - pairs)``, exactly."""
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(
        "smollm-135m")), head_dim=64)
    shape = ShapeConfig("p", "prefill", 128, 2)
    naive = dryrun.lower_cell(cfg.name, "p", mesh=(1, 1), shape=shape,
                              cfg=cfg)
    flash = dryrun.lower_cell(cfg.name, "p", mesh=(1, 1), shape=shape,
                              cfg=dataclasses.replace(
                                  cfg, use_flash_attention=True))
    b, lq, hq, dh = 2, 128, cfg.n_heads, 64
    gap = cfg.n_layers * 4 * b * hq * dh * (lq * lq - causal_pairs(lq, lq))
    assert flash["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert naive["flops_per_device"] - flash["flops_per_device"] == gap


# ------------------------------------------------ against the reference --

def test_production_meshes_match(ref):
    for mp in (False, True):
        m = mesh.make_production_mesh(mp, device="cpu")
        assert [list(m.shape), list(m.shape.values())] == ref[f"mesh/{int(mp)}"]


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def test_input_prefill_and_cache_specs_match(ref):
    """Every LM arch and shape: the inputs and the prefill's inputs as
    shapes and dtypes, and (decode shapes) the cache each model makes as
    shapes, dtypes and ``cache_pspecs`` at the 16x16 mesh."""
    prod = mesh.make_production_mesh(device="cpu")
    for name, cfg in configs.REGISTRY.items():
        if cfg.family == "gcn":
            continue
        with FakeTensorMode():
            model = zoo.build(cfg, "cpu").init(0)
        for sname, shape in SHAPES.items():
            for kind, fn in (("in", zoo.input_specs),
                             ("pre", zoo.prefill_specs)):
                got = {k: [list(s), str(d).replace("torch.", "")]
                       for k, (s, d) in fn(cfg, shape).items()}
                assert got == ref[f"{kind}/{name}/{sname}"], (name, sname)
            if shape.kind != "decode":
                continue
            with FakeTensorMode():
                cache = model.init_cache(shape.global_batch, shape.seq_len)
            specs = zoo.cache_pspecs(cfg, {k: v.shape for k, v in
                                           cache.items()}, prod.shape)
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", ""),
                       _spec(specs[k])] for k, v in cache.items()}
            assert got == ref[f"cache/{name}/{sname}"], (name, sname)


@pytest.mark.parametrize("arch", FLOP_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flops_match_trip_weighted_cost(ref, arch, kind):
    """One device, the smoke config, ``--attn naive``: the traced FLOPs
    equal ``trip_weighted_cost`` of the reference's compiled program
    (exactly; 2% would be allowed)."""
    cfg = configs.smoke_config(configs.get_config(arch))
    shape = ShapeConfig("s", kind, FLOP_S, FLOP_B)
    rec = dryrun.lower_cell(arch, "s", mesh=(1, 1), shape=shape, cfg=cfg)
    want = ref[f"flops/{kind}/{arch}"]
    print(f"{arch} {kind}: traced {rec['flops_per_device']}, reference "
          f"{want}")
    assert rec["flops_per_device"] == want


@pytest.mark.parametrize("merge", MERGES)
def test_gcn_collective_bytes_match(ref, merge):
    """The GCN pipelined step at W = 4: the per-device bytes of every
    all-to-all (the feature shuffle and the cache's probe round),
    collective-permute (the tree merge) and all-gather (the frontier)
    equal the reference's compiled HLO's."""
    rec = dryrun.lower_gcn_cell(
        {"arch": "graphgen-gcn"}, "graphgen-gcn", False, merge_mode=merge,
        cache_rows=GCN_CACHE_ROWS, mesh=(GCN_W, 1), n_nodes=GCN_NODES,
        n_edges=GCN_EDGES, seeds=GCN_B, dims=GCN_DIMS, capacity_slack=2.0)
    got = rec["collective_bytes_per_device"]
    want = ref[f"gcn/{merge}"]
    for kind in ("all-to-all", "collective-permute", "all-gather"):
        assert got[kind] == want[kind], kind
    assert got["all-to-all"] > 0 and got["collective-permute"] > 0


def test_fake_collectives_match_a_real_gloo_step(ref, background):
    """``FakeWorkers``' calls and bytes per mesh axis of one traced
    ``train_lm --dist`` step at (2, 2) equal rank 0's
    ``ProcessWorkers.stats`` of the same step run on four gloo ranks."""
    _, real = background()
    cfg = configs.smoke_config(configs.get_config(MESH_ARCH))
    shape = ShapeConfig("smoke", "train", MESH_S, MESH_B)
    rec = dryrun.lower_cell(MESH_ARCH, "smoke", mesh=(2, 2), shape=shape,
                            cfg=cfg, **MESH_FLAGS)
    got = {axis: {k: [v["calls"], v["bytes"]] for k, v in st.items()}
           for axis, st in rec["collective_calls"].items()}
    assert got == real
    assert sum(v[0] for st in real.values() for v in st.values()) > 0


def test_roofline_matches_the_reference(monkeypatch):
    """``analyse`` and ``markdown_table`` give the reference's output on
    the same records once the reference's module reads the port's
    constants (patched here only)."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", LINK_BW)
    monkeypatch.setattr(jroofline, "PCIE_BW", roofline.PCIE_BW)
    recs = [_cell("graphgen-gcn", "train_4k"),
            _cell("smollm-135m", "decode_32k"),
            _cell("llama3-405b", "long_500k")]
    rows = []
    for rec in recs:
        mine, theirs = roofline.analyse(rec), jroofline.analyse(rec)
        assert mine == theirs
        rows.append(mine or rec)
    assert roofline.markdown_table(rows, "16x16") == \
        jroofline.markdown_table(rows, "16x16")
    assert roofline._fmt(2.5e-4) == jroofline._fmt(2.5e-4)
