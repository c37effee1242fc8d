"""Dry-run: trace one rank's step of every (arch x shape x mesh) cell on
fake tensors and read the roofline terms from the trace (the
counterpart of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k [--multi-pod] [--attn chunked] [--remat full] \\
        [--variant name] [--out results.jsonl]

The reference lowers and compiles each cell's SPMD program for 256 or
512 forced host devices.  The port has no compiler to ask, so it runs
rank 0's step of the production mesh (``launch/mesh.py::
make_production_mesh``: every axis a ``FakeWorkers``) through the port's
own step builders, eagerly, under ``FakeTensorMode``: every argument is
a fake tensor of the reference's shapes, nothing is allocated, no graph
is built, no kernel is launched (``kernels/ops.py``'s fake branch) and
nothing is read back to the host.  ``launch/trace_analysis.py`` counts
the FLOPs, HBM bytes, collective bytes and memory of that step.  This
proves without hardware that a cell's program runs at its shapes on
one rank (no shape mismatch, every collective's block well formed) and
what it would cost; it does not prove that XLA-style partitioning
exists, since the port's ranks run what the port's modules run (PERF.md
compares the two).

The trace's tensors live on ``cuda`` where a card is present and on the
CPU otherwise (``trace_device``): a CPU-only torch cannot index a fake
CUDA tensor (its device guard is missing), and the port's builders take
``cuda`` only where ``resolve_device`` finds a card.  The device changes
no shape and no count: no path of the port branches on it but the
kernels', which the fake branch replaces.  The record names it.

The record has the reference's keys (``arch``, ``shape``, ``mesh``,
``variant``, ``kind``, ``chips``, ``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``, ``memory``,
``t_lower_s``, ``status``, ``params``, ``active_params``, ``tokens``, and
for GCN cells the ``cache_*``, ``feature_store`` and ``collect_stats``
fields), without ``xla_cost_*`` and ``t_compile_s``, and with
``kernels`` (``{name: {calls, flops, bytes}}``, what the HLO shows of a
custom call), so ``launch/roofline.py`` reads it as it reads the
reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import REGISTRY, SUBQUADRATIC, get_config
from ..core.collectives import new_tally
from ..core.config import SHAPES, ShapeConfig, TrainConfig
from ..models import zoo
from .mesh import make_fake_mesh, make_production_mesh
from .trace_analysis import trace_step

#: the GCN cell: the paper's evaluation graph and batch per worker
GCN_NODES, GCN_EDGES, GCN_SEEDS = 530_000_000, 5_000_000_000, 128
#: the GCN cell's widths (the reference's dry-run overrides)
GCN_DIMS = {"gcn_in_dim": 128, "gcn_hidden": 256, "n_classes": 64}


def trace_device() -> torch.device:
    """Where the trace's fake tensors live: ``cuda`` where a card is
    present, else the CPU (module docstring)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _rows(n: int, dp: int) -> int:
    """A rank's rows of a batch of ``n``: split over ``dp`` where it
    divides ``n`` and ``n > 1`` (``zoo.batch_pspecs``), else whole."""
    return n // dp if n > 1 and n % dp == 0 else n


def _fake(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _record(rec: dict, res: dict, mesh, device) -> dict:
    """``rec`` with the trace's costs, the chips, the trace's device and
    each mesh axis's collective ``stats`` (``collective_calls``: calls
    and bytes sent, as ``ProcessWorkers`` counts them)."""
    rec.update({k: res[k] for k in (
        "flops_per_device", "bytes_per_device", "aten_flops", "aten_bytes",
        "kernels", "collective_bytes_per_device", "memory", "t_lower_s")})
    rec.update(chips=1 if mesh is None else mesh.world.world,
               trace_device=str(device),
               collective_calls={} if mesh is None else {
                   axis: g.stats for axis, g in mesh.groups().items()})
    return rec


def lower_gcn_cell(rec: dict, arch: str, multi_pod: bool,
                   merge_mode: str = "butterfly",
                   cache_rows: int = None, cache_mode: str = None,
                   l1_rows: int = None, probe_wire: str = None,
                   feature_store: str = None, collect_stats: bool = False,
                   *, mesh=None, n_nodes: int = GCN_NODES,
                   n_edges: int = GCN_EDGES, seeds: int = GCN_SEEDS,
                   dims: Optional[dict] = None,
                   capacity_slack: float = None) -> dict:
    """The paper's workload: one synchronized generation + training step
    (``core/pipeline.py::make_pipelined_step``: generate batch t+1, train
    on batch t) of rank 0 on the 530 M-node, 5 B-edge graph, ``seeds``
    per worker, the sampling depth of the arch.  Generation runs over the
    mesh's ``data`` axis (the worker axis); the small GCN replicates over
    ``model``, so the multi-pod cell is the same rank's program on 512
    chips.  With a cache its state rides the carry.

    ``feature_store="host"`` traces the L3 path's device half: no feature
    table among the arguments, the carry grows the ``HostMissRequest``
    and the step takes the landed ``[1, S, D]`` gather buffer (the host
    gather itself is host code, not traced).  ``collect_stats`` traces
    the autotuner's instrumented generator alone.

    ``mesh``, ``n_nodes``, ``n_edges``, ``seeds``, ``dims`` and
    ``capacity_slack`` resize the cell (the card's checks trace the
    train phase's own step at ``(1, 1)``)."""
    from ..core.feature_cache import CacheConfig, init_cache_state
    from ..core.generation import make_generator_fn, probe_round_capacity
    from ..core.host_store import HostMissRequest
    from ..core.pipeline import make_host_consume_step, make_pipelined_step
    from ..graph.subgraph import slots_per_seed
    from ..models.gcn import GCN
    from ..train.optimizer import init_adam
    from .train import make_gcn_train_fn

    tally = new_tally()
    dev = trace_device()
    if mesh is None:
        mesh = make_production_mesh(multi_pod, dev, tally)
    else:
        mesh = make_fake_mesh(*mesh, device=dev, tally=tally)
    group = mesh.data
    w = group.world
    over = dict(GCN_DIMS if dims is None else dims)
    for key, value in (("cache_rows", cache_rows), ("cache_mode", cache_mode),
                       ("cache_l1_rows", l1_rows), ("cache_wire", probe_wire),
                       ("feature_store", feature_store)):
        if value is not None:
            over[key] = value
    cfg = dataclasses.replace(get_config(arch), **over)
    host = cfg.feature_store == "host"
    cache_cfg = CacheConfig.from_model(cfg)
    cached = cache_cfg is not None
    fanouts, d = cfg.fanouts, cfg.gcn_in_dim
    rows, e_pad = -(-n_nodes // w), -(-n_edges // w)
    slack = capacity_slack if capacity_slack is not None else (
        cfg.capacity_slack if cfg.capacity_slack is not None else 2.0)
    i32, f32 = torch.int32, torch.float32
    gen_fn = make_generator_fn(fanouts=fanouts, merge_mode=merge_mode,
                               capacity_slack=slack, cache_cfg=cache_cfg,
                               feature_store=cfg.feature_store,
                               feat_dim=d if host else None,
                               collect_stats=collect_stats, group=group)
    r = seeds * slots_per_seed(fanouts)
    stage = max(int(probe_round_capacity(r, 1, slack)), 1)
    with FakeTensorMode():
        graph = (_fake((1, n_nodes + 1), i32, dev),
                 _fake((1, e_pad), i32, dev))
        labels = _fake((1, rows, 1), f32, dev)
        device_args = graph + ((labels,) if host else
                               (_fake((1, rows, d), f32, dev), labels))
        seeds_t = _fake((1, seeds), i32, dev)
        draws, f = [], w * seeds
        for k in fanouts:
            draws.append((_fake((1, f, k), i32, dev),
                          _fake((1, f, k), f32, dev)))
            f *= k
        draws = tuple(draws)
        cache0 = (init_cache_state(cache_cfg.validated(), d, 1,
                                   device=dev) if cached else None)
        admit = (_fake((1, stage), i32, dev), _fake((1, stage, d), f32, dev))
        if collect_stats:
            args = (device_args, seeds_t, draws) + (
                (cache0,) + (admit if host else ()) if cached else ())
            res = trace_step(gen_fn, args, tally)
        else:
            # the GCN's shapes (its seeded init draws on the host, then
            # moves: a fake parameter cannot move between devices)
            model = GCN(d, cfg.gcn_hidden, cfg.n_classes,
                        max(len(fanouts), 1), device=dev)
            opt = init_adam(model.leaves())
            train_fn = make_gcn_train_fn(TrainConfig(), group)
            # the carried batch t (the step generates t + 1): one
            # generation outside the trace, its collectives not counted
            with torch.no_grad():
                first = gen_fn(device_args, seeds_t, draws,
                               *((cache0,) + (admit if host else ())
                                 if cached else ()))
            for key in tally:
                tally[key] = 0
            for g in mesh.groups().values():
                g.reset_stats()
            if host:
                batch0 = first[0]
                req0 = HostMissRequest(ids=_fake((1, stage), i32, dev),
                                       slot=_fake((1, r), i32, dev),
                                       patch=_fake((1, r), torch.bool, dev))
                landed = admit[1]
                consume = make_host_consume_step(train_fn)
                if cached:
                    def step(carry, device_args, seeds, draws, landed):
                        params, opt, batch, req, cache = carry
                        with torch.no_grad():
                            nb, cache, nreq = gen_fn(device_args, seeds, draws,
                                                     cache, req.ids, landed)
                        params, opt, loss = consume(params, opt, batch, req,
                                                    landed)
                        return (params, opt, nb, nreq, cache), loss
                    carry = (model, opt, batch0, req0, cache0)
                else:
                    def step(carry, device_args, seeds, draws, landed):
                        params, opt, batch, req = carry
                        with torch.no_grad():
                            nb, nreq = gen_fn(device_args, seeds, draws)
                        params, opt, loss = consume(params, opt, batch, req,
                                                    landed)
                        return (params, opt, nb, nreq), loss
                    carry = (model, opt, batch0, req0)
                args = (carry, device_args, seeds_t, draws, landed)
            else:
                batch0 = first[0] if cached else first
                step = make_pipelined_step(gen_fn, train_fn, cached=cached)
                carry = ((model, opt, batch0, cache0) if cached
                         else (model, opt, batch0))
                args = (carry, device_args, seeds_t, draws)
            res = trace_step(step, args, tally,
                             held=list(model.parameters()))
    _record(rec, res, mesh, dev)
    rec.update(
        status="ok",
        params=cfg.param_count(),
        active_params=cfg.param_count(),
        cache_rows=cfg.cache_rows,
        cache_mode=cfg.cache_mode if cached else None,
        cache_l1_rows=cache_cfg.l1_rows if cached else 0,
        feature_store=cfg.feature_store,
        collect_stats=collect_stats,
        tokens=w * seeds * slots_per_seed(fanouts),   # padded node slots
    )
    return rec


def _lm_step(cfg, shape: ShapeConfig, mesh, device, tcfg):
    """``(fn, args, held)`` of an LM cell's step on ``mesh`` (None:
    one process), made under the caller's ``FakeTensorMode`` and
    ``zoo.settings``: the train step over the mesh's FSDP plan
    (``train_loop.make_train_step``), the prefill's ``forward_logits``, or
    one decode step against a ``seq_len`` cache at its last position.
    Each input is the rank's rows of the global batch."""
    from ..convert import lm_leaves
    from ..train.fsdp import ShardPlan
    from ..train.train_loop import init_state, make_train_step, module_loss
    dp = 1 if mesh is None else mesh.dp.world
    api = zoo.build(cfg, device)
    model = api.init(0)
    b = _rows(shape.global_batch, dp)
    if shape.kind == "train":
        params, layout = lm_leaves(model)
        plan = None if mesh is None else ShardPlan(layout, mesh,
                                                   cfg.fsdp_params)
        state = init_state(params, tcfg, layout, plan)
        del params
        # train_lm empties the shell to ``meta``; a fake parameter cannot
        # be swapped, and the state's tensors shadow it in the loss anyway
        loss_fn = module_loss(model, api.loss, layout.names)
        step = make_train_step(loss_fn, tcfg, layout, mesh=plan)
        batch = {k: _fake((b,) + tuple(s[0][1:]), s[1], device)
                 for k, s in zoo.input_specs(cfg, shape).items()}
        return step, (state, batch), None
    held = list(model.parameters()) + list(model.buffers())
    if shape.kind == "prefill":
        batch = {k: _fake((b,) + tuple(s[0][1:]), s[1], device)
                 for k, s in zoo.prefill_specs(cfg, shape).items()}
        return (lambda batch: zoo.forward_logits(cfg, model, batch),
                (batch,), held)
    cache = model.init_cache(b, shape.seq_len)
    tokens = _fake((b, 1), torch.int32, device)

    def serve_step(cache, tokens):
        with torch.no_grad():
            return api.decode(model, cache, tokens, shape.seq_len - 1)
    return serve_step, (cache, tokens), held


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               attn: str = "naive", remat: str = "keep",
               variant: str = "baseline", shard_heads: bool = False,
               gen_merge: str = "butterfly", moe_impl: str = "gather",
               seq_parallel: bool = False, compress: bool = False,
               cache_rows: int = None, cache_mode: str = None,
               l1_rows: int = None, probe_wire: str = None,
               feature_store: str = None, collect_stats: bool = False,
               *, mesh=None, shape: ShapeConfig = None, cfg=None) -> dict:
    """One cell's record (module docstring).  ``mesh`` (a ``(data,
    model)`` pair; ``(1, 1)`` is one process), ``shape`` (a
    ``ShapeConfig``) and ``cfg`` (an LM config) replace the production
    mesh, ``SHAPES[shape_name]`` and the arch's config (the card's
    checks trace the cells the card runs whole)."""
    cfg = get_config(arch) if cfg is None else cfg
    rec = {"arch": arch, "shape": shape_name,
           "mesh": (_mesh_name(multi_pod) if mesh is None
                    else "x".join(map(str, mesh))),
           "variant": variant}
    if cfg.family == "gcn":
        rec["kind"] = "train"
        return lower_gcn_cell(rec, arch, multi_pod, merge_mode=gen_merge,
                              cache_rows=cache_rows, cache_mode=cache_mode,
                              l1_rows=l1_rows, probe_wire=probe_wire,
                              feature_store=feature_store,
                              collect_stats=collect_stats, mesh=mesh)
    shape = SHAPES[shape_name] if shape is None else shape
    rec["kind"] = shape.kind
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        rec["status"] = "skipped"
        rec["reason"] = ("quadratic-attention arch; long_500k runs on "
                         "SSM/hybrid only (DESIGN.md §4)")
        return rec
    if remat != "keep":
        cfg = dataclasses.replace(cfg, remat=remat)
    dev = trace_device()
    tally = new_tally()
    if mesh is None:
        pmesh = make_production_mesh(multi_pod, dev, tally)
    elif tuple(mesh) == (1, 1):
        pmesh = None
    else:
        pmesh = make_fake_mesh(*mesh, device=dev, tally=tally)
    split = pmesh is not None and zoo.batch_pspecs(
        cfg, {"tokens": (shape.global_batch, shape.seq_len)},
        pmesh.shape)["tokens"][0] is not None
    settings = (contextlib.nullcontext() if pmesh is None else
                zoo.settings(pmesh.model, moe_impl=moe_impl,
                             shard_heads=shard_heads,
                             seq_parallel=seq_parallel, attn_impl=attn,
                             data=pmesh.dp if split else None))
    with FakeTensorMode(), settings:
        fn, args, held = _lm_step(cfg, shape, pmesh, dev,
                                  TrainConfig(compress_grads=compress))
        res = trace_step(fn, args, tally, held=held)
    _record(rec, res, pmesh, dev)
    rec.update(
        status="ok",
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        tokens=shape.global_batch
        * (shape.seq_len if shape.kind in ("train", "prefill") else 1),
    )
    return rec


def main(argv=None) -> None:
    """CLI entry (module docstring): print one JSONL record and append it
    to ``--out``; a cell that fails to trace raises."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn", default="naive", choices=["naive", "chunked"])
    ap.add_argument("--remat", default="keep",
                    choices=["keep", "none", "full", "dots"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--shard-heads", action="store_true")
    ap.add_argument("--gen-merge", default="butterfly",
                    choices=["butterfly", "reduce_scatter"])
    ap.add_argument("--moe", default="gather", choices=["gather", "ep_a2a"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--cache-rows", type=int, default=None,
                    help="GCN cells: hot-node feature cache rows/worker "
                         "(0 disables; default from the arch config)")
    ap.add_argument("--cache-mode", default=None,
                    choices=["replicated", "sharded", "tiered"],
                    help="GCN cells: cache placement override")
    ap.add_argument("--l1-rows", type=int, default=None,
                    help="GCN cells, tiered mode: replicated L1 "
                         "rows/worker (0 auto-sizes to cache_rows/8)")
    ap.add_argument("--probe-wire", default=None,
                    choices=["dense", "compact"],
                    help="GCN cells: shard-probe response wire format "
                         "override (sharded/tiered modes)")
    ap.add_argument("--feature-store", default=None,
                    choices=["device", "host"],
                    help="GCN cells: feature-table placement override; "
                         "host traces the L3 path with NO device feature "
                         "table among the arguments")
    ap.add_argument("--collect-stats", action="store_true",
                    help="GCN cells: trace the autotuner's instrumented "
                         "generator (the FetchStats/CacheStats tail) "
                         "instead of the train step")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    rec = lower_cell(args.arch, args.shape, args.multi_pod,
                     attn=args.attn, remat=args.remat, variant=args.variant,
                     shard_heads=args.shard_heads, gen_merge=args.gen_merge,
                     moe_impl=args.moe, seq_parallel=args.seq_parallel,
                     compress=args.compress, cache_rows=args.cache_rows,
                     cache_mode=args.cache_mode, l1_rows=args.l1_rows,
                     probe_wire=args.probe_wire,
                     feature_store=args.feature_store,
                     collect_stats=args.collect_stats)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if rec.get("status") not in ("ok", "skipped"):
        sys.exit(1)


if __name__ == "__main__":
    main()
