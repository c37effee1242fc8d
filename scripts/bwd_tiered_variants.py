#!/usr/bin/env python3
"""Variants of the fanout_mean_bwd and tiered-probe kernels, timed in turns
on one NVIDIA card, at the train steps' own inputs.

Inputs: a 20-step graphgen-gcn-deep train run at W = 1 (``chip_smoke.
train_args``) gives the deep step's two backward shapes, (32, 15, 256) and
(480, 10, 256), from its last batch's masks (a seeded random gradient), and
the tiered probe's inputs: that batch's deduplicated ids (R = 29 312)
against the run's warm L1 and L2; a 20-step graphgen-gcn train run at
W = 4 gives the W = 4 step's backward shape, (128, 40, 256).

fanout_mean_bwd: the committed kernel at its plan and with K split over
other numbers of warps (1, twice the plan's, K); source variants
(``BWD_VARIANTS``): other CTA sizes (the kernel's ``kWarps``: 1, 2 and 8
warps; the grid follows), default stores (no ``__stcs``); the parent's
kernel, built from its source.
Yardsticks: ``torch.bmm`` of the normalised mask with g (the library call
``chip_smoke.py`` reports), a ``zero_()`` of dx's bytes, and a 4-byte
``zero_()`` (the floor of each reading).

cache_probe_tiered: the committed kernel, its scalar row route, and source
variants (``TIERED_VARIANTS``): other ids per warp and warps per CTA (the
kernel's ``kIdsPerWarp`` and ``kWarps``; the grid follows them), 4 and 16
row units in flight, streaming stores, and diagnostics that change the
result on purpose (timed, not checked: the stores alone, at the
committed shape, at 4 ids a warp in 4-warp CTAs and at 16 and 32 ids a
warp; every id a miss); the parent's kernel.  Yardsticks: a ``zero_()`` of the
output's bytes and the 4-byte ``zero_()``.

Every variant is checked against the twin first (exactly, nan where the
twin has nan), then timed in four turns, forward and reverse order, two
ways each turn: CUDA events (``chip_smoke.gpu_ms``, median of 30) and the
profiler's device duration (``chip_smoke.device_ms``, median of 30); the
table gives the median of the turns for both, and each against the bound.

Usage, from the repository root: ``python3 scripts/bwd_tiered_variants.py``.
The parent's sources are read from ``build/parent/``; in a git checkout,
``python3 scripts/bwd_tiered_variants.py --prepare --parent-rev REV``
writes them there first (``git show REV:<path>``), so a copy of the tree
without ``.git`` can run the comparison.
"""
import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from probe_variants import (build_all, prepare, turns,  # noqa: E402
                            variant_source)

OUT = os.path.join(ROOT, "build", "bwd_tiered_variants")
SOURCES = ("fanout_mean_bwd.cu", "cache_probe_tiered.cu")
#: name -> (what it tests, [(text in the source, replacement)])
_BWD_WARPS = "constexpr int kWarps = 4;"
BWD_VARIANTS = {
    "final": ("the kernel as committed", []),
    **{f"warps_{w}": (f"CTAs of {w} warps",
                      [(_BWD_WARPS, f"constexpr int kWarps = {w};")])
       for w in (1, 2, 8)},
    "plain_stores": ("stores with the default policy (no __stcs)",
                     [("__stcs(out, bit ? on : off);",
                       "*out = bit ? on : off;")]),
}
_IDS = "constexpr int kIdsPerWarp = 8;"
_WARPS = "constexpr int kWarps = 1;"
_STORES_ONLY = ("  const int w1 = s1.first(id, l1_assoc);\n"
                "  const int w2 = s2.first(id, l2_assoc);\n",
                "  const int w1 = -1, w2 = -1;\n")


def _shape(ids, warps):
    """Substitutions for ``ids`` ids a warp and ``warps`` warps a CTA."""
    return [(_IDS, f"constexpr int kIdsPerWarp = {ids};"),
            (_WARPS, f"constexpr int kWarps = {warps};")]


TIERED_VARIANTS = {
    "final": ("the kernel as committed", []),
    "ids_16": ("16 ids a warp", _shape(16, 1)),
    "ids_32": ("32 ids a warp", _shape(32, 1)),
    "warps_2": ("CTAs of 2 warps", _shape(8, 2)),
    "warps_4": ("CTAs of 4 warps", _shape(8, 4)),
    "unroll_4": ("4 row units in flight per lane",
                 [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")]),
    "unroll_16": ("16 row units in flight per lane",
                  [("constexpr int kUnroll = 8;",
                    "constexpr int kUnroll = 16;")]),
    "stream": ("stores with the streaming hint (__stcs)",
               [("o[u0 + q * 32] = buf[q];",
                 "__stcs(o + u0 + q * 32, buf[q]);")]),
    "diag_stores_only": (
        "diagnostic: no probe, every row zeros (wrong where an id hits): "
        "the kernel's stores alone", [_STORES_ONLY]),
    "diag_stores_ids_4_warps_4": (
        "diagnostic: the stores alone at 4 ids a warp in 4-warp CTAs (four "
        "times the warps, 4 units a lane)", [_STORES_ONLY] + _shape(4, 4)),
    "diag_stores_ids_16": (
        "diagnostic: the stores alone at 16 ids a warp (half the warps)",
        [_STORES_ONLY] + _shape(16, 1)),
    "diag_stores_ids_32": (
        "diagnostic: the stores alone at 32 ids a warp (a quarter of the "
        "warps)",
        [_STORES_ONLY] + _shape(32, 1)),
    "diag_no_hits": (
        "diagnostic: every id moved past the caches' ids (wrong where an "
        "id hits): the id and key trips, then zeros",
        [("const int32_t id = live ? ids[base + lane] : 0;",
          "const int32_t id = live ? ids[base + lane] | 0x40000000 : 0;")]),
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: as ``probe_variants.KERNELS``
KERNELS = (
    ("bwd", "fanout_mean_bwd.cu", BWD_VARIANTS, "repro_fanout_mean_bwd",
     [_P] * 3 + [_LL] + [_I] * 6 + [_P], [_P] * 3 + [_LL] + [_I] * 3 + [_P]),
    ("tiered", "cache_probe_tiered.cu", TIERED_VARIANTS,
     "repro_cache_probe_tiered", [_P] * 7 + [_LL] + [_I] * 8 + [_P],
     [_P] * 7 + [_LL] + [_I] * 6 + [_P]),
)


def constant(kernel, name, cname):
    """The compile-time constant ``cname`` of variant ``name`` of
    ``kernel`` (``bwd`` or ``tiered``)."""
    _, source, variants, *_ = next(k for k in KERNELS if k[0] == kernel)
    text = variant_source(kernel, source, name, variants[name][1])
    return int(re.search(rf"constexpr int {cname} = (\d+);", text).group(1))


def bwd_call(torch, lib, parent, g, mask, warps=None, ways=None):
    """A closure that launches one backward variant on the committed plan's
    grid, with rows of M over CTAs of ``warps`` warps (the variant's
    ``kWarps``) and K over ``ways`` shares (the plan's by default; dx
    allocated once)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_reduce import fanout_mean_bwd_plan
    (m, d), k = g.shape, mask.shape[1]
    _, plan_ways, gz = fanout_mean_bwd_plan(
        m, k, d, n_sm=_build.sm_count(g.device))
    dx = torch.empty((m, k, d), dtype=g.dtype, device=g.device)
    head = (g.data_ptr(), mask.data_ptr(), dx.data_ptr(), m, k, d,
            _build.dtype_code(g))
    tail = () if parent else (-(-m // warps), ways or plan_ways, gz)

    def run():
        status = lib.repro_fanout_mean_bwd(
            *head, *tail, torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"bwd launch failed: CUDA error {status}")
        return dx
    return run


def tiered_call(torch, lib, parent, k1, r1, k2, r2, ids, l1_assoc,
                l2_assoc, per_cta=None, vec=None):
    """A closure that launches one tiered-probe variant: ``per_cta`` ids a
    CTA (the variant's own; the committed kernel's by default), rows of
    ``vec`` elements a unit (the plan's by default)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_gather import _shift_for, tiered_plan
    r, d = ids.shape[0], r2.shape[1]
    plan = tiered_plan(r, d, r2.element_size())
    if per_cta is not None:
        plan = plan._replace(grid=-(-r // per_cta))
    if vec is not None:
        plan = plan._replace(vec=vec)
    src = torch.empty((r,), dtype=torch.int32, device=ids.device)
    out = torch.empty((r, d), dtype=r2.dtype, device=ids.device)
    head = (k1.data_ptr(), r1.data_ptr(), k2.data_ptr(), r2.data_ptr(),
            ids.data_ptr(), src.data_ptr(), out.data_ptr(), r, d, l1_assoc,
            _shift_for(k1.shape[0] // l1_assoc), l2_assoc,
            _shift_for(k2.shape[0] // l2_assoc), _build.dtype_code(r2))
    tail = () if parent else (plan.vec, plan.grid)

    def run():
        status = lib.repro_cache_probe_tiered(
            *head, *tail, torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"tiered launch failed: CUDA error {status}")
        return src, out
    return run


def real_inputs(torch):
    """The train steps' inputs: ``[(name, inputs, kw)]`` for the three
    backward shapes and the deep step's tiered probe."""
    from repro_torch.configs import get_config
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import dedup_requests
    from repro_torch.launch import train
    gen = torch.Generator(device="cuda").manual_seed(6)
    items = []
    for arch, w in (("graphgen-gcn-deep", 1), ("graphgen-gcn", 4)):
        res = train.train_gcn(cs.train_args(arch, w))
        batch, hidden = res["batch"], get_config(arch).gcn_hidden
        for lvl in range(len(batch.masks) - 1):
            mask = batch.masks[lvl]
            mask = mask.reshape(-1, mask.shape[-1]).contiguous()
            g = torch.randn((mask.shape[0], hidden), generator=gen,
                            device="cuda")
            items.append(("fanout_mean_bwd", (g, mask), {}))
        if w == 1:
            dcfg = CacheConfig.from_model(get_config(arch))
            cache = res["cache"]
            need = torch.cat([batch.seeds.reshape(1, -1)] + [
                h.reshape(1, -1) for h in batch.hops], dim=1)
            uniq = dedup_requests(need)[0][0]
            items.append(("cache_probe_tiered", tuple(t.contiguous() for t in (
                cache.l1.keys[0], cache.l1.rows[0], cache.l2.keys[0],
                cache.l2.rows[0], uniq)),
                {"l1_assoc": dcfg.l1_assoc, "l2_assoc": dcfg.assoc}))
    torch.cuda.synchronize()
    return items


def same(torch, got, want):
    """Exactly equal, nan where the twin has nan."""
    nan = want.isnan() if want.is_floating_point() else None
    if nan is None:
        return torch.equal(got, want)
    return (torch.equal(got.isnan(), nan)
            and torch.equal(got[~nan], want[~nan]))


def main():
    """Build, check and time every variant; see the module docstring."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prepare", action="store_true",
                    help="only write the parent's sources to build/parent")
    ap.add_argument("--parent-rev", default="HEAD~1")
    opts = ap.parse_args()
    if opts.prepare:
        prepare(opts.parent_rev, SOURCES)
        return
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_gather import tiered_plan
    from repro_torch.kernels.gather_reduce import (BWD_WARPS,
                                                   fanout_mean_bwd_plan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs = build_all(KERNELS, OUT)
    for (kernel, name), (_, regs) in sorted(libs.items()):
        print(f"[build] {kernel} {name}: {regs}")
    floor = torch.zeros(1, device="cuda")
    for name, ins, kw in real_inputs(torch):
        # the committed kernel through its wrapper: the bound, and the
        # lines chip_smoke prints
        entry = cs.time_kernel(torch, name, ins, kw)
        fns, what = {}, {}
        kernel = "bwd" if name == "fanout_mean_bwd" else "tiered"
        variants = BWD_VARIANTS if kernel == "bwd" else TIERED_VARIANTS
        for (kn, var), (lib, _) in libs.items():
            if kn != kernel:
                continue
            what[var] = ("the parent's kernel" if var == "parent"
                         else variants[var][0])
        final = libs[kernel, "final"][0]
        if kernel == "bwd":
            g, mask = ins
            (m, d), k = g.shape, mask.shape[1]
            want = ref.fanout_mean_bwd_ref(g, mask)
            for (kn, var), (lib, _) in libs.items():
                if kn == kernel:
                    fns[var] = bwd_call(
                        torch, lib, var == "parent", g, mask,
                        None if var == "parent"
                        else constant("bwd", var, "kWarps"))
            grid = fanout_mean_bwd_plan(m, k, d)
            what["final"] += f" (grid {grid})"
            ways = grid[1]
            for w in sorted({1, min(2 * ways, k), k} - {ways}):
                fns[f"ways_{w}"] = bwd_call(torch, final, False, g, mask,
                                            BWD_WARPS, w)
                what[f"ways_{w}"] = f"the committed kernel, K over {w} shares"
            for var, fn in fns.items():
                cs.check(same(torch, fn(), want), f"bwd {var} differs from "
                         f"its twin at {(m, k, d)}")
            wts = mask.float() / mask.float().sum(1, keepdim=True).clamp(min=1)
            wts = wts[:, :, None].contiguous()
            g3 = g[:, None, :]
            fns["torch.bmm"] = lambda: torch.bmm(wts, g3)      # noqa: E731
            what["torch.bmm"] = ("library: bmm of the normalised mask with g "
                                 "(normalisation not timed)")
            dx = want.clone()
        else:
            want = ref.cache_probe_tiered_ref(*ins, **kw)
            for (kn, var), (lib, _) in libs.items():
                if kn == kernel:
                    fns[var] = tiered_call(
                        torch, lib, var == "parent", *ins, **kw,
                        per_cta=None if var == "parent" else
                        constant("tiered", var, "kIdsPerWarp")
                        * constant("tiered", var, "kWarps"))
            r, d = ins[4].shape[0], ins[3].shape[1]
            what["final"] += f" ({tiered_plan(r, d, ins[3].element_size())})"
            fns["scalar"] = tiered_call(torch, final, False, *ins, **kw,
                                        vec=1)
            what["scalar"] = "the committed kernel's scalar row route"
            for var, fn in fns.items():
                if var.startswith("diag_"):
                    continue
                for a, b in zip(fn(), want):
                    cs.check(torch.equal(a, b), f"tiered {var} differs from "
                             f"its twin")
            dx = want[1].clone()
        fns["zero_out"] = dx.zero_
        what["zero_out"] = (f"library: a zero_() of the output's "
                            f"{dx.numel() * dx.element_size()} B")
        fns["floor"] = floor.zero_
        what["floor"] = "library: a 4-byte zero_(), the floor of each reading"
        times = turns(torch, fns, cs.both_ms)
        b_ms = entry["bound_ms"]
        print(f"{name} at {[tuple(t.shape) for t in ins]} {kw}: bound "
              f"{b_ms:.4f} ms ({entry['bound_by']}); median of four turns: "
              f"events ms, device ms, bound share by each")
        for var, ts in times.items():
            ev = statistics.median(t[0] for t in ts)
            dv = statistics.median(t[1] for t in ts)
            regs = libs.get((kernel, var), (None, ""))[1]
            print(f"  {var:10s} {ev:.4f} {dv:.4f}  {100 * b_ms / ev:4.0f}% "
                  f"{100 * b_ms / dv:4.0f}%  "
                  f"{[(round(e, 4), round(v, 4)) for e, v in ts]}  "
                  f"{what[var]}{'; ' + regs if regs else ''}")
    print(smi)


if __name__ == "__main__":
    main()
