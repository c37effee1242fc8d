#!/usr/bin/env python3
"""Variants of the gather_reduce kernel, timed in turns on one NVIDIA card,
at the drive's own operands.

Inputs: a graphgen-gcn server at W = 1 (``chip_smoke.serve_args``, built,
warmed and served as ``chip_smoke.py`` does) and the first of
``chip_smoke.gather_levels``'s requests: the 20 000 x 128 float32 feature
table, the request's hop-2 ids and mask as [1280, 20]; and the same ids
over the table cast once to bfloat16.

Variants: the committed kernel at its plan and with K split over other
numbers of warps (``ways``: 1 to ``GATHER_WARPS``; the plan's rows per
CTA follow); its scalar route; source variants (``VARIANTS``): other
loads in flight a slot group (the kernel's ``kUnroll``: 8, 12), other
CTA sizes (``kWarps``: 2, 8; the plan is made with each variant's own
constants), ``__launch_bounds__`` (the kernel has none; ptxas then
spills in some instances), with and without a minimum of one CTA per SM,
the table loaded with the default policy or the streaming hint
(``__ldcs``) instead of ``__ldg``, and diagnostics that change the
result on purpose (``UNCHECKED``: no row loads; a kernel that returns at
once); the parent's kernel, built from its source.  Yardsticks:
``embedding_bag`` (sum, mask weights) and the division, the library call
``chip_smoke.py`` reports; and a 4-byte ``zero_()``, the floor of each
reading.

Every variant is checked against the twin first (``chip_smoke.
gather_close``), then timed in four turns, forward and reverse order, two
ways each turn: CUDA events (``chip_smoke.gpu_ms``, median of 30) and the
profiler's device duration (``chip_smoke.device_ms``, median of 30); the
table gives the median of the turns for both, each against the bound, and
whether the committed kernel was faster than the parent's in every turn.

Usage, from the repository root: ``python3 scripts/gather_variants.py``.
The parent's source is read from ``build/parent/``; in a git checkout,
``python3 scripts/gather_variants.py --prepare --parent-rev REV`` writes
it there first (``git show REV:<path>``), so a copy of the tree without
``.git`` can run the comparison.
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

OUT = os.path.join(ROOT, "build", "gather_variants")
SOURCE = "gather_reduce.cu"
_UNROLL = "constexpr int kUnroll = 10;"
_WARPS = "constexpr int kWarps = 4;"
_LOAD = "u[q] = __ldg(tv + static_cast<int64_t>(rq) * row_vecs);"


def _consts(unroll=10, warps=4):
    """Substitutions for ``unroll`` loads in flight a slot group and CTAs
    of up to ``warps`` warps."""
    return [(_UNROLL, f"constexpr int kUnroll = {unroll};"),
            (_WARPS, f"constexpr int kWarps = {warps};")]


#: name -> (what it tests, [(text in the source, replacement)])
VARIANTS = {
    "final": ("the kernel as committed", []),
    **{f"unroll_{u}": (f"{u} row loads in flight a slot group", _consts(u))
       for u in (8, 12)},
    **{f"warps_{w}": (f"CTAs of up to {w} warps", _consts(warps=w))
       for w in (2, 8)},
    **{name: (f"__launch_bounds__({bounds})",
              [("__global__ void gather_reduce_kernel(",
                f"__global__ void __launch_bounds__({bounds}) "
                f"gather_reduce_kernel(")])
       for name, bounds in (("bounds", "kWarps * 32"),
                            ("bounds_1", "kWarps * 32, 1"))},
    "plain_loads": ("table rows loaded with the default policy (no __ldg)",
                    [(_LOAD, "u[q] = tv[static_cast<int64_t>(rq) * "
                             "row_vecs];")]),
    "ldcs": ("table rows loaded with the streaming hint (__ldcs)",
             [(_LOAD, "u[q] = __ldcs(tv + static_cast<int64_t>(rq) * "
                      "row_vecs);")]),
    "diag_no_rows": ("diagnostic: no row loads (every mean 0): the ids, "
                     "the partial sums and the stores alone",
                     [("if (j < 32 && (kept >> j) & 1u)\n            u[q]",
                       "if (false)\n            u[q]")]),
    "diag_empty": ("diagnostic: the kernel returns at once: the launch of "
                   "its grid",
                   [("  using U = repro::Unit<T, V>;\n",
                     "  using U = repro::Unit<T, V>;\n"
                     "  if (k_fan >= 0) return;\n")]),
}
#: variants that change the result on purpose: timed, not checked
UNCHECKED = ("diag_no_rows", "diag_empty")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: as ``probe_variants.KERNELS``
KERNELS = (("gather", SOURCE, VARIANTS, "repro_gather_reduce",
            [_P] * 4 + [_LL] * 2 + [_I] * 10 + [_P],
            [_P] * 4 + [_LL] * 2 + [_I] * 3 + [_P]),)


def constant(name, cname):
    """The compile-time constant ``cname`` of variant ``name``."""
    text = variant_source("gather", SOURCE, name, VARIANTS[name][1])
    return int(re.search(rf"constexpr int {cname} = (\d+);", text).group(1))


def gather_call(torch, lib, parent, table, idx, mask, plan=None):
    """A closure that launches one variant on ``plan`` (the parent's kernel
    takes none; the output is allocated once)."""
    from repro_torch.kernels import _build
    (n, d), (m, k) = table.shape, idx.shape
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    head = (table.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            out.data_ptr(), n, m, k, d, _build.dtype_code(table))
    tail = () if parent else (plan.vec, plan.lanes, plan.ways, plan.rows,
                              *plan.grid, plan.smem)

    def run():
        status = lib.repro_gather_reduce(
            *head, *tail, torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"gather launch failed: CUDA error {status}")
        return out
    return run


def drive_operands(torch):
    """The drive's first request: ``(table, idx, mask)`` on the card."""
    from repro_torch.launch import serve
    args = cs.serve_args("graphgen-gcn", 1)
    built = serve.build_server(args)
    serve.serve_gcn(args, built)
    table, _, levels = cs.gather_levels(torch, *built)
    return (table, *levels[0])


def main():
    """Build, check and time every variant; see the module docstring."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prepare", action="store_true",
                    help="only write the parent's source to build/parent")
    ap.add_argument("--parent-rev", default="HEAD~1")
    opts = ap.parse_args()
    if opts.prepare:
        prepare(opts.parent_rev, (SOURCE,))
        return
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_reduce import (GATHER_WARPS,
                                                   gather_reduce_plan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs = build_all(KERNELS, OUT)
    for (_, name), (_, regs) in sorted(libs.items()):
        print(f"[build] gather {name}: {regs}")
    table, idx, mask = drive_operands(torch)
    n_sm = _build.sm_count(table.device)
    floor = torch.zeros(1, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        tab = table.to(dtype)
        (m, k), d, elem = idx.shape, tab.shape[1], tab.element_size()
        # the committed kernel through its wrapper: the bound, the counts
        # and the lines chip_smoke prints
        entry = cs.time_kernel(torch, "gather_reduce", (tab, idx, mask), {})
        fns, what = {}, {}
        for (_, var), (lib, _) in libs.items():
            if var == "parent":
                fns[var] = gather_call(torch, lib, True, tab, idx, mask)
                what[var] = "the parent's kernel"
                continue
            plan = gather_reduce_plan(m, k, d, elem, n_sm=n_sm,
                                      warps=constant(var, "kWarps"),
                                      unroll=constant(var, "kUnroll"))
            fns[var] = gather_call(torch, lib, False, tab, idx, mask, plan)
            what[var] = f"{VARIANTS[var][0]} ({plan})"
        final = libs["gather", "final"][0]
        plan = gather_reduce_plan(m, k, d, elem, n_sm=n_sm)
        for ways in sorted(set(range(1, GATHER_WARPS + 1)) - {plan.ways}):
            rows = GATHER_WARPS // ways
            p = plan._replace(ways=ways, rows=rows,
                              grid=(-(-m // rows), plan.grid[1]),
                              smem=4 * rows * ways * 32 * plan.vec)
            fns[f"ways_{ways}"] = gather_call(torch, final, False, tab, idx,
                                              mask, p)
            what[f"ways_{ways}"] = f"the committed kernel, K over {ways} warps"
        scalar = gather_reduce_plan(m, k, d, elem, aligned=False, n_sm=n_sm)
        fns["scalar"] = gather_call(torch, final, False, tab, idx, mask,
                                    scalar)
        what["scalar"] = f"the committed kernel's scalar route ({scalar})"
        from repro_torch.kernels import ref
        want = ref.gather_reduce_ref(tab, idx, mask)
        for var, fn in fns.items():
            if var in UNCHECKED:
                continue
            ok, err = cs.gather_close(torch, fn(), want)
            cs.check(ok, f"gather {var} ({dtype}) differs from its twin: max "
                     f"err {err}")
        bag_idx = idx.to(torch.int64).clamp(0, tab.shape[0] - 1)
        wts = mask.to(dtype)
        den = mask.float().sum(1, keepdim=True).clamp(min=1).to(dtype)
        emb = torch.nn.functional.embedding_bag
        fns["embedding_bag"] = lambda: emb(                # noqa: E731
            bag_idx, tab, mode="sum", per_sample_weights=wts) / den
        what["embedding_bag"] = ("library: embedding_bag (sum, mask "
                                 "weights) and the division")
        fns["floor"] = floor.zero_
        what["floor"] = "library: a 4-byte zero_(), the floor of each reading"
        times = turns(torch, fns, cs.both_ms)
        b_ms = entry["bound_ms"]
        print(f"gather_reduce {dtype} at table {tuple(tab.shape)}, idx "
              f"{tuple(idx.shape)}: {entry['kept_slots']} kept slots, "
              f"{entry['distinct_rows']} distinct rows; bound {b_ms:.4f} ms "
              f"({entry['bound_by']}); median of four turns: events ms, "
              f"device ms, bound share by each")
        for var, ts in times.items():
            ev = statistics.median(t[0] for t in ts)
            dv = statistics.median(t[1] for t in ts)
            regs = libs.get(("gather", var), (None, ""))[1]
            print(f"  {var:13s} {ev:.4f} {dv:.4f}  {100 * b_ms / ev:4.0f}% "
                  f"{100 * b_ms / dv:4.0f}%  "
                  f"{[(round(e, 4), round(v, 4)) for e, v in ts]}  "
                  f"{what[var]}{'; ' + regs if regs else ''}")
        faster = all(f[1] < p[1] for f, p in zip(times["final"],
                                                 times["parent"]))
        print(f"  final below the parent by device duration in every turn: "
              f"{faster}")
    print(smi)


if __name__ == "__main__":
    main()
