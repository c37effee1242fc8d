#!/usr/bin/env python3
"""Variants of the compact-probe and fanout_mean kernels, timed in turns on
one NVIDIA card, at the main path's own inputs.

Inputs: a graphgen-gcn server at W = 4 (``chip_smoke.serve_args``, built,
warmed and served as ``chip_smoke.py`` does) gives one bucket-32 request's
three ``fanout_mean`` calls and its compact probe round (``chip_smoke.
request_items``); a 20-step graphgen-gcn train run at W = 4 gives the
train run's own probe round (``chip_smoke.train_probe_round``: its
calibrated slack and hit cap).

Compact probe: the committed kernel at S = 1, 2, 4, 8 CTAs per destination
row (the plan's S is 8 at W = 4), its scalar route, and asking 120 KB of
shared memory (one CTA per SM); source variants (``COMPACT_VARIANTS``):
the zero tail issued last, the holder's keys read from L2, the zero tail
by TMA bulk stores from a zeroed shared tile, 256 and 1 024 threads per
CTA, and diagnostics that change the result on purpose (``UNCHECKED``:
no zero tail, no kept-row copies, each CTA's SM number, printed as CTAs
per SM).  Yardsticks: the payload's ``zero_()`` and a 4-byte ``zero_()``
(the timing's floor).

fanout_mean: the committed plan, lanes kept at 32 (no narrowing at small
M), other K splits (``ways``), the scalar route; source variants
(``FANOUT_VARIANTS``): 2 and 8 loads in flight, loads without the
streaming hint or through the read-only path, 8 CTAs per SM.  Yardsticks:
``torch.bmm`` of the normalised mask with x (the library call
``chip_smoke.py`` reports), ``x.sum(1)``, ``x.sum()``, a copy of x, and
the 4-byte ``zero_()``.  Both kernels against the parent's, built from
its source.

Every variant that should be right is checked against the twin first
(compact exact; fanout_mean rtol 1e-5 / atol 1e-6).  Each is then timed
(CUDA events, ``chip_smoke.gpu_ms``, median of 30) in four turns, forward
and reverse order; the table gives the median of the turns.

Usage, from the repository root: ``python3 scripts/probe_variants.py``.
The parent's sources are read from ``build/parent/``; in a git checkout,
``python3 scripts/probe_variants.py --prepare --parent-rev REV`` writes
them there first (``git show REV:<path>``; the default REV is ``HEAD~1``),
so a copy of the tree without ``.git`` can run the comparison.
"""
import argparse
import collections
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

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "probe_variants")
PARENT = os.path.join(ROOT, "build", "parent")
SOURCES = ("cache_probe_compact.cu", "fanout_mean.cu")

_TAIL = """  const V z = zero_of<V>();
#pragma unroll 4
  for (int64_t i = rank * per + threadIdx.x; i < t1; i += kThreads) zt[i] = z;
"""
_BULK_TAIL = """  if constexpr (sizeof(V) == 16) {
    __shared__ int4 zbuf[256];
    zbuf[threadIdx.x % 256] = make_int4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
    const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(zbuf));
    for (int64_t c0 = rank * per + threadIdx.x * 256LL; c0 < t1;
         c0 += kThreads * 256LL) {
      const int n = static_cast<int>(min(static_cast<int64_t>(256), t1 - c0));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
          :: "l"(zt + c0), "r"(src), "r"(n * 16) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
  } else {
""" + _TAIL + "  }\n"

_TAIL_BLOCK = """  // the zero tail, rows [kept_total, hit_cap), split evenly over the
  // cluster: issued first, its stores drain while the words are written,
  // the kept lists gathered and the kept rows copied
  const int64_t tail = static_cast<int64_t>(hit_cap - kept_total) * row_vecs;
  const int64_t per = (tail + n_ranks - 1) / n_ranks;
  const int64_t t1 = min(tail, (rank + 1) * per);
  V* zt = pay + static_cast<int64_t>(kept_total) * row_vecs;
""" + _TAIL + "\n"
_WAIT = "  cluster_wait();  // no CTA leaves"
_X_LOAD = "u[q] = __ldcs(xr + static_cast<int64_t>(k) * row_vecs);"

#: name -> (what it tests, [(text in the source, replacement)])
COMPACT_VARIANTS = {
    "final": ("the kernel as committed", []),
    "tail_last": ("the zero tail issued after the kept-row copies",
                  [(_TAIL_BLOCK, ""), (_WAIT, _TAIL_BLOCK + _WAIT)]),
    "keys_l2": (
        "the holder's keys read from L2 (no shared-memory copy)",
        [("  for (int i = threadIdx.x; i < n_slots_c; i += kThreads) "
          "sk[i] = kg[i];\n", ""),
         ("if (sk[sb + j] == id[u]) {", "if (kg[sb + j] == id[u]) {")]),
    "tma_tail": (
        "the zero tail by TMA bulk stores (cp.async.bulk) from a zeroed "
        "4 KB shared tile", [(_TAIL, _BULK_TAIL)]),
    "smid": (
        "diagnostic: each CTA writes its SM's number into its first word "
        "(wrong words), to show where the CTAs ran",
        [(_WAIT,
          "  if (threadIdx.x == 0 && n_own > 0) {\n"
          "    unsigned sm;\n"
          "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
          "    wo[w0] = static_cast<int32_t>(sm);\n"
          "  }\n" + _WAIT)]),
    "no_tail": ("diagnostic: no zero tail (wrong payload)", [(_TAIL, "")]),
    "no_copy": ("diagnostic: no kept-row copies (wrong payload)",
                [("const int n_keep = min(e0 + per_keep, kept_total) - e0;",
                  "const int n_keep = 0;")]),
    "threads_256": ("256 threads per CTA",
                    [("constexpr int kThreads = 512;",
                      "constexpr int kThreads = 256;")]),
    "threads_1024": ("1 024 threads per CTA",
                     [("constexpr int kThreads = 512;",
                       "constexpr int kThreads = 1024;")]),
}
#: compact variants that change the result on purpose: timed, not checked
UNCHECKED = ("smid", "no_tail", "no_copy")
FANOUT_VARIANTS = {
    "final": ("the kernel as committed", []),
    "unroll_2": ("2 x loads in flight per thread",
                 [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")]),
    "unroll_8": ("8 x loads in flight per thread",
                 [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    "plain_loads": ("x loaded without the streaming hint (no __ldcs)",
                    [(_X_LOAD, "u[q] = xr[static_cast<int64_t>(k) * "
                               "row_vecs];")]),
    "blocks_8": ("__launch_bounds__(256, 8): at most 32 registers, 8 CTAs "
                 "per SM", [("__launch_bounds__(kMaxThreads)",
                             "__launch_bounds__(kMaxThreads, 8)")]),
    "ldg": ("x loaded through the read-only path (__ldg)",
            [(_X_LOAD, "u[q] = __ldg(xr + static_cast<int64_t>(k) * "
                       "row_vecs);")]),
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (name, source, variants, C entry point, its argument types, the parent's)
KERNELS = (
    ("compact", "cache_probe_compact.cu", COMPACT_VARIANTS,
     "repro_cache_probe_compact", [_P] * 6 + [_I] * 14 + [_P],
     [_P] * 6 + [_I] * 10 + [_P]),
    ("fanout", "fanout_mean.cu", FANOUT_VARIANTS, "repro_fanout_mean",
     [_P] * 3 + [_LL] + [_I] * 10 + [_P], [_P] * 3 + [_LL] + [_I] * 3 + [_P]),
)


def prepare(rev, sources=SOURCES):
    """Write the parent's kernel ``sources`` to ``build/parent/``."""
    os.makedirs(PARENT, exist_ok=True)
    for name in sources:
        src = subprocess.run(
            ["git", "show", f"{rev}:src/repro_torch/kernels/csrc/{name}"],
            cwd=ROOT, capture_output=True, text=True, check=True).stdout
        with open(os.path.join(PARENT, name), "w") as f:
            f.write(src)
    print(f"wrote the sources of {rev} to {PARENT}")


def variant_source(kernel, source, name, subs):
    """The text of ``source`` with a variant's substitutions made; each
    must be found."""
    text = open(os.path.join(CSRC, source)).read()
    for old, new in subs:
        cs.check(old in text, f"{kernel} variant {name}: text not in the "
                 f"source")
        text = text.replace(old, new)
    return text


def build_all(kernels=KERNELS, out=OUT):
    """Compile every variant of ``kernels`` (see ``KERNELS``) and the
    parent's kernels into ``out``, all ``nvcc`` processes started
    together; returns ``{(kernel, name): (library, ptxas summary)}``.  A
    variant that fails to build is reported and left out; the committed
    kernels and the parent's must build."""
    from repro_torch.kernels import _build
    os.makedirs(out, exist_ok=True)
    jobs, argtypes = {}, {}
    for kernel, source, variants, symbol, args, parent_args in kernels:
        for name, (_, subs) in variants.items():
            jobs[kernel, name] = variant_source(kernel, source, name, subs)
            argtypes[kernel, name] = symbol, args
        parent = os.path.join(PARENT, source)
        cs.check(os.path.exists(parent), f"{parent} is missing: run "
                 f"--prepare in a git checkout first")
        jobs[kernel, "parent"] = open(parent).read()
        argtypes[kernel, "parent"] = symbol, parent_args
    procs = {}
    for (kernel, name), text in jobs.items():
        path = os.path.join(out, f"{kernel}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[kernel, name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", CSRC, path,
             "-o", path[:-3] + ".so"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            cs.check(name not in ("final", "parent"),
                     f"{kernel} {name} failed to build:\n{log}")
            print(f"{kernel} variant {name} failed to build, left out:\n"
                  f"{log[-2000:]}")
            continue
        lib = ctypes.CDLL(os.path.join(out, f"{kernel}_{name}.so"))
        symbol, args = argtypes[kernel, name]
        getattr(lib, symbol).argtypes = args
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        libs[kernel, name] = (lib, f"registers {regs}, spill stores {spills}")
    return libs


def compact_call(torch, lib, parent, keys, rows, ids, assoc, hit_cap,
                 cluster=None, vec=True, smem=None):
    """A closure that launches one compact-probe variant (outputs allocated
    once); ``cluster`` overrides the plan's S, ``smem`` its shared memory
    (a request above half an SM's keeps one CTA per SM)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_gather import _shift_for, compact_plan
    h, w, r = ids.shape
    c, d = keys.shape[1], rows.shape[2]
    n_words, hc = -(-r // 32), min(hit_cap, r)
    plan = compact_plan(h, w, r, c, _build.sm_count(ids.device))
    if cluster is not None:
        wpc = -(-n_words // cluster)
        plan = plan._replace(cluster=cluster, words_per_cta=wpc,
                             smem=4 * (c + 66 * wpc))
    if smem is not None:
        plan = plan._replace(smem=smem)
    words = torch.empty((h, w, n_words), dtype=torch.int32, device=ids.device)
    raw = torch.empty_like(words)
    payload = torch.empty((h, w, hc, d), dtype=rows.dtype, device=ids.device)
    head = (keys.data_ptr(), rows.data_ptr(), ids.data_ptr(),
            words.data_ptr(), raw.data_ptr(), payload.data_ptr(), h, c, w, r,
            n_words, hc, d, assoc, _shift_for(c // assoc),
            _build.dtype_code(rows))
    tail = () if parent else (plan.cluster, plan.words_per_cta, plan.smem,
                              int(vec))

    def run():
        status = lib.repro_cache_probe_compact(
            *head, *tail, torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"compact launch failed: CUDA error {status}")
        return words, raw, payload
    return run


def fanout_call(torch, lib, parent, x, mask, plan=None):
    """A closure that launches one fanout_mean variant at ``plan`` (the
    committed plan by default)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_reduce import fanout_mean_plan
    m, k, d = x.shape
    plan = plan or fanout_mean_plan(m, k, d, x.element_size(),
                                    n_sm=_build.sm_count(x.device))
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    head = (x.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, d,
            _build.dtype_code(x))
    tail = () if parent else (plan.vec, plan.lanes, plan.ways, plan.rows,
                              *plan.grid, plan.smem)

    def run():
        status = lib.repro_fanout_mean(
            *head, *tail, torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"fanout launch failed: CUDA error {status}")
        return out
    return run


def real_inputs(torch):
    """The main path's inputs: the W = 4 request's items and the W = 4
    train run's probe round."""
    import numpy as np
    from repro_torch.launch import serve, train
    args = cs.serve_args("graphgen-gcn", 4)
    built = serve.build_server(args)
    serve.serve_gcn(args, built)
    server, head_order = built
    rng = np.random.default_rng(11)
    ranks = np.minimum(rng.zipf(1.5, 32 * 4), head_order.size) - 1
    items = cs.request_items(torch, server, server.generate(head_order[ranks]),
                             4)
    res = train.train_gcn(cs.train_args("graphgen-gcn", 4))
    keys, rows, recv, hc = cs.train_probe_round(torch, res, 4)
    items.append(("cache_probe_compact", (keys, rows, recv),
                  {"assoc": res["cache_cfg"].assoc, "hit_cap": hc}))
    torch.cuda.synchronize()
    return [(name, tuple(t.contiguous() for t in ins), kw)
            for name, ins, kw in items]


def turns(torch, fns, timer=cs.gpu_ms):
    """Per closure, its four turns' ``timer`` readings, forward and reverse
    order."""
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in range(4):
        for name in order if turn % 2 == 0 else order[::-1]:
            times[name].append(timer(torch, fns[name]))
    return times


def main():
    """Build, check and time every variant; see the module docstring."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prepare", action="store_true",
                    help="only write the parent's sources to build/parent")
    ap.add_argument("--parent-rev", default="HEAD~1")
    opts = ap.parse_args()
    if opts.prepare:
        prepare(opts.parent_rev)
        return
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_reduce import (FANOUT_THREADS,
                                                   fanout_mean_plan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs = build_all()
    for (kernel, name), (_, regs) in sorted(libs.items()):
        print(f"[build] {kernel} {name}: {regs}")
    items = real_inputs(torch)
    for name, ins, kw in items:
        # the committed kernel through its wrapper: the bound, and the line
        # chip_smoke prints
        entry = cs.time_kernel(torch, name, ins, kw)
        fns, what = {}, {}
        if name == "cache_probe_compact":
            want = ref.cache_probe_compact_ref(*ins, **kw)
            for (kernel, var), (lib, _) in libs.items():
                if kernel != "compact":
                    continue
                fns[var] = compact_call(torch, lib, var == "parent", *ins,
                                        **kw)
                what[var] = ("the parent's kernel (one block per row)"
                             if var == "parent" else COMPACT_VARIANTS[var][0])
            final = libs["compact", "final"][0]
            for s in (1, 2, 4):
                fns[f"S={s}"] = compact_call(torch, final, False, *ins, **kw,
                                             cluster=s)
                what[f"S={s}"] = f"the committed kernel at S = {s}"
            fns["scalar"] = compact_call(torch, final, False, *ins, **kw,
                                         vec=False)
            what["scalar"] = "the committed kernel's scalar route"
            fns["one_per_sm"] = compact_call(torch, final, False, *ins, **kw,
                                             smem=120 * 1024)
            what["one_per_sm"] = ("the committed kernel asking 120 KB of "
                                  "shared memory (one CTA per SM)")
            floor = torch.zeros(1, device=ins[0].device)
            fns["floor"] = floor.zero_
            what["floor"] = "library: a 4-byte zero_(), the timing's floor"
            payload = want[2].clone()
            fns["memset"] = payload.zero_
            what["memset"] = (f"library: payload.zero_() alone "
                              f"({payload.numel() * payload.element_size()} B)")
            if ("compact", "smid") in libs:
                words = fns["smid"]()[0]
                torch.cuda.synchronize()
                wpc = -(-words.shape[-1] // 8)
                sms = words[:, :, ::wpc].reshape(-1).tolist()
                per_sm = collections.Counter(sms)
                print(f"compact at {tuple(ins[2].shape)}: {len(sms)} CTAs on "
                      f"{len(per_sm)} SMs, at most "
                      f"{max(per_sm.values())} on one")
            for var, fn in fns.items():
                if var in UNCHECKED or var in ("memset", "floor"):
                    continue
                for a, b in zip(fn(), want):
                    cs.check(torch.equal(a, b), f"compact {var} differs "
                             f"from its twin at {tuple(ins[2].shape)}")
        else:
            x, mask = ins
            want = ref.fanout_mean_ref(x, mask)
            m, k, d = x.shape
            plan = fanout_mean_plan(m, k, d, x.element_size())
            for (kernel, var), (lib, _) in libs.items():
                if kernel != "fanout":
                    continue
                fns[var] = fanout_call(torch, lib, var == "parent", x, mask)
                what[var] = ("the parent's kernel (one thread per output)"
                             if var == "parent" else FANOUT_VARIANTS[var][0])
            final = libs["fanout", "final"][0]
            unroll_8 = libs.get(("fanout", "unroll_8"), (None,))[0]

            def with_ways(p, ways):
                rows = FANOUT_THREADS // (p.lanes * ways)
                return p._replace(ways=ways, rows=rows,
                                  grid=(-(-m // rows), p.grid[1]),
                                  smem=4 * (FANOUT_THREADS * p.vec
                                            + rows * ways) + rows * k)
            wide = fanout_mean_plan(m, k, d, x.element_size(), n_sm=0)
            plans = [("lanes_32", final, wide,
                      f"lanes {wide.lanes} (no narrowing at small M), ways "
                      f"{wide.ways}"),
                     ("scalar", final, fanout_mean_plan(
                         m, k, d, x.element_size(), aligned=False),
                      "the scalar route (4-byte loads)")]
            for ways in sorted({1, 2, max(plan.ways // 2, 1)} - {plan.ways}):
                p = with_ways(plan, ways)
                text = f"ways {ways}, rows {p.rows} per CTA"
                plans.append((f"ways_{ways}", final, p, text))
                if unroll_8 is not None:
                    plans.append((f"ways_{ways}_u8", unroll_8, p,
                                  text + ", 8 loads in flight"))
            for var, lib, p, text in plans:
                fns[var] = fanout_call(torch, lib, False, x, mask, p)
                what[var] = text
            for var, fn in fns.items():
                got = fn()
                cs.check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                         f"fanout {var} differs from its twin at "
                         f"{tuple(x.shape)}")
            wts = mask.float() / mask.float().sum(1, keepdim=True).clamp(min=1)
            wts = wts[:, None, :].contiguous()
            fns["torch.bmm"] = lambda: torch.bmm(wts, x)      # noqa: E731
            fns["x.sum(1)"] = lambda: x.sum(1)                # noqa: E731
            fns["x.sum()"] = lambda: x.sum()                  # noqa: E731
            what["x.sum()"] = "library: x.sum(), a full reduction of x"
            x2 = torch.empty_like(x)
            fns["copy"] = lambda: x2.copy_(x)                 # noqa: E731
            what["copy"] = "library: a copy of x (reads and writes x's bytes)"
            floor = torch.zeros(1, device=x.device)
            fns["floor"] = floor.zero_
            what["floor"] = "library: a 4-byte zero_(), the timing's floor"
            what["x.sum(1)"] = "library: x.sum(1), a read of x alone"
            what["torch.bmm"] = ("library: bmm of the normalised mask with x "
                                 "(normalisation not timed)")
            what["final"] += (f" (vec {plan.vec}, lanes {plan.lanes}, ways "
                              f"{plan.ways}, rows {plan.rows}, grid "
                              f"{plan.grid})")
        times = turns(torch, fns)
        print(f"{name} at {[tuple(t.shape) for t in ins]} {kw}: bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); ms in four "
              f"turns, median; x the bound")
        for var, ts in times.items():
            med = statistics.median(ts)
            regs = libs.get(("compact" if name.startswith("cache")
                             else "fanout", var), (None, ""))[1]
            print(f"  {var:13s} {med:.4f}  {med / entry['bound_ms']:5.2f}x  "
                  f"{[round(t, 4) for t in ts]}  {what[var]}"
                  f"{'; ' + regs if regs else ''}")
    print(smi)


if __name__ == "__main__":
    main()
