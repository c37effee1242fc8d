#!/usr/bin/env python3
"""Variants of the tensor-core SSD-scan kernel, timed in turns on one
NVIDIA card.

Each variant is ``src/repro_torch/kernels/csrc/ssd_scan_sm90.cu`` with a
few lines substituted (``VARIANTS``), compiled alone into its own shared
library (all ``nvcc`` processes started together), checked against the
twin under the derived gate (``chip_smoke.ssd_gate``) on a few shapes,
then timed (CUDA events, ``chip_smoke.gpu_ms``) in four turns, forward and
reverse order: the mamba2-1.3b prefill shape (B 8, L 2048, H 64, P 64, N
128, chunk 128) and zamba2-1.2b's state of 64, bf16 operands as views of
one conv output.  Diagnostic variants (``UNCHECKED``) change the result
on purpose, to show where the time goes, each by leaving one piece out or
doubling it: the exponentials of the decays, the C B^T products (issued
twice), the wait between the warpgroups over the state copy, the output
store, the x^T load and w scaling of the state update's operand, and the
float64 scan of cum.

Usage, from the repository root: ``python3 scripts/ssd_variants.py``.
"""
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

OUT = os.path.join(ROOT, "build", "ssd_variants")

#: name -> (what it tests, [(text in the kernel source, replacement)])
VARIANTS = {
    "final": ("the kernel as committed", []),
    "serial_state": (
        "warpgroup 0 waits for its state update before the scores (no "
        "overlap of the state's wgmma with the scores)",
        [("""                   sw128_desc(sB + k * L::kTile + ks * 16 * kRowBytes));
      wgmma_commit();
    }""", """                   sw128_desc(sB + k * L::kTile + ks * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
    }""")]),
    "exp2f": (
        "exp2f in place of ex2.approx.ftz for the decays",
        [("exp2_ftz((cum_r[half]", "exp2f((cum_r[half]")]),
    "one_stage": (
        "one x / b / c slot (no prefetch of the next chunk)",
        [("constexpr int kStages = 2;", "constexpr int kStages = 1;")]),
    "no_exp": (
        "diagnostic: decay dt_j alone, no exponential (wrong values)",
        [("exp2_ftz((cum_r[half] - cj.x) * kLog2e) * cj.y", "cj.y")]),
    "twice_cbt": (
        "diagnostic: the C B^T products issued twice (wrong values)",
        [("""               sw128_desc(sB + (ks / 4) * L::kTile + (ks % 4) * 32), ks > 0);
    wgmma_commit();""", """               sw128_desc(sB + (ks / 4) * L::kTile + (ks % 4) * 32), ks > 0);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_ss(g, sw128_desc(cw + (ks / 4) * L::kTile + (ks % 4) * 32),
               sw128_desc(sB + (ks / 4) * L::kTile + (ks % 4) * 32), 1);
    wgmma_commit();""")]),
    "no_cross_wait": (
        "diagnostic: the warpgroups do not wait for each other over the "
        "state copy (races: wrong values)",
        [("      if (kPair && W == 1) bar_sync(kStateReady, 256);\n", ""),
         ("      if (kPair && W == 1 && c < nc - 1) bar_arrive(kStateRead, 256);"
          "\n", ""),
         ("        if (kPair && c > 0) bar_sync(kStateRead, 256);\n", ""),
         ("        if (kPair) bar_arrive(kStateReady, 256);\n", "")]),
    "no_y_store": (
        "diagnostic: no TMA store of y (the output is never written)",
        [("      tma_store(ty, sY, 0, c * Q + 64 * W, h, b);\n", "")]),
    "no_x_w": (
        "diagnostic: no x^T load or w scaling for the state update's A "
        "operand (wrong values)",
        [("ldmatrix_x4_trans(xa[ks], sX + swizzle_offset(j, 2 * warp + m % 2));",
          "xa[ks][0] = xa[ks][1] = xa[ks][2] = xa[ks][3] = j;"),
         ("          xa[ks][q] = scale_pair(xa[ks][q], q < 2 ? w_lo : w_hi);",
          "          xa[ks][q] += q < 2 ? w_lo.x > 0 : w_hi.x > 0;")]),
    "no_scan": (
        "diagnostic: no float64 shuffle scan for cum (wrong values)",
        [("      const double n = __shfl_up_sync(0xffffffffu, v, off);\n"
          "      if (lane >= off) v += n;", "      v += off;")]),
}
#: variants that change the result on purpose: timed, not checked
UNCHECKED = ("no_exp", "twice_cbt", "no_cross_wait", "no_y_store", "no_x_w",
             "no_scan")
SHAPES = ((8, 2048, 64, 64, 128), (8, 2048, 64, 64, 64))
CHECKS = (((1, 256, 2, 64, 128), 128, "small"),
          ((2, 512, 8, 64, 64), 128, "small"),
          ((2, 512, 8, 64, 128), 64, "ref"),
          ((8, 2048, 64, 64, 128), 128, "ref"))


def build_all():
    """Compile every variant; returns ``{name: (ctypes library, ptxas
    summary)}``."""
    from repro_torch.kernels import _build
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    base = open(os.path.join(csrc, "ssd_scan_sm90.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        src = base
        for old, new in subs:
            cs.check(old in src, f"variant {name}: text not in the source")
            src = src.replace(old, new)
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc, path,
             "-o", os.path.join(OUT, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"variant {name} failed:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_ssd_scan_sm90.argtypes = [p] * 6 + [i] * 5 + [ll] * 7 + [p]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        libs[name] = (lib, f"registers {regs}, spill stores {spills}")
    return libs


def launch(torch, lib, x, dt, a, bm, cm, chunk):
    """One launch of a variant's kernel (the wrapper's call, unchecked)."""
    bsz, l, h, p = x.shape
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    status = lib.repro_ssd_scan_sm90(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
        cm.data_ptr(), y.data_ptr(), bsz, l, h, bm.shape[-1], chunk,
        *x.stride()[:3], *bm.stride()[:2], *cm.stride()[:2],
        torch.cuda.current_stream().cuda_stream)
    cs.check(status == 0, f"launch failed: CUDA error {status}")
    return y


def main():
    """Build, check and time every variant; see the module docstring."""
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import ref
    libs = build_all()
    dev = torch.device("cuda")
    for i, (shape, chunk, kind) in enumerate(CHECKS):
        ins = cs.ssd_inputs(torch, dev, shape, kind, seed=60 + i,
                            dtype=torch.bfloat16)
        want = ref.ssd_scan_ref(*ins, chunk=chunk)
        for name, (lib, _) in libs.items():
            if name in UNCHECKED:
                continue
            ok, err, share, _ = cs.ssd_gate(
                torch, ins, chunk, launch(torch, lib, *ins, chunk), want)
            cs.check(ok, f"variant {name} is outside the gate at {shape} "
                     f"chunk {chunk}: max err {err}, {share:.3f} of it")
    print(f"every checked variant within the bf16 gate at {len(CHECKS)} "
          f"shapes")
    for shape in SHAPES:
        ins = cs.ssd_inputs(torch, dev, shape, "ref", seed=1,
                            dtype=torch.bfloat16)
        fns = {name: (lambda lib=lib: launch(torch, lib, *ins, 128))
               for name, (lib, _) in libs.items()}
        times = {name: [] for name in fns}
        order = list(fns)
        for turn in range(4):
            for name in order if turn % 2 == 0 else order[::-1]:
                times[name].append(cs.gpu_ms(torch, fns[name]))
        print(f"shape (B, L, H, P, N) = {shape}, chunk 128, bf16 conv-output "
              f"views; ms in four turns, median")
        for name, ts in times.items():
            print(f"  {name:14s} {statistics.median(ts):.4f}  "
                  f"{[round(t, 4) for t in ts]}  {VARIANTS[name][0]}; "
                  f"{libs[name][1]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
