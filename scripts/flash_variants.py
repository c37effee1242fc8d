#!/usr/bin/env python3
"""Variants of the tensor-core flash-attention kernel, timed in turns on
one NVIDIA card.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu``
with a few lines substituted (``VARIANTS``), compiled alone into its own
shared library (all ``nvcc`` processes started together), checked against
the twin at the bf16 gate of ``chip_smoke.flash_close`` on a few shapes,
then timed (CUDA events, ``chip_smoke.gpu_ms``) in four turns, forward
and reverse order, beside ``scaled_dot_product_attention`` on the same
operands: the smollm-135m prefill shape (8, 9/3, 2048, 64), (8, 16/4,
2048, 128) and stablelm-12b's layer-0 shape (8, 32/8, 2048, 160),
causal, bf16, as strided [B, L, H, Dh] views.  A variant that disagrees
with the twin is reported and left out of the timing; the script exits
nonzero at the end if the committed kernel ("final") disagrees.

Usage, from the repository root: ``python3 scripts/flash_variants.py``.
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

OUT = os.path.join(ROOT, "build", "flash_variants")

#: name -> (what it tests, [(text in the kernel source, replacement)])
VARIANTS = {
    "final": ("the kernel as committed", []),
    "no_overlap": (
        "softmax of S_t waits for P V of t-1 too (no overlap)",
        [("      wgmma_wait<1>();", "      wgmma_wait<0>();")]),
    "two_consumers": (
        "two consumer warpgroups (128-row tiles), setmaxnreg 24 / 240",
        [("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
         ("kProducerRegs = 32;", "kProducerRegs = 24;"),
         ("kConsumerRegs = 160;", "kConsumerRegs = 240;")]),
    "three_stages": (
        "three K and V slots",
        [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "keys64": (
        "64-key tiles at Dh 64 too",
        [("kN = DH == 64 ? 128 : 64;", "kN = 64;")]),
    "rescale_skip": (
        "skip O *= alpha when no row max of the warp moved",
        [("""#pragma unroll
      for (int c = 0; c < T::kFull; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];""",
          """      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int c = 0; c < T::kFull; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];""")]),
    "tail_n64": (
        "Dh 160's last 32 columns as an n64 product over the padded box",
        [("static constexpr int kTailN = kTail;",
          "static constexpr int kTailN = kTail ? 64 : 0;")]),
}
SHAPES = ((8, 9, 3, 2048, 2048, 64), (8, 16, 4, 2048, 2048, 128),
          (8, 32, 8, 2048, 2048, 160))
CHECKS = ((1, 1, 1, 128, 128, 64, False), (2, 9, 3, 192, 320, 64, True),
          (1, 4, 2, 320, 448, 128, True), (8, 9, 3, 2048, 2048, 64, True),
          (1, 1, 1, 128, 128, 160, False), (1, 4, 2, 320, 448, 160, True),
          (2, 32, 8, 1024, 1024, 160, True))


def build_all():
    """Compile every variant; returns ``{name: (ctypes library, ptxas
    summary)}``."""
    from repro_torch.kernels import _build
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    base = open(os.path.join(csrc, "flash_attention_sm90.cu")).read()
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
        lib.repro_flash_attention_sm90.argtypes = (
            [p] * 4 + [i] * 7 + [ctypes.c_float] + [ll] * 12 + [p])
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        libs[name] = (lib, f"registers {regs}, spill stores {spills}")
    return libs


def launch(torch, lib, q, k, v, causal=True):
    """One launch of a variant's kernel (the wrapper's call, unchecked)."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty((b, lq, hq, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    status = lib.repro_flash_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, lq, lk, dh, int(causal), 1.0 / dh ** 0.5, *strides,
        torch.cuda.current_stream().cuda_stream)
    cs.check(status == 0, f"launch failed: CUDA error {status}")
    return out


def main():
    """Build, check and time every variant; see the module docstring."""
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import ref
    libs = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def operands(b, hq, hkv, lq, lk, dh):
        return tuple(cs.flash_operand(torch, (b, h, l, dh), "blhd",
                                      torch.bfloat16, gen, dev)
                     for h, l in ((hq, lq), (hkv, lk), (hkv, lk)))
    wrong = set()
    for shape in CHECKS:
        q, k, v = operands(*shape[:6])
        want = ref.flash_attention_ref(q, k, v, shape[6])
        for name, (lib, _) in libs.items():
            ok, err, _ = cs.flash_close(
                torch, q, k, v, launch(torch, lib, q, k, v, shape[6]), want,
                shape[6])
            print(f"{name} at {shape}: {'ok' if ok else 'FAILS'} (max abs "
                  f"err {err})")
            if not ok:
                wrong.add(name)
    for name in wrong:
        del libs[name]
    print(f"within the bf16 gate at {len(CHECKS)} shapes: {sorted(libs)}; "
          f"disagreeing: {sorted(wrong)}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in SHAPES:
        q, k, v = operands(*shape)
        fns = {name: (lambda lib=lib: launch(torch, lib, q, k, v))
               for name, (lib, _) in libs.items()}
        fns["sdpa"] = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        times = {name: [] for name in fns}
        order = list(fns)
        for turn in range(4):
            for name in order if turn % 2 == 0 else order[::-1]:
                times[name].append(cs.gpu_ms(torch, fns[name]))
        print(f"shape (B, Hq, Hkv, Lq, Lk, Dh) = {shape}, causal, bf16, "
              f"strided; ms in four turns, median")
        for name, ts in times.items():
            what = VARIANTS[name][0] if name in VARIANTS else \
                "scaled_dot_product_attention (enable_gqa)"
            extra = f"; {libs[name][1]}" if name in libs else ""
            print(f"  {name:14s} {statistics.median(ts):.4f}  "
                  f"{[round(t, 4) for t in ts]}  {what}{extra}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cs.check("final" not in wrong, "the committed kernel disagrees")


if __name__ == "__main__":
    main()
