#!/usr/bin/env python3
"""A short first call for the flash-attention kernels on one NVIDIA card.

Builds the port's kernels, prints the tensor-core kernel's build report
(ptxas registers and spills, dynamic shared memory, HGMMA / UTMALDG
counts in its SASS), holds ``ops.flash_attention`` against its twin at
``chip_smoke.FLASH_CHECKS`` plus one-tile shapes (bf16 at the bf16 gate,
float32 at 1e-5), and times the kernel against
``scaled_dot_product_attention`` at the smollm-135m prefill shape, passed
as the model's strided views.  Exits nonzero on any failure.

Usage, from the repository root: ``python3 scripts/flash_bringup.py``.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

#: one-tile shapes first (a swizzle or descriptor fault shows here), then
#: chip_smoke's checks: (B, Hq, Hkv, Lq, Lk, Dh, causal, dtype, layout)
SHAPES = ((1, 1, 1, 128, 128, 64, False, "bfloat16", "bhld"),
          (1, 1, 1, 128, 128, 64, True, "bfloat16", "bhld"),
          (1, 1, 1, 128, 128, 128, False, "bfloat16", "bhld"),
          *cs.FLASH_CHECKS)


def main():
    """Build, report, check and time; see the module docstring."""
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import _build, ops, ref
    cs.phase_build_report(_build.build())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for b, hq, hkv, lq, lk, dh, causal, dtype, layout in SHAPES:
        dt = getattr(torch, dtype)
        q = cs.flash_operand(torch, (b, hq, lq, dh), layout, dt, gen, dev)
        k = cs.flash_operand(torch, (b, hkv, lk, dh), layout, dt, gen, dev)
        v = cs.flash_operand(torch, (b, hkv, lk, dh), layout, dt, gen, dev)
        got = ops.flash_attention(q, k, v, causal)
        want = ref.flash_attention_ref(q, k, v, causal)
        ok, err, rel = cs.flash_close(torch, q, k, v, got, want, causal)
        print(f"{(b, hq, hkv, lq, lk, dh)} causal={causal} {dtype} {layout}: "
              f"{'ok' if ok else 'FAILS'} (max abs err {err}, relative "
              f"{rel:.3e})")
        cs.check(ok, "kernel disagrees with its twin")
    q = cs.flash_operand(torch, (8, 9, 2048, 64), "blhd", torch.bfloat16,
                         gen, dev)
    k, v = (cs.flash_operand(torch, (8, 3, 2048, 64), "blhd",
                             torch.bfloat16, gen, dev) for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(f"(8, 9/3, 2048, 64) bf16 causal, strided: kernel "
          f"{cs.gpu_ms(torch, lambda: ops.flash_attention(q, k, v)):.4f} "
          f"ms, scaled_dot_product_attention "
          f"{cs.gpu_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)):.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
