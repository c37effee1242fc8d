#!/usr/bin/env python3
"""A short first call for the SSD-scan kernels on one NVIDIA card.

Builds the port's kernels, prints the tensor-core kernels' build report
(ptxas registers and spills, dynamic shared memory, HGMMA / UTMALDG
counts in their SASS), holds ``ops.ssd_scan`` against its twin at
one-chunk shapes and at ``chip_smoke.SSD_BF16_CHECKS`` (bf16, the
tensor-core route, under the derived gate; x, b and c as views of one
conv output) and at ``chip_smoke.SSD_CHECKS`` (float32, the SIMT route),
printing where a failing check differs (by chunk and by row half of a
chunk), then times both routes at the mamba2-1.3b prefill shape (B 8, L
2048, H 64, P 64, N 128, chunk 128): the bf16 views and their float32
upcast.  Exits nonzero on any failure.

Usage, from the repository root: ``python3 scripts/ssd_bringup.py``.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

#: one-chunk shapes first (a descriptor or swizzle fault shows here, with
#: no carry), then two chunks, then chip_smoke's bf16 checks
SHAPES = (((1, 128, 1, 64, 128), 128, "ref"),
          ((1, 64, 1, 64, 64), 64, "ref"),
          ((1, 128, 1, 64, 64), 128, "ref"),
          ((1, 64, 1, 64, 128), 64, "ref"),
          ((1, 256, 2, 64, 128), 128, "small"),
          ((1, 128, 2, 64, 64), 64, "small"),
          *cs.SSD_BF16_CHECKS)


def where(torch, diff, gate, chunk):
    """Where a bf16 check fails: the largest error over its gate, by chunk
    (first eight) and by 64-row half of a chunk."""
    b, l, h, p = diff.shape
    share = (diff / gate.clamp(min=1e-30)).reshape(b, l // chunk, chunk, h, p)
    by_chunk = share.amax(dim=(0, 2, 3, 4))[:8].tolist()
    halves = share.reshape(b, l // chunk, -1, 64, h, p).amax(
        dim=(0, 1, 3, 4, 5)).tolist()
    return (f"by chunk {[f'{v:.2g}' for v in by_chunk]}, by 64-row part of "
            f"a chunk {[f'{v:.2g}' for v in halves]}")


def main():
    """Build, report, check and time; see the module docstring."""
    import torch
    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import _build, ops, ref
    cs.phase_build_report(_build.build(verbose=True))
    dev = torch.device("cuda")
    failed = []
    for i, (shape, chunk, kind) in enumerate(SHAPES):
        ins = cs.ssd_inputs(torch, dev, shape, kind, seed=40 + i,
                            dtype=torch.bfloat16)
        ops.reset_launch_counts()
        got = ops.ssd_scan(*ins, chunk=chunk)
        torch.cuda.synchronize()
        routes = ops.ssd_route_counts()
        want = ref.ssd_scan_ref(*ins, chunk=chunk)
        ok, err, share, gate = cs.ssd_gate(torch, ins, chunk, got, want)
        ok = ok and routes == {"tensor_core": 1, "float32": 0}
        line = (f"bf16 {shape} chunk {chunk} dt {kind}: "
                f"{'ok' if ok else 'FAILS'} (max abs err {err:.3e}, "
                f"{share:.3f} of the gate; routes {routes})")
        if not ok:
            failed.append(line)
            line += "; " + where(torch, (got.float() - want.float()).abs(),
                                 gate, chunk)
        print(line, flush=True)
    if failed:
        cs.fail(f"{len(failed)} bf16 checks failed:\n" + "\n".join(failed))
    cs.phase_ssd_kernels(torch, dev)

    ins = cs.ssd_inputs(torch, dev, (8, 2048, 64, 64, 128), "ref", seed=1,
                        dtype=torch.bfloat16)
    f32 = tuple(t.float().contiguous() for t in ins)
    for name, operands in (("ssd_scan", ins), ("ssd_scan_f32", f32)):
        entry = cs.time_kernel(torch, name, operands, {"chunk": 128})
        print(f"{name}: {entry['ms']:.4f} ms (bound {entry['bound_ms']:.4f} "
              f"ms, {entry['bound_by']})", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
