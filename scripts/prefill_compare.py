#!/usr/bin/env python3
"""An LM's prefill forward of two or more checkouts on one card.

For each checkout named on the command line, in order, a fresh process
builds that checkout's kernels, runs ``zoo.forward_logits`` of the arch
at full width (random weights from seed 0, bf16 compute, flash attention
on for the dense LM) over 8 x 2048 seeded tokens once cold and five
times warm, then profiles one forward, and prints the median warm
forward, tokens/s over the warm forwards, device busy ms, peak memory,
the launch count and every device row of the profile (launches, ms,
kernel name).  Name the checkouts in turns, e.g. ``parent . . parent``,
to compare two trees on the same card.

Usage: ``python3 scripts/prefill_compare.py [--arch ARCH] TREE [TREE
...]`` (ARCH smollm-135m, the default, or mamba2-1.3b; a TREE is a
directory holding ``src/repro_torch``, such as an unpacked ``git
archive`` of another commit).
"""
import os
import statistics
import subprocess
import sys
import time


def one(tree, arch):
    """Run and profile the prefill of ``arch`` in the checkout at
    ``tree``."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import zoo
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _build.library()
    cfg = get_config(arch)
    if cfg.family == "dense":
        cfg = dataclasses.replace(cfg, use_flash_attention=True)
    model = zoo.build(cfg, "cuda").init(0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2048), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        zoo.forward_logits(cfg, model, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        zoo.forward_logits(cfg, model, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[{tree}] median warm forward "
          f"{statistics.median(times[1:]) * 1e3:.3f} ms, "
          f"{8 * 2048 * 5 / sum(times[1:]):.0f} tokens/s over 5 warm "
          f"forwards, device busy {busy:.3f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"{sum(e.count for e in rows)} launches ({arch})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        print(f"[{tree}]   x{e.count:5d} "
              f"{e.self_device_time_total / 1e3:8.4f} ms  {e.key[:140]}")


def main():
    """One fresh process per named checkout, in order."""
    if len(sys.argv) > 3 and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        return
    args, arch = sys.argv[1:], "smollm-135m"
    if args[:1] == ["--arch"]:
        arch, args = args[1], args[2:]
    for tree in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(tree), arch], check=True)


if __name__ == "__main__":
    main()
