#!/usr/bin/env python3
"""The dense LM's prefill forward of two or more checkouts on one card.

For each checkout named on the command line, in order, a fresh process
builds that checkout's kernels, runs ``zoo.forward_logits`` of
smollm-135m at full width (random weights from seed 0, flash attention
on) over 8 x 2048 seeded tokens once cold and five times warm, then
profiles one forward, and prints the median warm forward, tokens/s over
the warm forwards, device busy ms, the launch count and every device row
of the profile (launches, ms, kernel name).  Name the checkouts in turns,
e.g. ``parent . . parent``, to compare two trees on the same card.

Usage: ``python3 scripts/prefill_compare.py TREE [TREE ...]`` (a TREE is a
directory holding ``src/repro_torch``, such as an unpacked ``git
archive`` of another commit).
"""
import os
import statistics
import subprocess
import sys
import time


def one(tree):
    """Run and profile the prefill of the checkout at ``tree``."""
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
    cfg = dataclasses.replace(get_config("smollm-135m"),
                              use_flash_attention=True)
    model = zoo.build(cfg, "cuda").init(0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2048), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    times = []
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
          f"forwards, device busy {busy:.3f} ms, "
          f"{sum(e.count for e in rows)} launches")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        print(f"[{tree}]   x{e.count:5d} "
              f"{e.self_device_time_total / 1e3:8.4f} ms  {e.key[:140]}")


def main():
    """One fresh process per named checkout, in order."""
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(tree)], check=True)


if __name__ == "__main__":
    main()
