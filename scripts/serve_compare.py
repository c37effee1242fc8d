#!/usr/bin/env python3
"""The graph-serving cells of ``chip_smoke.py`` for two or more checkouts
on one card.

For each checkout named on the command line, in order, a fresh process
builds that checkout's kernels and runs its own ``chip_smoke.phase_serve``
(graphgen-gcn at W = 1 and W = 4, graphgen-gcn-deep at W = 1: build,
warm-up sweeps, 64 requests each), which prints each cell's p50, p99 and
QPS.  Name the checkouts in turns, e.g. ``parent . . parent parent . .
parent``, to compare two trees on the same card; the summary gives each
tree's QPS per cell in run order and its median.

Usage: ``python3 scripts/serve_compare.py TREE [TREE ...]`` (a TREE is a
directory holding ``chip_smoke.py`` and ``src/repro_torch``, such as an
unpacked ``git archive`` of another commit).
"""
import os
import re
import statistics
import subprocess
import sys

_SERVE = re.compile(r"\[serve (.+?)\] p50 [\d.]+ ms  p99 [\d.]+ ms  "
                    r"QPS ([\d.]+)")


def one(tree):
    """Serve the three cells with the checkout at ``tree``."""
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_serve(torch)


def main():
    """Serve with each named checkout in turn; print the QPS summary."""
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return
    qps = {}
    for tree in sys.argv[1:]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(tree)], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{tree} failed:\n{proc.stdout[-4000:]}"
                     f"{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            m = _SERVE.match(line)
            if m:
                print(f"{tree} {line.split('  launches')[0]}", flush=True)
                qps.setdefault((m.group(1), tree), []).append(
                    float(m.group(2)))
    for (cell, tree), runs in sorted(qps.items()):
        print(f"{cell} {tree}: QPS {runs}, median "
              f"{statistics.median(runs):.2f}")


if __name__ == "__main__":
    main()
