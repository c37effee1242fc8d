#!/usr/bin/env python3
"""The process backend on as many cards as workers: ``chip_smoke.py``'s
``dist``, ``dist paths`` and ``nccl`` phases alone.

With four cards visible, rank ``r`` of a W-worker run takes ``cuda:r``,
so the ``dist`` phase's gloo cells (W = 2, 4) stage through host memory
from separate cards, and the ``nccl`` phase runs the same cells over NCCL
(NVLink between the cards) after its world-size-1 check; every cell is
held to the stacked run of the same flags on ``cuda:0`` by all of
``chip_smoke.dist_cell``'s gates, and prints its median step, bytes per
round and transport share; the ``dist paths`` phase's cells (serve,
the tiered cache, the L3 host store, the export and a warm-started
server, offline, autotune) run the same way, ranks on ``cuda:r``.
Card only, from the repository root (four
cards for the NCCL cells; with fewer it says which it did not run):
``python3 scripts/dist_cards.py``.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    """Build the kernels, run both phases, print their JSON."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        cs.fail("dist_cards.py needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(f"[dist cards] {torch.cuda.device_count()} card(s): {smi}")
    _build.build()
    _build.library()
    dist = cs.phase_dist(torch)
    paths = cs.phase_dist_paths(torch)
    nccl = cs.phase_nccl(torch)
    print(json.dumps({"dist": {f"W={w}": r for w, r in
                               dist["widths"].items()},
                      "dist_paths": {f"W={w}": r for w, r in
                                     paths["widths"].items()},
                      "nccl": nccl["widths"], "cards": smi}))


if __name__ == "__main__":
    main()
