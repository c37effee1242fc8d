"""The whole dry-run sweep (the counterpart of ``repro/launch/sweep.py``):
every assigned arch x every shape on the single-pod 16x16 mesh and the
multi-pod 2x16x16 mesh, plus the paper's GCN cell on both, one fresh
subprocess per cell (one bad cell cannot end the sweep), each record
appended to ``--out``; a cell that fails or outlives ``--timeout`` is
recorded with its status (``error``, ``timeout``).

    PYTHONPATH=src python -m repro_torch.launch.sweep --out dryrun_results.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def cells():
    """``(arch, shape, multi_pod)`` of every cell, in the reference's
    order."""
    from ..configs import ASSIGNED_ARCHS
    from ..core.config import SHAPES
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            for multi_pod in (False, True):
                yield arch, shape, multi_pod
    # the paper's own workload (530M nodes / 5B edges GCN pipeline)
    yield "graphgen-gcn", "train_4k", False
    yield "graphgen-gcn", "train_4k", True


def _mesh(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, out: str,
             timeout: int) -> dict:
    """Trace one cell in a subprocess (``launch/dryrun.py`` appends its
    record to ``out``); a failure or a timeout appends a record of its
    own.  Returns ``{"status", "wall_s"}``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=dict(os.environ))
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "mesh": _mesh(multi_pod),
               "status": "timeout", "wall_s": timeout}
    else:
        if proc.returncode == 0:
            return {"status": "ok", "wall_s": round(time.time() - t0, 1)}
        rec = {"arch": arch, "shape": shape, "mesh": _mesh(multi_pod),
               "status": "error", "stderr_tail": proc.stderr[-2000:],
               "wall_s": round(time.time() - t0, 1)}
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def main(argv=None) -> None:
    """CLI entry (module docstring); ``--only-missing`` skips the cells
    ``--out`` already holds as ``ok`` or ``skipped``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--only-missing", action="store_true")
    args = ap.parse_args(argv)
    done = set()
    if args.only_missing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    todo = list(cells())
    for i, (arch, shape, multi_pod) in enumerate(todo):
        if (arch, shape, _mesh(multi_pod)) in done:
            continue
        r = run_cell(arch, shape, multi_pod, args.out, args.timeout)
        print(f"[{i + 1}/{len(todo)}] {arch} {shape} {_mesh(multi_pod)}: "
              f"{r['status']} ({r.get('wall_s', '?')}s)", flush=True)


if __name__ == "__main__":
    main()
