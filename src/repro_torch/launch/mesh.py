"""Worker groups and the process launcher (the counterpart of
``repro/launch/mesh.py``'s ``make_mesh`` and ``make_local_mesh``).

* ``make_local_group(w, device)`` is ``make_local_mesh``: the stacked
  group of ``w`` workers in this process (``--dist none``).
* ``make_group(backend, world, rank, device, init_method)`` joins a
  ``torch.distributed`` process group (``gloo`` or ``nccl``) and returns
  the worker's ``ProcessWorkers``; ``join_from_env`` does so from the
  environment a launcher set: ``RANK`` and ``WORLD_SIZE`` with
  ``REPRO_DIST_FILE`` (this module's launcher: a ``FileStore`` in a
  temporary directory, so concurrent runs never contend for a port) or
  ``MASTER_ADDR``/``MASTER_PORT`` (``torchrun``: ``env://``).
* ``spawn(argv, world, timeout_s)`` is the launcher: ``world`` copies of
  ``python argv...``, one per rank, joined with a timeout; a child that
  fails or outlives the timeout ends the rest, and the call returns
  non-zero.
* ``python -m repro_torch.launch.mesh --workers W --dist gloo --device
  cpu module:function ['{"kwarg": ...}']`` runs ``function(group,
  **kwargs)`` on every rank (``run`` is the same from Python).
* ``launch_or_join(module, argv, args, body)`` is the ``--dist`` half of
  the train and serve launchers' ``main``: spawn the ranks, or, in a
  rank, join the group and run ``body(group)``.

Rank ``r`` takes ``cuda:r`` when at least ``W`` cards are visible and
``cuda:0`` otherwise (gloo only: NCCL refuses two ranks on one card, so
``--dist nccl`` with fewer cards than workers raises); ``--device cpu``
keeps every rank on the CPU.  Every entry point here takes the card
unless its caller names the CPU.  ``make_production_mesh`` waits for ROADMAP
Queue 1 item 7.4.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..core.collectives import ProcessWorkers, StackedGroup
from ..core.config import resolve_device

#: ``--dist`` choices: ``none`` is the stacked group in one process
DIST_BACKENDS = ("none", "gloo", "nccl")
#: seconds ``init_process_group`` (and every collective) waits for peers
INIT_TIMEOUT_S = 120
#: the launcher's rendezvous file
ENV_STORE = "REPRO_DIST_FILE"
_SRC = str(Path(__file__).resolve().parents[2])


def make_local_group(n_workers: int = 1, device="cuda") -> StackedGroup:
    """The stacked group of ``n_workers`` workers in this process, on the
    card unless ``device`` says otherwise (``resolve_device`` raises where
    no card is present: the group never drops to the CPU on its own)."""
    return StackedGroup(n_workers, resolve_device(device))


def check_backend(backend: str, world: int, device) -> None:
    """Refuse a backend this machine cannot run, before any work: an
    unknown name, and ``nccl`` off the card or with fewer visible cards
    than workers (it never becomes gloo on its own)."""
    if backend not in DIST_BACKENDS[1:]:
        raise ValueError(f"process backend must be one of "
                         f"{DIST_BACKENDS[1:]}, got {backend!r}")
    if world < 1:
        raise ValueError(f"need at least one worker, got {world}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("--dist nccl moves device tensors: it needs "
                         "--device cuda (use --dist gloo on the CPU)")
    resolve_device(device)
    n = torch.cuda.device_count()
    if n < world:
        raise RuntimeError(
            f"--dist nccl needs one card per worker: --workers {world}, "
            f"{n} card(s) visible (NCCL refuses two ranks of one "
            f"communicator on one card); use --dist gloo, which stages "
            f"through host memory")


def rank_device(device, world: int, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU for ``cpu``; ``cuda:rank`` when
    ``world`` cards are visible, else ``cuda:0``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if torch.cuda.device_count() >= world
                        else 0)


def make_group(backend: str, world: int, rank: int, device,
               init_method: str,
               timeout_s: float = INIT_TIMEOUT_S) -> ProcessWorkers:
    """Join the process group as ``rank`` of ``world`` and return its
    ``ProcessWorkers`` on ``rank_device``."""
    import torch.distributed as dist
    check_backend(backend, world, device)
    dev = rank_device(device, world, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessWorkers(backend, world, rank, dev)


def launched() -> bool:
    """True in a process a launcher started (``RANK`` and ``WORLD_SIZE``
    set, as this module's ``spawn`` and ``torchrun`` do)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_from_env(backend: str, device, world=None) -> ProcessWorkers:
    """Join the group the launcher set up (see the module docstring);
    ``world``, when given, must equal ``WORLD_SIZE``."""
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world is not None and world != size:
        raise ValueError(f"--workers {world} but WORLD_SIZE={size}")
    path = os.environ.get(ENV_STORE)
    if path:
        init = f"file://{path}"
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init = "env://"
    else:
        raise RuntimeError(f"RANK is set but neither {ENV_STORE} nor "
                           f"MASTER_ADDR/MASTER_PORT says where to meet")
    return make_group(backend, size, rank, device, init)


def close(group) -> None:
    """Leave a process group (nothing to do for the stacked one)."""
    if isinstance(group, ProcessWorkers):
        import torch.distributed as dist
        dist.destroy_process_group()


def spawn(argv, world: int, timeout_s: float, env=None) -> int:
    """Run ``python argv...`` once per rank, with ``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE`` and a fresh rendezvous file set and
    this package on ``PYTHONPATH``; wait for all of them.

    Returns 0 when every rank exits 0.  The first rank to exit non-zero
    ends the others and its code is returned; past ``timeout_s`` every
    rank is ended and 124 is returned.  No child outlives the call."""
    tmp = tempfile.mkdtemp(prefix="repro_dist_")
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_SRC, base.get("PYTHONPATH", "")) if p)
    base[ENV_STORE] = os.path.join(tmp, "store")
    base["WORLD_SIZE"] = str(world)
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, *argv],
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                print(f"launcher: ranks still running after {timeout_s}s; "
                      f"ending them", file=sys.stderr)
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def launch_or_join(module: str, argv, args, body) -> None:
    """The ``--dist gloo|nccl`` half of a launcher's ``main``
    (``args.dist``, ``args.workers``, ``args.device``,
    ``args.dist_timeout``): in a rank (``launched()``) join the group and
    call ``body(group)``; otherwise build the kernels once on a card and
    spawn ``python -m module argv...`` once per rank, exiting non-zero if
    any rank fails or outlives the timeout."""
    check_backend(args.dist, args.workers, args.device)
    if launched():
        group = join_from_env(args.dist, args.device, world=args.workers)
        try:
            body(group)
        finally:
            close(group)
        return
    cuda = torch.device(args.device).type == "cuda"
    print(f"--dist {args.dist}: {args.workers} worker processes on "
          f"{args.device}"
          + ("; gloo stages every collective's CUDA blocks through host "
             "memory" if cuda and args.dist == "gloo" else ""), flush=True)
    if cuda:
        from ..kernels import _build
        _build.build()          # once, before the ranks load it
    rc = spawn(["-m", module, *argv], args.workers, args.dist_timeout)
    if rc:
        raise SystemExit(f"--dist {args.dist}: a rank failed (exit {rc})")


def run(target: str, world: int, backend: str = "gloo", device="cuda",
        kwargs=None, timeout_s: float = 600, env=None) -> int:
    """``spawn`` of this module's runner: ``target`` (``module:function``)
    called as ``function(group, **kwargs)`` on every rank; returns the
    launcher's code.  The ranks take the card unless ``device`` says
    otherwise; ``resolve_device`` refuses ``cuda`` here, before any rank
    starts, where no card is present."""
    resolve_device(device)
    argv = ["-m", "repro_torch.launch.mesh", "--workers", str(world),
            "--dist", backend, "--device", str(device), target,
            json.dumps(kwargs or {})]
    return spawn(argv, world, timeout_s, env)


def _call(target: str, group, kwargs: dict):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)(group, **kwargs)


def main(argv=None) -> None:
    """CLI entry of the runner (see the module docstring)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, required=True)
    ap.add_argument("--dist", default="gloo", choices=DIST_BACKENDS[1:])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds the launcher waits for every rank")
    ap.add_argument("target", help="module:function, called as "
                                   "function(group, **kwargs)")
    ap.add_argument("kwargs", nargs="?", default="{}",
                    help="JSON object of keyword arguments")
    args = ap.parse_args(argv)
    check_backend(args.dist, args.workers, args.device)
    if not launched():
        raise SystemExit(spawn(["-m", "repro_torch.launch.mesh", *argv],
                               args.workers, args.timeout))
    group = join_from_env(args.dist, args.device, world=args.workers)
    try:
        _call(args.target, group, json.loads(args.kwargs))
    finally:
        close(group)


if __name__ == "__main__":
    main()
