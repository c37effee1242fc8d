"""Collectives over a stacked worker axis (the port's first backend).

``repro`` runs each worker as one ``shard_map`` instance and moves data
between them with ``lax`` collectives.  Here all ``W`` workers live in one
process: every per-worker array carries a leading ``[W, ...]`` axis, and a
collective is a re-indexing of that axis.  The forms below are exactly the
``tiled=True`` / ``split_axis=0, concat_axis=0`` shapes ``repro`` uses, so
a per-worker block of the stacked result equals what worker ``w`` would
receive from ``lax``.  This runs ``W > 1`` on one CPU or one GPU;
a ``torch.distributed`` backend behind the same four names is later work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def axis_index(n_workers: int, device=None) -> torch.Tensor:
    """``lax.axis_index`` for every worker at once: ``[W]`` int32 ranks."""
    return torch.arange(n_workers, dtype=torch.int32, device=device)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Tiled ``lax.all_gather``: ``x [W, n, ...]`` -> ``[W, W*n, ...]``,
    every worker holding the concatenation of all workers' blocks."""
    w = x.shape[0]
    flat = x.reshape((1, w * x.shape[1]) + tuple(x.shape[2:]))
    return flat.expand((w,) + tuple(flat.shape[1:]))


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled ``lax.all_to_all`` (split and concat on axis 0 of each
    worker's block): ``x [W_src, W_dst, ...]`` -> ``[W_dst, W_src, ...]``.

    Worker ``i``'s chunk ``j`` lands on worker ``j`` as chunk ``i`` — a
    transpose of the two leading axes."""
    return x.transpose(0, 1).contiguous()


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``out[dst] = x[src]`` for every ``(src, dst)`` pair
    of ``perm`` (a permutation of the worker axis), zeros elsewhere."""
    src = torch.tensor([s for s, _ in perm], dtype=torch.long, device=x.device)
    dst = torch.tensor([d for _, d in perm], dtype=torch.long, device=x.device)
    out = torch.zeros_like(x)
    out[dst] = x[src]
    return out
