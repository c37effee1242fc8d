"""The workers' gradient sync (port of the sync half of
``repro/train/train_loop.py``; its LM step builder ``make_train_step``
waits for ROADMAP Queue 1 item 6.3).

``repro`` leaves the gradient AllReduce to the SPMD partitioner
(``grad_sync="psum"``) or routes it through an explicit butterfly
(``"tree"``, ``make_shardmap_grad_sync``).  Here the stacked group needs
neither: one process holds every worker and differentiates the global
mean loss.  Where each worker runs in its own process
(``core/collectives.py``'s ``ProcessWorkers``), every rank
differentiates the mean over its own seeds and the sync averages the
gradients: the group's ``all_reduce`` (``psum``) or ``tree_psum`` over the
group (``tree``), each then divided by the worker count.  The sync runs
before the optimizer's global-norm clip, which must see the global
gradient.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..core.collectives import WorkerGroup
from ..core.config import GRAD_SYNC_MODES
from ..core.tree_reduce import tree_psum


def make_grad_sync(group: WorkerGroup, mode: str = "psum"
                   ) -> Callable[[Sequence[torch.Tensor]], List[torch.Tensor]]:
    """``sync(blocks) -> blocks``: per-worker ``[L, ...]`` gradient blocks
    in, every worker's block holding the mean over all ``W`` workers out
    (``psum``: the group's ``all_reduce``; ``tree``: the butterfly of
    additions, then ``/ W`` as in ``make_shardmap_grad_sync``)."""
    if mode not in GRAD_SYNC_MODES:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNC_MODES}, "
                         f"got {mode!r}")

    def sync(blocks):
        if mode == "psum":
            summed = [group.all_reduce(b) for b in blocks]
        else:
            summed = list(tree_psum(tuple(blocks), group))
        return [s / group.world for s in summed]
    return sync


def make_step_sync(group: WorkerGroup, mode: str = "psum"
                   ) -> Callable[..., Tuple[List[torch.Tensor], torch.Tensor]]:
    """``sync(grads, loss) -> (grads, loss)`` for one process's step: its
    gradients and its loss packed into ONE flat block, averaged over the
    workers by ``make_grad_sync`` (one collective, or one butterfly),
    and unpacked.  The loss comes back as the global mean."""
    sync = make_grad_sync(group, mode)

    def step_sync(grads, loss):
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        out = sync([flat[None]])[0][0]
        parts = torch.split(out, [g.numel() for g in grads] + [1])
        return ([p.reshape(g.shape) for p, g in zip(parts, grads)],
                parts[-1][0])
    return step_sync
