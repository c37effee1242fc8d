"""Tree reduction over a worker group (paper §2 step 3).

The butterfly of ``repro.core.tree_reduce.tree_allreduce``: at stage
``s`` worker ``i`` exchanges its partial aggregate with partner
``i ^ s`` and merges ``(x_i, x_{i^s})`` in that order, so after
``log2(W)`` stages every worker holds the full reduction.  The merge is
any associative op over pytrees (tuples / NamedTuples) of per-worker
``[L, ...]`` blocks; ``generation.merge_topk`` is the sampler's.  The
exchanges are ``group.ppermute`` (``core/collectives.py``), so the same
code runs on the stacked axis (``group`` None: ``L = W``, the leading
axis) and as one process per worker (``L = 1``).

``tree_reduce_scatter`` is the reference's recursive halving: each
worker ends with only its own ``1/W`` row segment of the merged result.
"""
from __future__ import annotations

from typing import Callable, Optional, TypeVar

import torch

from .collectives import WorkerGroup, stacked

T = TypeVar("T")


def _map(fn, x):
    """Apply ``fn`` to every tensor leaf of a (Named)tuple or a tensor."""
    if isinstance(x, tuple):
        leaves = [_map(fn, a) for a in x]
        return type(x)(*leaves) if hasattr(x, "_fields") else type(x)(leaves)
    return fn(x)


def _first(x) -> torch.Tensor:
    """The first tensor leaf."""
    while isinstance(x, tuple):
        x = x[0]
    return x


def _world(x, group: Optional[WorkerGroup], what: str) -> WorkerGroup:
    """``group``, or the stacked group of ``x``'s leading axis; refuses a
    world that is not a power of two (on every rank, before any
    exchange)."""
    group = stacked(_first(x)) if group is None else group
    size = group.world
    if size & (size - 1):
        raise ValueError(f"{what} needs power-of-two axis, got {size}")
    return group


def tree_allreduce(x: T, merge: Callable[[T, T], T],
                   group: Optional[WorkerGroup] = None) -> T:
    """Butterfly allreduce of ``x`` (leaves ``[L, ...]``, ``W`` a power of
    two) using ``merge(own, partner)`` at each stage."""
    group = _world(x, group, "butterfly")
    size = group.world
    stage = 1
    while stage < size:
        perm = [(i, i ^ stage) for i in range(size)]
        partner = _map(lambda a, p=perm: group.ppermute(a, p), x)
        x = merge(x, partner)
        stage <<= 1
    return x


def tree_psum(x: T, group: Optional[WorkerGroup] = None) -> T:
    """Gradient AllReduce as an explicit butterfly of additions."""
    def add(a, b):
        if isinstance(a, tuple):
            leaves = [add(u, v) for u, v in zip(a, b)]
            return (type(a)(*leaves) if hasattr(a, "_fields")
                    else type(a)(leaves))
        return a + b
    return tree_allreduce(x, add, group)


def tree_reduce_scatter(x: T, merge: Callable[[T, T], T],
                        group: Optional[WorkerGroup] = None) -> T:
    """Recursive-halving reduce-scatter along axis 1 of stacked leaves.

    Every leaf is ``[L, F, ...]`` with one ``F`` divisible by ``W`` (a
    power of two).  Stage ``b`` runs from the highest rank bit down:
    worker ``i`` keeps the half of its segment that its bit ``b`` names,
    sends the other half to partner ``i ^ (1 << b)`` and merges ``(keep,
    recv)`` in that order.  Returns ``[L, F / W, ...]``: worker ``i``
    holds the merged rows ``i F/W .. (i+1) F/W`` (the reference's
    big-endian rank-bit segment order)."""
    group = _world(x, group, "recursive halving")
    size = group.world
    seg = x
    for b in reversed(range(size.bit_length() - 1)):
        leaf = _first(seg)
        half = leaf.shape[1] // 2
        # each worker's own rank bit picks its half: a per-worker index
        upper = ((group.axis_index(leaf.device) >> b) & 1).bool()

        def pick(a, mine):
            cond = (upper if mine else ~upper).reshape(
                (a.shape[0],) + (1,) * (a.dim() - 1))
            return torch.where(cond, a[:, half:], a[:, :half])
        keep = _map(lambda a: pick(a, True), seg)
        send = _map(lambda a: pick(a, False), seg)
        perm = [(i, i ^ (1 << b)) for i in range(size)]
        recv = _map(lambda a, p=perm: group.ppermute(a, p), send)
        seg = merge(keep, recv)
    return seg
