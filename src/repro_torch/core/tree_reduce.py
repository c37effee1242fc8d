"""Tree reduction over the stacked worker axis (paper §2 step 3).

The butterfly of ``repro.core.tree_reduce.tree_allreduce``: at stage
``s`` worker ``i`` exchanges its partial aggregate with partner
``i ^ s`` and merges ``(x_i, x_{i^s})`` in that order, so after
``log2(W)`` stages every worker holds the full reduction.  The merge is
any associative op over pytrees (tuples / NamedTuples) of stacked
``[W, ...]`` tensors; ``generation.merge_topk`` is the sampler's.

``tree_reduce_scatter`` is the reference's recursive halving: each
worker ends with only its own ``1/W`` row segment of the merged result.
"""
from __future__ import annotations

from typing import Callable, TypeVar

import torch

from .collectives import ppermute

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


def tree_allreduce(x: T, merge: Callable[[T, T], T]) -> T:
    """Butterfly allreduce of ``x`` (leaves ``[W, ...]``, ``W`` a power of
    two) using ``merge(own, partner)`` at each stage."""
    size = _first(x).shape[0]
    if size & (size - 1):
        raise ValueError(f"butterfly needs power-of-two axis, got {size}")
    stage = 1
    while stage < size:
        perm = [(i, i ^ stage) for i in range(size)]
        partner = _map(lambda a, p=perm: ppermute(a, p), x)
        x = merge(x, partner)
        stage <<= 1
    return x


def tree_psum(x: T) -> T:
    """Gradient AllReduce as an explicit butterfly of additions."""
    def add(a, b):
        if isinstance(a, tuple):
            leaves = [add(u, v) for u, v in zip(a, b)]
            return (type(a)(*leaves) if hasattr(a, "_fields")
                    else type(a)(leaves))
        return a + b
    return tree_allreduce(x, add)


def tree_reduce_scatter(x: T, merge: Callable[[T, T], T]) -> T:
    """Recursive-halving reduce-scatter along axis 1 of stacked leaves.

    Every leaf is ``[W, F, ...]`` with one ``F`` divisible by ``W`` (a
    power of two).  Stage ``b`` runs from the highest rank bit down:
    worker ``i`` keeps the half of its segment that its bit ``b`` names,
    sends the other half to partner ``i ^ (1 << b)`` and merges ``(keep,
    recv)`` in that order.  Returns ``[W, F / W, ...]``: worker ``i``
    holds the merged rows ``i F/W .. (i+1) F/W`` (the reference's
    big-endian rank-bit segment order)."""
    size = _first(x).shape[0]
    if size & (size - 1):
        raise ValueError(
            f"recursive halving needs power-of-two axis, got {size}")
    seg = x
    for b in reversed(range(size.bit_length() - 1)):
        leaf = _first(seg)
        half = leaf.shape[1] // 2
        # each worker's own rank bit picks its half: a per-worker index
        upper = ((torch.arange(size, device=leaf.device) >> b) & 1).bool()

        def pick(a, mine):
            cond = (upper if mine else ~upper).reshape(
                (size,) + (1,) * (a.dim() - 1))
            return torch.where(cond, a[:, half:], a[:, :half])
        keep = _map(lambda a: pick(a, True), seg)
        send = _map(lambda a: pick(a, False), seg)
        perm = [(i, i ^ (1 << b)) for i in range(size)]
        recv = _map(lambda a, p=perm: ppermute(a, p), send)
        seg = merge(keep, recv)
    return seg
