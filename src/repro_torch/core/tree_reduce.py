"""Tree reduction over the stacked worker axis (paper §2 step 3).

The butterfly of ``repro.core.tree_reduce.tree_allreduce``: at stage
``s`` worker ``i`` exchanges its partial aggregate with partner
``i ^ s`` and merges ``(x_i, x_{i^s})`` in that order, so after
``log2(W)`` stages every worker holds the full reduction.  The merge is
any associative op over pytrees (tuples / NamedTuples) of stacked
``[W, ...]`` tensors; ``generation.merge_topk`` is the sampler's.
``tree_reduce_scatter`` waits for a later slice of the port.
"""
from __future__ import annotations

from typing import Callable, TypeVar

from .collectives import ppermute

T = TypeVar("T")


def _map(fn, x):
    """Apply ``fn`` to every tensor leaf of a (Named)tuple or a tensor."""
    if isinstance(x, tuple):
        leaves = [_map(fn, a) for a in x]
        return type(x)(*leaves) if hasattr(x, "_fields") else type(x)(leaves)
    return fn(x)


def _leading(x) -> int:
    """Worker-axis size of the first tensor leaf."""
    while isinstance(x, tuple):
        x = x[0]
    return x.shape[0]


def tree_allreduce(x: T, merge: Callable[[T, T], T]) -> T:
    """Butterfly allreduce of ``x`` (leaves ``[W, ...]``, ``W`` a power of
    two) using ``merge(own, partner)`` at each stage."""
    size = _leading(x)
    if size & (size - 1):
        raise ValueError(f"butterfly needs power-of-two axis, got {size}")
    stage = 1
    while stage < size:
        perm = [(i, i ^ stage) for i in range(size)]
        partner = _map(lambda a, p=perm: ppermute(a, p), x)
        x = merge(x, partner)
        stage <<= 1
    return x
