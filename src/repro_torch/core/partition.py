"""Graph partitioning (paper §2 step 1; numpy, copy of
``repro/core/partition.py``).

Each worker receives a local CSR over the GLOBAL node-id space (only its
edge partition's adjacency is populated), the precondition of
edge-centric generation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph.csr import CSRGraph


@dataclasses.dataclass
class PartitionedGraph:
    """Stacked per-worker local CSRs, padded to common sizes.

    indptr   [W, N+1] int32   local CSR offsets (global node-id space)
    indices  [W, E_pad] int32 local neighbor lists, padded with 0
    n_local  [W] int32        true local edge counts
    """

    indptr: np.ndarray
    indices: np.ndarray
    n_local: np.ndarray
    n_nodes: int

    @property
    def n_workers(self) -> int:
        """Worker count ``W`` (the stacked leading axis)."""
        return self.indptr.shape[0]

    def edge_balance(self) -> float:
        """Max-over-mean local edge count (1.0 = perfectly balanced)."""
        m = self.n_local.mean()
        return float(self.n_local.max() / m) if m > 0 else float("inf")


def partition_edges(
    graph: CSRGraph, n_workers: int, strategy: str = "by_edge_hash"
) -> PartitionedGraph:
    """Split the edge set over ``n_workers``: ``by_edge_hash`` stripes edge
    ids (splits a hot node's edge list), ``by_src_block`` keeps contiguous
    source ranges together."""
    src, dst = graph.edge_list()
    n_edges = len(src)
    if strategy == "by_edge_hash":
        owner = (np.arange(n_edges) % n_workers).astype(np.int32)
    elif strategy == "by_src_block":
        block = -(-graph.n_nodes // n_workers)
        owner = np.minimum(src // block, n_workers - 1).astype(np.int32)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    counts = np.bincount(owner, minlength=n_workers)
    e_pad = int(counts.max()) if n_edges else 1
    indptr = np.zeros((n_workers, graph.n_nodes + 1), dtype=np.int32)
    indices = np.zeros((n_workers, max(e_pad, 1)), dtype=np.int32)
    for w in range(n_workers):
        sel = owner == w
        local = CSRGraph.from_edges(src[sel], dst[sel], graph.n_nodes)
        indptr[w] = local.indptr.astype(np.int32)
        indices[w, : local.n_edges] = local.indices
    return PartitionedGraph(
        indptr=indptr,
        indices=indices,
        n_local=counts.astype(np.int32),
        n_nodes=graph.n_nodes,
    )
