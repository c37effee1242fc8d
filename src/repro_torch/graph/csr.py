"""CSR graph representation (numpy, copy of ``repro/graph/csr.py``).

The global graph lives host-side as numpy arrays; device-resident
partitions of it are built by ``repro_torch.core.partition``.  All ids are
int32.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed sparse row adjacency: ``indices[indptr[v]:indptr[v+1]]``
    are the out-neighbors of ``v``."""

    indptr: np.ndarray   # [n_nodes + 1] int32 (int64 if E overflows)
    indices: np.ndarray  # [n_edges] int32

    @property
    def n_nodes(self) -> int:
        """Node count (``len(indptr) - 1``)."""
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        """Edge count (``len(indices)``)."""
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        """Out-degree of every node."""
        return np.diff(self.indptr)

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        """Build CSR from an edge list (src -> dst)."""
        order = np.argsort(src, kind="stable")
        src_sorted = src[order]
        dst_sorted = dst[order].astype(np.int32)
        counts = np.bincount(src_sorted, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        if indptr[-1] < np.iinfo(np.int32).max:
            indptr = indptr.astype(np.int32)
        return CSRGraph(indptr=indptr, indices=dst_sorted)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        """``(src, dst)`` arrays of every edge, in CSR order."""
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int32), self.degrees())
        return src, self.indices.copy()
