"""Synthetic industrial-graph generators (numpy, copy of
``repro/graph/synthetic.py``; bit-equal for equal seeds).

A Zipf-distributed out-degree sequence realized with a configuration
model, plus optional planted "hot" nodes — the scale-down analogue of
the paper's 530M-node power-law graph.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph


def powerlaw_graph(
    n_nodes: int,
    avg_degree: float = 10.0,
    alpha: float = 2.1,
    n_hot: int = 0,
    hot_degree: int = 0,
    seed: int = 0,
) -> CSRGraph:
    """Directed power-law graph via a configuration model.

    ``n_hot`` nodes are planted with out-degree ``hot_degree`` to stress
    the hot-node aggregation path."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=n_nodes).astype(np.float64)
    raw = np.minimum(raw, n_nodes // 2)
    deg = np.maximum((raw * (avg_degree / raw.mean())).astype(np.int64), 1)
    if n_hot > 0:
        hot_ids = rng.choice(n_nodes, size=n_hot, replace=False)
        deg[hot_ids] = hot_degree or max(int(deg.max() * 10), 100)
    src = np.repeat(np.arange(n_nodes, dtype=np.int32), deg)
    dst = rng.integers(0, n_nodes, size=len(src), dtype=np.int32)
    return CSRGraph.from_edges(src, dst, n_nodes)


def node_features(n_nodes: int, dim: int, seed: int = 0, *,
                  features_on_host: bool = False,
                  chunk_rows: int = 1 << 16) -> np.ndarray:
    """Synthetic [n_nodes, dim] float32 feature table.

    With ``features_on_host=True`` (the L3 host store's table) it is
    drawn in ``chunk_rows``-row chunks into one preallocated array, so
    the peak is the table plus one chunk; sequential chunk draws consume
    the generator exactly like one full draw, so the result is
    bit-identical for every chunk size."""
    rng = np.random.default_rng(seed + 1)
    if not features_on_host:
        return rng.standard_normal((n_nodes, dim), dtype=np.float32) * 0.1
    out = np.empty((n_nodes, dim), np.float32)
    for lo in range(0, n_nodes, chunk_rows):
        hi = min(lo + chunk_rows, n_nodes)
        out[lo:hi] = rng.standard_normal((hi - lo, dim), dtype=np.float32)
    out *= np.float32(0.1)
    return out


def node_labels(n_nodes: int, n_classes: int, seed: int = 0) -> np.ndarray:
    """Synthetic [n_nodes] int32 class labels in ``[0, n_classes)``."""
    rng = np.random.default_rng(seed + 2)
    return rng.integers(0, n_classes, size=n_nodes, dtype=np.int32)
