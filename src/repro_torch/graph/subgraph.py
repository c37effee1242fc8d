"""Fixed-fanout padded subgraph batches of arbitrary depth (port of
``repro/graph/subgraph.py``).

A batch of ``B`` seeds with fanouts ``(k_1, ..., k_L)`` is:

    seeds      [B]                      int32
    hops[l]    [B, k_1, ..., k_{l+1}]   int32 sampled hop-(l+1) neighbor ids
    masks[l]   [B, k_1, ..., k_{l+1}]   bool, chained down the tree
    x_seed     [B, D]                   float features
    x_hops[l]  [B, k_1, .., k_{l+1}, D] float features, padded slots zeroed
    labels     [B]                      int32
    n_dropped, n_cache_hits, n_cache_misses, n_probe_demoted
               [W]                      int32 per-worker fetch counters

``B`` is the global batch: worker ``w``'s seeds are rows
``w * b .. (w + 1) * b``, the layout ``repro``'s sharded outputs have.
Where each worker runs in its own process (``core/collectives.py``'s
``ProcessWorkers``) a batch holds that worker's ``b`` rows and its
counters ``[1]``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SubgraphBatch(NamedTuple):
    """One generated batch (see the module docstring for the layout)."""
    seeds: torch.Tensor
    hops: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...]
    x_seed: torch.Tensor
    x_hops: Tuple[torch.Tensor, ...]
    labels: torch.Tensor
    n_dropped: torch.Tensor
    n_cache_hits: Optional[torch.Tensor] = None
    n_cache_misses: Optional[torch.Tensor] = None
    n_probe_demoted: Optional[torch.Tensor] = None

    def cache_hit_rate(self) -> float:
        """Fraction of unique feature requests served by the cache."""
        if self.n_cache_hits is None or self.n_cache_misses is None:
            return 0.0
        hits = float(self.n_cache_hits.sum())
        total = hits + float(self.n_cache_misses.sum())
        return hits / total if total else 0.0

    @property
    def batch_size(self) -> int:
        """Seeds in the batch (``B``, the leading axis of every field)."""
        return self.seeds.shape[0]

    @property
    def depth(self) -> int:
        """Sampled hop count ``L``."""
        return len(self.hops)

    @property
    def fanouts(self) -> Tuple[int, ...]:
        """Per-hop fanouts ``(k_1, ..., k_L)`` recovered from the shapes."""
        return tuple(h.shape[-1] for h in self.hops)

    def nodes_per_iteration(self) -> int:
        """Padded node slots materialized per iteration (the paper's
        nodes-per-iteration count)."""
        return self.batch_size * slots_per_seed(self.fanouts)


def slots_per_seed(fanouts: Tuple[int, ...]) -> int:
    """Padded node slots per seed: ``1 + k1 + k1*k2 + ...``."""
    total, level = 1, 1
    for k in fanouts:
        level *= k
        total += level
    return total
