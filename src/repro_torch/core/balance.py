"""Load-balanced subgraph mapping (paper §2 step 2, Algorithm 1 lines
4-13; numpy, copy of ``repro/core/balance.py``'s ``BalanceTable`` and
``balance_table``).

The coordinator builds a *balance table* mapping seed nodes to workers:
seeds are shuffled, assigned round-robin, and the remainder
``|S| mod |W|`` is **discarded** so every worker owns exactly
``floor(|S|/|W|)`` seeds.  Failure rebalancing and the skew metric wait
for the fleet slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BalanceTable:
    """``per_worker[w]`` is the ``[S/W]`` seed array of worker ``w``;
    ``seed_order`` the shuffled survivor seeds in round-robin order."""

    per_worker: np.ndarray      # [n_workers, seeds_per_worker] int32
    n_discarded: int
    seed_order: np.ndarray

    @property
    def n_workers(self) -> int:
        """Workers the table deals seeds to."""
        return self.per_worker.shape[0]

    @property
    def seeds_per_worker(self) -> int:
        """Seeds each worker owns."""
        return self.per_worker.shape[1]


def balance_table(seeds: np.ndarray, n_workers: int,
                  seed: int = 0) -> BalanceTable:
    """Shuffle ``seeds`` (line 4), keep ``floor(|S|/|W|) * |W|`` of them
    (line 6) and deal them round-robin (line 11).  Bit-equal to
    ``repro.core.balance.balance_table``."""
    if n_workers <= 0:
        raise ValueError("need at least one worker")
    rng = np.random.default_rng(seed)
    shuffled = rng.permutation(np.asarray(seeds, dtype=np.int32))
    per = len(shuffled) // n_workers
    max_i = per * n_workers
    kept = shuffled[:max_i]
    per_worker = kept.reshape(per, n_workers).T.copy()
    return BalanceTable(per_worker=per_worker,
                        n_discarded=len(shuffled) - max_i, seed_order=kept)
