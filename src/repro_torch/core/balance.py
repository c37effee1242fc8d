"""Load-balanced subgraph mapping (paper §2 step 2, Algorithm 1 lines
4-13; numpy, copy of ``repro/core/balance.py``'s ``BalanceTable`` and
``balance_table``).

The coordinator builds a *balance table* mapping seed nodes to workers:
seeds are shuffled, assigned round-robin, and the remainder
``|S| mod |W|`` is **discarded** so every worker owns exactly
``floor(|S|/|W|)`` seeds.  ``rebalance_on_failure`` re-deals the table
over the workers that survive a failure, and ``load_skew`` is the
balance metric (bit-equal copies of the reference's).
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


def rebalance_on_failure(table: BalanceTable, failed: list[int],
                         seed: int = 1) -> BalanceTable:
    """Rebuild the balance table over the surviving workers (Algorithm 1
    re-run with ``|W| - |failed|``): every seed of the table, the failed
    workers' included, is re-dealt round-robin."""
    survivors = [w for w in range(table.n_workers) if w not in set(failed)]
    if not survivors:
        raise RuntimeError("all workers failed")
    all_seeds = table.per_worker.reshape(-1)
    return balance_table(all_seeds, len(survivors), seed=seed)


def load_skew(per_worker_work: np.ndarray) -> float:
    """max/mean worker load — the balance metric of the paper's §3
    (``inf`` when the mean load is 0)."""
    m = float(np.mean(per_worker_work))
    return float(np.max(per_worker_work)) / m if m > 0 else float("inf")
