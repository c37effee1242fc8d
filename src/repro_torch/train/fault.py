"""Worker failure and recovery for the generation and training fleet
(the port of ``repro/train/fault.py``; numpy and Python only).

A lost worker means the job restarts on the surviving workers from the
last checkpoint:

* ``FailureInjector`` — deterministic fault simulation (a worker dies at
  step k);
* ``recover_assignment`` — re-runs Algorithm 1's balance table over the
  survivors, so every remaining worker gets an equal seed share;
* ``run_with_recovery`` — the supervision loop: run, and on a failure
  rebalance, restore the latest checkpoint and continue.

Straggler mitigation for producers on the host is speculative
re-execution in ``data.loader.PrefetchLoader``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..core.balance import BalanceTable, balance_table


class WorkerFailure(RuntimeError):
    """Worker ``worker`` failed at step ``step``."""

    def __init__(self, worker: int, step: int):
        super().__init__(f"worker {worker} failed at step {step}")
        self.worker = worker
        self.step = step


@dataclasses.dataclass
class FailureInjector:
    """Raises ``WorkerFailure(fail_worker or 0, step)`` once, at the first
    ``check(step)`` with ``step >= fail_at_step``."""
    fail_worker: Optional[int] = None
    fail_at_step: Optional[int] = None
    _tripped: bool = False

    def check(self, step: int) -> None:
        """Raise the injected failure if it is due and has not fired."""
        if (not self._tripped and self.fail_at_step is not None
                and step >= self.fail_at_step):
            self._tripped = True
            raise WorkerFailure(self.fail_worker or 0, step)


def recover_assignment(table: BalanceTable, failed: list[int],
                       seed: int = 1) -> BalanceTable:
    """Rebuild the balance table over the survivors (Algorithm 1 with
    ``|W| - f`` workers)."""
    survivors = [w for w in range(table.n_workers) if w not in set(failed)]
    if not survivors:
        raise RuntimeError("no surviving workers")
    pool = table.per_worker.reshape(-1)
    return balance_table(pool, len(survivors), seed=seed)


def run_with_recovery(run_steps: Callable[[int, int, BalanceTable], int],
                      table: BalanceTable, total_steps: int,
                      restore_step: Callable[[], int],
                      max_failures: int = 3):
    """Supervision loop.  ``run_steps(start, end, table)`` trains and may
    raise ``WorkerFailure``; ``restore_step()`` returns the last durable
    step.  Returns ``(completed_steps, failures_handled, final_table)``."""
    failures = 0
    step = 0
    while step < total_steps:
        try:
            step = run_steps(step, total_steps, table)
        except WorkerFailure as f:
            failures += 1
            if failures > max_failures:
                raise
            table = recover_assignment(table, [f.worker], seed=failures)
            step = restore_step()
    return step, failures, table
