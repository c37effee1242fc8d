"""The port's fleet recovery against ``repro``: ``rebalance_on_failure``
and ``load_skew`` (``core/balance.py``), ``FailureInjector``,
``recover_assignment`` and ``run_with_recovery`` (``train/fault.py``)
and ``PrefetchLoader`` (``data/loader.py``).  Every table is held to the
reference's exactly (numpy in both packages); the loader cases are the
reference's own, with its sleeps and timeouts."""
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import balance as jbal  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro_torch.core.balance import (balance_table, load_skew,  # noqa: E402
                                      rebalance_on_failure)
from repro_torch.data import PrefetchLoader  # noqa: E402
from repro_torch.train import fault as tfault  # noqa: E402
from repro_torch.train.fault import (FailureInjector,  # noqa: E402
                                     WorkerFailure, recover_assignment,
                                     run_with_recovery)


def _same_table(a, b):
    """Two balance tables equal in every field."""
    np.testing.assert_array_equal(a.per_worker, b.per_worker)
    np.testing.assert_array_equal(a.seed_order, b.seed_order)
    assert a.n_discarded == b.n_discarded
    assert a.per_worker.dtype == b.per_worker.dtype


@pytest.mark.parametrize("n,w,failed,seed", [
    (120, 6, [2, 4], 1),        # the reference's table
    (103, 8, [3, 6], 1),        # a remainder discarded again
    (96, 8, [0], 2),
    (50, 3, [1, 2], 5),         # one survivor
])
def test_rebalance_on_failure_matches_reference(n, w, failed, seed):
    """The survivors' table equals the reference's, deals equal shares
    and re-deals only seeds of the original pool."""
    t = balance_table(np.arange(n), w, seed=0)
    _same_table(t, jbal.balance_table(np.arange(n), w, seed=0))
    got = rebalance_on_failure(t, failed, seed=seed)
    _same_table(got, jbal.rebalance_on_failure(
        jbal.balance_table(np.arange(n), w, seed=0), failed, seed=seed))
    assert got.n_workers == w - len(failed)
    assert set(got.per_worker.reshape(-1)) <= set(t.per_worker.reshape(-1))


def test_rebalance_all_failed_raises():
    """Every worker lost: both packages raise."""
    t = balance_table(np.arange(10), 2, seed=0)
    with pytest.raises(RuntimeError):
        rebalance_on_failure(t, failed=[0, 1])
    with pytest.raises(RuntimeError):
        recover_assignment(t, failed=[0, 1])


@pytest.mark.parametrize("work", [[5, 5, 5, 5], [1, 2, 3, 10], [0, 0, 0],
                                  [7], [0, 4]])
def test_load_skew_matches_reference(work):
    """max/mean load, ``inf`` at zero mean, as the reference computes."""
    got, want = (load_skew(np.array(work)),
                 jbal.load_skew(np.array(work)))
    assert got == want


def test_failure_injector_and_recovery_loop():
    """A worker lost at step 7 of 20: one failure handled, the run
    restarts from the last checkpoint on 7 workers, and the final table
    equals the reference's supervision loop's."""
    def run(mod, table):
        injector = mod.FailureInjector(fail_worker=3, fail_at_step=7)
        ckpt = {"step": 0}
        starts = []

        def run_steps(start, end, tbl):
            starts.append(start)
            for s in range(start, end):
                injector.check(s)
                if s % 5 == 0:
                    ckpt["step"] = s
            return end

        out = mod.run_with_recovery(run_steps, table, 20,
                                    restore_step=lambda: ckpt["step"])
        return out, starts

    (done, failures, final), starts = run(
        tfault, balance_table(np.arange(96), 8, seed=0))
    (jdone, jfailures, jfinal), jstarts = run(
        jfault, jbal.balance_table(np.arange(96), 8, seed=0))
    assert (done, failures) == (jdone, jfailures) == (20, 1)
    assert starts == jstarts == [0, 5]
    assert final.n_workers == 7
    _same_table(final, jfinal)


@pytest.mark.parametrize("n,w,failed", [(100, 10, [0, 9]), (96, 8, [3, 6])])
def test_recover_assignment_equal_shares(n, w, failed):
    """The pool re-dealt over the survivors in equal shares, equal to the
    reference's table."""
    got = recover_assignment(balance_table(np.arange(n), w, seed=1), failed)
    _same_table(got, jfault.recover_assignment(
        jbal.balance_table(np.arange(n), w, seed=1), failed))
    assert got.n_workers == w - len(failed)
    assert got.per_worker.shape[1] == n // w * w // (w - len(failed))


def test_recovery_gives_up_after_max_failures():
    """More failures than ``max_failures``: the last one propagates."""
    table = balance_table(np.arange(8), 4, seed=0)

    def always_fail(start, end, tbl):
        raise WorkerFailure(1, start)

    with pytest.raises(WorkerFailure, match="worker 1 failed at step 0"):
        run_with_recovery(always_fail, table, 10, restore_step=lambda: 0,
                          max_failures=2)


def test_failure_injector_fires_once():
    """The injected failure fires at the first due step, once, naming its
    worker (worker 0 when none is given)."""
    inj = FailureInjector(fail_worker=None, fail_at_step=3)
    inj.check(2)
    with pytest.raises(WorkerFailure) as e:
        inj.check(4)
    assert (e.value.worker, e.value.step) == (0, 4)
    inj.check(5)


def test_loader_prefetches_all_shards():
    def produce(shard):
        time.sleep(0.01)
        return shard * 10

    loader = PrefetchLoader(produce, n_shards=12, depth=2, n_threads=3)
    assert sorted(loader) == [s * 10 for s in range(12)]


def test_loader_speculative_backup_on_straggler():
    """A straggling shard is re-issued to an idle thread and the backup's
    batch is served."""
    calls = {"n": 0}

    def produce(shard):
        calls["n"] += 1
        if shard == 5 and calls["n"] <= 6:
            time.sleep(1.0)        # straggler
        else:
            time.sleep(0.01)
        return shard

    loader = PrefetchLoader(produce, n_shards=8, depth=8, n_threads=3,
                            straggler_factor=3.0)
    assert sorted(loader) == list(range(8))
    assert loader.backups_issued >= 1


def test_loader_stop_leaves_no_live_threads():
    """A stopped loader leaks no producer or watchdog thread, even with
    producers blocked behind a full queue."""
    def produce(shard):
        time.sleep(0.005)
        return shard

    loader = PrefetchLoader(produce, n_shards=32, depth=1, n_threads=3)
    it = iter(loader)
    assert next(it) is not None
    loader.stop()
    assert loader.live_threads() == []


def test_loader_exhaustion_joins_threads():
    loader = PrefetchLoader(lambda s: s, n_shards=6, depth=2, n_threads=2)
    assert sorted(loader) == list(range(6))
    assert loader.live_threads() == []
