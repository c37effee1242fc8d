"""Host-side producer/consumer pipeline (the port of
``repro/data/loader.py``; threads and queues only, no device work).

A bounded queue of prefetched batches, produced by worker threads that
own balance-table shards, with MapReduce-style **speculative
execution** against stragglers: when a shard's production time exceeds
``straggler_factor x`` the running median, the same shard is re-issued
to an idle thread and whichever copy finishes first wins.  ``stop()``
leaves no live thread.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional


class PrefetchLoader:
    """Iterate ``produce(shard)`` for every shard in ``range(n_shards)``,
    ``depth`` batches ahead on ``n_threads`` threads, re-issuing
    stragglers (at most ``max_backups`` times)."""

    def __init__(
        self,
        produce: Callable[[int], object],   # shard_index -> batch
        n_shards: int,
        depth: int = 2,
        n_threads: int = 2,
        straggler_factor: float = 4.0,
        max_backups: int = 8,
    ) -> None:
        self._produce = produce
        self._n_shards = n_shards
        self._q: "queue.Queue[tuple[int, object]]" = queue.Queue(maxsize=depth)
        self._pending: "queue.Queue[int]" = queue.Queue()
        self._done: dict[int, object] = {}
        self._done_lock = threading.Lock()
        self._times: list[float] = []
        self._stop = threading.Event()
        self._straggler_factor = straggler_factor
        self._backups_issued = 0
        self._max_backups = max_backups
        self._inflight: dict[int, float] = {}   # shard -> start time
        for s in range(n_shards):
            self._pending.put(s)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(n_threads)
        ]
        self._watchdog = threading.Thread(target=self._watch, daemon=True)

    # -- internals ---------------------------------------------------------
    def _worker(self) -> None:
        """Producer thread: take pending shards until all are done."""
        while not self._stop.is_set():
            try:
                shard = self._pending.get(timeout=0.05)
            except queue.Empty:
                if self._all_done():
                    return
                continue
            with self._done_lock:
                if shard in self._done:      # a backup already finished it
                    continue
                self._inflight[shard] = time.perf_counter()
            t0 = time.perf_counter()
            batch = self._produce(shard)
            dt = time.perf_counter() - t0
            with self._done_lock:
                if shard in self._done:
                    continue                 # lost the race to a backup
                self._done[shard] = batch
                self._inflight.pop(shard, None)
                self._times.append(dt)
            # bounded put that keeps observing the stop flag — a plain
            # blocking put() would deadlock a producer forever if the
            # consumer goes away while the queue is full
            while not self._stop.is_set():
                try:
                    self._q.put((shard, batch), timeout=0.05)
                    break
                except queue.Full:
                    continue

    def _watch(self) -> None:
        """Speculative re-execution of stragglers."""
        while not self._stop.is_set() and not self._all_done():
            time.sleep(0.01)
            with self._done_lock:
                if len(self._times) < 3 or self._backups_issued >= self._max_backups:
                    continue
                med = sorted(self._times)[len(self._times) // 2]
                now = time.perf_counter()
                for shard, t0 in list(self._inflight.items()):
                    if now - t0 > self._straggler_factor * max(med, 1e-4):
                        self._pending.put(shard)        # re-issue
                        self._inflight.pop(shard)
                        self._backups_issued += 1

    def _all_done(self) -> bool:
        """Every shard has a finished batch."""
        with self._done_lock:
            return len(self._done) >= self._n_shards

    # -- public ------------------------------------------------------------
    def __iter__(self) -> Iterator[object]:
        """Start the threads and yield one batch per shard (in the order
        they finish); stops every thread on exhaustion or close."""
        for t in self._threads:
            t.start()
        self._watchdog.start()
        served = 0
        try:
            while served < self._n_shards:
                shard, batch = self._q.get()
                served += 1
                yield batch
        finally:
            # normal exhaustion AND early generator close both land here
            self.stop()

    @property
    def backups_issued(self) -> int:
        """Speculative re-executions issued so far."""
        return self._backups_issued

    def stop(self, join_timeout: float = 2.0) -> None:
        """Shut down producers and the watchdog.

        Drains the bounded queue so any producer blocked on a full queue can
        observe the stop flag, then joins all threads.  Idempotent; safe to
        call before iteration started (threads never started -> no join)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        me = threading.current_thread()
        for t in self._threads + [self._watchdog]:
            if t is not me and t.is_alive():
                t.join(timeout=join_timeout)

    def live_threads(self) -> list[threading.Thread]:
        """Worker/watchdog threads still running (diagnostics + tests)."""
        return [t for t in self._threads + [self._watchdog] if t.is_alive()]
