"""L3 host-RAM feature store (port of ``repro/core/host_store.py``).

The feature table stays in host RAM, never on the card; cache-tier
misses resolve against it through an asynchronous gather instead of the
routed owner fetch.  The fetch path splits into *issue* and *collect*
(``generation.fetch_rows(store="host")``): generation of batch *t*
stages its misses in a :class:`HostMissRequest`, the loop hands the ids
to :meth:`HostFeatureStore.issue`, and one step later the landed
``[W, S, D]`` buffer feeds both the next generation's deferred cache
admission and :func:`patch_batch`, which fills batch *t*'s feature
holes right before it trains.

On a card the gathered rows go into a fresh pinned host buffer and are
copied to the device with ``non_blocking=True`` on a CUDA stream of the
store's own; an event recorded after the copy is what the consuming
stream waits on.  ``depth`` picks the overlap: **2** runs the wait for
gen *t*'s ids (``event.synchronize()`` on an event recorded after gen
*t*), the host gather and the copy's launch on one worker thread while
the main thread launches batch *t-1*'s train step; **1** does all of it
inline and blocks until the rows are on the device.  On the CPU (the
tests) the landed buffer is the host gather itself.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import resolve_device


class HostMissRequest(NamedTuple):
    """One step's staged cache misses, stacked ``[W, ...]``.

    ids    [W, S]  int32  staged miss ids (-1 = empty staging slot)
    slot   [W, R]  int32  staging slot serving each request slot
                          (meaningful only where ``patch``)
    patch  [W, R]  bool   request slots whose row arrives by the L3 gather
    """
    ids: torch.Tensor
    slot: torch.Tensor
    patch: torch.Tensor


def empty_admit(n_workers: int, dim: int, dtype=torch.float32,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The prologue's ``(admit_ids [W, 1], admit_rows [W, 1, D])`` on
    ``device``: nothing has landed yet, so every id is -1 and admits
    nothing."""
    device = resolve_device(device)
    return (torch.full((n_workers, 1), -1, dtype=torch.int32, device=device),
            torch.zeros((n_workers, 1, dim), dtype=dtype, device=device))


def patch_batch(batch, req: HostMissRequest, landed: torch.Tensor):
    """Fill the batch's feature holes with the landed L3 rows.

    Every request slot flagged ``req.patch`` takes its staged row of
    ``landed [W, S, D]``, every other slot keeps its value (a ``where``
    merge, never arithmetic), and each hop level is multiplied by its
    mask again, exactly as generation masks a device fetch — so the
    result is bit-identical to the device store's batch, ``-0.0``
    included."""
    w, s, d = landed.shape
    wb = batch.x_seed.shape[0]
    b = wb // w

    def fill(slots, flag, x):
        idx = torch.clamp(slots, 0, s - 1).to(torch.int64)
        rows = torch.gather(landed, 1, idx[..., None].expand(idx.shape + (d,)))
        return torch.where(flag[..., None], rows, x)

    x_seed = fill(req.slot[:, :b], req.patch[:, :b],
                  batch.x_seed.reshape(w, b, d)).reshape(wb, d)
    x_hops = []
    off = b
    for mask, x in zip(batch.masks, batch.x_hops):
        n = mask.numel() // w          # per-worker request slots of the level
        patched = fill(req.slot[:, off:off + n], req.patch[:, off:off + n],
                       x.reshape(w, n, d))
        patched = patched * mask.reshape(w, n, 1)
        x_hops.append(patched.reshape(x.shape))
        off += n
    return batch._replace(x_seed=x_seed, x_hops=tuple(x_hops))


class HostGather:
    """Handle on one in-flight host gather.

    ``rows()`` returns the landed ``[W, S, D]`` tensor: it joins the
    worker thread (depth 2), makes the caller's current stream wait on
    the copy's event and marks the buffer as used there, so the caching
    allocator cannot hand its memory out while that stream still reads
    it.  ``host_rows()`` is the gathered numpy buffer (the pinned staging
    buffer on a card), which the offline loop stores without copying the
    rows back off the device.  A failure on the worker thread is raised
    again by either."""

    def __init__(self, result=None, future=None):
        self._result = result
        self._future = future
        self._waited = False

    def _get(self):
        if self._result is None:
            self._result = self._future.result()
        return self._result

    def rows(self) -> torch.Tensor:
        """The landed ``[W, S, D]`` buffer, ready on the current stream."""
        dev, _, event = self._get()
        if event is not None and not self._waited:
            stream = torch.cuda.current_stream(dev.device)
            stream.wait_event(event)
            dev.record_stream(stream)
            self._waited = True
        return dev

    def host_rows(self) -> np.ndarray:
        """The gathered rows as a host numpy array."""
        return self._get()[1]


class HostFeatureStore:
    """The host-RAM feature table and its gather machinery.

    ``table`` is the ``[N, D]`` numpy feature table (host memory only);
    ``depth`` is the gather pipeline depth, 1 or 2 (module docstring).
    ``bytes_issued`` sums the ids and rows each issue ships;
    ``rows_issued`` counts the valid staged ids gathered (the run's
    ``CacheStats.n_l3_hits``, summed)."""

    def __init__(self, table: np.ndarray, *, depth: int = 2):
        if table.ndim != 2:
            raise ValueError(f"host feature table must be [N, D], "
                             f"got shape {table.shape}")
        if depth not in (1, 2):
            raise ValueError(f"host_gather_depth must be 1 or 2, "
                             f"got {depth}")
        self.table = table
        self.depth = depth
        self.bytes_issued = 0
        self.rows_issued = 0
        self._stream = None
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="l3")
                      if depth == 2 else None)

    @property
    def feat_dim(self) -> int:
        """Feature width ``D`` of the table."""
        return self.table.shape[1]

    def _rows_into(self, ids_np: np.ndarray, out: np.ndarray) -> None:
        # staging is sized for the worst miss burst, so most slots are -1
        # padding: gather only the valid rows into the zeroed buffer
        valid = ids_np >= 0
        out[valid] = self.table[np.clip(ids_np[valid], 0,
                                        self.table.shape[0] - 1)]
        self.rows_issued += int(valid.sum())

    def _gather_cpu(self, ids: torch.Tensor):
        ids_np = ids.numpy()
        rows = np.zeros(ids_np.shape + (self.feat_dim,), self.table.dtype)
        self._rows_into(ids_np, rows)
        return torch.from_numpy(rows), rows, None

    def _gather_cuda(self, ids: torch.Tensor, ready: torch.cuda.Event):
        dev = ids.device
        shape = tuple(ids.shape) + (self.feat_dim,)
        dtype = torch.from_numpy(self.table[:0]).dtype
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            ready.synchronize()            # gen t has written the ids
            ids_pin = torch.empty(ids.shape, dtype=ids.dtype,
                                  pin_memory=True)
            rows_pin = torch.zeros(shape, dtype=dtype, pin_memory=True)
            if not (ids_pin.is_pinned() and rows_pin.is_pinned()):
                raise RuntimeError("the L3 staging buffers could not be "
                                   "pinned")
            ids_pin.copy_(ids, non_blocking=True)
            ids.record_stream(self._stream)
            self._stream.synchronize()     # only the ids copy is queued here
            rows_np = rows_pin.numpy()
            self._rows_into(ids_pin.numpy(), rows_np)
            # allocated for the copy stream; rows() marks it for the reader
            landed = torch.empty(shape, dtype=dtype, device=dev)
            landed.copy_(rows_pin, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return landed, rows_np, done

    def issue(self, ids: torch.Tensor) -> HostGather:
        """Start the gather of one step's staged miss ids ``[W, S]``;
        returns the :class:`HostGather` the next step consumes.  Depth 2
        hands the work to the worker thread and returns at once; depth 1
        gathers inline and blocks until the rows are on the device."""
        self.bytes_issued += (ids.numel() * 4 + ids.numel() * self.feat_dim
                              * self.table.dtype.itemsize)
        if ids.is_cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(ids.device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(ids.device))
            work, args = self._gather_cuda, (ids, ready)
        else:
            work, args = self._gather_cpu, (ids,)
        if self.depth == 2:
            return HostGather(future=self._pool.submit(work, *args))
        result = work(*args)
        if result[2] is not None:
            result[2].synchronize()
        return HostGather(result=result)
