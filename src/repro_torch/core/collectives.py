"""The workers' collectives, behind one ``WorkerGroup`` interface.

``repro`` runs each worker as one ``shard_map`` instance and moves data
between them with ``lax`` collectives.  The port has two backends for
the same five operations (``axis_index``, ``all_gather``, ``all_to_all``,
``ppermute``, ``all_reduce``), plus a ``broadcast`` from worker 0 that
the serving loop's request header rides:

* ``StackedGroup`` (``--dist none``, the default): all ``W`` workers live
  in one process, every per-worker array carries a leading ``[W, ...]``
  axis, and a collective is a re-indexing of that axis.  This runs
  ``W > 1`` on one CPU or one card.
* ``ProcessWorkers`` (``--dist gloo|nccl``): one process per worker, each
  holding the leading axis of length 1 (its own block), with the
  collectives carried out by ``torch.distributed``.  ``ppermute`` is
  ``batch_isend_irecv`` pairs and ``all_to_all`` is ``all_to_all_single``
  on the contiguous ``[W, ...]`` send block.  gloo has no path for CUDA
  tensors in ``all_to_all`` and point-to-point, so on a card every gloo
  collective stages its send block to host memory and copies the result
  back (``staged``); NCCL takes the device tensors as they are.  Booleans
  travel as their uint8 bytes.

Every collective takes and returns the LOCAL block ``[L, ...]``, ``L`` =
``group.local`` (``W`` stacked, 1 per process).  The forms are exactly
the ``tiled=True`` / ``split_axis=0, concat_axis=0`` shapes ``repro``
uses, so a worker's block of the result equals what worker ``w`` would
receive from ``lax``, on either backend.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import torch

from .config import resolve_device

#: ``all_reduce`` operations
REDUCE_OPS = ("sum", "max")


class WorkerGroup:
    """The workers this process holds, and their collectives.

    ``world`` is the number of workers (the destinations of every
    exchange), ``rank`` the first worker of this process's block,
    ``local`` the block's length and ``device`` where its tensors live."""
    world: int
    rank: int
    local: int
    device: torch.device

    @property
    def lead(self) -> bool:
        """True in the process that holds worker 0 (the one that logs and
        writes checkpoints)."""
        return self.rank == 0

    def block(self, x):
        """This process's rows ``[rank, rank + local)`` of a full
        ``[W, ...]`` array (numpy or torch)."""
        return x[self.rank:self.rank + self.local]

    def axis_index(self, device=None) -> torch.Tensor:
        """``lax.axis_index`` of every worker of the block: ``[L]`` int32."""
        return torch.arange(self.rank, self.rank + self.local,
                            dtype=torch.int32,
                            device=self.device if device is None else device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled ``lax.all_gather``: ``x [L, n, ...]`` -> ``[L, W*n, ...]``,
        every worker holding the concatenation of all workers' blocks."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled ``lax.all_to_all``: ``x [L, W_dst, ...]`` ->
        ``[L, W_src, ...]``; worker ``i``'s chunk ``j`` lands on worker
        ``j`` as chunk ``i``."""
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: worker ``dst`` receives worker ``src``'s block
        for every ``(src, dst)`` pair of ``perm``, zeros elsewhere."""
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``lax.psum`` (``op="sum"``) or ``lax.pmax``: ``x [L, ...]`` ->
        ``[L, ...]``, every worker holding the reduction over all ``W``."""
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Worker 0's block to every worker: ``x [L, ...]`` -> ``[L, ...]``,
        each row worker 0's row (``lax`` has no such op: the serving loop's
        request header, which only worker 0 holds, rides it)."""
        raise NotImplementedError


class StackedGroup(WorkerGroup):
    """All ``world`` workers in this process, on the stacked axis, on the
    card unless ``device`` says otherwise (``resolve_device`` raises where
    no card is present)."""

    def __init__(self, world: int, device="cuda"):
        if world < 1:
            raise ValueError(f"need at least one worker, got {world}")
        self.world = self.local = int(world)
        self.rank = 0
        self.device = resolve_device(device)

    def all_gather(self, x):
        w = x.shape[0]
        flat = x.reshape((1, w * x.shape[1]) + tuple(x.shape[2:]))
        return flat.expand((w,) + tuple(flat.shape[1:]))

    def all_to_all(self, x):
        return x.transpose(0, 1).contiguous()

    def ppermute(self, x, perm):
        src = torch.tensor([s for s, _ in perm], dtype=torch.long,
                           device=x.device)
        dst = torch.tensor([d for _, d in perm], dtype=torch.long,
                           device=x.device)
        out = torch.zeros_like(x)
        out[dst] = x[src]
        return out

    def all_reduce(self, x, op="sum"):
        if op not in REDUCE_OPS:
            raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
        red = x.sum(0, keepdim=True) if op == "sum" \
            else x.amax(0, keepdim=True)
        return red.to(x.dtype).expand(x.shape)

    def broadcast(self, x):
        return x[:1].expand(x.shape)


def stacked(x: torch.Tensor) -> StackedGroup:
    """The stacked group of a ``[W, ...]`` per-worker array (the default
    where a caller passes no group)."""
    return StackedGroup(x.shape[0], x.device)


class ProcessWorkers(WorkerGroup):
    """One worker per process over the default ``torch.distributed``
    process group (``launch/mesh.py`` joins it).

    ``stats`` counts, per collective, the calls, the bytes this rank's
    blocks sent to other ranks (``all_reduce``: its block once, whatever
    the transport's algorithm moves), the host seconds spent in the
    transport call, and, when ``staged``, the seconds of the host copies
    (each collective starts after a device synchronise, so neither clock
    holds the work that produced its block); ``reset_stats`` zeroes
    them."""

    KINDS = ("all_gather", "all_to_all", "ppermute", "all_reduce",
             "broadcast")

    def __init__(self, backend: str, world: int, rank: int, device):
        import torch.distributed as dist
        self._dist = dist
        self.backend = backend
        self.world, self.rank, self.local = int(world), int(rank), 1
        self.device = torch.device(device)
        # gloo moves host tensors only: a card's blocks go through host RAM
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero every collective's counters."""
        self.stats: Dict[str, Dict[str, float]] = {
            k: {"calls": 0, "bytes": 0, "seconds": 0.0, "staging_s": 0.0}
            for k in self.KINDS}

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A block as the transport takes it: uint8 bytes of a bool, a
        host copy when staged."""
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if not self.staged:
            return t.contiguous()
        t0 = time.perf_counter()
        h = torch.empty(t.shape, dtype=t.dtype)
        h.copy_(t)
        self._staging += time.perf_counter() - t0
        return h

    def _in(self, t: torch.Tensor, dtype, device=None) -> torch.Tensor:
        """A received block back on ``device`` (default: the group's) in
        its own dtype."""
        device = self.device if device is None else device
        if self.staged and device.type == "cuda":
            t0 = time.perf_counter()
            t = t.to(device)
            torch.cuda.current_stream(device).synchronize()
            self._staging += time.perf_counter() - t0
        return t.view(torch.bool) if dtype == torch.bool else t

    def _run(self, kind: str, fn, x: torch.Tensor, sent: int):
        if self.staged:
            # the block's producers finish first, outside the clocks
            torch.cuda.current_stream(self.device).synchronize()
        self._staging = 0.0
        t0 = time.perf_counter()
        out = fn(x)
        st = self.stats[kind]
        st["calls"] += 1
        st["bytes"] += sent
        st["seconds"] += time.perf_counter() - t0 - self._staging
        st["staging_s"] += self._staging
        return out

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != 1:
            raise ValueError(f"a process holds one worker's block: leading "
                             f"axis 1, got shape {tuple(x.shape)}")

    def all_gather(self, x):
        self._check(x)

        def go(x):
            t = self._out(x[0])
            parts = [torch.empty_like(t) for _ in range(self.world)]
            self._dist.all_gather(parts, t)
            return self._in(torch.cat(parts, dim=0), x.dtype)[None]
        return self._run("all_gather", go, x,
                         x[0].nbytes * (self.world - 1))

    def all_to_all(self, x):
        self._check(x)
        if x.shape[1] != self.world:
            raise ValueError(f"all_to_all needs one chunk per worker: "
                             f"[1, {self.world}, ...], got {tuple(x.shape)}")

        def go(x):
            t = self._out(x[0])
            out = torch.empty_like(t)
            self._dist.all_to_all_single(out, t)
            return self._in(out, x.dtype)[None]
        return self._run("all_to_all", go, x,
                         x[0].nbytes * (self.world - 1) // self.world)

    def ppermute(self, x, perm):
        self._check(x)
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"perm is not a permutation: {list(perm)}")

        def go(x):
            out = torch.zeros_like(x)
            if dst and dst[0] == self.rank:
                out.copy_(x)
                return out
            ops = []
            if dst:
                ops.append(self._dist.P2POp(self._dist.isend, self._out(x[0]),
                                            dst[0]))
            if src:
                buf = torch.empty(
                    x.shape[1:], device="cpu" if self.staged else x.device,
                    dtype=torch.uint8 if x.dtype == torch.bool else x.dtype)
                ops.append(self._dist.P2POp(self._dist.irecv, buf, src[0]))
            for req in (self._dist.batch_isend_irecv(ops) if ops else ()):
                req.wait()
            if src:
                out[0] = self._in(buf, x.dtype)
            return out
        sent = x[0].nbytes if dst and dst[0] != self.rank else 0
        return self._run("ppermute", go, x, sent)

    def all_reduce(self, x, op="sum"):
        self._check(x)
        if op not in REDUCE_OPS:
            raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
        rop = (self._dist.ReduceOp.SUM if op == "sum"
               else self._dist.ReduceOp.MAX)

        def go(x):
            t = self._out(x[0]).clone()
            self._dist.all_reduce(t, op=rop)
            return self._in(t, x.dtype)[None]
        return self._run("all_reduce", go, x, x[0].nbytes)

    def broadcast(self, x):
        self._check(x)

        def go(x):
            t = self._out(x[0]).clone()
            self._dist.broadcast(t, src=0)
            return self._in(t, x.dtype, x.device)[None]
        sent = x[0].nbytes * (self.world - 1) if self.rank == 0 else 0
        return self._run("broadcast", go, x, sent)
