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
  back (``staged``), through page-locked buffers the process reuses;
  NCCL takes the device tensors as they are.  Booleans
  travel as their uint8 bytes.

* ``FakeWorkers`` (the dry-run, ``launch/dryrun.py``): one rank of a
  group whose other ranks do not exist.  Each collective returns an
  empty block of the shape and dtype the rank would receive and counts
  what it would move, so one rank's step of a 256-rank mesh traces in
  one process on fake tensors.

A ``ProcessWorkers`` may span a sub-group of the processes (``pg``: one
axis of a ``(data, model)`` mesh, ``launch/mesh.py::make_local_mesh``),
with its own counters.  ``sum_over``, ``gather_over`` and
``all_to_all_over`` are ``all_reduce``, ``all_gather`` and
``all_to_all`` under autograd, each backward its forward's adjoint (the
LM's model axis in training).

Every collective takes and returns the LOCAL block ``[L, ...]``, ``L`` =
``group.local`` (``W`` stacked, 1 per process).  The forms are exactly
the ``tiled=True`` / ``split_axis=0, concat_axis=0`` shapes ``repro``
uses, so a worker's block of the result equals what worker ``w`` would
receive from ``lax``, on either backend.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Sequence, Tuple

import torch

from .config import resolve_device

#: ``all_reduce`` operations
REDUCE_OPS = ("sum", "max")
#: the collective kinds of the dry-run's record, under the names of
#: ``repro/launch/hlo_analysis.py``'s ``collective_bytes`` (and
#: ``broadcast``, which ``lax`` has not); ``reduce-scatter`` stays 0: the
#: port sums and slices instead (``gather_over``'s backward)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "broadcast")
#: page-locked host buffers of gloo's staged transport: one for the
#: block a collective sends (and reduces in place), one for the blocks it
#: receives; shared by every group of the process, whose collectives run
#: one at a time, and grown in powers of two to the largest block
_PINNED: Dict[str, torch.Tensor] = {}


def _pinned(role: str, shape, dtype) -> torch.Tensor:
    """A page-locked host tensor of ``shape`` and ``dtype`` over the
    process's ``role`` buffer (valid until the next collective)."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buf = _PINNED.get(role)
    if buf is None or buf.numel() < n:
        buf = _PINNED[role] = torch.empty(1 << max(n - 1, 0).bit_length(),
                                          dtype=torch.uint8, pin_memory=True)
    return buf[:n].view(dtype).view(shape)


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
    """One worker per process over a ``torch.distributed`` process group:
    the default (world) group ``launch/mesh.py`` joins, or ``pg``, a
    sub-group of it (a mesh axis, ``mesh.make_local_mesh``), in which
    this process is ``rank`` of ``world``.

    ``stats`` counts, per collective, the calls, the bytes this rank's
    blocks sent to other ranks (``all_reduce``: its block once, whatever
    the transport's algorithm moves), the host seconds spent in the
    transport call, and, when ``staged``, the seconds of the host copies
    (each collective starts after a device synchronise, so neither clock
    holds the work that produced its block); ``reset_stats`` zeroes
    them."""

    KINDS = ("all_gather", "all_to_all", "ppermute", "all_reduce",
             "broadcast")

    def __init__(self, backend: str, world: int, rank: int, device,
                 pg=None):
        import torch.distributed as dist
        self._dist = dist
        self.backend = backend
        self.world, self.rank, self.local = int(world), int(rank), 1
        self.device = torch.device(device)
        self.pg = pg
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
        h = _pinned("send", t.shape, t.dtype)
        h.copy_(t)
        self._staging += time.perf_counter() - t0
        return h

    def _recv(self, shape, dtype, like: torch.Tensor) -> torch.Tensor:
        """A receive block: page-locked when staged, else beside
        ``like``."""
        if self.staged:
            return _pinned("recv", tuple(shape), dtype)
        return like.new_empty(shape)

    def _in(self, t: torch.Tensor, dtype, device=None) -> torch.Tensor:
        """A received block back on ``device`` (default: the group's) in
        its own dtype."""
        device = self.device if device is None else device
        if self.staged and device.type == "cuda":
            t0 = time.perf_counter()
            t = t.to(device)
            torch.cuda.current_stream(device).synchronize()
            self._staging += time.perf_counter() - t0
        elif self.staged:
            t = t.clone()                 # off the reused host buffers
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

    def _global(self, r: int) -> int:
        """The world rank of this group's rank ``r``."""
        return r if self.pg is None else self._dist.get_global_rank(
            self.pg, r)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != 1:
            raise ValueError(f"a process holds one worker's block: leading "
                             f"axis 1, got shape {tuple(x.shape)}")

    def all_gather(self, x):
        self._check(x)

        def go(x):
            t = self._out(x[0])
            got = self._recv((self.world,) + tuple(t.shape), t.dtype, t)
            self._dist.all_gather(list(got.unbind(0)), t, group=self.pg)
            return self._in(got.reshape((-1,) + tuple(t.shape[1:])),
                            x.dtype)[None]
        return self._run("all_gather", go, x,
                         x[0].nbytes * (self.world - 1))

    def all_to_all(self, x):
        self._check(x)
        if x.shape[1] != self.world:
            raise ValueError(f"all_to_all needs one chunk per worker: "
                             f"[1, {self.world}, ...], got {tuple(x.shape)}")

        def go(x):
            t = self._out(x[0])
            out = self._recv(t.shape, t.dtype, t)
            self._dist.all_to_all_single(out, t, group=self.pg)
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
                                            self._global(dst[0]), self.pg))
            if src:
                buf = torch.empty(
                    x.shape[1:], device="cpu" if self.staged else x.device,
                    dtype=torch.uint8 if x.dtype == torch.bool else x.dtype)
                ops.append(self._dist.P2POp(self._dist.irecv, buf,
                                            self._global(src[0]), self.pg))
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
            t = self._out(x[0])
            if not self.staged:            # the staged copy is already new
                t = t.clone()
            self._dist.all_reduce(t, op=rop, group=self.pg)
            return self._in(t, x.dtype)[None]
        return self._run("all_reduce", go, x, x[0].nbytes)

    def broadcast(self, x):
        self._check(x)

        def go(x):
            t = self._out(x[0])
            if not self.staged:            # the staged copy is already new
                t = t.clone()
            self._dist.broadcast(t, src=self._global(0), group=self.pg)
            return self._in(t, x.dtype, x.device)[None]
        sent = x[0].nbytes * (self.world - 1) if self.rank == 0 else 0
        return self._run("broadcast", go, x, sent)


def new_tally() -> Dict[str, int]:
    """Zeroed output bytes per device of every ``COLLECTIVE_KINDS``."""
    return {k: 0 for k in COLLECTIVE_KINDS}


class FakeWorkers(WorkerGroup):
    """Rank ``rank`` of a group of ``world`` ranks that only this process
    traces (the dry-run: ``launch/mesh.py::make_production_mesh``).

    Every collective returns an EMPTY block of the shape and dtype the
    rank would receive (its values are undefined: the dry-run runs on
    fake tensors, where there are none) and counts the call twice:

    * ``stats``, as ``ProcessWorkers`` counts it: per collective the
      calls and the bytes this rank's blocks send to other ranks;
    * ``tally``, the OUTPUT bytes of the rank's block by the kind's name
      in ``COLLECTIVE_KINDS`` (the convention of the reference's
      ``collective_bytes``: an all-gather counts its gathered block, a
      permute its block whether or not this rank sends).  A group of one
      rank adds nothing there (XLA removes such a collective).

    ``tally`` may be shared by the groups of one mesh (``new_tally``).
    Nothing is staged and nothing is allocated but the outputs."""

    KINDS = ProcessWorkers.KINDS
    _HLO = {"all_gather": "all-gather", "all_to_all": "all-to-all",
            "ppermute": "collective-permute", "all_reduce": "all-reduce",
            "broadcast": "broadcast"}

    def __init__(self, world: int, rank: int = 0, device="cuda",
                 tally: Dict[str, int] = None):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a group of {world}")
        self.world, self.rank, self.local = int(world), int(rank), 1
        self.device = torch.device(device)
        self.tally = new_tally() if tally is None else tally
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero ``stats`` (not the shared ``tally``)."""
        self.stats: Dict[str, Dict[str, int]] = {
            k: {"calls": 0, "bytes": 0} for k in self.KINDS}

    def _count(self, kind: str, x: torch.Tensor, out_shape, sent: int):
        if x.shape[0] != 1:
            raise ValueError(f"a rank holds one worker's block: leading "
                             f"axis 1, got shape {tuple(x.shape)}")
        st = self.stats[kind]
        st["calls"] += 1
        st["bytes"] += sent
        out = x.new_empty(out_shape)
        if self.world > 1:
            self.tally[self._HLO[kind]] += out[0].nbytes
        return out

    def all_gather(self, x):
        shape = (1, self.world * x.shape[1]) + tuple(x.shape[2:])
        return self._count("all_gather", x, shape,
                           x[0].nbytes * (self.world - 1))

    def all_to_all(self, x):
        if x.shape[1] != self.world:
            raise ValueError(f"all_to_all needs one chunk per worker: "
                             f"[1, {self.world}, ...], got {tuple(x.shape)}")
        return self._count("all_to_all", x, x.shape,
                           x[0].nbytes * (self.world - 1) // self.world)

    def ppermute(self, x, perm):
        dst = [d for s, d in perm if s == self.rank]
        sent = x[0].nbytes if dst and dst[0] != self.rank else 0
        return self._count("ppermute", x, x.shape, sent)

    def all_reduce(self, x, op="sum"):
        if op not in REDUCE_OPS:
            raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
        return self._count("all_reduce", x, x.shape, x[0].nbytes)

    def broadcast(self, x):
        sent = x[0].nbytes * (self.world - 1) if self.rank == 0 else 0
        return self._count("broadcast", x, x.shape, sent)


# ------------------------------------------------- differentiable forms --
# The model axis's collectives under autograd.  Each backward is its
# forward's adjoint, so the gradient that reaches a rank's tensor is the
# derivative of the SUM of every rank's objective: a replicated loss is
# seeded 1 / M on each of the M ranks, and a weight every rank holds
# whole sums its ranks' gradients (``train/fsdp.py``).  Integer blocks
# (EP's expert ids) take the group's own methods: they carry no gradient.

class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.all_reduce(g.contiguous())


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group, ctx.n = group, x.shape[1]
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        grp, n = ctx.group, ctx.n
        summed = grp.all_reduce(g.contiguous())
        lead = summed.reshape((grp.local, grp.world, n)
                              + tuple(summed.shape[2:]))
        i = torch.arange(grp.local, device=g.device)
        return None, lead[i, grp.rank + i]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.all_to_all(g.contiguous())


def sum_over(group: WorkerGroup, x: torch.Tensor) -> torch.Tensor:
    """``group.all_reduce(x)`` (a partial sum made whole) under autograd:
    the backward sums the ranks' gradients the same way."""
    return _Sum.apply(group, x)


def gather_over(group: WorkerGroup, x: torch.Tensor) -> torch.Tensor:
    """``group.all_gather(x)`` (``[L, n, ...] -> [L, W n, ...]``) under
    autograd: the backward is the reduce-scatter, an ``all_reduce`` of
    the whole gradient and each worker's slice of it (gloo has no
    reduce-scatter)."""
    return _Gather.apply(group, x)


def all_to_all_over(group: WorkerGroup, x: torch.Tensor) -> torch.Tensor:
    """``group.all_to_all(x)`` under autograd: the backward sends each
    chunk's gradient back the way it came, the same ``all_to_all``."""
    return _AllToAll.apply(group, x)
