"""ctypes wrappers of the ``fanout_mean`` and ``gather_reduce`` CUDA
kernels.

``fanout_mean_cuda`` wraps ``csrc/fanout_mean.cu`` (the port of
``repro/kernels/gather_reduce.py::fanout_mean_pallas``),
``fanout_mean_bwd_cuda`` wraps ``csrc/fanout_mean_bwd.cu``, its gradient
with respect to ``x``, and ``gather_reduce_cuda`` wraps
``csrc/gather_reduce.cu`` (the port of ``gather_reduce_pallas``, the
fused row gather and masked mean); ``<wrapper>.launches`` counts each
kernel's launches.  Each kernel's launch plan is plain Python here
(``fanout_mean_plan``, ``fanout_mean_bwd_plan``, ``gather_reduce_plan``),
so the CPU tests hold it.  ``ops.FanoutMean`` ties the first two together
for autograd; ``gather_reduce`` is forward only, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _build

#: threads of one ``fanout_mean`` CTA
FANOUT_THREADS = 256
#: x loads each thread keeps in flight (``kUnroll`` in ``fanout_mean.cu``)
FANOUT_UNROLL = 4
#: dynamic shared memory a ``fanout_mean`` launch may take without opting in
FANOUT_SMEM_LIMIT = 48 * 1024


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class FanoutPlan(NamedTuple):
    """Launch plan of ``csrc/fanout_mean.cu``: CTAs of ``lanes x ways x
    rows`` threads on a ``grid`` of (rows of M, load units of D)."""
    vec: int               # elements a lane loads at once (16 bytes), or 1
    lanes: int             # threads along D for one (row, K share)
    ways: int              # thread groups splitting K: k = way + i ways
    rows: int              # output rows per CTA
    grid: Tuple[int, int]  # CTAs along M, along D
    smem: int              # dynamic shared memory per CTA, bytes


def fanout_mean_plan(m: int, k: int, d: int, elem_size: int,
                     aligned: bool = True, n_sm: int = 132) -> FanoutPlan:
    """The ``fanout_mean`` plan for ``x [m, k, d]`` of ``elem_size``-byte
    elements.  Rows of a 16-byte multiple width on a 16-byte aligned base
    take 16-byte loads, others the scalar route; up to 32 lanes cover a
    row's load units, fewer (down to 16) while the grid would hold under
    two CTAs per SM; the CTA's other thread groups split K, about
    ``FANOUT_UNROLL`` loads each, and what is left of the CTA takes more
    rows.  Shared memory: the partial sums, the groups' counts, the rows'
    mask bytes."""
    vec = (16 // elem_size if aligned and (d * elem_size) % 16 == 0
           else 1)
    row_vecs = d // vec
    lanes = min(32, _pow2_at_least(row_vecs))
    while lanes > 16 and m * -(-row_vecs // lanes) < 2 * n_sm:
        lanes //= 2
    groups = FANOUT_THREADS // lanes
    ways = min(groups, _pow2_at_least(-(-k // FANOUT_UNROLL)))
    rows = groups // ways
    grid = (-(-m // rows), -(-row_vecs // lanes))
    smem = 4 * (FANOUT_THREADS * vec + rows * ways) + rows * k
    return FanoutPlan(vec, lanes, ways, rows, grid, smem)


#: warps of one ``fanout_mean_bwd`` CTA (the kernel's ``kWarps``)
BWD_WARPS = 4


def fanout_mean_bwd_plan(m: int, k: int, d: int,
                         n_sm: int = 132) -> Tuple[int, int, int]:
    """The grid of ``csrc/fanout_mean_bwd.cu`` for ``dx [m, k, d]``: CTAs
    of ``BWD_WARPS`` warps along M, K shares and blocks of 32 columns of
    D.  A warp takes one (row, share, block); share y of ``ways`` takes
    k = y, y + ways, ...; K is split over up to K shares until the grid
    holds two CTAs per SM."""
    d_blocks = -(-d // 32)
    ways = max(1, min(k, -(-2 * n_sm * BWD_WARPS // max(m * d_blocks, 1)),
                      65535))
    return -(-m // BWD_WARPS), ways, d_blocks


#: warps of one ``gather_reduce`` CTA (the kernel's ``kWarps``)
GATHER_WARPS = 4
#: row loads a slot group keeps in flight (``kUnroll`` in ``gather_reduce.cu``)
GATHER_UNROLL = 10


class GatherPlan(NamedTuple):
    """Launch plan of ``csrc/gather_reduce.cu``: CTAs of ``rows x ways``
    warps on a ``grid`` of (rows of M, blocks of ``lanes`` load units of
    D)."""
    vec: int               # elements a lane loads at once (16 bytes), or 1
    lanes: int             # threads along D for one slot
    ways: int              # warps splitting K into shares of ceil(K / ways)
    rows: int              # output rows per CTA
    grid: Tuple[int, int]  # CTAs along M, along D
    smem: int              # dynamic shared memory per CTA, bytes


def gather_reduce_plan(m: int, k: int, d: int, elem_size: int,
                       aligned: bool = True, n_sm: int = 132,
                       warps: int = GATHER_WARPS,
                       unroll: int = GATHER_UNROLL) -> GatherPlan:
    """The ``gather_reduce`` plan for ``idx [m, k]`` over a table of ``d``
    columns of ``elem_size``-byte elements.  Rows of a 16-byte multiple
    width on a 16-byte aligned base take 16-byte loads, others the scalar
    route; a power of two of lanes, up to 32, covers a row's load units,
    and a warp's ``32 // lanes`` slot groups take every ``32 // lanes``-th
    slot each.  K is split over ``ways`` warps, at least enough that a
    share's slots fit its groups' ``unroll`` loads in flight, and more, up
    to ``warps`` (and one slot a group), while the grid would hold under
    two CTAs per SM; the CTA's other warps take more rows.  Shared memory:
    the threads' partial sums.  ``warps`` and ``unroll`` are the kernel's
    ``kWarps`` and ``kUnroll`` (a variant of the source built with others
    passes its own)."""
    vec = (16 // elem_size if aligned and (d * elem_size) % 16 == 0
           else 1)
    row_vecs = d // vec
    lanes = min(32, _pow2_at_least(row_vecs))
    groups = 32 // lanes
    d_blocks = -(-row_vecs // lanes)
    most = max(1, min(warps, -(-k // groups)))
    ways = max(1, min(most, -(-k // (groups * unroll))))
    while ways < most and -(-m // (warps // ways)) * d_blocks < 2 * n_sm:
        ways += 1
    rows = warps // ways
    grid = (-(-m // rows), d_blocks)
    smem = 4 * rows * ways * 32 * vec
    return GatherPlan(vec, lanes, ways, rows, grid, smem)


def _check(x: torch.Tensor, mask: torch.Tensor, name: str) -> None:
    """Validate an ``x``/``g`` tensor against its ``[M, K]`` mask."""
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"{name} needs its operands on one CUDA device, "
                         f"got {x.device} and {mask.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")


def fanout_mean_cuda(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the fanout axis on the card: ``x [M, K, D]``
    (float32 or bfloat16, contiguous CUDA), ``mask [M, K]`` bool ->
    ``[M, D]`` in ``x``'s dtype, accumulated in float32, launched as
    ``fanout_mean_plan`` says (raises ``ValueError`` for a fanout whose
    mask rows do not fit its shared memory)."""
    _check(x, mask, "fanout_mean_cuda")
    if x.dim() != 3 or mask.shape != x.shape[:2]:
        raise ValueError(f"fanout_mean_cuda needs x [M, K, D] and mask "
                         f"[M, K], got {tuple(x.shape)} and "
                         f"{tuple(mask.shape)}")
    code = _build.dtype_code(x)
    m, k, d = x.shape
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = fanout_mean_plan(m, k, d, x.element_size(),
                            aligned=x.data_ptr() % 16 == 0,
                            n_sm=_build.sm_count(x.device))
    if plan.smem > FANOUT_SMEM_LIMIT:
        raise ValueError(f"fanout_mean_cuda: a fanout of {k} needs {plan.smem}"
                         f" bytes of shared memory, above {FANOUT_SMEM_LIMIT}")
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.repro_fanout_mean(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, d, code,
            plan.vec, plan.lanes, plan.ways, plan.rows, *plan.grid,
            plan.smem, _build.stream_of(x))
    _build.check(status, "fanout_mean")
    fanout_mean_cuda.launches += 1
    return out


fanout_mean_cuda.launches = 0


def fanout_mean_bwd_cuda(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gradient of the masked mean on the card: ``g [M, D]`` (float32 or
    bfloat16, contiguous CUDA), ``mask [M, K]`` bool -> ``dx [M, K, D]`` in
    ``g``'s dtype, ``g / max(count, 1) * mask`` (see
    ``ref.fanout_mean_bwd_ref``), launched as ``fanout_mean_bwd_plan``
    says (raises ``ValueError`` for a row of more than 65 535 blocks of 32
    columns)."""
    _check(g, mask, "fanout_mean_bwd_cuda")
    if g.dim() != 2 or mask.dim() != 2 or mask.shape[0] != g.shape[0]:
        raise ValueError(f"fanout_mean_bwd_cuda needs g [M, D] and mask "
                         f"[M, K], got {tuple(g.shape)} and "
                         f"{tuple(mask.shape)}")
    code = _build.dtype_code(g)
    (m, d), k = g.shape, mask.shape[1]
    dx = torch.empty((m, k, d), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    grid = fanout_mean_bwd_plan(m, k, d, n_sm=_build.sm_count(g.device))
    if grid[2] > 65535:
        raise ValueError(f"fanout_mean_bwd_cuda: a row of {d} elements is "
                         f"{grid[2]} blocks of 32 columns, above 65 535")
    lib = _build.library()
    with torch.cuda.device(g.device):
        status = lib.repro_fanout_mean_bwd(
            g.data_ptr(), mask.data_ptr(), dx.data_ptr(), m, k, d, code,
            *grid, _build.stream_of(g))
    _build.check(status, "fanout_mean_bwd")
    fanout_mean_bwd_cuda.launches += 1
    return dx


fanout_mean_bwd_cuda.launches = 0


def gather_reduce_cuda(table: torch.Tensor, idx: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Row gather and masked mean on the card: ``table [N, D]`` (float32 or
    bfloat16), ``idx [M, K]`` int32, ``mask [M, K]`` bool (contiguous, one
    CUDA device) -> ``[M, D]`` in ``table``'s dtype, ids clamped to
    ``[0, N - 1]``, accumulated in float32 (see
    ``ref.gather_reduce_ref``), launched as ``gather_reduce_plan`` says
    (raises ``ValueError`` for a row of more than 65 535 blocks of load
    units)."""
    _check(idx, mask, "gather_reduce_cuda")
    if table.device != idx.device or not table.is_contiguous():
        raise ValueError(f"gather_reduce_cuda needs a contiguous table on "
                         f"{idx.device}, got {table.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 2 or mask.shape != idx.shape \
            or table.shape[0] == 0:
        raise ValueError(f"gather_reduce_cuda needs table [N, D] (N > 0), "
                         f"idx and mask [M, K], got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)} and {tuple(mask.shape)}")
    code = _build.dtype_code(table)
    (n, d), (m, k) = table.shape, idx.shape
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    plan = gather_reduce_plan(m, k, d, table.element_size(),
                              aligned=table.data_ptr() % 16 == 0,
                              n_sm=_build.sm_count(table.device))
    if plan.grid[1] > 65535:
        raise ValueError(f"gather_reduce_cuda: a row of {d} elements is "
                         f"{plan.grid[1]} blocks of load units, above 65 535")
    lib = _build.library()
    with torch.cuda.device(table.device):
        status = lib.repro_gather_reduce(
            table.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, m, k, d, code, plan.vec, plan.lanes, plan.ways, plan.rows,
            *plan.grid, plan.smem, _build.stream_of(table))
    _build.check(status, "gather_reduce")
    gather_reduce_cuda.launches += 1
    return out


gather_reduce_cuda.launches = 0
