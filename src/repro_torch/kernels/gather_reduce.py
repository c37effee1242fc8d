"""ctypes wrappers of the ``fanout_mean`` and ``gather_reduce`` CUDA
kernels.

``fanout_mean_cuda`` wraps ``csrc/fanout_mean.cu`` (the port of
``repro/kernels/gather_reduce.py::fanout_mean_pallas``),
``fanout_mean_bwd_cuda`` wraps ``csrc/fanout_mean_bwd.cu``, its gradient
with respect to ``x``, and ``gather_reduce_cuda`` wraps
``csrc/gather_reduce.cu`` (the port of ``gather_reduce_pallas``, the
fused row gather and masked mean); ``<wrapper>.launches`` counts each
kernel's launches.  ``ops.FanoutMean`` ties the first two together for
autograd; ``gather_reduce`` is forward only, as in the reference.
"""
from __future__ import annotations

import torch

from . import _build


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
    ``[M, D]`` in ``x``'s dtype, accumulated in float32."""
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
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.repro_fanout_mean(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, d, code,
            _build.stream_of(x))
    _build.check(status, "fanout_mean")
    fanout_mean_cuda.launches += 1
    return out


fanout_mean_cuda.launches = 0


def fanout_mean_bwd_cuda(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gradient of the masked mean on the card: ``g [M, D]`` (float32 or
    bfloat16, contiguous CUDA), ``mask [M, K]`` bool -> ``dx [M, K, D]`` in
    ``g``'s dtype, ``g / max(count, 1) * mask`` (see
    ``ref.fanout_mean_bwd_ref``)."""
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
    lib = _build.library()
    with torch.cuda.device(g.device):
        status = lib.repro_fanout_mean_bwd(
            g.data_ptr(), mask.data_ptr(), dx.data_ptr(), m, k, d, code,
            _build.stream_of(g))
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
    ``ref.gather_reduce_ref``)."""
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
    lib = _build.library()
    with torch.cuda.device(table.device):
        status = lib.repro_gather_reduce(
            table.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, m, k, d, code, _build.stream_of(table))
    _build.check(status, "gather_reduce")
    gather_reduce_cuda.launches += 1
    return out


gather_reduce_cuda.launches = 0
