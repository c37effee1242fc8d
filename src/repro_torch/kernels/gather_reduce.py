"""ctypes wrapper of the ``fanout_mean`` CUDA kernel (``csrc/fanout_mean.cu``,
the port of ``repro/kernels/gather_reduce.py::fanout_mean_pallas``).

``fanout_mean_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from . import _build


def fanout_mean_cuda(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the fanout axis on the card: ``x [M, K, D]``
    (float32 or bfloat16, contiguous CUDA), ``mask [M, K]`` bool ->
    ``[M, D]`` in ``x``'s dtype, accumulated in float32."""
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"fanout_mean_cuda needs x and mask on one CUDA "
                         f"device, got {x.device} and {mask.device}")
    if x.dim() != 3 or mask.shape != x.shape[:2]:
        raise ValueError(f"fanout_mean_cuda needs x [M, K, D] and mask "
                         f"[M, K], got {tuple(x.shape)} and "
                         f"{tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("fanout_mean_cuda needs contiguous x and mask")
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
