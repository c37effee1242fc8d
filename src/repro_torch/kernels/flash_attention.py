"""ctypes wrapper of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``, the port of
``repro/kernels/flash_attention.py::flash_attention_pallas``).

``flash_attention_cuda`` validates its operands, allocates the output,
launches on PyTorch's current stream, raises on a launch error, and
counts its launches in ``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import torch

from . import _build

#: head dims the kernel is instantiated for (smollm's 64, and 128)
HEAD_DIMS = (64, 128)
#: query and key tile rows: both sequence lengths must be multiples
TILE = 64


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``q [B, Hq, Lq, Dh]`` and ``k``/``v
    [B, Hkv, Lk, Dh]`` are shapes the kernel takes: Hq a multiple of Hkv,
    ``Dh`` in ``HEAD_DIMS``, both lengths positive multiples of ``TILE``
    (the Pallas kernel asserts block multiples the same way)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q [B, Hq, Lq, Dh] and k/v "
                         f"[B, Hkv, Lk, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] <= 0 \
            or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (same B and Dh, Hq a multiple "
                         f"of Hkv)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel is built for head dims "
                         f"{HEAD_DIMS}, got {dh}")
    lk = k.shape[2]
    if lq <= 0 or lk <= 0 or lq % TILE or lk % TILE:
        raise ValueError(f"flash_attention needs Lq and Lk to be positive "
                         f"multiples of {TILE}, got {lq} and {lk}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Online-softmax GQA attention on the card: ``q [B, Hq, Lq, Dh]``,
    ``k``/``v [B, Hkv, Lk, Dh]`` (float32 or bfloat16, contiguous, one CUDA
    device) -> ``[B, Hq, Lq, Dh]`` in ``q``'s dtype (see
    ``ref.flash_attention_ref`` for the arithmetic)."""
    _check_shapes(q, k, v)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs its operands on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous operands")
    code = _build.dtype_code(q)
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, lq, lk, dh, int(causal), 1.0 / dh ** 0.5, code,
            _build.stream_of(q))
    _build.check(status, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
