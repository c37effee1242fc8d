"""ctypes wrapper of the SSD-scan CUDA kernel (``csrc/ssd_scan.cu``, the
port of ``repro/kernels/ssd_scan.py::ssd_scan_pallas``).

``ssd_scan_cuda`` validates its operands, allocates the output, launches
on PyTorch's current stream, raises on a launch error, and counts its
launches in ``ssd_scan_cuda.launches``.
"""
from __future__ import annotations

import torch

from . import _build

#: the kernel's limits: chunk rows, head dim and state width
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


def chunk_len(l: int, chunk: int) -> int:
    """The chunk the scan runs, ``min(chunk, L)``; raises ``ValueError``
    unless it divides ``L`` (the Pallas kernel asserts the same)."""
    q = min(chunk, l)
    if q <= 0 or l % q:
        raise ValueError(f"ssd_scan needs L a multiple of the chunk: L = {l}, "
                         f"chunk {q}")
    return q


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """The Mamba-2 SSD chunked scan on the card: ``x [B, L, H, P]``, ``dt
    [B, L, H]``, ``a [H]``, ``b_mat``/``c_mat [B, L, N]`` (float32,
    contiguous, one CUDA device) -> ``y [B, L, H, P]`` float32, the state
    carried across chunks of ``min(chunk, L)`` rows (see
    ``ref.ssd_scan_ref`` for the arithmetic)."""
    operands = (x, dt, a, b_mat, c_mat)
    if x.device.type != "cuda" or any(t.device != x.device for t in operands):
        raise ValueError(f"ssd_scan_cuda needs its operands on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"ssd_scan_cuda takes float32 operands, got "
                        f"{[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("ssd_scan_cuda needs contiguous operands")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, L, H, P], got {tuple(x.shape)}")
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    if dt.shape != (bsz, l, h) or a.shape != (h,) \
            or b_mat.shape != (bsz, l, n) or c_mat.shape != (bsz, l, n):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b_mat.shape)}, c {tuple(c_mat.shape)}")
    q = chunk_len(l, chunk)
    if q > MAX_CHUNK or not 0 < p <= MAX_HEAD_DIM or not 0 < n <= MAX_STATE:
        raise ValueError(f"the ssd_scan kernel takes chunk <= {MAX_CHUNK}, "
                         f"head dim <= {MAX_HEAD_DIM} and state <= "
                         f"{MAX_STATE}, got {q}, {p} and {n}")
    if bsz * h > 2 ** 31 - 1:
        raise ValueError(f"B * H = {bsz * h} exceeds the grid")
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), y.data_ptr(), bsz, l, h, p, n, q,
            _build.stream_of(x))
    _build.check(status, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return y


ssd_scan_cuda.launches = 0
