"""ctypes wrapper of the SSD-scan CUDA kernels, the port of
``repro/kernels/ssd_scan.py::ssd_scan_pallas``.

``ssd_scan_cuda`` picks the route by ``x``'s dtype alone: bfloat16 goes to
the Hopper kernel (``csrc/ssd_scan_sm90.cu``: TMA loads, ``wgmma``
products) and reads any strided views of x, b and c whose last dimension
is contiguous, so the SSM's three views of its conv output need no copy;
float32 goes to the SIMT kernel (``csrc/ssd_scan.cu``) on contiguous
copies.  It validates its operands, allocates the output, launches on
PyTorch's current stream, raises on a launch error, and counts its
launches in ``ssd_scan_cuda.launches`` and per route in
``ssd_scan_cuda.routes``.  ``bf16_error_bound`` is the gate the bfloat16
route is held to against the twin.
"""
from __future__ import annotations

import torch

from . import _build

#: the float32 kernel's limits: chunk rows, head dim and state width
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
#: the tensor-core kernel's shapes: head dim, state widths, chunks
TC_HEAD_DIM, TC_STATES, TC_CHUNKS = 64, (64, 128), (64, 128)
#: TMA's alignment (bytes) of every stride but the last and of each base
TMA_ALIGN = 16
#: bf16 operand roundings on the longest path of the tensor-core route
#: (x . w into the state, then the state's bf16 copy read by the inter
#: term; the scores' rounding lies on the other, intra-chunk path)
BF16_ROUNDINGS = 2


def chunk_len(l: int, chunk: int) -> int:
    """The chunk the scan runs, ``min(chunk, L)``; raises ``ValueError``
    unless it divides ``L`` (the Pallas kernel asserts the same)."""
    q = min(chunk, l)
    if q <= 0 or l % q:
        raise ValueError(f"ssd_scan needs L a multiple of the chunk: L = {l}, "
                         f"chunk {q}")
    return q


def ssd_scan_shapes(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor,
                    chunk: int = 128):
    """The output, a contiguous ``y [B, L, H, P]`` in x's dtype, after the
    checks of the wrapper that need no data: the shapes, the chunk and
    the route's dims (``ValueError`` where the kernel would refuse)."""
    _check_shapes(x, dt, a, b_mat, c_mat)
    _check_route_dims(x.dtype, x.shape[-1], b_mat.shape[-1],
                      chunk_len(x.shape[1], chunk))
    return ((tuple(x.shape), x.dtype),)


def ssd_scan_work(b: int, l: int, h: int, p: int, n: int, chunk: int,
                  item: int = 2):
    """``(ops, bytes)`` of the scan at ``x [B, L, H, P]``, ``b``/``c
    [B, L, N]`` (``item``-byte elements; dt and a float32): C B^T over
    the causal pairs once per (batch, chunk), shared by the heads; per
    head the decay (exp and two products) and scores x over the pairs;
    the inter-chunk read-out and the state update, 2 P N each per row,
    after the first chunk only (the state before it is zero).  x, b and
    c read, y written, dt and a read."""
    q = min(chunk, l)
    nc, pairs = l // q, q * (q + 1) // 2
    ops = (2 * b * nc * pairs * n + b * h * nc * pairs * (2 * p + 3)
           + 2 * b * h * (l - q) * 2 * n * p)
    return ops, (item * (2 * b * l * h * p + 2 * b * l * n)
                 + 4 * (b * l * h + h))


def check_dtypes(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor) -> None:
    """Raise ``TypeError`` unless x, b and c share one dtype, float32 or
    bfloat16, and dt and a are float32 (the reference's operand types)."""
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, b and c in one dtype, float32 or "
                        f"bfloat16, got {x.dtype}, {b_mat.dtype}, "
                        f"{c_mat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes dt and a in float32, got {dt.dtype}, "
                        f"{a.dtype}")


def _check_shapes(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``x [B, L, H, P]``, ``dt [B, L, H]``,
    ``a [H]`` and ``b``/``c [B, L, N]`` agree."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, L, H, P], got {tuple(x.shape)}")
    bsz, l, h, _ = x.shape
    n = b_mat.shape[-1]
    if dt.shape != (bsz, l, h) or a.shape != (h,) \
            or b_mat.shape != (bsz, l, n) or c_mat.shape != (bsz, l, n):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b_mat.shape)}, c {tuple(c_mat.shape)}")


def _check_route_dims(dtype, p: int, n: int, q: int) -> None:
    """Raise ``ValueError`` unless the route of ``dtype`` takes head dim
    ``p``, state ``n`` and chunk ``q``: bfloat16 (the tensor cores) head
    dim ``TC_HEAD_DIM``, state and chunk in ``TC_STATES``/``TC_CHUNKS``;
    float32 (SIMT) chunk, head dim and state up to ``MAX_CHUNK``,
    ``MAX_HEAD_DIM`` and ``MAX_STATE``."""
    if dtype == torch.bfloat16:
        if p != TC_HEAD_DIM or n not in TC_STATES or q not in TC_CHUNKS:
            raise ValueError(f"the bfloat16 ssd_scan kernel takes head dim "
                             f"{TC_HEAD_DIM}, state {TC_STATES} and chunk "
                             f"{TC_CHUNKS}, got {p}, {n} and {q}")
    elif q > MAX_CHUNK or not 0 < p <= MAX_HEAD_DIM or not 0 < n <= MAX_STATE:
        raise ValueError(f"the float32 ssd_scan kernel takes chunk <= "
                         f"{MAX_CHUNK}, head dim <= {MAX_HEAD_DIM} and "
                         f"state <= {MAX_STATE}, got {q}, {p} and {n}")


def _check_tensor_core(x: torch.Tensor, b_mat: torch.Tensor,
                       c_mat: torch.Tensor, q: int) -> None:
    """Raise ``ValueError`` unless the tensor-core kernel takes these
    bfloat16 operands: head dim ``TC_HEAD_DIM``, state width and chunk in
    ``TC_STATES`` and ``TC_CHUNKS``, and each of x, b and c a view the
    tensor maps can describe (last dimension contiguous, every other stride
    and the base a multiple of ``TMA_ALIGN`` bytes)."""
    _check_route_dims(x.dtype, x.shape[-1], b_mat.shape[-1], q)
    for name, t in (("x", x), ("b", b_mat), ("c", c_mat)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan needs {name}'s last dimension to have "
                             f"stride 1, got strides {t.stride()}")
        if any(s * 2 % TMA_ALIGN for s in t.stride()[:-1]):
            raise ValueError(f"ssd_scan needs {name}'s strides to be "
                             f"multiples of {TMA_ALIGN} bytes, got "
                             f"{t.stride()} elements of 2 bytes")
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"ssd_scan needs {name}'s data to start on a "
                             f"{TMA_ALIGN}-byte boundary")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """The Mamba-2 SSD chunked scan on the card: ``x [B, L, H, P]``, ``dt
    [B, L, H]``, ``a [H]``, ``b_mat``/``c_mat [B, L, N]`` (one CUDA device)
    -> ``y [B, L, H, P]`` in ``x``'s dtype, the state carried across chunks
    of ``min(chunk, L)`` rows (see ``ref.ssd_scan_ref`` for the
    arithmetic).  Bfloat16 x, b and c may be any views with a contiguous
    last dimension and 16-byte aligned strides (P 64, N 64 or 128, chunk
    64 or 128); float32 ones are made contiguous (P <= 64, N <= 128, chunk
    <= 128).  dt and a are float32."""
    _check_shapes(x, dt, a, b_mat, c_mat)
    check_dtypes(x, dt, a, b_mat, c_mat)
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk_len(l, chunk)
    tensor_core = x.dtype == torch.bfloat16
    if tensor_core:
        _check_tensor_core(x, b_mat, c_mat, q)
    operands = (x, dt, a, b_mat, c_mat)
    if x.device.type != "cuda" or any(t.device != x.device for t in operands):
        raise ValueError(f"ssd_scan_cuda needs its operands on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    if bsz * h > 2 ** 31 - 1:
        raise ValueError(f"B * H = {bsz * h} exceeds the grid")
    dt, a = dt.contiguous(), a.contiguous()
    lib = _build.library()
    if tensor_core:
        y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            status = lib.repro_ssd_scan_sm90(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), y.data_ptr(), bsz, l, h, n, q,
                *x.stride()[:3], *b_mat.stride()[:2], *c_mat.stride()[:2],
                _build.stream_of(x))
        route = "tensor_core"
    else:
        _check_route_dims(x.dtype, p, n, q)
        x, b_mat, c_mat = x.contiguous(), b_mat.contiguous(), \
            c_mat.contiguous()
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            status = lib.repro_ssd_scan(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), y.data_ptr(), bsz, l, h, p, n, q,
                _build.stream_of(x))
        route = "float32"
    _build.check(status, f"ssd_scan ({route})")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.routes[route] += 1
    return y


def bf16_error_bound(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b_mat: torch.Tensor, c_mat: torch.Tensor,
                     chunk: int = 128) -> torch.Tensor:
    """Per-element bound on ``|kernel - twin|`` for bfloat16 operands, in
    float32: ``(BF16_ROUNDINGS * 2^-8 + 2^-7 + 2^-12) * M`` with ``M =
    ssd_scan_ref(|x|, dt, a, |b|, |c|)``.

    Every term of y is a product of nonnegative decays and dt with x, b
    and c, so M bounds the sum of the terms' magnitudes, on the intra- and
    the inter-chunk path alike.  The tensor-core route rounds three
    operands it forms to bfloat16, each by at most 2^-8 of itself: the
    scores (one rounding on the intra path), and x . w and the bf16 copy
    of the float32 state (two on the inter path, the state's own error
    not compounding: it is carried in float32 and each chunk's update
    enters it once); so the kernel's float32 y lies within
    ``BF16_ROUNDINGS * 2^-8 * M`` of the twin's.  Both round y to bfloat16
    once (2^-7 M for the two), and 2^-12 M covers the second-order terms,
    the order of float32 sums and the approximate exponentials."""
    f32 = torch.float32
    from .ref import ssd_scan_ref
    mag = ssd_scan_ref(x.to(f32).abs(), dt.to(f32), a.to(f32),
                       b_mat.to(f32).abs(), c_mat.to(f32).abs(), chunk=chunk)
    return (BF16_ROUNDINGS * 2.0 ** -8 + 2.0 ** -7 + 2.0 ** -12) * mag


ssd_scan_cuda.launches = 0
ssd_scan_cuda.routes = {"tensor_core": 0, "float32": 0}
