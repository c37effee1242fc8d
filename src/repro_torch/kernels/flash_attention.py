"""ctypes wrapper of the flash-attention CUDA kernels, the port of
``repro/kernels/flash_attention.py::flash_attention_pallas``.

``flash_attention_cuda`` picks the route by the operands' dtype alone:
bfloat16 goes to the Hopper kernel (``csrc/flash_attention_sm90.cu``:
TMA loads, ``wgmma`` products) and reads any strided view whose last
dimension is contiguous, so the dense LM's ``[B, L, H, Dh]`` tensors need
no layout copy; float32 goes to the SIMT kernel
(``csrc/flash_attention.cu``) on contiguous copies.  It validates its
operands, allocates the output, launches on PyTorch's current stream,
raises on a launch error, and counts its launches in
``flash_attention_cuda.launches`` and per route in
``flash_attention_cuda.routes``.  ``flash_attention_shapes`` gives its
output as the route allocates it (the dry-run's fake call) and
``flash_attention_work`` the work it needs, ``(ops, bytes)``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

#: head dims the kernels are instantiated for (smollm's and whisper's 64,
#: the llama heads' 128, stablelm-12b's 160)
HEAD_DIMS = (64, 128, 160)
#: both sequence lengths must be multiples of this many rows
TILE = 64
#: TMA's alignment (bytes) of every stride but the last and of each base
TMA_ALIGN = 16


def check_causal(lq: int, lk: int, causal: bool) -> None:
    """Raise ``ValueError`` for causal attention with ``Lq > Lk``: the mask
    aligns the last query with the last key, so the first ``Lq - Lk``
    query rows would see no key at all (and the twin, the card's kernel and
    the Pallas reference give them three different answers)."""
    if causal and lq > lk:
        raise ValueError(f"causal flash_attention needs Lq <= Lk, got Lq "
                         f"{lq} > Lk {lk}: the first {lq - lk} query rows "
                         f"would see no key")


def check_head_dims(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless q, k and v share one head dim: the
    kernels (and the Pallas kernel, which reshapes v to q's head dim) take
    one ``Dh`` for all three, so MLA's 192-wide q/k heads over 128-wide
    values take the plain attention path."""
    dims = (q.shape[-1], k.shape[-1], v.shape[-1])
    if len(set(dims)) != 1:
        raise ValueError(f"flash_attention needs one head dim for q, k and "
                         f"v, got {dims[0]}, {dims[1]} and {dims[2]}")


def flash_attention_shapes(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True):
    """The output as the route allocates it: bfloat16 a contiguous ``[B,
    Lq, Hq, Dh]`` seen as ``[B, Hq, Lq, Dh]`` (the permutation is the
    third item), float32 a contiguous ``[B, Hq, Lq, Dh]``; after the
    wrapper's shape checks (``ValueError`` where the kernel would
    refuse)."""
    _check_shapes(q, k, v, causal)
    b, hq, lq, dh = q.shape
    if q.dtype == torch.bfloat16:
        return (((b, lq, hq, dh), q.dtype, (0, 2, 1, 3)),)
    return (((b, hq, lq, dh), q.dtype),)


def causal_pairs(lq: int, lk: int, causal: bool = True) -> int:
    """The (query, key) pairs the mask lets through: all ``Lq Lk``, or
    with ``causal`` (the last query aligned with the last key, ``Lq <=
    Lk``: ``check_causal``) row ``i`` sees ``i + Lk - Lq + 1`` keys."""
    if not causal:
        return lq * lk
    return lq * (lk - lq + 1) + lq * (lq - 1) // 2


def flash_attention_work(b: int, hq: int, lq: int, lk: int, dh: int,
                         hkv: int, causal: bool = True, item: int = 2):
    """``(ops, bytes)`` of attention at ``q [B, Hq, Lq, Dh]``, ``k``/``v
    [B, Hkv, Lk, Dh]``: ``2 Dh`` for q.k and ``2 Dh`` for p.v on each
    visible pair (``causal_pairs``); q, k and v read and the output
    written, in ``item``-byte elements."""
    pairs = causal_pairs(lq, lk, causal)
    return (4 * b * hq * dh * pairs,
            2 * (b * hq * lq * dh + b * hkv * lk * dh) * item)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> None:
    """Raise ``ValueError`` unless ``q [B, Hq, Lq, Dh]`` and ``k``/``v
    [B, Hkv, Lk, Dh]`` are shapes the kernels take: Hq a multiple of Hkv,
    ``Dh`` in ``HEAD_DIMS``, both lengths positive multiples of ``TILE``
    (the Pallas kernel asserts block multiples the same way), and ``Lq <=
    Lk`` when causal (``check_causal``)."""
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
    check_causal(lq, lk, causal)


def _check_tma_layout(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless each bfloat16 operand is a view the
    tensor maps can describe: last dimension contiguous, every other
    stride and the base address a multiple of ``TMA_ALIGN`` bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention needs {name}'s last dimension "
                             f"to have stride 1, got strides {t.stride()}")
        item = t.element_size()
        if any(s * item % TMA_ALIGN for s in t.stride()[:-1]):
            raise ValueError(f"flash_attention needs {name}'s strides to be "
                             f"multiples of {TMA_ALIGN} bytes, got "
                             f"{t.stride()} elements of {item} bytes")
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention needs {name}'s data to start "
                             f"on a {TMA_ALIGN}-byte boundary")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Online-softmax GQA attention on the card: ``q [B, Hq, Lq, Dh]``,
    ``k``/``v [B, Hkv, Lk, Dh]`` (one dtype, float32 or bfloat16, one CUDA
    device) -> ``[B, Hq, Lq, Dh]`` in ``q``'s dtype (see
    ``ref.flash_attention_ref`` for the arithmetic).  Bfloat16 operands
    may be any views with a contiguous last dimension and 16-byte aligned
    strides; their result is the ``[B, Hq, Lq, Dh]`` view of a contiguous
    ``[B, Lq, Hq, Dh]`` tensor.  Float32 operands are made contiguous."""
    _check_shapes(q, k, v, causal)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    _build.dtype_code(q)  # raises on a dtype no kernel takes
    tensor_core = q.dtype == torch.bfloat16
    if tensor_core:
        _check_tma_layout(q, k, v)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs its operands on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = 1.0 / dh ** 0.5
    lib = _build.library()
    if tensor_core:
        out = torch.empty((b, lq, hq, dh), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            status = lib.repro_flash_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, lq, lk, dh, int(causal), scale, *strides,
                _build.stream_of(q))
        route = "tensor_core"
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if b * hq > 65535:
            raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535")
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            status = lib.repro_flash_attention_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, lq, lk, dh, int(causal), scale, _build.stream_of(q))
        route = "float32"
    _build.check(status, f"flash_attention ({route})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.routes[route] += 1
    return out


def bf16_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     want: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Per-element bound on ``|kernel - twin|`` for bfloat16 operands, in
    float32: ``2^-8 * flash_attention_ref(q, k, |v|) + 2^-7 * |want| +
    1e-5``, where ``want`` is the twin's output.  The tensor-core route
    rounds each ``p`` to bfloat16 before ``P V`` (the reference's plain
    path does too), which moves an output by at most ``2^-8 sum_j p_ij
    |v_j| / l_i`` (the first term, the twin's own arithmetic on ``|v|``);
    the second covers both sides' one output rounding, the third the
    order of float32 sums."""
    mag = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                              causal=causal)
    return 2.0 ** -8 * mag + 2.0 ** -7 * want.float().abs() + 1e-5


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = {"tensor_core": 0, "float32": 0}
