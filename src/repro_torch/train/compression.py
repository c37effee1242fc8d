"""Int8 gradient compression with error feedback (port of
``repro/train/compression.py``).

Per-leaf symmetric quantization: ``scale = max(max |g|, 1e-12) / 127``,
``q = clip(round(g / scale), -127, 127)`` as int8 (round half to even in
both packages), and the residual ``g - q scale`` carried in float32 and
added to the next step's gradient before it is quantized (error
feedback: the compression bias telescopes instead of accumulating).

A leaf is one of the REFERENCE's pytree leaves, whose LM weights are
stacked over the layers (``params["layers"]["wq"]`` is ``[L, ...]``): one
scale covers every layer of a weight.  The port holds one tensor per
layer, so its gradients are grouped into the reference's leaves first
(``convert.LeafLayout.group``, done by ``train_loop``), and the residual
is kept per reference leaf; quantizing each port tensor alone would give
other scales and another result.  Every function here takes and returns
lists of leaves, bit-equal to the reference on the same float32 values.
Over a training mesh each rank holds a slice of every leaf
(``train/fsdp.py``): ``compress_grads(..., reduce_max=plan.amax)`` takes
each leaf's scale from the max over all its slices, so every slice's
``q`` and residual are the whole leaf's, bit for bit.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

_F32 = torch.float32


def quantize(g: torch.Tensor, amax: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 scalar)`` of one leaf: the division by the
    scale, not a multiplication by its inverse, as the reference.
    ``amax``, when given, is the leaf's ``max |g|`` (``g`` a slice of
    it)."""
    if amax is None:
        amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in float32."""
    return q.to(_F32) * scale


def init_error(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A zero float32 residual beside each leaf."""
    return [torch.zeros(p.shape, dtype=_F32, device=p.device)
            for p in leaves]


def compress_grads(grads: Sequence[torch.Tensor],
                   error: Sequence[torch.Tensor],
                   reduce_max: Optional[Callable] = None):
    """``(packed, new_error)``: each leaf's ``(q, scale)`` of ``g + e``
    (``g`` in float32) and its new residual ``g + e - dequantize(q,
    scale)``.  With ``reduce_max`` (``[n] -> [n]``: the leaves' maxima
    over their slices) each leaf is a slice and its scale the whole
    leaf's."""
    amax = [None] * len(grads)
    if reduce_max is not None:
        amax = reduce_max(torch.stack([
            torch.amax(torch.abs(g.to(_F32) + e))
            for g, e in zip(grads, error)])).unbind(0)
    packed, out_e = [], []
    for g, e, mx in zip(grads, error, amax):
        gf = g.to(_F32) + e
        q, s = quantize(gf, mx)
        packed.append((q, s))
        out_e.append(gf - dequantize(q, s))
    return packed, out_e


def decompress_grads(packed) -> List[torch.Tensor]:
    """Each ``(q, scale)`` leaf back to float32."""
    return [dequantize(q, s) for q, s in packed]
