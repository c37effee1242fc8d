"""Device dispatch for the port's kernels.

A CPU tensor goes to the plain-torch twin in ``ref``; a CUDA tensor goes
to the hand-written CUDA kernel, which launches or raises — there is no
fallback from the kernel to the twin, and no switch that picks one.
``launch_counts``/``reset_launch_counts`` read and zero the kernels'
launch counters (the proof that a run went through the kernels);
``flash_attention`` and ``ssd_scan`` also count per route
(``flash_route_counts``, ``ssd_route_counts``).

Fake or meta operands (the dry-run traces on
``torch._subclasses.FakeTensor``s) take neither: they cannot be launched
and hold no values for the twin.  The op returns empty outputs of the
kernel's shapes (``<kernel>_shapes``) and, inside ``fake_tally()``,
records the call and its work (``<kernel>_work``, the most the data can
need); ``launch_counts()`` never moves.  A real CUDA operand never takes
that branch.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from . import ref
from .cache_gather import (cache_probe_compact_cuda,
                           cache_probe_compact_shapes,
                           cache_probe_compact_work, cache_probe_gather_cuda,
                           cache_probe_gather_shapes, cache_probe_gather_work,
                           cache_probe_tiered_cuda, cache_probe_tiered_shapes,
                           cache_probe_tiered_work)
from .flash_attention import (check_causal, check_head_dims,
                              flash_attention_cuda, flash_attention_shapes,
                              flash_attention_work)
from .gather_reduce import (fanout_mean_bwd_cuda, fanout_mean_bwd_shapes,
                            fanout_mean_bwd_work, fanout_mean_cuda,
                            fanout_mean_shapes, fanout_mean_work,
                            gather_reduce_cuda, gather_reduce_shapes,
                            gather_reduce_work)
from .ssd_scan import (check_dtypes, ssd_scan_cuda, ssd_scan_shapes,
                       ssd_scan_work)

#: kernel name -> its CUDA wrapper (each carries a ``launches`` counter)
KERNELS = {
    "fanout_mean": fanout_mean_cuda,
    "fanout_mean_bwd": fanout_mean_bwd_cuda,
    "cache_probe_gather": cache_probe_gather_cuda,
    "cache_probe_compact": cache_probe_compact_cuda,
    "cache_probe_tiered": cache_probe_tiered_cuda,
    "flash_attention": flash_attention_cuda,
    "ssd_scan": ssd_scan_cuda,
    "gather_reduce": gather_reduce_cuda,
}


#: the dry-run's record of kernel calls on fake operands: name ->
#: ``{"calls", "flops", "bytes"}`` (None outside ``fake_tally``)
_FAKE_TALLY: Optional[Dict[str, Dict[str, int]]] = None


@contextlib.contextmanager
def fake_tally():
    """Record every kernel call on fake operands inside the block: yields
    ``{name: {"calls", "flops", "bytes"}}``, filled as the calls come
    (``flops`` is the kernel's operation count, ``<kernel>_work``)."""
    global _FAKE_TALLY
    saved, _FAKE_TALLY = _FAKE_TALLY, {}
    try:
        yield _FAKE_TALLY
    finally:
        _FAKE_TALLY = saved


def _fake(*ts: torch.Tensor) -> bool:
    """True when every operand is a fake or meta tensor (nothing to
    launch); a mix with real tensors goes on to ``_on_cuda``, which
    refuses it."""
    return all(t.is_meta or is_fake(t) for t in ts)


def _fake_call(name: str, like: torch.Tensor, shapes, work):
    """Empty outputs of ``shapes`` (``(shape, dtype[, permutation])``) on
    ``like``'s device, and the call in the tally when the kernel would
    launch (its first output has elements; the wrappers return without a
    launch otherwise)."""
    outs = []
    for spec in shapes:
        t = torch.empty(spec[0], dtype=spec[1], device=like.device)
        outs.append(t.permute(spec[2]) if len(spec) > 2 else t)
    if _FAKE_TALLY is not None and outs[0].numel():
        ops_n, n_bytes = work
        rec = _FAKE_TALLY.setdefault(name, {"calls": 0, "flops": 0,
                                            "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += int(ops_n)
        rec["bytes"] += int(n_bytes)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True when every operand is on a CUDA device, False when every one is
    on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on the CPU or all on CUDA, got "
                     f"{sorted(kinds)}")


class FanoutMean(torch.autograd.Function):
    """``fanout_mean`` with its gradient; each direction dispatches like
    every other op here.  The bool mask gets no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``[M, K, D]``, ``[M, K]`` -> ``[M, D]``."""
        ctx.save_for_backward(mask)
        if _fake(x, mask):
            m, k, d = x.shape
            return _fake_call("fanout_mean", x, fanout_mean_shapes(x, mask),
                              fanout_mean_work(m, k, d, x.element_size()))
        if _on_cuda(x, mask):
            return fanout_mean_cuda(x, mask)
        return ref.fanout_mean_ref(x, mask)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        """``dx = g / max(count, 1) * mask``; ``None`` for the mask."""
        (mask,) = ctx.saved_tensors
        return fanout_mean_bwd(g, mask), None


def fanout_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the fanout axis: ``x [M, K, D]``, ``mask [M, K]``
    -> ``[M, D]`` (the GCN aggregation step on a padded fanout tree),
    differentiable in ``x`` through ``FanoutMean`` on both devices."""
    return FanoutMean.apply(x.contiguous(), mask.contiguous())


def fanout_mean_bwd(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gradient of ``fanout_mean`` with respect to ``x``: ``g [M, D]``,
    ``mask [M, K]`` -> ``dx [M, K, D]``."""
    if _fake(g, mask):
        (m, d), k = g.shape, mask.shape[1]
        return _fake_call("fanout_mean_bwd", g,
                          fanout_mean_bwd_shapes(g, mask),
                          fanout_mean_bwd_work(m, k, d, g.element_size()))
    if _on_cuda(g, mask):
        return fanout_mean_bwd_cuda(g.contiguous(), mask.contiguous())
    return ref.fanout_mean_bwd_ref(g, mask)


def cache_probe_gather(keys: torch.Tensor, rows: torch.Tensor,
                       ids: torch.Tensor, assoc: int = 1):
    """Fused hot-node cache probe + gather: ``(hit [R], rows [R, D])``."""
    if _fake(keys, rows, ids):
        return _fake_call(
            "cache_probe_gather", ids,
            cache_probe_gather_shapes(keys, rows, ids, assoc),
            cache_probe_gather_work(ids.shape[0], keys.shape[0],
                                    rows.shape[1], assoc,
                                    rows.element_size()))
    if _on_cuda(keys, rows, ids):
        return cache_probe_gather_cuda(keys.contiguous(), rows.contiguous(),
                                       ids.contiguous(), assoc=assoc)
    return ref.cache_probe_gather_ref(keys, rows, ids, assoc=assoc)


def cache_probe_compact(keys: torch.Tensor, rows: torch.Tensor,
                        ids: torch.Tensor, assoc: int = 1, hit_cap: int = 1):
    """Fused probe + compact-wire encode of an ``[H, W, R]`` stack of
    holders' probe blocks: ``(words, raw_words, payload)`` — the
    post-demotion wire bitmap, the pre-demotion telemetry bitmap, and the
    compacted hit rows (see ``ref.cache_probe_compact_ref``)."""
    if _fake(keys, rows, ids):
        h, w, r = ids.shape
        return _fake_call(
            "cache_probe_compact", ids,
            cache_probe_compact_shapes(keys, rows, ids, assoc, hit_cap),
            cache_probe_compact_work(h, w, r, keys.shape[1], rows.shape[2],
                                     assoc, hit_cap, rows.element_size()))
    if _on_cuda(keys, rows, ids):
        return cache_probe_compact_cuda(keys.contiguous(), rows.contiguous(),
                                        ids.contiguous(), assoc=assoc,
                                        hit_cap=hit_cap)
    return ref.cache_probe_compact_ref(keys, rows, ids, assoc=assoc,
                                       hit_cap=hit_cap)


def cache_probe_tiered(l1_keys: torch.Tensor, l1_rows: torch.Tensor,
                       l2_keys: torch.Tensor, l2_rows: torch.Tensor,
                       ids: torch.Tensor, l1_assoc: int = 1, l2_assoc: int = 1):
    """Fused two-tier L1/L2 probe + gather: ``(src [R] int32, rows
    [R, D])``, src 0 miss / 1 L1 / 2 L2 (the L1 wins a double hit)."""
    if _fake(l1_keys, l1_rows, l2_keys, l2_rows, ids):
        return _fake_call(
            "cache_probe_tiered", ids,
            cache_probe_tiered_shapes(l1_keys, l1_rows, l2_keys, l2_rows, ids,
                                      l1_assoc, l2_assoc),
            cache_probe_tiered_work(ids.shape[0], l1_keys.shape[0],
                                    l2_keys.shape[0], l2_rows.shape[1],
                                    l1_assoc, l2_assoc,
                                    l2_rows.element_size()))
    if _on_cuda(l1_keys, l1_rows, l2_keys, l2_rows, ids):
        return cache_probe_tiered_cuda(
            l1_keys.contiguous(), l1_rows.contiguous(), l2_keys.contiguous(),
            l2_rows.contiguous(), ids.contiguous(), l1_assoc=l1_assoc,
            l2_assoc=l2_assoc)
    return ref.cache_probe_tiered_ref(l1_keys, l1_rows, l2_keys, l2_rows, ids,
                                      l1_assoc=l1_assoc, l2_assoc=l2_assoc)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Online-softmax attention with GQA head grouping: ``q [B, Hq, Lq,
    Dh]``, ``k``/``v [B, Hkv, Lk, Dh]`` -> ``[B, Hq, Lq, Dh]`` in ``q``'s
    dtype (the dense LM's full-sequence attention).  Causal operands need
    ``Lq <= Lk`` on both devices (``ValueError`` otherwise: the first ``Lq
    - Lk`` rows would see no key).  On the card bfloat16
    operands pass as they are (any views with a contiguous last dimension:
    the dense LM hands in its ``[B, L, H, Dh]`` tensors transposed) and the
    result is the ``[B, Hq, Lq, Dh]`` view of a contiguous ``[B, Lq, Hq,
    Dh]`` tensor; float32 operands are made contiguous by the wrapper.
    One head dim for q, k and v on both devices (``ValueError``
    otherwise: MLA's v is narrower than its q and k).

    Forward only, as in the reference (``jax.grad`` cannot pass through
    ``flash_attention_pallas``): an operand that requires grad under
    autograd raises on both devices rather than leave the card's output
    without a ``grad_fn``.  LM training runs the plain attention in both
    packages (``use_flash_attention`` off, the default)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: run it under "
            "torch.no_grad(), or train with use_flash_attention off (the "
            "default); a flash backward kernel is a later redesign, "
            "ROADMAP Queue 2 item 6, not one of Queue 1 item 6's modules)")
    check_head_dims(q, k, v)
    check_causal(q.shape[-2], k.shape[-2], causal)
    if _fake(q, k, v):
        (b, hq, lq, dh), (hkv, lk) = q.shape, k.shape[1:3]
        return _fake_call(
            "flash_attention", q, flash_attention_shapes(q, k, v, causal),
            flash_attention_work(b, hq, lq, lk, dh, hkv, causal,
                                 q.element_size()))
    if _on_cuda(q, k, v):
        return flash_attention_cuda(q, k, v, causal=causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD chunked scan: ``x [B, L, H, P]``, ``dt [B, L, H]``,
    ``a [H]``, ``b_mat``/``c_mat [B, L, N]`` -> ``y [B, L, H, P]`` in
    ``x``'s dtype, the state carried across chunks of ``min(chunk, L)``
    rows (every layer of the SSM's full-sequence forward).  x, b and c are
    float32 or bfloat16 (one dtype), dt and a float32 (``TypeError``
    otherwise).  On the card bfloat16 x, b and c pass as they are (any
    views with a contiguous last dimension: the SSM hands in views of its
    conv output) to the tensor-core kernel; float32 ones go to the SIMT
    kernel.

    Forward only, as the reference's Pallas kernel: an operand that
    requires grad under autograd raises on both devices rather than leave
    the card's output without a ``grad_fn``; the SSM's training forward
    reaches it through ``models.ssm.SSDScan``, whose backward is the vjp
    of ``ssd_chunked``.  ``L`` not a multiple of the chunk raises
    ``ValueError`` (the Pallas kernel asserts it)."""
    operands = (x, dt, a, b_mat, c_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise NotImplementedError(
            "ssd_scan has no backward yet: run it under torch.no_grad(), "
            "or differentiate through models.ssm.SSDScan (the kernel "
            "forward, the vjp of ssd_chunked backward; a backward kernel "
            "is a later redesign, ROADMAP Queue 2 item 6, not one of Queue "
            "1 item 6's modules)")
    check_dtypes(*operands)
    if _fake(*operands):
        (bsz, l, h, p), n = x.shape, b_mat.shape[-1]
        return _fake_call("ssd_scan", x, ssd_scan_shapes(*operands, chunk),
                          ssd_scan_work(bsz, l, h, p, n, chunk,
                                        x.element_size()))
    if _on_cuda(*operands):
        return ssd_scan_cuda(*operands, chunk=chunk)
    return ref.ssd_scan_ref(*operands, chunk=chunk)


def gather_reduce(table: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Fused row gather and masked mean: ``table [N, D]``, ``idx [M, K]``
    int32 (clamped to ``[0, N - 1]``), ``mask [M, K]`` bool -> ``[M, D]``
    in ``table``'s dtype (edge-centric collection + aggregation).
    Forward only, as in the reference."""
    if _fake(table, idx, mask):
        (n, d), (m, k) = table.shape, idx.shape
        return _fake_call("gather_reduce", table,
                          gather_reduce_shapes(table, idx, mask),
                          gather_reduce_work(m, k, d, n,
                                             table.element_size()))
    if _on_cuda(table, idx, mask):
        return gather_reduce_cuda(table.contiguous(), idx.contiguous(),
                                  mask.contiguous())
    return ref.gather_reduce_ref(table, idx, mask)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def flash_route_counts() -> Dict[str, int]:
    """``flash_attention`` launches since the last reset, by route
    (``tensor_core``: bfloat16; ``float32``: the SIMT kernel)."""
    return dict(flash_attention_cuda.routes)


def ssd_route_counts() -> Dict[str, int]:
    """``ssd_scan`` launches since the last reset, by route
    (``tensor_core``: bfloat16; ``float32``: the SIMT kernel)."""
    return dict(ssd_scan_cuda.routes)


def reset_launch_counts() -> None:
    """Zero every kernel's launch counter (and the per-route ones of
    flash_attention and ssd_scan)."""
    for fn in KERNELS.values():
        fn.launches = 0
    for routes in (flash_attention_cuda.routes, ssd_scan_cuda.routes):
        for route in routes:
            routes[route] = 0
