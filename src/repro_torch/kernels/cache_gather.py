"""ctypes wrappers of the cache-probe CUDA kernels
(``csrc/cache_probe_gather.cu``, ``csrc/cache_probe_compact.cu`` and
``csrc/cache_probe_tiered.cu``, the ports of
``repro/kernels/cache_gather.py``'s ``cache_probe_gather_pallas``,
``cache_probe_compact_pallas`` and ``cache_probe_tiered_pallas``).

Each wrapper validates its operands, allocates the outputs, launches on
PyTorch's current stream, raises on a launch error, and counts its
launches in ``<wrapper>.launches``.  ``<kernel>_shapes`` gives each
kernel's outputs for its operands (the dry-run's fake call) and
``<kernel>_work`` the work it needs, ``(ops, bytes)``: each input byte
read once, each output byte written once, and of the cache's rows only
those the hits need (the bound ``chip_smoke.py`` prints and the
dry-run's count).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import VALID_CACHE_ASSOC
from . import _build


def _shift_for(n_sets: int) -> int:
    """Hash shift for a power-of-two set count; 32 marks the single-set
    cache, which the kernels map to set 0 without shifting."""
    return 32 if n_sets == 1 else 32 - (int(n_sets).bit_length() - 1)


def _check_cache(keys: torch.Tensor, rows: torch.Tensor, assoc: int) -> int:
    """Validate a ``keys [..., C]`` / ``rows [..., C, D]`` cache block and
    return its hash shift."""
    c = keys.shape[-1]
    if c <= 0 or c & (c - 1):
        raise ValueError(f"cache size must be a power of two, got {c}")
    if assoc not in VALID_CACHE_ASSOC or assoc > c:
        raise ValueError(f"assoc must be one of {VALID_CACHE_ASSOC} and "
                         f"<= {c}, got {assoc}")
    if rows.shape[:-1] != keys.shape:
        raise ValueError(f"rows {tuple(rows.shape)} do not match keys "
                         f"{tuple(keys.shape)}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    return _shift_for(c // assoc)


def cache_probe_gather_shapes(keys: torch.Tensor, rows: torch.Tensor,
                              ids: torch.Tensor, assoc: int = 1):
    """The gather probe's outputs: ``hit [R]`` bool, ``out [R, D]``."""
    r, d = ids.shape[0], rows.shape[1]
    return (((r,), torch.bool), ((r, d), rows.dtype))


def cache_probe_gather_work(r: int, c: int, d: int, assoc: int,
                            item: int = 4, hit_rows=None):
    """``(ops, bytes)`` of the gather probe of ``r`` ids against ``c``
    slots of ``d``-wide rows: a hash, a compare per way and a select per
    id; ids and keys read, the ``hit_rows`` distinct rows the hits name
    read once, hit flags and rows written.  ``hit_rows`` depends on the
    data: None counts the most it can be, ``min(r, c)``."""
    hit_rows = min(r, c) if hit_rows is None else hit_rows
    return (r * (2 + assoc),
            r * 4 + c * 4 + hit_rows * d * item + r + r * d * item)


def cache_probe_compact_shapes(keys: torch.Tensor, rows: torch.Tensor,
                               ids: torch.Tensor, assoc: int = 1,
                               hit_cap: int = 1):
    """The compact probe's outputs: ``words``/``raw_words [H, W,
    ceil(R/32)]`` int32 and ``payload [H, W, min(hit_cap, R), D]``."""
    h, w, r = ids.shape
    n_words = -(-r // 32)
    return (((h, w, n_words), torch.int32), ((h, w, n_words), torch.int32),
            ((h, w, min(hit_cap, r), rows.shape[2]), rows.dtype))


def cache_probe_compact_work(h: int, w: int, r: int, c: int, d: int,
                             assoc: int, hit_cap: int, item: int = 4,
                             kept=None):
    """``(ops, bytes)`` of the compact probe of ``ids [H, W, R]`` against
    ``H`` holders of ``c`` slots: a hash, a compare per way and a select
    per id; ids and keys read, the ``kept`` hit rows read once, both
    bitmaps and the payload written.  ``kept`` (the wire bitmap's set
    bits) depends on the data: None counts the most it can be, a full
    payload ``H W min(hit_cap, R)``."""
    n_words, hc = -(-r // 32), min(hit_cap, r)
    kept = h * w * hc if kept is None else kept
    return (h * w * r * (2 + assoc),
            h * w * r * 4 + h * c * 4 + kept * d * item
            + 2 * h * w * n_words * 4 + h * w * hc * d * item)


def cache_probe_tiered_shapes(l1_keys: torch.Tensor, l1_rows: torch.Tensor,
                              l2_keys: torch.Tensor, l2_rows: torch.Tensor,
                              ids: torch.Tensor, l1_assoc: int = 1,
                              l2_assoc: int = 1):
    """The tiered probe's outputs: ``src [R]`` int32, ``out [R, D]``."""
    r, d = ids.shape[0], l2_rows.shape[1]
    return (((r,), torch.int32), ((r, d), l2_rows.dtype))


def cache_probe_tiered_work(r: int, c1: int, c2: int, d: int, l1_assoc: int,
                            l2_assoc: int, item: int = 4, hit_rows=None):
    """``(ops, bytes)`` of the tiered probe of ``r`` ids against an L1 of
    ``c1`` and an L2 of ``c2`` slots: two hashes, a compare per way of
    each tier and two selects per id; ids and both tiers' keys read, the
    ``hit_rows`` distinct rows the hits name (both tiers) read once, the
    tier per id and the rows written.  ``hit_rows`` depends on the data:
    None counts the most it can be, ``min(r, c1 + c2)``."""
    hit_rows = min(r, c1 + c2) if hit_rows is None else hit_rows
    return (r * (4 + l1_assoc + l2_assoc),
            r * 4 + (c1 + c2) * 4 + hit_rows * d * item + r * 4
            + r * d * item)


def _check_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"the probe kernels need every operand on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the probe kernels need contiguous operands")


def cache_probe_gather_cuda(keys: torch.Tensor, rows: torch.Tensor,
                            ids: torch.Tensor, assoc: int = 1):
    """Probe ``ids [R]`` against one ``assoc``-way cache (``keys [C]``,
    ``rows [C, D]``) on the card: ``(hit [R] bool, out [R, D])``, the first
    matching way's row where hit, zeros where missed."""
    _check_device(keys, rows, ids)
    if keys.dim() != 1 or rows.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"need keys [C], rows [C, D], ids [R]; got "
                         f"{tuple(keys.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(ids.shape)}")
    shift = _check_cache(keys, rows, assoc)
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    code = _build.dtype_code(rows)
    r, d = ids.shape[0], rows.shape[1]
    hit = torch.empty((r,), dtype=torch.bool, device=ids.device)
    out = torch.empty((r, d), dtype=rows.dtype, device=ids.device)
    if r == 0:
        return hit, out
    lib = _build.library()
    with torch.cuda.device(ids.device):
        status = lib.repro_cache_probe_gather(
            keys.data_ptr(), rows.data_ptr(), ids.data_ptr(), hit.data_ptr(),
            out.data_ptr(), r, d, assoc, shift, code, _build.stream_of(ids))
    _build.check(status, "cache_probe_gather")
    cache_probe_gather_cuda.launches += 1
    return hit, out


cache_probe_gather_cuda.launches = 0


#: the portable thread-block cluster size (the compact probe's S <= 8)
MAX_CLUSTER = 8
#: shared memory one CTA may take on the H100 (227 KB)
SMEM_LIMIT = 232_448


class CompactPlan(NamedTuple):
    """Launch plan of ``csrc/cache_probe_compact.cu``: a grid of
    ``(cluster, W, H)`` CTAs in clusters of ``cluster`` along each
    destination row."""
    cluster: int        # S, the CTAs of one destination row
    words_per_cta: int  # bitmap words each cluster rank owns
    smem: int           # dynamic shared memory per CTA, bytes


def compact_plan(n_holders: int, n_dest: int, n_probe: int, n_slots_c: int,
                 n_sm: int = 132) -> CompactPlan:
    """The compact probe's plan: ``S = clamp(ceil(n_sm / (H W)), 1, 8)``,
    at most one CTA per bitmap word, each rank owning ``ceil(n_words / S)``
    whole words; shared memory holds the holder's ``n_slots_c`` keys and,
    per owned slot, its matched slot and kept-list entry, per owned word
    its ballot and offset (``4 (C + 66 words_per_cta)`` bytes)."""
    n_words = -(-n_probe // 32)
    s = max(1, min(-(-n_sm // (n_holders * n_dest)), MAX_CLUSTER, n_words))
    wpc = -(-n_words // s)
    return CompactPlan(s, wpc, 4 * (n_slots_c + 66 * wpc))


def cache_probe_compact_cuda(keys: torch.Tensor, rows: torch.Tensor,
                             ids: torch.Tensor, assoc: int = 1,
                             hit_cap: int = 1):
    """Fused probe + compact-wire encode on the card, in ONE launch for
    every holder and destination.

    ``keys [H, C]``, ``rows [H, C, D]``, ``ids [H, W, R]`` -> ``(words
    [H, W, ceil(R/32)], raw_words [H, W, ceil(R/32)], payload
    [H, W, min(hit_cap, R), D])``; holder ``h``'s cache answers
    ``ids[h]``.  Words are the int32 bit patterns of the uint32 bitmap
    words.  Launched as ``compact_plan`` says; raises ``ValueError`` where
    the plan's shared memory exceeds the card's or a 16-byte-route row
    base is misaligned, and ``RuntimeError`` where CUDA refuses the
    cluster launch."""
    _check_device(keys, rows, ids)
    if keys.dim() != 2 or rows.dim() != 3 or ids.dim() != 3 \
            or ids.shape[0] != keys.shape[0]:
        raise ValueError(f"need keys [H, C], rows [H, C, D], ids [H, W, R]; "
                         f"got {tuple(keys.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(ids.shape)}")
    shift = _check_cache(keys, rows, assoc)
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    h, w, r = ids.shape
    if r < 1 or w < 1:
        raise ValueError(f"need at least one destination and one probe "
                         f"slot, got ids shape {tuple(ids.shape)}")
    hc = min(hit_cap, r)
    if hc < 1:
        raise ValueError("hit_cap must be >= 1 (a zero-row payload cannot "
                         "ship hits; use the dense wire to disable)")
    code = _build.dtype_code(rows)
    c, d = keys.shape[1], rows.shape[2]
    n_words = -(-r // 32)
    dev = ids.device
    plan = compact_plan(h, w, r, c, _build.sm_count(dev))
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"cache_probe_compact_cuda: {c} keys per holder and "
                         f"{plan.words_per_cta} bitmap words per CTA need "
                         f"{plan.smem} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    vec = (d * rows.element_size()) % 16 == 0
    if vec and rows.data_ptr() % 16:
        raise ValueError("cache_probe_compact_cuda: rows of a 16-byte "
                         "multiple width take 16-byte loads and need a "
                         "16-byte aligned base")
    words = torch.empty((h, w, n_words), dtype=torch.int32, device=dev)
    raw = torch.empty((h, w, n_words), dtype=torch.int32, device=dev)
    payload = torch.empty((h, w, hc, d), dtype=rows.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.repro_cache_probe_compact(
            keys.data_ptr(), rows.data_ptr(), ids.data_ptr(),
            words.data_ptr(), raw.data_ptr(), payload.data_ptr(),
            h, c, w, r, n_words, hc, d, assoc, shift, code, plan.cluster,
            plan.words_per_cta, plan.smem, int(vec), _build.stream_of(ids))
    _build.check(status, "cache_probe_compact")
    cache_probe_compact_cuda.launches += 1
    return words, raw, payload


cache_probe_compact_cuda.launches = 0


#: ids one warp of ``cache_probe_tiered`` probes, one a lane (the kernel's
#: ``kIdsPerWarp``)
TIERED_IDS = 8
#: warps of one ``cache_probe_tiered`` CTA (the kernel's ``kWarps``)
TIERED_WARPS = 1


class TieredPlan(NamedTuple):
    """Launch plan of ``csrc/cache_probe_tiered.cu``."""
    vec: int   # elements of one row unit (16 bytes), or 1
    grid: int  # CTAs of TIERED_WARPS warps of TIERED_IDS ids


def tiered_plan(r: int, d: int, elem_size: int,
                aligned: bool = True) -> TieredPlan:
    """The tiered probe's plan for ``r`` ids and rows of ``d``
    ``elem_size``-byte elements.  Rows of a 16-byte multiple width on
    16-byte aligned bases move as 16-byte units, others on the scalar
    route; ``TIERED_IDS`` ids per warp and CTAs of ``TIERED_WARPS`` warps,
    so the grid spreads evenly over the SMs (3 664 one-warp CTAs at the
    deep step's R = 29 312, ~28 an SM: one wave)."""
    vec = (16 // elem_size if aligned and (d * elem_size) % 16 == 0
           else 1)
    return TieredPlan(vec, max(-(-r // (TIERED_IDS * TIERED_WARPS)), 1))


def cache_probe_tiered_cuda(l1_keys: torch.Tensor, l1_rows: torch.Tensor,
                            l2_keys: torch.Tensor, l2_rows: torch.Tensor,
                            ids: torch.Tensor, l1_assoc: int = 1,
                            l2_assoc: int = 1):
    """Probe ``ids [R]`` against the L1 (``l1_keys [C1]``, ``l1_rows
    [C1, D]``) and the L2 (``l2_keys [C2]``, ``l2_rows [C2, D]``) on the
    card: ``(src [R] int32, out [R, D])`` — 0 miss, 1 L1 (it wins a double
    hit), 2 L2 — and the serving tier's row, zeros on a miss.  Launched as
    ``tiered_plan`` says."""
    _check_device(l1_keys, l1_rows, l2_keys, l2_rows, ids)
    if (l1_keys.dim() != 1 or l2_keys.dim() != 1 or l1_rows.dim() != 2
            or l2_rows.dim() != 2 or ids.dim() != 1):
        raise ValueError(f"need keys [C], rows [C, D] per tier and ids [R]; "
                         f"got {tuple(l1_keys.shape)}, {tuple(l1_rows.shape)}, "
                         f"{tuple(l2_keys.shape)}, {tuple(l2_rows.shape)}, "
                         f"{tuple(ids.shape)}")
    shift1 = _check_cache(l1_keys, l1_rows, l1_assoc)
    shift2 = _check_cache(l2_keys, l2_rows, l2_assoc)
    if l1_rows.shape[1] != l2_rows.shape[1] or l1_rows.dtype != l2_rows.dtype:
        raise ValueError(f"tier rows differ: {tuple(l1_rows.shape)} "
                         f"{l1_rows.dtype} vs {tuple(l2_rows.shape)} "
                         f"{l2_rows.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if max(l1_keys.shape[0], l2_keys.shape[0]) > 1 << 30:
        raise ValueError("cache_probe_tiered_cuda takes tiers of at most "
                         "2^30 rows")
    code = _build.dtype_code(l2_rows)
    r, d = ids.shape[0], l2_rows.shape[1]
    src = torch.empty((r,), dtype=torch.int32, device=ids.device)
    out = torch.empty((r, d), dtype=l2_rows.dtype, device=ids.device)
    if r == 0:
        return src, out
    plan = tiered_plan(
        r, d, out.element_size(),
        aligned=all(t.data_ptr() % 16 == 0 for t in (l1_rows, l2_rows, out)))
    lib = _build.library()
    with torch.cuda.device(ids.device):
        status = lib.repro_cache_probe_tiered(
            l1_keys.data_ptr(), l1_rows.data_ptr(), l2_keys.data_ptr(),
            l2_rows.data_ptr(), ids.data_ptr(), src.data_ptr(),
            out.data_ptr(), r, d, l1_assoc, shift1, l2_assoc, shift2, code,
            plan.vec, plan.grid, _build.stream_of(ids))
    _build.check(status, "cache_probe_tiered")
    cache_probe_tiered_cuda.launches += 1
    return src, out


cache_probe_tiered_cuda.launches = 0
