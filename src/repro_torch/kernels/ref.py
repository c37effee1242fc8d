"""Plain-torch twins of the port's CUDA kernels (the ``ref.py`` contract).

Each function has the semantics of the jnp oracle of the same name in
``repro/kernels/ref.py``.  ``ops`` sends CPU tensors here, the CPU tests
hold these against ``repro``, and ``chip_smoke.py`` holds each CUDA
kernel against its twin on the card.  Nothing on the main path calls
them when the tensors are on a card.
"""
from __future__ import annotations

import torch

from .ssd_scan import chunk_len


def fanout_mean_ref(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the fanout axis: ``x [M, K, D]``, ``mask [M, K]``
    -> ``[M, D]``, accumulated in float32 and rounded once to ``x``'s
    dtype (the GCN aggregation step)."""
    m = mask.to(torch.float32)
    num = torch.einsum("mkd,mk->md", x.to(torch.float32), m)
    den = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    return (num / den).to(x.dtype)


def fanout_mean_bwd_ref(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gradient of ``fanout_mean_ref`` with respect to ``x``: ``g [M, D]``
    (the output's gradient), ``mask [M, K]`` -> ``dx [M, K, D]`` in ``g``'s
    dtype, ``dx[m, k] = g[m] / max(sum_k mask[m, k], 1) * mask[m, k]``.

    The steps of JAX's autodiff of the oracle: the cast's transpose lifts
    ``g`` to float32, the division's gives ``g / den``, the einsum's
    multiplies by the float mask, and the input cast rounds once."""
    m = mask.to(torch.float32)
    den = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    dnum = g.to(torch.float32) / den
    return (dnum[:, None, :] * m[:, :, None]).to(g.dtype)


def cache_probe_gather_ref(keys: torch.Tensor, rows: torch.Tensor,
                           ids: torch.Tensor, assoc: int = 1):
    """Set-associative probe: ``keys [C]``, ``rows [C, D]``, ``ids [R]`` ->
    ``(hit [R] bool, out [R, D])``, out the FIRST matching way's row where
    hit, zeros where missed.  Set ``s = hash(id) mod (C / assoc)`` owns
    slots ``s * assoc + j``."""
    from ..core.feature_cache import hash_slots
    sets = hash_slots(ids, keys.shape[0] // assoc).to(torch.int64)
    slots = sets[:, None] * assoc + torch.arange(assoc, device=ids.device)
    match = keys[slots] == ids[:, None]                  # [R, A]
    hit = match.any(dim=-1)
    way = torch.argmax(match.to(torch.int32), dim=-1)    # first match
    out = torch.where(hit[:, None], rows[sets * assoc + way], 0)
    return hit, out


def cache_probe_compact_ref(keys: torch.Tensor, rows: torch.Tensor,
                            ids: torch.Tensor, assoc: int = 1,
                            hit_cap: int = 1):
    """Fused probe + compact-wire encode over a stack of holders: ``keys
    [H, C]``, ``rows [H, C, D]``, ``ids [H, W, R]`` -> ``(words
    [H, W, ceil(R/32)], raw_words [H, W, ceil(R/32)], payload
    [H, W, min(hit_cap, R), D])``; holder ``h``'s cache answers ``ids[h]``
    (the stacked shard-probe round).

    Ids ``< 0`` never hit (the empty-probe-slot sentinel).  ``words``
    packs the first ``hit_cap`` hits per destination row, ``raw_words``
    every hit before that demotion, and payload slot ``p`` holds the
    ``p``-th kept row, zeros beyond.  Words are int32 bit patterns of the
    reference's uint32 words."""
    from ..core.feature_cache import compact_hit_rows, pack_hit_bitmap
    h, w, r = ids.shape
    hits, outs = zip(*(cache_probe_gather_ref(keys[i], rows[i],
                                              ids[i].reshape(-1), assoc)
                       for i in range(h)))
    hit = torch.stack(hits).reshape(h, w, r) & (ids >= 0)
    out = torch.where(hit[..., None], torch.stack(outs).reshape(h, w, r, -1),
                      0)
    kept, payload = compact_hit_rows(hit, out, hit_cap)
    return pack_hit_bitmap(kept), pack_hit_bitmap(hit), payload


def cache_probe_tiered_ref(l1_keys: torch.Tensor, l1_rows: torch.Tensor,
                           l2_keys: torch.Tensor, l2_rows: torch.Tensor,
                           ids: torch.Tensor, l1_assoc: int = 1,
                           l2_assoc: int = 1):
    """Two-tier probe: ``(src [R] int32, out [R, D])``.  ``src`` is 0 where
    both tiers miss, 1 where the L1 serves the id (it wins a double hit)
    and 2 where only the L2 does; ``out`` is the serving tier's row, zeros
    on a miss.  Like the gather probe, an id of -1 matches an empty slot;
    the caller's ``valid`` mask removes those hits."""
    l1_hit, l1_out = cache_probe_gather_ref(l1_keys, l1_rows, ids,
                                            assoc=l1_assoc)
    l2_hit, l2_out = cache_probe_gather_ref(l2_keys, l2_rows, ids,
                                            assoc=l2_assoc)
    src = torch.where(l1_hit, 1, torch.where(l2_hit, 2, 0)).to(torch.int32)
    out = torch.where(l1_hit[:, None], l1_out,
                      torch.where(l2_hit[:, None], l2_out, 0))
    return src, out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Softmax attention with GQA head grouping, in the arithmetic of
    ``repro/kernels/flash_attention.py::flash_attention_pallas`` (not of
    the jnp oracle, which forms bf16 logits): ``q [B, Hq, Lq, Dh]``,
    ``k``/``v [B, Hkv, Lk, Dh]`` -> ``[B, Hq, Lq, Dh]`` in ``q``'s dtype.

    q, k and v are upcast to float32; the logits are scaled by the float
    ``1 / sqrt(Dh)`` in float32; the causal mask (row ``i`` sees column
    ``j`` iff ``i + Lk - Lq >= j``) writes -1e30; the softmax numerator
    and denominator are float32 and the denominator is clamped at 1e-30
    before the one division and the one rounding.  Query head ``h`` reads
    KV head ``h // (Hq / Hkv)``."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, lq, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    s = s * (1.0 / dh ** 0.5)
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        cols = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32)) / den
    return out.reshape(b, hq, lq, dh).to(q.dtype)


def gather_reduce_ref(table: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Row gather then masked mean: ``table [N, D]``, ``idx [M, K]``,
    ``mask [M, K]`` -> ``[M, D]`` in ``table``'s dtype, ids clamped to
    ``[0, N - 1]`` (edge-centric collection + aggregation fused)."""
    rows = table[idx.to(torch.int64).clamp(0, table.shape[0] - 1)]
    return fanout_mean_ref(rows, mask)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor,
                 chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD chunked scan in float32 (the vectorised chunked form of
    ``repro/models/ssm.py::ssd_chunked``, the function
    ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` computes): ``x [B, L,
    H, P]``, ``dt [B, L, H]`` (> 0), ``a [H]`` (< 0), ``b_mat``/``c_mat
    [B, L, N]`` (one group, broadcast over heads) -> ``y [B, L, H, P]``
    in ``x``'s dtype: x, b and c (float32 or bfloat16) are upcast to
    float32 first and the float32 result is cast back once at the end, as
    the Pallas kernel does.

    Chunks of ``Q = min(chunk, L)`` rows (``L % Q`` must be 0).  Within a
    chunk ``cum = cumsum(a dt)`` (accumulated in float64 and rounded once
    per entry, as torch's CPU cumsum does for float32), the masked decay
    ``exp(cum_i - cum_j) dt_j`` for ``j <= i`` (the exponent of ``j > i``
    is masked to ``-inf`` before ``exp``, so no ``inf`` ever meets a 0),
    and ``y = ((C B^T) * decay) x``; across chunks the ``[H, P, N]`` state
    is carried in order, ``state' = state exp(cum_{Q-1}) + (x w)^T B``
    with ``w = dt exp(cum_{Q-1} - cum)``, and adds ``(C exp(cum))
    state^T`` to the next chunk's rows."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk_len(l, chunk)
    nc = l // q
    f32 = torch.float32
    xr = x.to(f32).reshape(bsz, nc, q, h, p)
    dtr = dt.to(f32).reshape(bsz, nc, q, h)
    br = b_mat.to(f32).reshape(bsz, nc, q, n)
    cr = c_mat.to(f32).reshape(bsz, nc, q, n)
    adt = a.to(f32)[None, None, None, :] * dtr                 # [B,NC,Q,H]
    cum = torch.cumsum(adt.to(torch.float64), dim=2).to(f32)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,NC,Q,Q,H]
    ii = torch.arange(q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    seg = torch.where(tri, seg, -torch.inf)
    l_mat = torch.exp(seg) * dtr[:, :, None, :, :]
    scores = torch.einsum("bnqc,bnkc->bnqk", cr, br)[..., None] * l_mat
    y = torch.einsum("bnqkh,bnkhp->bnqhp", scores, xr)
    w = dtr * torch.exp(cum[:, :, -1:, :] - cum)               # [B,NC,Q,H]
    s_c = torch.einsum("bnqhp,bnqk->bnhpk", xr * w[..., None], br)
    total = torch.exp(cum[:, :, -1, :])                        # [B,NC,H]
    state = torch.zeros_like(s_c[:, 0])
    prev = []
    for c in range(nc):            # state BEFORE chunk c
        prev.append(state)
        state = state * total[:, c, :, None, None] + s_c[:, c]
    st_prev = torch.stack(prev, dim=1)                         # [B,NC,H,P,N]
    inter = torch.einsum("bnqk,bnhpk->bnqhp", cr, st_prev)
    y = y + inter * torch.exp(cum)[..., None]
    return y.reshape(bsz, l, h, p).to(x.dtype)
