"""Building blocks of the LMs (port of ``repro/models/layers.py``).

Plain functions on tensors.  Weights keep the reference's ``x @ W``
layout (``[d_in, d_out]``) and stay float32; activations run in
``COMPUTE_DTYPE`` (bfloat16, as in the reference), with the norms, rope,
softmax and logits in float32.  The attention's full-sequence branch is
``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
twin on the CPU.  The reference's mesh helpers (``shard*``,
``set_mesh``), ``chunked_attention``/``ATTN_IMPL`` and ``maybe_remat``
are XLA/TPU knobs with no counterpart here yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..kernels import ops

#: activation dtype of the forward and decode paths (tests set float32
#: here and in the reference to compare the two without bf16 rounding)
COMPUTE_DTYPE = torch.bfloat16
_NEG = -1e30


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``w * x / rms(x)`` with float32 statistics and product, cast back
    to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (w * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Rotary frequencies ``theta ** (-2i / Dh)`` for ``i < Dh / 2``."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate ``x [..., L, H, Dh]`` by integer positions ``pos [..., L]``
    in the rotate-half layout: ``[x1 cos - x2 sin, x1 sin + x2 cos]`` over
    the two halves of Dh (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = pos[..., None].to(torch.float32) * freqs       # [..., L, Dh/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., L, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, use_flash: bool = False,
                  kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention: ``q [B, Lq, Hq, Dh]``, ``k``/``v [B, Lk,
    Hkv, Dh]`` -> ``[B, Lq, Hq, Dh]``.

    With ``use_flash``, no ``kv_valid_len`` and both lengths multiples of
    128 (the reference's own predicate) it runs ``ops.flash_attention`` on
    ``[B, H, L, Dh]`` views of the operands (no copy: the card's bf16
    kernel reads these strides in place and returns the view of a
    ``[B, Lq, Hq, Dh]`` tensor, so the transpose back is contiguous).
    Otherwise the plain masked path: logits in float32, scaled after the
    cast, causal with offset ``Lk - Lq``, keys at or past ``kv_valid_len``
    masked (decode against a cache), softmax in float32 and cast to the
    compute dtype before ``p @ v``."""
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if use_flash and kv_valid_len is None and lq % 128 == 0 \
            and lk % 128 == 0:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    qg = q.reshape(b, lq, hkv, hq // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = logits * (1.0 / dh ** 0.5)
    if causal and lq > 1:
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits, _NEG)
    if kv_valid_len is not None:
        valid = torch.arange(lk, device=q.device) < kv_valid_len
        logits = torch.where(valid, logits, _NEG)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, lq, hq, v.shape[-1])


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, *, pos: torch.Tensor,
                 causal: bool = True, rope: bool = True,
                 kv_x: Optional[torch.Tensor] = None,
                 cache: Optional[tuple] = None,
                 cache_pos: Optional[int] = None):
    """Self- or cross-attention of ``x [B, L, D]``; ``p`` holds ``wq``,
    ``wk``, ``wv``, ``wo``.  Returns ``(out, new_cache)``.

    Keys and values are projected from ``kv_x [B, Lk, D]`` when it is
    given (cross-attention), else from ``x``.  With ``rope`` the queries
    and keys are roped at ``pos [B, L]`` (the keys at ``cache_pos`` with
    a cache); without it neither is (the cross-attention of the VLM and
    Whisper).  The attention is causal only when ``causal`` is set and no
    cache is given.

    With ``cache = (k_cache, v_cache)`` (``[B, S, Hkv * Dh]`` bfloat16)
    the step's keys are roped at ``cache_pos``, written into the cache IN
    PLACE at ``cache_pos`` (the reference returns an updated copy; the
    port saves the copy), and the query attends over the whole cache with
    keys from ``cache_pos + L`` on masked."""
    b, l, _ = x.shape
    hd = cfg.resolved_head_dim
    src = x if kv_x is None else kv_x
    lk = src.shape[1]
    q = (x @ p.wq.to(x.dtype)).reshape(b, l, cfg.n_heads, hd)
    k = (src @ p.wk.to(x.dtype)).reshape(b, lk, cfg.n_kv_heads, hd)
    v = (src @ p.wv.to(x.dtype)).reshape(b, lk, cfg.n_kv_heads, hd)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        kpos = pos if cache is None else torch.full(
            (b, lk), cache_pos, dtype=pos.dtype, device=pos.device)
        k = apply_rope(k, kpos, cfg.rope_theta)
    new_cache = kv_valid = None
    if cache is not None:
        kc, vc = cache
        s = kc.shape[1]
        kc[:, cache_pos:cache_pos + l] = k.reshape(b, l, -1).to(kc.dtype)
        vc[:, cache_pos:cache_pos + l] = v.reshape(b, l, -1).to(vc.dtype)
        new_cache = (kc, vc)
        k = kc.reshape(b, s, cfg.n_kv_heads, hd).to(x.dtype)
        v = vc.reshape(b, s, cfg.n_kv_heads, hd).to(x.dtype)
        kv_valid = cache_pos + l
    out = gqa_attention(q, k, v, causal=causal and cache is None,
                        use_flash=cfg.use_flash_attention,
                        kv_valid_len=kv_valid)
    out = out.reshape(b, l, cfg.n_heads * hd) @ p.wo.to(x.dtype)
    return out, new_cache


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU in the compute dtype: ``(silu(x Wg) * x Wu) Wd``; ``p`` holds
    ``wg``, ``wu``, ``wd``."""
    h = F.silu(x @ p.wg.to(x.dtype)) * (x @ p.wu.to(x.dtype))
    return h @ p.wd.to(x.dtype)


def draw(p: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill the weight ``p`` in place with normal draws x ``scale`` from
    ``gen`` (a generator on ``p``'s device)."""
    p.normal_(0.0, scale, generator=gen)


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """``vocab_size`` rounded up to a multiple of ``multiple``."""
    return -(-cfg.vocab_size // multiple) * multiple


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the float32 table ``tok`` in ``COMPUTE_DTYPE``.  The
    reference casts the whole table before the gather; gathering first
    gives the same values for a fraction of the bytes."""
    return tok[tokens].to(COMPUTE_DTYPE)


def lm_head(tok: torch.Tensor, norm_f: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig, head: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Final norm and the read-out: tied ``x @ tok.T``, or with untied
    embeddings ``x @ head`` (``head [D, V_pad]``); float32 logits over the
    padded vocab."""
    x = rmsnorm(norm_f, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return (x @ tok.to(x.dtype).T).to(torch.float32)
    if head is None:
        raise ValueError(f"{cfg.name!r} has untied embeddings: lm_head "
                         f"needs its head [D, V_pad]")
    return (x @ head.to(x.dtype)).to(torch.float32)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the PADDED vocab (labels < the true
    vocab)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return nll.mean()
