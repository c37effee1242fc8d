"""DeepSeek-V2-236B (port of ``repro/models/deepseek.py``): multi-head
latent attention (MLA, kv_lora 512) and a fine-grained MoE (2 shared + 160
routed experts, top-6), the first layer dense.

The full-sequence forward (``mla_train``) expands the latent into
per-head keys and values; its q/k heads are ``nope + rope`` = 192 wide
and its values 128, which neither flash kernel takes (the Pallas kernel
reshapes v to q's head dim; the port's are built for one head dim of 64
or 128 and ``ops.flash_attention`` refuses unequal ones), so the
attention takes the plain path in both packages (the config's
``use_flash_attention`` is False).  Decode is the absorbed form
(``mla_decode``): the cache holds only the latent ``c_kv [B, S, 512]``
and the roped key ``k_r [B, S, 64]`` in bfloat16, written in place;
``q_nope`` goes into latent space through ``W_uk`` and the values come
back through ``W_uv`` after the softmax.  The routed experts are
``moe.moe_forward``'s layer, with the shared experts beside them.

On the model axis under ``set_shard_heads(True)`` an ``MLA`` whose heads
divide M holds the rank's heads at the reference's two ``shard_heads``
sites: the columns of ``wuq`` (the queries) and of ``wukv`` (the
expanded keys and values), and the rows of ``wo``; the latent
projections, their norms and the latent cache stay whole on every rank,
and the output is summed by one ``all_reduce``.  The MoE layers split
their experts (``moe.py``); sequence parallelism gathers the sequence
for ``mla_train`` and keeps the FFN on the rank's slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import ModelConfig, resolve_device
from . import layers as L
from . import moe as M
from .transformer import MLP


class MLA(nn.Module):
    """``wdq [D, q_lora]``, ``wuq [q_lora, H (nope + rope)]``, ``wdkv [D,
    kv_lora]``, ``wkr [D, rope]``, ``wukv [kv_lora, H (nope + v)]``, ``wo
    [H v, D]`` and the latent norms ``lnq``, ``lnkv``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        vd = cfg.v_head_dim
        self.split = sp = L.head_split(cfg.n_heads)
        h = sp.nq if sp else cfg.n_heads

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))
        self.wdq = zeros(d, cfg.q_lora_rank)
        self.wuq = zeros(cfg.q_lora_rank, h * (nope + rope))
        self.wdkv = zeros(d, cfg.kv_lora_rank)
        self.wkr = zeros(d, rope)
        self.wukv = zeros(cfg.kv_lora_rank, h * (nope + vd))
        self.wo = zeros(h * vd, d)
        if sp is not None:
            for w, dim, width in ((self.wuq, 1, nope + rope),
                                  (self.wukv, 1, nope + vd), (self.wo, 0, vd)):
                L.split_param(w, dim, sp.q0 * width, cfg.n_heads * width)
        self.lnq = nn.Parameter(torch.ones(cfg.q_lora_rank, device=device))
        self.lnkv = nn.Parameter(torch.ones(cfg.kv_lora_rank, device=device))


def _heads(p: MLA, cfg: ModelConfig) -> int:
    """The heads ``p`` holds: the rank's of a head-split MLA."""
    return p.split.nq if p.split else cfg.n_heads


def _query(p: MLA, x: torch.Tensor, cfg: ModelConfig):
    """``(q_nope, q_rope)`` of ``x [B, L, D]``, ``[B, L, H, nope|rope]``,
    the rope part not yet rotated."""
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = L.rmsnorm(p.lnq, x @ p.wdq.to(x.dtype), cfg.norm_eps)
    q = (cq @ p.wuq.to(x.dtype)).reshape(b, s, _heads(p, cfg), nope + rope)
    return q[..., :nope], q[..., nope:]


def _latent(p: MLA, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor):
    """``(c_kv [B, L, kv_lora], k_r [B, L, 1, rope])``: the normed latent
    and the shared key's rope part rotated at ``pos [B, L]``."""
    ckv = L.rmsnorm(p.lnkv, x @ p.wdkv.to(x.dtype), cfg.norm_eps)
    kr = L.apply_rope((x @ p.wkr.to(x.dtype))[:, :, None, :], pos,
                      cfg.rope_theta)
    return ckv, kr


def mla_train(p: MLA, x: torch.Tensor, cfg: ModelConfig,
              pos: torch.Tensor) -> torch.Tensor:
    """MLA over a full sequence: ``x [B, S, D]``, ``pos [B, S]`` ->
    ``[B, S, D]``; keys ``[k_nope | k_r]`` per head, causal
    ``gqa_attention`` of 192-wide q/k heads over 128-wide values.  ``x``
    may hold the rank's slice of the sequence (gathered here; the result
    is the slice)."""
    s = pos.shape[1]
    sliced = x.shape[1] != s
    x = L.gather_seq(x, s)
    b = x.shape[0]
    h, nope = _heads(p, cfg), cfg.qk_nope_head_dim
    rope, vd = cfg.qk_rope_head_dim, cfg.v_head_dim
    qn, qr = _query(p, x, cfg)
    qr = L.apply_rope(qr, pos, cfg.rope_theta)
    ckv, kr = _latent(p, x, cfg, pos)
    kv = (ckv @ p.wukv.to(x.dtype)).reshape(b, s, h, nope + vd)
    kn, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([kn, kr.expand(b, s, h, rope)], dim=-1)
    out = L.gqa_attention(torch.cat([qn, qr], dim=-1), k, v, causal=True,
                          use_flash=cfg.use_flash_attention)
    out = L.reduce_heads(out.reshape(b, s, h * vd) @ p.wo.to(x.dtype),
                         p.split)
    return L.seq_slice(out) if sliced else out


def mla_decode(p: MLA, x: torch.Tensor, cfg: ModelConfig,
               ckv_c: torch.Tensor, kr_c: torch.Tensor,
               pos: int) -> torch.Tensor:
    """Absorbed MLA for one token: ``x [B, 1, D]`` at position ``pos``
    against the cache ``ckv_c [B, S, kv_lora]`` and ``kr_c [B, S, rope]``
    (bfloat16, the step's latent and roped key written in place at
    ``pos``) -> ``[B, 1, D]``.  Scores ``(q_nope W_uk) c_kv + q_r k_r``
    in the compute dtype, then float32 over sqrt(nope + rope), keys past
    ``pos`` masked; the values ``(w c_kv) W_uv``."""
    b = x.shape[0]
    h, nope = _heads(p, cfg), cfg.qk_nope_head_dim
    rope, vd, lora = cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    qn, qr = _query(p, x, cfg)                       # [B, 1, H, nope|rope]
    qn, qr = qn[:, 0], L.apply_rope(qr, posb, cfg.rope_theta)[:, 0]
    ckv_t, kr_t = _latent(p, x, cfg, posb)
    ckv_c[:, pos:pos + 1] = ckv_t.to(ckv_c.dtype)
    kr_c[:, pos:pos + 1] = kr_t[:, :, 0].to(kr_c.dtype)
    s = ckv_c.shape[1]
    wukv = p.wukv.to(x.dtype).reshape(lora, h, nope + vd)
    wuk, wuv = wukv[..., :nope], wukv[..., nope:]
    q_lat = torch.einsum("bhn,lhn->bhl", qn, wuk)    # [B, H, lora]
    ckv = ckv_c.to(x.dtype)
    scores = (torch.einsum("bhl,bsl->bhs", q_lat, ckv)
              + torch.einsum("bhr,bsr->bhs", qr, kr_c.to(x.dtype))
              ).to(torch.float32) / ((nope + rope) ** 0.5)
    valid = torch.arange(s, device=x.device) < pos + 1
    scores = torch.where(valid, scores, L._NEG)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhs,bsl->bhl", w, ckv)
    out = torch.einsum("bhl,lhv->bhv", o_lat, wuv).reshape(b, h * vd)
    return L.reduce_heads(out[:, None, :] @ p.wo.to(x.dtype), p.split)


class MLABlock(nn.Module):
    """Pre-norm block: ``x + mla(norm(x))``, then ``x + ffn(norm(x))``,
    the FFN a dense SwiGLU ``mlp`` or the routed ``moe``."""

    def __init__(self, cfg: ModelConfig, moe: bool, device=None):
        super().__init__()
        self.attn = MLA(cfg, device)
        self.mlp = None if moe else MLP(cfg, device)
        self.moe = M.MoEMLP(cfg, device) if moe else None
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))

    def ffn(self, x: torch.Tensor, cfg: ModelConfig,
            seq_len: Optional[int] = None) -> torch.Tensor:
        """``x + ffn(norm(x))`` (``x`` may hold the rank's slice of a
        ``seq_len``-token sequence)."""
        z = L.rmsnorm(self.ln2, x, cfg.norm_eps)
        if self.moe is not None:
            return x + M.moe_forward(self.moe, z, cfg, seq_len)
        return x + L.mlp_forward(self.mlp, z)


class DeepSeekLM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, ``first_dense_layers`` dense
    MLA blocks (``dense``), the MoE MLA blocks (``layers``), the final
    norm ``norm_f`` and the read-out ``head [D, V_pad]`` (untied); built on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "moe" or not cfg.kv_lora_rank:
            raise ValueError(f"DeepSeekLM needs a moe config with MLA "
                             f"(kv_lora_rank), got {cfg.name!r}")
        device = resolve_device(device)
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.dense = nn.ModuleList(MLABlock(cfg, False, device)
                                   for _ in range(cfg.first_dense_layers))
        self.layers = nn.ModuleList(
            MLABlock(cfg, True, device)
            for _ in range(cfg.n_layers - cfg.first_dense_layers))

    def blocks(self):
        """``(block, cache suffix, index)`` of every block in order: the
        dense blocks' caches are ``ckv_dense``/``kr_dense``, the MoE
        blocks' ``ckv``/``kr``."""
        return ([(blk, "_dense", i) for i, blk in enumerate(self.dense)]
                + [(blk, "", i) for i, blk in enumerate(self.layers)])

    def forward_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward: ``tokens [B, S]`` -> float32 logits
        ``[B, S, V_pad]`` (plain attention: no kernel runs)."""
        b, s = tokens.shape
        x = L.shard_batch(L.embed_tokens(self.tok, tokens))
        pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        cfg = self.cfg

        def body(x, blk):
            x = x + mla_train(blk.attn, L.rmsnorm(blk.ln1, x, cfg.norm_eps),
                              cfg, pos)
            return blk.ffn(x, cfg, s)
        for blk, _, _ in self.blocks():
            x = L.maybe_remat(lambda x, b=blk: body(x, b), cfg)(x)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), self.cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` against ``batch["labels"]``."""
        return L.lm_loss(self.forward_train(batch["tokens"]), batch["labels"])

    def init_cache(self, batch: int, seq: int) -> dict:
        """Zeroed bfloat16 latent cache: ``ckv_dense``/``kr_dense`` of the
        dense layers and ``ckv``/``kr`` of the MoE layers, ``[n, B, S,
        kv_lora]`` and ``[n, B, S, rope]``."""
        cfg, dev = self.cfg, self.tok.device
        nd, nm = len(self.dense), len(self.layers)

        def zeros(n, w):
            return torch.zeros((n, batch, seq, w), dtype=torch.bfloat16,
                               device=dev)
        return {"ckv_dense": zeros(nd, cfg.kv_lora_rank),
                "kr_dense": zeros(nd, cfg.qk_rope_head_dim),
                "ckv": zeros(nm, cfg.kv_lora_rank),
                "kr": zeros(nm, cfg.qk_rope_head_dim)}

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens [B, 1]`` at position ``pos`` ->
        ``(logits [B, V_pad], cache)``; the cache is written in place."""
        x = L.embed_tokens(self.tok, tokens)
        for blk, suffix, i in self.blocks():
            x = x + mla_decode(blk.attn, L.rmsnorm(blk.ln1, x,
                                                   self.cfg.norm_eps),
                               self.cfg, cache["ckv" + suffix][i],
                               cache["kr" + suffix][i], pos)
            x = blk.ffn(x, self.cfg)
        logits = L.lm_head(self.tok, self.norm_f, x, self.cfg, self.head)
        return logits[:, 0], cache


def init_deepseek(cfg: ModelConfig, seed: int = 0, device="cuda"
                  ) -> DeepSeekLM:
    """A ``DeepSeekLM`` on ``device`` with the reference's init scales
    (``tok`` and ``head`` x 0.01, MLA and MLP matrices and experts x 0.02,
    routers x 0.006, norms 1), drawn in place from a generator on
    ``device`` seeded with ``seed`` (as ``moe.init_qwen3_moe``: the same
    weights on one device type, not across them)."""
    model = DeepSeekLM(cfg, device)
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        for blk, _, _ in model.blocks():
            a = blk.attn
            for w in (a.wdq, a.wuq, a.wdkv, a.wkr, a.wukv, a.wo):
                L.draw(w, gen, 0.02)
            if blk.moe is not None:
                M.init_moe_mlp(blk.moe, gen)
            else:
                for w in (blk.mlp.wg, blk.mlp.wu, blk.mlp.wd):
                    L.draw(w, gen, 0.02)
    return model
