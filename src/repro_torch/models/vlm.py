"""Llama-3.2-Vision-11B text backbone (port of ``repro/models/vlm.py``):
``n_layers`` dense decoder layers in groups of ``cross_attn_every``, each
group followed by a gated cross-attention block over the projected
vision embeddings (llama-3.2-vision-11b: 40 layers, 8 cross sites).

The modality frontend is a stub, as in the reference: the inputs are
precomputed patch embeddings ``vision [B, n_vision_tokens, d_vision]``,
projected by ``vproj`` in the compute dtype.  A cross block adds
``tanh(gate) * attn(norm(x), vis)`` with no rope and no causal mask; the
gate starts at 0, so at the seeded init the cross path adds nothing
(ROADMAP Queue 3).  The self layers are the dense LM's ``Block``s: with
``use_flash_attention`` and both lengths multiples of 128 they run
``ops.flash_attention``; the cross-attention over 1 600 vision tokens
takes the plain path (the reference's predicate).  Decode keeps the
reference's inline cross step over the per-site ``vis_k``/``vis_v``
caches.

On the model axis every attention, the cross sites' included, splits
its heads under ``set_shard_heads(True)`` and the caches hold the
rank's kv heads; the projected vision embeddings stay whole on every
rank.  Under sequence parallelism a cross site's queries run on the
rank's slice of the sequence as they stand.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig, resolve_device
from . import layers as L
from .transformer import Attention, Block, kv_cache


def n_sites(cfg: ModelConfig) -> int:
    """Cross-attention sites: ``n_layers // cross_attn_every``."""
    return cfg.n_layers // cfg.cross_attn_every


class CrossBlock(nn.Module):
    """One gated cross-attention site: ``attn`` (``wq``, ``wk``, ``wv``,
    ``wo``), its pre-norm ``ln`` and the scalar ``gate [1]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.ln = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.gate = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor, cfg: ModelConfig, vis: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        """``x + tanh(gate) * attn(norm(x), vis)``: no rope, no mask."""
        h, _ = L.attn_forward(self.attn, L.rmsnorm(self.ln, x, cfg.norm_eps),
                              cfg, pos=pos, causal=False, rope=False,
                              kv_x=vis)
        return x + torch.tanh(self.gate).to(x.dtype) * h


class VisionLM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, the vision projection ``vproj
    [d_vision, D]``, ``n_layers`` dense ``Block``s (``layers``), one
    ``CrossBlock`` per site (``cross``), the final norm ``norm_f`` and,
    untied, the read-out ``head [D, V_pad]``; built on ``device``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "vlm" or cfg.cross_attn_every < 1 \
                or cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(f"VisionLM needs a vlm config whose n_layers "
                             f"is a multiple of cross_attn_every >= 1, got "
                             f"{cfg.name!r} ({cfg.family}, {cfg.n_layers} "
                             f"layers, every {cfg.cross_attn_every})")
        device = resolve_device(device)
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.vproj = nn.Parameter(torch.zeros(cfg.d_vision, d, device=device))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.cross = nn.ModuleList(CrossBlock(cfg, device)
                                   for _ in range(n_sites(cfg)))

    def forward_train(self, tokens: torch.Tensor, vision: torch.Tensor
                      ) -> torch.Tensor:
        """Full-sequence forward: ``tokens [B, S]`` and ``vision [B, T,
        d_vision]`` -> float32 logits ``[B, S, V_pad]``."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_tokens(self.tok, tokens)
        vis = vision.to(x.dtype) @ self.vproj.to(x.dtype)
        x = L.shard_batch(x)
        pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        ce = cfg.cross_attn_every
        for site, cross in enumerate(self.cross):
            for block in self.layers[site * ce:(site + 1) * ce]:
                x = L.maybe_remat(lambda x, b=block: b(x, cfg, pos)[0],
                                  cfg)(x)
            x = cross(x, cfg, vis, pos)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` (with ``batch["vision"]``)
        against ``batch["labels"]``; differentiable with
        ``use_flash_attention`` off (the training default)."""
        return L.lm_loss(self.forward_train(batch["tokens"], batch["vision"]),
                         batch["labels"])

    def init_cache(self, batch: int, seq: int) -> dict:
        """Zeroed bfloat16 caches: the self layers' ``k``/``v [L, B, S,
        Hkv Dh]`` and each site's vision keys and values ``vis_k``/``vis_v
        [sites, B, n_vision_tokens, Hkv Dh]``."""
        cfg, dev = self.cfg, self.tok.device
        sp = self.layers[0].attn.split
        vis = kv_cache(cfg, n_sites(cfg), batch, cfg.n_vision_tokens, dev,
                       sp)
        return {**kv_cache(cfg, cfg.n_layers, batch, seq, dev, sp),
                "vis_k": vis["k"], "vis_v": vis["v"]}

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens [B, 1]`` at position ``pos`` ->
        ``(logits [B, V_pad], cache)``; the self caches are written in
        place, ``vis_k``/``vis_v`` are read as they stand (the reference's
        inline cross step: q from the site's ``wq``, attention over the
        cached vision keys, ``wo``, the gate)."""
        cfg = self.cfg
        b, hd = tokens.shape[0], cfg.resolved_head_dim
        x = L.embed_tokens(self.tok, tokens)
        qpos = torch.full((b, 1), pos, dtype=torch.int64, device=tokens.device)
        ce = cfg.cross_attn_every
        for site, cross in enumerate(self.cross):
            for i in range(site * ce, (site + 1) * ce):
                x, _ = self.layers[i](x, cfg, qpos,
                                      cache=(cache["k"][i], cache["v"][i]),
                                      cache_pos=pos)
            z = L.rmsnorm(cross.ln, x, cfg.norm_eps)
            sp = cross.attn.split
            q = (z @ cross.attn.wq.to(x.dtype)).reshape(b, 1, -1, hd)
            k, v = (L.kv_for_heads(cache[name][site].reshape(
                        b, -1, sp.nkv if sp else cfg.n_kv_heads, hd),
                        sp, cfg.n_kv_heads).to(x.dtype)
                    for name in ("vis_k", "vis_v"))
            att = L.gqa_attention(q, k, v, causal=False)
            att = L.reduce_heads(
                att.reshape(b, 1, -1) @ cross.attn.wo.to(x.dtype), sp)
            x = x + torch.tanh(cross.gate).to(x.dtype) * att
        logits = L.lm_head(self.tok, self.norm_f, x, cfg, self.head)
        return logits[:, 0], cache


def init_vlm(cfg: ModelConfig, seed: int = 0, device="cuda") -> VisionLM:
    """A ``VisionLM`` on ``device`` with the reference's init scales:
    ``tok`` and ``head`` x 0.01, ``vproj`` and every layer and site matrix
    x 0.02, norms 1, gates 0.  Drawn in place from a generator on
    ``device`` seeded with ``seed`` (as ``moe.init_qwen3_moe``: the same
    weights on one device type, not across them)."""
    model = VisionLM(cfg, device)
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        L.draw(model.vproj, gen, 0.02)
        for block in model.layers:
            for w in (block.attn.wq, block.attn.wk, block.attn.wv,
                      block.attn.wo, block.mlp.wg, block.mlp.wu,
                      block.mlp.wd):
                L.draw(w, gen, 0.02)
        for cross in model.cross:
            for w in (cross.attn.wq, cross.attn.wk, cross.attn.wv,
                      cross.attn.wo):
                L.draw(w, gen, 0.02)
    return model
