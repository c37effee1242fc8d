"""Zamba2-1.2b hybrid (port of ``repro/models/hybrid.py``,
arXiv:2411.15242): a Mamba-2 backbone of ``n_layers`` ``MambaBlock``s and
ONE shared attention + MLP block.

The shared block runs after every ``attn_every``-th Mamba layer, with the
same parameters at each of the ``n_layers // attn_every`` sites; then the
``n_layers - sites * attn_every`` tail layers run (zamba2-1.2b: 6 sites
of 6 layers, 2 tail layers).  Each site keeps its own KV cache.  The
full-sequence forward runs ``ops.ssd_scan`` in every Mamba layer (as
``Mamba2LM``) and, with ``use_flash_attention`` and both lengths
multiples of 128, ``ops.flash_attention`` at every site (the reference's
predicate, ``layers.gqa_attention``).  Decode is the SSM's O(1)
recurrence (the conv history through bfloat16 in the cache) and the
dense LM's cached attention at each site.

On the model axis the Mamba layers and their state are replicated on
every rank (the reference's variants shard no Mamba weight); the shared
block's attention splits its heads under ``set_shard_heads(True)``, with
each site's KV cache holding the rank's kv heads.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig, resolve_device
from . import layers as L
from .ssm import MambaBlock, dims, mamba_body
from .transformer import Block, kv_cache


def grouped(cfg: ModelConfig):
    """``(sites, tail)``: the shared block's sites and the Mamba layers
    after the last one."""
    sites = cfg.n_layers // cfg.attn_every
    return sites, cfg.n_layers - sites * cfg.attn_every


class Zamba2LM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, ``n_layers`` Mamba blocks
    (``layers``), the shared attention + MLP ``shared`` (a dense ``Block``),
    the final norm ``norm_f`` and, untied (zamba2-1.2b), the read-out
    ``head [D, V_pad]``; built on ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "hybrid" or cfg.attn_every < 1:
            raise ValueError(f"Zamba2LM needs a hybrid config with "
                             f"attn_every >= 1, got {cfg.name!r} "
                             f"({cfg.family})")
        device = resolve_device(device)
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.layers = nn.ModuleList(MambaBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.shared = Block(cfg, device)

    def schedule(self):
        """The forward's order: ``("mamba", i)`` for Mamba layer ``i`` and
        ``("attn", site)`` for the shared block's ``site``-th run."""
        sites, _ = grouped(self.cfg)
        ae = self.cfg.attn_every
        out = []
        for site in range(sites):
            out += [("mamba", site * ae + j) for j in range(ae)]
            out.append(("attn", site))
        return out + [("mamba", i)
                      for i in range(sites * ae, self.cfg.n_layers)]

    def forward_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward: ``tokens [B, S]`` -> float32 logits
        ``[B, S, V_pad]``."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.shard_batch(L.embed_tokens(self.tok, tokens))
        pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        for kind, i in self.schedule():
            if kind == "attn":
                x, _ = self.shared(x, cfg, pos)
            else:
                x = L.maybe_remat(lambda x, b=self.layers[i]: mamba_body(
                    b, x, cfg, s), cfg)(x)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` against ``batch["labels"]``,
        differentiable through every Mamba layer (``ssm.SSDScan``) and,
        with ``use_flash_attention`` off (the training default, as in the
        reference), at every site: ``ops.flash_attention`` is forward
        only."""
        return L.lm_loss(self.forward_train(batch["tokens"]), batch["labels"])

    def init_cache(self, batch: int, seq: int) -> dict:
        """Zeroed state: the Mamba layers' ``ssm [L, B, H, P, N]`` float32
        and ``conv [L, B, W - 1, d_in + 2N]`` bfloat16, and each site's
        ``k``/``v [sites, B, S, Hkv Dh]`` bfloat16 (the part that grows
        with ``seq``)."""
        cfg, dev = self.cfg, self.tok.device
        d_in, h, p, n = dims(cfg)
        sites, _ = grouped(cfg)
        return {
            "ssm": torch.zeros((cfg.n_layers, batch, h, p, n),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                                 d_in + 2 * n), dtype=torch.bfloat16,
                                device=dev),
            **kv_cache(cfg, sites, batch, seq, dev, self.shared.attn.split)}

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens [B, 1]`` at position ``pos`` ->
        ``(logits [B, V_pad], cache)``; the cache is written in place."""
        cfg = self.cfg
        b = tokens.shape[0]
        x = L.embed_tokens(self.tok, tokens)
        qpos = torch.full((b, 1), pos, dtype=torch.int64, device=tokens.device)
        for kind, i in self.schedule():
            if kind == "attn":
                x, _ = self.shared(x, cfg, qpos,
                                   cache=(cache["k"][i], cache["v"][i]),
                                   cache_pos=pos)
            else:
                x = self.layers[i].decode_step(x, cfg, cache["ssm"][i],
                                               cache["conv"][i])
        logits = L.lm_head(self.tok, self.norm_f, x, cfg, self.head)
        return logits[:, 0], cache


def init_zamba2(cfg: ModelConfig, seed: int = 0, device="cuda") -> Zamba2LM:
    """A ``Zamba2LM`` on ``device`` with the reference's init scales:
    ``tok`` and ``head`` x 0.01; the Mamba layers as ``ssm.init_mamba2``
    (``w_in``, ``w_out`` x 0.02, ``conv_k`` x 0.5, ``a_log`` and
    ``dt_bias`` 0, ``d_skip`` 1); the shared block's matrices x 0.02 but
    ``wo`` x 0.02 / sqrt(n_layers); norms 1.  Drawn in place from a
    generator on ``device`` seeded with ``seed`` (as
    ``moe.init_qwen3_moe``: the same weights on one device type, not
    across them)."""
    model = Zamba2LM(cfg, device)
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        for blk in model.layers:
            L.draw(blk.w_in, gen, 0.02)
            L.draw(blk.conv_k, gen, 0.5)
            L.draw(blk.w_out, gen, 0.02)
        sh = model.shared
        for w in (sh.attn.wq, sh.attn.wk, sh.attn.wv, sh.mlp.wg, sh.mlp.wu,
                  sh.mlp.wd):
            L.draw(w, gen, 0.02)
        L.draw(sh.attn.wo, gen, 0.02 / max(cfg.n_layers, 1) ** 0.5)
    return model
