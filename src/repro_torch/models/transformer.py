"""Dense decoder-only LM, llama family (port of
``repro/models/transformer.py``): smollm-135m, smollm-360m, stablelm-12b
and llama3-405b.

The reference stacks every layer's weights on a leading ``[L]`` axis and
scans over them; ``scan_layers`` is an XLA knob, so here each layer is
its own ``Block`` in an ``nn.ModuleList`` and the forward is a Python
loop.  Weights are float32 in the reference's ``[d_in, d_out]`` layout,
so ``repro_torch.convert.lm_params_from_numpy`` copies them across.
The smollm configs tie the read-out to the embedding; stablelm-12b and
llama3-405b hold an untied ``head [D, V_pad]``.

On the model axis (``layers.set_mesh``) an ``Attention`` built under
``set_shard_heads(True)`` holds the rank's heads and the KV cache its kv
heads; the MLP, the embedding and the read-out stay whole on every rank.
Under ``set_seq_parallel(True)`` the residual between blocks is the
rank's slice of the sequence, gathered once before the read-out.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig, resolve_device
from . import layers as L


def _matrix(d_in: int, d_out: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d_in, d_out, device=device))


def kv_cache(cfg: ModelConfig, n: int, batch: int, seq: int,
             device, split=None) -> dict:
    """Zeroed bfloat16 ``k``/``v [n, B, S, Hkv Dh]`` for ``n`` attention
    layers (or sites); with a ``layers.HeadSplit`` the rank's kv heads
    only."""
    hkv = cfg.n_kv_heads if split is None else split.nkv
    shape = (n, batch, seq, hkv * cfg.resolved_head_dim)
    return {name: torch.zeros(shape, dtype=torch.bfloat16, device=device)
            for name in ("k", "v")}


class Attention(nn.Module):
    """``wq [D, Hq Dh]``, ``wk``/``wv [D, Hkv Dh]``, ``wo [Hq Dh, D]``;
    built on the model axis under ``set_shard_heads(True)``, the rank's
    heads of each (``split``, a ``layers.HeadSplit``; None: whole)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        self.split = sp = L.head_split(cfg.n_heads, cfg.n_kv_heads)
        hq, hkv = (sp.nq, sp.nkv) if sp else (cfg.n_heads, cfg.n_kv_heads)
        self.wq = _matrix(d, hq * hd, device)
        self.wk = _matrix(d, hkv * hd, device)
        self.wv = _matrix(d, hkv * hd, device)
        self.wo = _matrix(hq * hd, d, device)
        if sp is not None:
            L.split_param(self.wq, 1, sp.q0 * hd, cfg.n_heads * hd)
            L.split_param(self.wo, 0, sp.q0 * hd, cfg.n_heads * hd)
            if not sp.kv_whole:
                for w in (self.wk, self.wv):
                    L.split_param(w, 1, sp.kv0 * hd, cfg.n_kv_heads * hd)


class MLP(nn.Module):
    """SwiGLU weights ``wg``/``wu [D, F]``, ``wd [F, D]``; ``F`` is
    ``d_ff`` when given (the MoE's shared experts), else ``cfg.d_ff``."""

    def __init__(self, cfg: ModelConfig, device=None, d_ff: int = 0):
        super().__init__()
        f = d_ff or cfg.d_ff
        self.wg = _matrix(cfg.d_model, f, device)
        self.wu = _matrix(cfg.d_model, f, device)
        self.wd = _matrix(f, cfg.d_model, device)


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))

    def forward(self, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor,
                cache=None, cache_pos=None, causal: bool = True):
        """``(x', new_cache)`` for activations ``x [B, L, D]`` (``causal``
        off: Whisper's encoder)."""
        h, new_cache = L.attn_forward(
            self.attn, L.rmsnorm(self.ln1, x, cfg.norm_eps), cfg, pos=pos,
            causal=causal, cache=cache, cache_pos=cache_pos)
        x = x + h
        x = x + L.mlp_forward(self.mlp, L.rmsnorm(self.ln2, x, cfg.norm_eps))
        return x, new_cache


class DenseLM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, ``n_layers`` blocks, the final
    norm ``norm_f`` and, untied (stablelm-12b, llama3-405b), the read-out
    ``head [D, V_pad]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "dense":
            raise ValueError(f"DenseLM needs a dense config, got "
                             f"{cfg.name!r} ({cfg.family})")
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

    def forward_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward: ``tokens [B, S]`` -> float32 logits
        ``[B, S, V_pad]``."""
        b, s = tokens.shape
        x = L.shard_batch(L.embed_tokens(self.tok, tokens))
        pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        for block in self.layers:
            x = L.maybe_remat(lambda x, b=block: b(x, self.cfg, pos)[0],
                              self.cfg)(x)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), self.cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` against ``batch["labels"]``.
        Differentiable with ``use_flash_attention`` off (the training
        default, as in the reference): ``ops.flash_attention`` is forward
        only and raises under autograd."""
        return L.lm_loss(self.forward_train(batch["tokens"]), batch["labels"])

    def init_cache(self, batch: int, seq: int) -> dict:
        """Zeroed bfloat16 KV cache: ``k``/``v [L, B, S, Hkv Dh]`` (the
        rank's kv heads of a head-split model)."""
        return kv_cache(self.cfg, self.cfg.n_layers, batch, seq,
                        self.tok.device, self.layers[0].attn.split)

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens [B, 1]`` at position ``pos`` (the
        current length) -> ``(logits [B, V_pad], cache)``; the cache is
        written in place."""
        b = tokens.shape[0]
        x = L.embed_tokens(self.tok, tokens)
        qpos = torch.full((b, 1), pos, dtype=torch.int64, device=tokens.device)
        for i, block in enumerate(self.layers):
            x, _ = block(x, self.cfg, qpos, cache=(cache["k"][i],
                                                   cache["v"][i]),
                         cache_pos=pos)
        return (L.lm_head(self.tok, self.norm_f, x, self.cfg, self.head)[:, 0],
                cache)


def init_dense_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> DenseLM:
    """A ``DenseLM`` on ``device`` with the reference's init scales: normal
    x 0.02 for every layer matrix, x 0.01 for ``tok`` and ``head``, ones
    for the norms.  Drawn in place from a generator on ``device`` seeded
    with ``seed`` (as ``moe.init_qwen3_moe``: the same weights on one
    device type, not across them; stablelm-12b's 12 G weights would take
    minutes to draw on the host).  The draws differ from
    ``repro.models.transformer.init_lm``'s — use ``convert`` to share
    weights."""
    model = DenseLM(cfg, resolve_device(device))
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        for block in model.layers:
            for w in (block.attn.wq, block.attn.wk, block.attn.wv,
                      block.attn.wo, block.mlp.wg, block.mlp.wu,
                      block.mlp.wd):
                L.draw(w, gen, 0.02)
    return model
