"""Whisper-small backbone (port of ``repro/models/whisper.py``): an
encoder of ``n_encoder_layers`` non-causal blocks over audio frames and a
decoder of ``n_layers`` blocks, each with causal self-attention,
cross-attention to the encoder's states and an MLP (whisper-small: 12 +
12 layers).

The conv frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings ``frames [B, n_audio_frames, d_audio]``,
cast to the compute dtype before ``aproj``.  Three of the reference's
choices are kept as they are: the encoder's non-causal self-attention IS
roped at the frame positions; the cross-attention has no rope and no
mask; decode cross-attends to ``cache["enc"]`` (projecting its keys and
values at every step) and returns the cache with ``enc`` unchanged.
With ``use_flash_attention`` the decoder's self-attention runs
``ops.flash_attention`` when the prompt is a multiple of 128; the
encoder's 1 500 frames and every cross site take the plain path (the
reference's predicate).

On the model axis every attention splits its heads under
``set_shard_heads(True)`` (whisper-small's 12 heads over 2 or 4 ranks)
and the self caches hold the rank's kv heads; the encoder states and
their cache ``enc`` stay whole on every rank.  Under sequence
parallelism the encoder and the decoder keep the rank's slice between
blocks, and the encoder's states are gathered once at its end.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig, resolve_device
from . import layers as L
from .transformer import MLP, Attention, Block, kv_cache


class DecoderBlock(nn.Module):
    """Causal self-attention ``attn``, cross-attention ``xattn``, the MLP
    ``mlp`` and their pre-norms ``ln1``, ``lnx``, ``ln2``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.attn = Attention(cfg, device)
        self.xattn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)
        self.ln1 = nn.Parameter(torch.ones(d, device=device))
        self.lnx = nn.Parameter(torch.ones(d, device=device))
        self.ln2 = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor, cfg: ModelConfig, enc: torch.Tensor,
                pos: torch.Tensor, cache=None, cache_pos=None):
        """``(x', new_cache)``: ``x + attn``, ``+ xattn(enc)``, ``+ mlp``
        (the reference's ``_dec_block``)."""
        h, new_cache = L.attn_forward(
            self.attn, L.rmsnorm(self.ln1, x, cfg.norm_eps), cfg, pos=pos,
            cache=cache, cache_pos=cache_pos)
        x = x + h
        h, _ = L.attn_forward(
            self.xattn, L.rmsnorm(self.lnx, x, cfg.norm_eps), cfg, pos=pos,
            causal=False, rope=False, kv_x=enc)
        x = x + h
        x = x + L.mlp_forward(self.mlp, L.rmsnorm(self.ln2, x, cfg.norm_eps))
        return x, new_cache


class WhisperLM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, the frame projection ``aproj
    [d_audio, D]``, the ``encoder`` (dense ``Block``s run non-causal), the
    ``decoder`` (``DecoderBlock``s), the final norm ``norm_f`` and, untied
    (whisper-small), the read-out ``head [D, V_pad]``; built on
    ``device``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"WhisperLM needs an audio config, got "
                             f"{cfg.name!r} ({cfg.family})")
        device = resolve_device(device)
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.aproj = nn.Parameter(torch.zeros(cfg.d_audio, d, device=device))
        self.encoder = nn.ModuleList(Block(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device)
                                     for _ in range(cfg.n_layers))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """``frames [B, T, d_audio]`` -> encoder states ``[B, T, D]`` in the
        compute dtype (self-attention roped at the frame positions, no
        mask)."""
        x = frames.to(L.COMPUTE_DTYPE) @ self.aproj.to(L.COMPUTE_DTYPE)
        b, t, _ = x.shape
        pos = torch.arange(t, device=x.device)[None, :].expand(b, t)
        x = L.shard_batch(x)
        for block in self.encoder:
            x = L.maybe_remat(lambda x, b=block: b(x, self.cfg, pos,
                                                   causal=False)[0],
                              self.cfg)(x)
        return L.gather_seq(x, t)

    def forward_train(self, tokens: torch.Tensor, frames: torch.Tensor
                      ) -> torch.Tensor:
        """Full-sequence forward: ``tokens [B, S]`` and ``frames [B, T,
        d_audio]`` -> float32 logits ``[B, S, V_pad]``."""
        enc = self.encode(frames)
        b, s = tokens.shape
        x = L.shard_batch(L.embed_tokens(self.tok, tokens))
        pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        for block in self.decoder:
            x = L.maybe_remat(lambda x, b=block: b(x, self.cfg, enc, pos)[0],
                              self.cfg)(x)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), self.cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` (with ``batch["frames"]``)
        against ``batch["labels"]``; differentiable with
        ``use_flash_attention`` off (the training default)."""
        return L.lm_loss(self.forward_train(batch["tokens"], batch["frames"]),
                         batch["labels"])

    def init_cache(self, batch: int, seq: int) -> dict:
        """Zeroed bfloat16 caches: the decoder's ``k``/``v [L, B, S, Hkv
        Dh]`` and the encoder states ``enc [B, n_audio_frames, D]``."""
        cfg, dev = self.cfg, self.tok.device
        return {**kv_cache(cfg, cfg.n_layers, batch, seq, dev,
                           self.decoder[0].attn.split),
                "enc": torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                                   dtype=torch.bfloat16, device=dev)}

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens [B, 1]`` at position ``pos`` ->
        ``(logits [B, V_pad], cache)``; the self caches are written in
        place, ``enc`` is read as it stands."""
        b = tokens.shape[0]
        x = L.embed_tokens(self.tok, tokens)
        qpos = torch.full((b, 1), pos, dtype=torch.int64, device=tokens.device)
        enc = cache["enc"].to(x.dtype)
        for i, block in enumerate(self.decoder):
            x, _ = block(x, self.cfg, enc, qpos,
                         cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
        logits = L.lm_head(self.tok, self.norm_f, x, self.cfg, self.head)
        return logits[:, 0], cache


def init_whisper(cfg: ModelConfig, seed: int = 0, device="cuda"
                 ) -> WhisperLM:
    """A ``WhisperLM`` on ``device`` with the reference's init scales:
    ``tok`` and ``head`` x 0.01, ``aproj`` and every encoder and decoder
    matrix x 0.02, norms 1.  Drawn in place from a generator on
    ``device`` seeded with ``seed`` (as ``moe.init_qwen3_moe``: the same
    weights on one device type, not across them)."""
    model = WhisperLM(cfg, device)
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        L.draw(model.aproj, gen, 0.02)
        for block in model.encoder:
            for w in (block.attn.wq, block.attn.wk, block.attn.wv,
                      block.attn.wo, block.mlp.wg, block.mlp.wu,
                      block.mlp.wd):
                L.draw(w, gen, 0.02)
        for block in model.decoder:
            for w in (block.attn.wq, block.attn.wk, block.attn.wv,
                      block.attn.wo, block.xattn.wq, block.xattn.wk,
                      block.xattn.wv, block.xattn.wo, block.mlp.wg,
                      block.mlp.wu, block.mlp.wd):
                L.draw(w, gen, 0.02)
    return model
