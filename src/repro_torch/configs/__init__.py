"""Config registry of the port: ``get_config(arch_id)`` and the reduced
``smoke_config`` for every arch the reference registers (the GCN archs,
the dense LMs, the two mixture-of-experts LMs, the Llama-3.2-Vision VLM,
Whisper, the Mamba-2 SSM and the Zamba2 hybrid); ``ASSIGNED_ARCHS``, the
LM archs of the dry-run sweep, and ``SUBQUADRATIC``, those that run the
``long_500k`` shape."""
from __future__ import annotations

import dataclasses

from ..core.config import ModelConfig
from . import (deepseek_v2_236b, graphgen_gcn, graphgen_gcn_deep,
               graphgen_sage, llama3_405b, llama32_vision_11b, mamba2_1p3b,
               qwen3_moe_30b_a3b, smollm_135m, smollm_360m, stablelm_12b,
               whisper_small, zamba2_1p2b)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (smollm_135m, smollm_360m, stablelm_12b, llama3_405b,
              qwen3_moe_30b_a3b, deepseek_v2_236b, llama32_vision_11b,
              whisper_small, mamba2_1p3b, zamba2_1p2b, graphgen_gcn,
              graphgen_sage, graphgen_gcn_deep)
}

#: the LM archs of the dry-run sweep (every registered non-GCN arch)
ASSIGNED_ARCHS = [n for n, c in REGISTRY.items() if c.family != "gcn"]
#: archs whose sequence mixing is not quadratic: only they run
#: ``long_500k``
SUBQUADRATIC = {"mamba2-1.3b", "zamba2-1.2b"}


def get_config(name: str) -> ModelConfig:
    """The registered config for ``name`` (``KeyError`` if unknown)."""
    return REGISTRY[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests, the reference's
    branches for the families the port has.  GCN: narrow widths, fanouts
    (4, 3, 2, ...) at the configured depth, and the cache kept on (tiny)
    when the full config enables it.  LM: 4 layers, d_model 64, vocab
    512; with attention, heads ``max(n // 4, 2)`` over ``max(kv // 4,
    1)`` and head_dim 16, without (ssm) heads, kv heads and head_dim 0;
    d_ff 128 where the config has an FFN, else 0; moe: 8 experts, top 2,
    expert width 32, and with MLA (DeepSeek) latent ranks 24/32, head
    dims 8 (rope) / 16 (nope, v), one dense layer of d_ff 64 before two
    MoE layers, one shared expert; ssm and hybrid: state 16, head_dim 16,
    chunk 8; hybrid: 5 layers, the shared block every 2 (two sites and a
    tail layer); vlm: 4 layers, cross-attention every 2, 8 vision tokens
    of width 24; audio: 2 encoder and 2 decoder layers, 12 frames of
    width 24."""
    if cfg.family == "gcn":
        depth = max(len(cfg.fanouts), 1)
        small = ((4, 3) + (2,) * depth)[:depth]
        return dataclasses.replace(cfg, gcn_in_dim=16, gcn_hidden=32,
                                   n_classes=5, fanouts=small,
                                   cache_rows=min(cfg.cache_rows, 256),
                                   cache_l1_rows=min(cfg.cache_l1_rows, 32))
    heads = max(cfg.n_heads // 4, 2) if cfg.n_heads else 0
    kv = max(cfg.n_kv_heads // 4, 1) if cfg.n_kv_heads else 0
    kv = min(kv, heads) if heads else 0
    if heads and kv and heads % kv:
        kv = 1
    rep = dict(n_layers=min(cfg.n_layers, 4), d_model=64, n_heads=heads,
               n_kv_heads=kv, head_dim=16 if heads else 0,
               d_ff=128 if cfg.d_ff else 0, vocab_size=512, remat="none")
    if cfg.family == "moe":
        rep.update(n_experts=8, top_k=2, d_ff_expert=32)
        if cfg.kv_lora_rank:
            rep.update(kv_lora_rank=24, q_lora_rank=32, qk_rope_head_dim=8,
                       qk_nope_head_dim=16, v_head_dim=16,
                       first_dense_layers=1, n_layers=3, n_shared_experts=1,
                       d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        rep.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.family == "hybrid":
        rep.update(n_layers=5, attn_every=2)
    if cfg.family == "vlm":
        rep.update(n_layers=4, cross_attn_every=2, n_vision_tokens=8,
                   d_vision=24)
    if cfg.family == "audio":
        rep.update(n_encoder_layers=2, n_layers=2, n_audio_frames=12,
                   d_audio=24)
    return dataclasses.replace(cfg, **rep)
