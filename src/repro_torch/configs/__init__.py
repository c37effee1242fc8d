"""Config registry of the port: ``get_config(arch_id)`` and the reduced
``smoke_config`` (the GCN archs and the dense LMs; the other LM families
wait for ROADMAP Queue 1 item 6)."""
from __future__ import annotations

import dataclasses

from ..core.config import ModelConfig
from . import (graphgen_gcn, graphgen_gcn_deep, graphgen_sage, smollm_135m,
               smollm_360m)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (smollm_135m, smollm_360m, graphgen_gcn, graphgen_sage,
              graphgen_gcn_deep)
}


def get_config(name: str) -> ModelConfig:
    """The registered config for ``name`` (``KeyError`` if unknown)."""
    return REGISTRY[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.  GCN: narrow
    widths, fanouts (4, 3, 2, ...) at the configured depth, and the cache
    kept on (tiny) when the full config enables it.  Dense LM: 4 layers,
    d_model 64, head_dim 16, vocab 512, heads ``max(n // 4, 2)`` over
    ``max(kv // 4, 1)`` (the reference's dense branch)."""
    if cfg.family == "gcn":
        depth = max(len(cfg.fanouts), 1)
        small = ((4, 3) + (2,) * depth)[:depth]
        return dataclasses.replace(cfg, gcn_in_dim=16, gcn_hidden=32,
                                   n_classes=5, fanouts=small,
                                   cache_rows=min(cfg.cache_rows, 256),
                                   cache_l1_rows=min(cfg.cache_l1_rows, 32))
    if cfg.family != "dense":
        raise ValueError(f"the port has no {cfg.family!r} family yet "
                         f"(ROADMAP Queue 1 item 6)")
    heads = max(cfg.n_heads // 4, 2)
    kv = min(max(cfg.n_kv_heads // 4, 1), heads)
    if heads % kv:
        kv = 1
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, 4), d_model=64, n_heads=heads,
        n_kv_heads=kv, head_dim=16, d_ff=128, vocab_size=512)
