"""Config registry of the port: ``get_config(arch_id)`` and the reduced
``smoke_config`` (the GCN archs only — the LM zoo waits for its slice)."""
from __future__ import annotations

import dataclasses

from ..core.config import ModelConfig
from . import graphgen_gcn, graphgen_gcn_deep, graphgen_sage

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (graphgen_gcn, graphgen_sage, graphgen_gcn_deep)
}


def get_config(name: str) -> ModelConfig:
    """The registered config for ``name`` (``KeyError`` if unknown)."""
    return REGISTRY[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: narrow widths,
    fanouts (4, 3, 2, ...) at the configured depth, and the cache kept on
    (tiny) when the full config enables it."""
    if cfg.family != "gcn":
        raise ValueError(f"the port has only GCN configs, got {cfg.family!r}")
    depth = max(len(cfg.fanouts), 1)
    small = ((4, 3) + (2,) * depth)[:depth]
    return dataclasses.replace(cfg, gcn_in_dim=16, gcn_hidden=32, n_classes=5,
                               fanouts=small,
                               cache_rows=min(cfg.cache_rows, 256),
                               cache_l1_rows=min(cfg.cache_l1_rows, 32))
