"""Model zoo of the port (``repro/models/zoo.py``'s ``build`` and
``forward_logits``) for the families ported so far: the paper's GCN and
the dense LM.  The other LM families raise ``NotImplementedError``
(ROADMAP Queue 1 item 6)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.config import ModelConfig, resolve_device
from . import gcn, transformer

_LATER = "is not ported yet (ROADMAP Queue 1 item 6)"


class ModelAPI(NamedTuple):
    """Uniform entry points of one config: ``init(seed) -> model``,
    ``loss(model, batch)``, and for LMs ``decode(model, cache, tokens,
    pos) -> (logits, cache)`` and ``init_cache(model, batch, seq)``."""
    cfg: ModelConfig
    init: Callable[[int], Any]
    loss: Callable[[Any, Any], torch.Tensor]
    decode: Optional[Callable]
    init_cache: Optional[Callable]


def build(cfg: ModelConfig, device="cuda") -> ModelAPI:
    """The ``ModelAPI`` of ``cfg`` with models made on ``device``."""
    device = resolve_device(device)
    if cfg.family == "gcn":
        return ModelAPI(cfg=cfg,
                        init=lambda seed: gcn.init_gcn(cfg, seed, device),
                        loss=gcn.gcn_loss, decode=None, init_cache=None)
    if cfg.family == "dense":
        return ModelAPI(
            cfg=cfg,
            init=lambda seed: transformer.init_dense_lm(cfg, seed, device),
            loss=lambda m, batch: m.loss(batch),
            decode=lambda m, cache, tokens, pos: m.forward_decode(
                cache, tokens, pos),
            init_cache=lambda m, batch, seq: m.init_cache(batch, seq))
    raise NotImplementedError(f"family {cfg.family!r} {_LATER}")


def forward_logits(cfg: ModelConfig, model, batch: dict) -> torch.Tensor:
    """Full-sequence forward (prefill) without an autograd graph: float32
    logits ``[B, S, V_pad]`` of ``batch["tokens"]``.  ``cfg`` must be the
    model's own config (the model reads its own, flash switch included)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"forward_logits of family "
                                  f"{cfg.family!r} {_LATER}")
    if cfg != model.cfg:
        raise ValueError(f"forward_logits got a config other than the "
                         f"model's own: {cfg} vs {model.cfg}")
    with torch.no_grad():
        return model.forward_train(batch["tokens"])
