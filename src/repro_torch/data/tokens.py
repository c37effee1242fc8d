"""Token data for the LM families (port of ``repro/data/tokens.py``).

Synthetic token streams (no corpus ships with the repo) sharded with the
same balance-table discipline as subgraph seeds: document ids are
shuffled, dealt round-robin to the data-parallel workers, and the
remainder is discarded, so every worker sees the same batch count.  Both
functions draw with numpy exactly as the reference does, so their
values are bit-equal to its.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.balance import balance_table
from ..core.config import ModelConfig, ShapeConfig, resolve_device


def synthetic_token_batch(cfg: ModelConfig, shape: ShapeConfig,
                          seed: int = 0, device="cuda") -> dict:
    """``{"tokens", "labels"}`` int32 ``[global_batch, seq_len]`` on
    ``device``: tokens uniform over the vocabulary from
    ``np.random.default_rng(seed)``, labels the tokens shifted left by
    one with the first token wrapped to the end."""
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    device = resolve_device(device)
    return {"tokens": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def token_shard_schedule(n_documents: int, n_workers: int, steps: int,
                         per_step: int, seed: int = 0) -> np.ndarray:
    """Balance-table document assignment -> ``[steps, W, per_step]``
    int32 document ids: each worker's dealt documents tiled to cover
    ``steps * per_step`` draws."""
    table = balance_table(np.arange(n_documents, dtype=np.int32), n_workers,
                          seed)
    per_w = table.per_worker                               # [W, S/W]
    need = steps * per_step
    reps = -(-need // per_w.shape[1])
    tiled = np.tile(per_w, (1, reps))[:, :need]             # [W, steps*per_step]
    return tiled.reshape(n_workers, steps, per_step).transpose(1, 0, 2)
