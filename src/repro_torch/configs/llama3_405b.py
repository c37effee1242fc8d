"""Llama-3-405B [arXiv:2407.21783] — dense GQA, 128k vocab, untied
read-out (copy of ``repro/configs/llama3_405b.py``, ``remat="full"``
included: every layer body is recomputed in the backward)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0, remat="full",
)
