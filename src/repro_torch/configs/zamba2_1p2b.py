"""Zamba2-1.2b [arXiv:2411.15242] — Mamba2 backbone + one shared
attention block (copy of ``repro/configs/zamba2_1p2b.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128, conv_width=4,
    attn_every=6,
)
