"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8 MoE (copy of
``repro/configs/qwen3_moe_30b_a3b.py``; d_ff_expert is the routed
experts' FFN width)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, d_ff_expert=768, vocab_size=151936, head_dim=128,
    n_experts=128, top_k=8,
)
