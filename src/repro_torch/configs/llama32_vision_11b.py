"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision] — text
decoder with a gated cross-attention block after every 5th layer; the
patch-embedding frontend is a stub: the inputs are precomputed vision
embeddings (copy of ``repro/configs/llama32_vision_11b.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5, n_vision_tokens=1600, d_vision=1280,
)
