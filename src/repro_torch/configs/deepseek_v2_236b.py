"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA (kv_lora 512) + MoE (2 shared
+ 160 routed experts, top-6); the first layer dense (d_ff 12288) (copy of
``repro/configs/deepseek_v2_236b.py``, ``remat="full"`` included)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, d_ff_expert=1536, vocab_size=102400,
    n_experts=160, top_k=6, n_shared_experts=2, first_dense_layers=1,
    kv_lora_rank=512, q_lora_rank=1536,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    remat="full",
)
