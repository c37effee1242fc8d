"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M family] — llama-arch small
dense (copy of ``repro/configs/smollm_360m.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    tie_embeddings=True,
)
