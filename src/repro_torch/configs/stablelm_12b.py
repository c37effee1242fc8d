"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b lineage] — dense GQA
with 160-wide heads and an untied read-out (copy of
``repro/configs/stablelm_12b.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
)
