"""Mamba2-1.3b [arXiv:2405.21060] — SSD, attention-free (copy of
``repro/configs/mamba2_1p3b.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128, conv_width=4,
)
