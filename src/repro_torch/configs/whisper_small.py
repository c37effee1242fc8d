"""Whisper-small [arXiv:2212.04356] — encoder-decoder; the conv frontend
is a stub: the inputs are precomputed frame embeddings (copy of
``repro/configs/whisper_small.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, n_encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    n_audio_frames=1500, d_audio=768,
)
