"""1-hop GraphSAGE-style workload, fanout (8,) (copy of
``repro/configs/graphgen_sage.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="graphgen-sage", family="gcn",
    gcn_in_dim=128, gcn_hidden=256, n_classes=64, fanouts=(8,),
    cache_rows=2048, cache_admit=2, cache_assoc=2, cache_mode="sharded",
)
