"""3-hop deep-GCN workload, fanouts (15, 10, 5), tiered cache: a 512-row
replicated L1 in front of the 4096-row 4-way sharded L2; the feature
table can move to host RAM (``--feature-store host``, gather depth 2)
(copy of ``repro/configs/graphgen_gcn_deep.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="graphgen-gcn-deep", family="gcn",
    gcn_in_dim=128, gcn_hidden=256, n_classes=64, fanouts=(15, 10, 5),
    cache_rows=4096, cache_admit=2, cache_assoc=4, cache_mode="tiered",
    cache_l1_rows=512, cache_l1_promote=3,
    feature_store="device", host_gather_depth=2,
)
