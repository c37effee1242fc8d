"""The paper's own model: mini-batch GCN on 2-hop (40, 20) subgraphs, with
a 4096-row, 4-way, sharded hot-node feature cache on the compact wire
(copy of ``repro/configs/graphgen_gcn.py``)."""
from ..core.config import ModelConfig

CONFIG = ModelConfig(
    name="graphgen-gcn", family="gcn",
    gcn_in_dim=128, gcn_hidden=256, n_classes=64, fanouts=(40, 20),
    cache_rows=4096, cache_admit=2, cache_assoc=4, cache_mode="sharded",
)
