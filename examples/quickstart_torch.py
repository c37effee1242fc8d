"""Quickstart of the PyTorch port: GraphGen+ in ~60 lines.

Builds a synthetic power-law graph, partitions it (coordinator), assigns
seeds with the balance table, generates 2-hop subgraphs with the
edge-centric distributed sampler, and trains a GCN with the synchronized
generation + training pipeline: the paper's full workflow (Algorithm 1),
as ``examples/quickstart.py`` runs it on the reference.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch        # noqa: E402

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core.balance import balance_table              # noqa: E402
from repro_torch.core.config import TrainConfig, resolve_device  # noqa: E402
from repro_torch.core.generation import (SeededDraws,           # noqa: E402
                                         make_distributed_generator)
from repro_torch.core.partition import partition_edges          # noqa: E402
from repro_torch.core.pipeline import make_pipelined_step       # noqa: E402
from repro_torch.graph.synthetic import (node_features,         # noqa: E402
                                         powerlaw_graph)
from repro_torch.launch.train import make_gcn_train_fn          # noqa: E402
from repro_torch.models.gcn import init_gcn                     # noqa: E402
from repro_torch.train.optimizer import init_adam               # noqa: E402

N_NODES, N_CLASSES, DIM = 5_000, 8, 64
FANOUTS = (10, 5)       # 2-hop fanouts (the paper uses 40, 20 at cluster
                        # scale); any depth works, e.g. (8,) or (15, 10, 5)
STEPS, BATCH = 30, 64


def main(device="cuda", steps: int = STEPS) -> dict:
    """Run the workflow on ``device``; returns ``{"losses": [...],
    "edge_balance", "seeds_per_worker", "nodes_per_iter"}``."""
    dev = resolve_device(device)
    # ---- Step 1: graph partitioning (coordinator) ----------------------
    graph = powerlaw_graph(N_NODES, avg_degree=8, n_hot=10, hot_degree=500,
                           seed=0)
    w = 1
    part = partition_edges(graph, w, strategy="by_edge_hash")
    print(f"graph: {graph.n_nodes} nodes / {graph.n_edges} edges, {w} "
          f"workers, edge balance {part.edge_balance():.3f}")
    # features + labels with learnable structure
    rng = np.random.default_rng(0)
    feats = node_features(N_NODES, DIM)
    labels = np.argmax(feats @ rng.standard_normal((DIM, N_CLASSES)),
                       1).astype(np.int32)
    # ---- Step 2: load-balanced subgraph mapping ------------------------
    table = balance_table(np.arange(N_NODES), w, seed=0)
    print(f"balance table: {table.seeds_per_worker} seeds/worker, "
          f"{table.n_discarded} discarded")
    # ---- Step 3: distributed (edge-centric) subgraph generation -------
    gen_fn, device_args = make_distributed_generator(
        part, feats, labels, fanouts=FANOUTS, device=dev)
    draws = SeededDraws(FANOUTS, 1, dev)
    # ---- Step 4: in-memory graph learning (synchronized pipeline) -----
    cfg = dataclasses.replace(get_config("graphgen-gcn"), gcn_in_dim=DIM,
                              n_classes=N_CLASSES, gcn_hidden=128,
                              fanouts=FANOUTS)
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=steps,
                       warmup_steps=0)
    model = init_gcn(cfg, 0, dev)
    opt = init_adam(model.leaves())
    step = make_pipelined_step(gen_fn, make_gcn_train_fn(tcfg))

    def seeds(t):
        cols = table.per_worker[:, (t * BATCH) % (N_NODES - BATCH):][:, :BATCH]
        return torch.from_numpy(np.ascontiguousarray(cols)).to(dev)

    with torch.no_grad():
        carry = (model, opt, gen_fn(device_args, seeds(0), draws(0, w, BATCH)))
    nodes = carry[2].nodes_per_iteration()
    losses = []
    for t in range(steps):
        carry, loss = step(carry, device_args, seeds(t + 1),
                           draws(t + 1, w, BATCH))
        losses.append(float(loss))
        if (t + 1) % 5 == 0:
            print(f"step {t + 1:3d}  loss {losses[-1]:.4f}")
    print("done: subgraphs were generated and consumed fully in memory.")
    return {"losses": losses, "edge_balance": part.edge_balance(),
            "seeds_per_worker": table.seeds_per_worker,
            "nodes_per_iter": nodes}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
