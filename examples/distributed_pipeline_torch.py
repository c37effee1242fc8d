"""End-to-end multi-worker driver of the PyTorch port: 8 workers on the
stacked group (one process) run the full GraphGen+ workflow, as
``examples/distributed_pipeline.py`` runs it on the reference:
partitioning, the balance table, edge-centric generation with tree
reduction, a TIERED device-resident hot-node feature cache (a small
replicated L1 holding the global Zipf head in front of the sharded L2,
where each worker holds the shard of ``hash(id) mod W``, probed by one
all_to_all round before any owner fetch) threaded through the pipelined
carry, synchronized training, checkpointing, a simulated worker FAILURE,
rebalancing over the survivors (``train/fault.py``, ``core/balance.py``;
the cache restarts cold: row ownership, the shard map and the promoted
L1 head all moved), and resume from the checkpoint.

    PYTHONPATH=src python examples/distributed_pipeline_torch.py [--device cpu]
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch        # noqa: E402

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core.balance import balance_table              # noqa: E402
from repro_torch.core.config import TrainConfig, resolve_device  # noqa: E402
from repro_torch.core.feature_cache import CacheConfig          # noqa: E402
from repro_torch.core.generation import (SeededDraws,           # noqa: E402
                                         make_distributed_generator)
from repro_torch.core.partition import partition_edges          # noqa: E402
from repro_torch.core.pipeline import make_pipelined_step       # noqa: E402
from repro_torch.graph.synthetic import (node_features,         # noqa: E402
                                         powerlaw_graph)
from repro_torch.launch.train import make_gcn_train_fn          # noqa: E402
from repro_torch.models.gcn import init_gcn                     # noqa: E402
from repro_torch.train import checkpoint as ckpt                # noqa: E402
from repro_torch.train.fault import recover_assignment          # noqa: E402
from repro_torch.train.optimizer import init_adam               # noqa: E402

N, DIM, CLASSES, B = 20_000, 64, 8, 16
FANOUTS = (8, 4)
# tiered 2-way cache: 8 workers x 1024 L2 rows = 8192 distinct sharded
# rows, plus a 128-row replicated L1 per worker serving the global head
# without even the probe round (rows promoted after 2 observations)
CACHE = CacheConfig(n_rows=1024, admit=2, assoc=2, mode="tiered",
                    l1_rows=128, l1_promote=2)
FAIL_AT, TOTAL, CKPT_EVERY = 20, 40, 10


def main(device="cuda", ckpt_dir: str = None) -> dict:
    """Run the driver on ``device``, checkpointing under ``ckpt_dir`` (a
    fresh temporary directory, removed at the end, when None).  Returns
    ``{"losses": {step: loss}, "cache_hit": {step: rate}, "workers":
    {step: W}, "resumed_at", "final_workers", "steps"}``."""
    dev = resolve_device(device)
    own_dir = ckpt_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="graphgen_ckpt_") if own_dir \
        else ckpt_dir
    graph = powerlaw_graph(N, avg_degree=8, n_hot=20, hot_degree=1000, seed=0)
    rng0 = np.random.default_rng(0)
    feats = node_features(N, DIM)
    labels = np.argmax(feats @ rng0.standard_normal((DIM, CLASSES)),
                       1).astype(np.int32)
    cfg = dataclasses.replace(get_config("graphgen-gcn"), gcn_in_dim=DIM,
                              n_classes=CLASSES, gcn_hidden=128,
                              fanouts=FANOUTS)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=0, total_steps=60)
    train_fn = make_gcn_train_fn(tcfg)
    draws = SeededDraws(FANOUTS, 1, dev)

    def build(workers: int):
        """(Re)build the pipeline for a worker count: the elastic path
        of startup and of recovery.  The cache starts empty on every
        build: row ownership follows the new partition AND the shard map
        ``hash(id) mod W`` changed with W."""
        part = partition_edges(graph, workers)
        gen_fn, dev_args, cache = make_distributed_generator(
            part, feats, labels, fanouts=FANOUTS, cache_cfg=CACHE,
            device=dev)
        table = balance_table(np.arange(N), workers, seed=0)
        step = make_pipelined_step(gen_fn, train_fn, cached=True)
        return gen_fn, dev_args, table, step, cache

    def seeds_for(table, t):
        per = table.per_worker
        cols = (np.arange(B) + t * B) % per.shape[1]
        return torch.from_numpy(np.ascontiguousarray(per[:, cols])).to(dev)

    model = init_gcn(cfg, 0, dev)
    opt = init_adam(model.leaves())
    workers = 8
    gen_fn, dev_args, table, step, cache = build(workers)
    with torch.no_grad():
        batch0, cache = gen_fn(dev_args, seeds_for(table, 0),
                               draws(0, workers, B), cache)
    carry = (model, opt, batch0, cache)
    out = {"losses": {}, "cache_hit": {}, "workers": {}, "resumed_at": None}
    t = 0
    try:
        while t < TOTAL:
            if t == FAIL_AT and workers == 8:
                print(f"\n*** step {t}: simulating loss of workers 3 and 6 "
                      f"***")
                # the survivors rebuild: Algorithm 1 re-runs over |W| - 2,
                # the graph is re-partitioned, training resumes from the
                # last durable checkpoint
                table = recover_assignment(table, failed=[3, 6])
                workers = table.n_workers
                # the butterfly merge takes a power-of-two worker count
                workers = 4 if workers not in (1, 2, 4, 8) else workers
                table = balance_table(np.arange(N), workers, seed=2)
                gen_fn, dev_args, _, step, cache = build(workers)
                restore_t = ckpt.latest_step(ckpt_dir)
                leaves, opt = ckpt.restore(ckpt_dir, restore_t,
                                           (model.leaves(), carry[1]))
                with torch.no_grad():
                    for p, v in zip(model.leaves(), leaves):
                        p.copy_(v)
                    batch0, cache = gen_fn(dev_args,
                                           seeds_for(table, restore_t),
                                           draws(restore_t, workers, B),
                                           cache)
                carry = (model, opt, batch0, cache)
                t = out["resumed_at"] = restore_t
                print(f"*** resumed at step {t} on {workers} workers ***\n")
                continue
            carry, loss = step(carry, dev_args, seeds_for(table, t + 1),
                               draws(t + 1, workers, B))
            if (t + 1) % CKPT_EVERY == 0:
                ckpt.save(ckpt_dir, t + 1, (model.leaves(), carry[1]), keep=3)
                hit = carry[2].cache_hit_rate()
                out["losses"][t + 1] = float(loss)
                out["cache_hit"][t + 1] = hit
                out["workers"][t + 1] = workers
                print(f"step {t + 1:3d}  loss {float(loss):.4f}  "
                      f"workers={workers}  cache_hit={hit:.2f}  "
                      f"[checkpointed]")
            t += 1
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\nfinished {TOTAL} steps across a simulated failure")
    out.update(final_workers=workers, steps=t)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
