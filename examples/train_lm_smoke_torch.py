"""Train any assigned architecture of the PyTorch port (reduced config)
end to end, as ``examples/train_lm_smoke.py`` does on the reference:

    PYTHONPATH=src python examples/train_lm_smoke_torch.py [arch] [--device cpu]

The production launcher's substrate: AdamW with warmup and cosine decay,
gradient clipping, microbatch accumulation, and the host prefetch loader
(the GraphGen+ pipeline generalized to token streams)."""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch        # noqa: E402

from repro_torch.configs import REGISTRY, smoke_config           # noqa: E402
from repro_torch.convert import lm_leaves                         # noqa: E402
from repro_torch.core.config import TrainConfig, resolve_device   # noqa: E402
from repro_torch.data.loader import PrefetchLoader                # noqa: E402
from repro_torch.models import zoo                                # noqa: E402
from repro_torch.train.train_loop import (init_state,             # noqa: E402
                                          make_train_step, module_loss)

STEPS, B, S = 30, 4, 32


def main(device="cuda", arch: str = "zamba2-1.2b", steps: int = STEPS
         ) -> dict:
    """Train ``arch``'s smoke config for ``steps`` steps on ``device``;
    returns ``{"losses": [...], "grad_norms": [...], "tokens", "steps",
    "backups"}`` (``tokens`` the tokens trained on)."""
    dev = resolve_device(device)
    cfg = smoke_config(REGISTRY[arch])
    api = zoo.build(cfg, dev)
    tcfg = TrainConfig(learning_rate=2e-3, warmup_steps=5, total_steps=steps,
                       microbatches=2)
    model = api.init(0)
    params, layout = lm_leaves(model)
    state = init_state(params, tcfg, layout)
    del params
    model.to_empty(device="meta")      # the state holds the weights
    step = make_train_step(module_loss(model, api.loss, layout.names), tcfg,
                           layout)

    def produce(shard: int):
        """Host-side batch producer: runs in the prefetch loader's worker
        threads, overlapping the device's compute."""
        r = np.random.default_rng(shard)
        toks = r.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(np.roll(toks, -1, 1))}
        if cfg.family == "vlm":
            batch["vision"] = torch.from_numpy(r.standard_normal(
                (B, cfg.n_vision_tokens, cfg.d_vision), dtype=np.float32))
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(r.standard_normal(
                (B, cfg.n_audio_frames, cfg.d_audio), dtype=np.float32))
        return batch

    loader = PrefetchLoader(produce, n_shards=steps, depth=2, n_threads=2)
    print(f"training {arch} (reduced) for {steps} steps...")
    losses, norms, tokens = [], [], 0
    for i, batch in enumerate(loader):
        batch = {k: v.to(dev) for k, v in batch.items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        tokens += batch["tokens"].numel()
        if (i + 1) % 5 == 0:
            print(f"step {i + 1:3d}  loss {losses[-1]:.4f}  "
                  f"gnorm {norms[-1]:.3f}")
    print("done;", f"{loader.backups_issued} straggler backups issued")
    return {"losses": losses, "grad_norms": norms, "tokens": tokens,
            "steps": len(losses), "backups": loader.backups_issued}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?", default="zamba2-1.2b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device, args.arch)
