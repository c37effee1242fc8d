"""Serve a small LM with batched requests through the port's zoo decode
path, as ``examples/serve_lm.py`` does on the reference: a GQA KV-cache
transformer (smollm) and an O(1)-state SSM (mamba2), the latter the
long_500k story at laptop scale.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch        # noqa: E402

from repro_torch.configs import REGISTRY, smoke_config           # noqa: E402
from repro_torch.core.config import resolve_device                # noqa: E402
from repro_torch.models import zoo                                # noqa: E402

BATCH, PROMPT, GEN = 8, 12, 24
ARCHS = ("smollm-135m", "mamba2-1.3b")


def main(device="cuda") -> dict:
    """Decode ``BATCH`` prompts of ``PROMPT`` tokens and ``GEN`` new ones
    per arch on ``device``; returns ``{arch: {"tokens" [BATCH, GEN] numpy,
    "tok_s"}}``."""
    dev = resolve_device(device)
    out = {}
    for arch in ARCHS:
        cfg = smoke_config(REGISTRY[arch])
        api = zoo.build(cfg, dev)
        model = api.init(0)
        cache = api.init_cache(model, BATCH, PROMPT + GEN)
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
        with torch.no_grad():
            logits = None
            for p in range(PROMPT):
                logits, cache = api.decode(model, cache, prompt[:, p:p + 1],
                                           p)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            gen = []
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for g in range(GEN):
                gen.append(tok)
                logits, cache = api.decode(model, cache, tok, PROMPT + g)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            tokens = torch.cat(gen, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
        out[arch] = {"tokens": tokens, "tok_s": BATCH * GEN / dt}
        print(f"{arch:16s} {BATCH * GEN / dt:8.1f} tok/s (batch {BATCH})  "
              f"sample: {tokens[0][:10].tolist()}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
