"""The port's examples (``examples/*_torch.py``) on the CPU, each at its
reference's sizes, holding the claims its reference prints: the GCN
pipeline's loss falls; the multi-worker driver checkpoints every 10
steps, loses workers 3 and 6 at step 20, resumes from that step's
checkpoint on 4 workers and ends at step 40 with a lower loss; every
served sequence gets its ``GEN`` tokens; the LM example trains its
steps on ``steps x B x S`` tokens with finite losses."""
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import distributed_pipeline_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_lm_torch  # noqa: E402
import train_lm_smoke_torch  # noqa: E402


def test_quickstart():
    """30 pipelined steps: finite losses, the last five's mean below the
    first five's."""
    res = quickstart_torch.main(device="cpu")
    losses = res["losses"]
    assert len(losses) == quickstart_torch.STEPS
    assert all(map(math.isfinite, losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert res["nodes_per_iter"] == quickstart_torch.BATCH * (1 + 10 + 50)


def test_distributed_pipeline(tmp_path):
    """The failure, the rebalance to 4 workers, the resume from step 20's
    checkpoint and the falling loss; the cache serves hits on both
    worker counts."""
    res = distributed_pipeline_torch.main(device="cpu",
                                          ckpt_dir=str(tmp_path))
    assert res["resumed_at"] == distributed_pipeline_torch.FAIL_AT == 20
    assert res["final_workers"] == 4
    assert res["steps"] == distributed_pipeline_torch.TOTAL == 40
    assert sorted(res["losses"]) == [10, 20, 30, 40]
    assert res["workers"] == {10: 8, 20: 8, 30: 4, 40: 4}
    assert res["losses"][40] < res["losses"][10]
    assert all(res["cache_hit"][t] > 0 for t in (20, 40))
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000040"


def test_serve_lm():
    """Every sequence of both archs gets ``GEN`` tokens in the vocab."""
    res = serve_lm_torch.main(device="cpu")
    for arch in serve_lm_torch.ARCHS:
        toks = res[arch]["tokens"]
        assert toks.shape == (serve_lm_torch.BATCH, serve_lm_torch.GEN)
        assert 0 <= toks.min() and toks.max() < 512
        assert res[arch]["tok_s"] > 0


def test_train_lm_smoke():
    """The default arch (zamba2's smoke config) trains its steps on its
    tokens with finite losses and gradient norms."""
    res = train_lm_smoke_torch.main(device="cpu")
    steps = train_lm_smoke_torch.STEPS
    assert res["steps"] == steps
    assert res["tokens"] == steps * train_lm_smoke_torch.B \
        * train_lm_smoke_torch.S
    assert all(map(math.isfinite, res["losses"] + res["grad_norms"]))
