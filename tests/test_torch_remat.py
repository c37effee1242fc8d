"""``models/layers.py::maybe_remat`` (the reference's ``maybe_remat``:
``remat`` none, full or dots) in one process on the CPU.

For each of the seven families' smoke configs (dense, Qwen3-MoE,
DeepSeek-V2, Mamba-2, Zamba2, the VLM, Whisper), in the default bf16
compute: ``remat`` full and dots give losses and gradients bit-equal to
none's; every layer body is checkpointed (``layers.checkpoint``'s calls)
and recomputed in the backward (``layers.recomputing()`` seen True);
``moe.tally()`` counts each dispatch once (the recompute appends
nothing); ``SSDScan``'s forward runs again in the recompute (the twin's
calls double), and its gradients are the unrecomputed ones.  Dots keeps
the outputs of the 2-D matrix products: its backward runs no
``aten.mm`` beyond none's, full's reruns the bodies' products.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import lm_leaves  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import lm_batch  # noqa: E402
from repro_torch.models import layers, moe, zoo  # noqa: E402
from repro_torch.train import train_loop as TL  # noqa: E402

ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
         "mamba2-1.3b", "zamba2-1.2b", "llama-3.2-vision-11b",
         "whisper-small")


def _bodies(cfg):
    """The layer bodies ``maybe_remat`` wraps, one per reference site."""
    if cfg.family == "hybrid":
        return cfg.n_layers                       # the Mamba layers only
    if cfg.family == "audio":
        return cfg.n_layers + cfg.n_encoder_layers
    return cfg.n_layers                           # VLM: its self layers


def _run(arch, remat, monkeypatch):
    """Loss, gradients, tally, checkpointed bodies, recomputed norms and
    the SSD twin's calls of one ``value_and_grad`` under ``remat``."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), remat=remat)
    api = zoo.build(cfg, "cpu")
    model = api.init(0)
    params, layout = lm_leaves(model)
    batch = lm_batch(np.random.default_rng(0), cfg, 2, 16, "cpu")
    seen = {"bodies": 0, "recomputed": 0, "ssd": 0}
    real_ckpt, real_norm, real_ssd = (layers.checkpoint, layers.rmsnorm,
                                      ref.ssd_scan_ref)

    def ckpt(*a, **kw):
        seen["bodies"] += 1
        return real_ckpt(*a, **kw)

    def norm(*a, **kw):
        seen["recomputed"] += layers.recomputing()
        return real_norm(*a, **kw)

    def ssd(*a, **kw):
        seen["ssd"] += 1
        return real_ssd(*a, **kw)
    monkeypatch.setattr(layers, "checkpoint", ckpt)
    monkeypatch.setattr(layers, "rmsnorm", norm)
    monkeypatch.setattr(ref, "ssd_scan_ref", ssd)
    fn = TL.module_loss(model, api.loss, layout.names)
    with moe.tally() as tally:
        loss, grads = TL.value_and_grad(fn, params, batch)
    monkeypatch.undo()
    return cfg, loss, grads, dict(tally), seen


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal(arch, remat, monkeypatch):
    """``remat`` full and dots against none: the loss and every gradient
    bit-equal, the MoE tally the same, every body checkpointed and
    recomputed, the SSD twin run again in each recompute."""
    cfg, loss, grads, tally, seen = _run(arch, remat, monkeypatch)
    _, loss0, grads0, tally0, seen0 = _run(arch, "none", monkeypatch)
    assert loss.item() == loss0.item()
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)
    assert tally == tally0
    if cfg.family == "moe":
        assert tally["calls"] == cfg.n_layers - cfg.first_dense_layers
    assert seen0["bodies"] == 0 and seen0["recomputed"] == 0
    assert seen["bodies"] == _bodies(cfg)
    assert seen["recomputed"] > 0
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert seen0["ssd"] == mamba and seen["ssd"] == 2 * mamba


class _MMs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_matrix_products():
    """smollm's forward and backward: ``dots`` runs exactly as many 2-D
    matrix products as ``none`` (the recompute takes the forward's saved
    outputs), ``full`` reruns the body's products."""
    counts = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(smoke_config(get_config("smollm-135m")),
                                  remat=remat)
        api = zoo.build(cfg, "cpu")
        model = api.init(0)
        params, layout = lm_leaves(model)
        batch = lm_batch(np.random.default_rng(0), cfg, 2, 16, "cpu")
        fn = TL.module_loss(model, api.loss, layout.names)
        with _MMs() as mode:
            TL.value_and_grad(fn, params, batch)
        counts[remat] = mode.n
    # per layer q, k, v, o, gate and up again: the recompute stops once
    # every saved tensor is back, before the down projection, whose
    # output no backward reads (the head is outside the bodies)
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 6 * cfg.n_layers


def test_remat_off_without_autograd():
    """Under ``torch.no_grad`` (serving) ``maybe_remat`` returns the body
    itself; ``none`` always does."""
    cfg = dataclasses.replace(smoke_config(get_config("smollm-135m")),
                              remat="full")

    def body(x):
        return x
    with torch.no_grad():
        assert layers.maybe_remat(body, cfg) is body
    assert layers.maybe_remat(body, dataclasses.replace(
        cfg, remat="none")) is body
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(cfg, remat="dot")
