"""GCN over fixed-fanout padded subgraph trees (port of
``repro/models/gcn.py``).

Layer ``i`` (1-based) updates every tree level that still matters
(levels ``0 .. L-i``) from its own representation plus the masked mean of
its children; after layer ``L`` only the seed level remains.  Parameters
keep the reference's ``x @ W`` layout (``[d_in, d_out]``), so carrying
weights across is a copy (``repro_torch.convert``).  The masked mean is
``kernels.ops.fanout_mean``: the CUDA kernel on the card, its plain twin
on the CPU.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.config import ModelConfig, resolve_device
from ..graph.subgraph import SubgraphBatch
from ..kernels import ops


class GCNLayer(nn.Module):
    """One graph convolution: ``relu(x @ w_self + mean(children) @ w_nbr
    + b)``."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.w_self = nn.Parameter(torch.zeros(d_in, d_out, device=device))
        self.w_nbr = nn.Parameter(torch.zeros(d_in, d_out, device=device))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        """Update one tree level from itself and its children's mean."""
        return torch.relu(x @ self.w_self + agg @ self.w_nbr + self.b)


class GCN(nn.Module):
    """The paper's mini-batch GCN: one ``GCNLayer`` per hop and a linear
    read-out of the seed level."""

    def __init__(self, d_in: int, hidden: int, n_classes: int, depth: int, *,
                 device=None):
        super().__init__()
        dims = [d_in] + [hidden] * depth
        self.layers = nn.ModuleList(
            GCNLayer(dims[i], hidden, device=device) for i in range(depth))
        self.w_out = nn.Parameter(torch.zeros(hidden, n_classes, device=device))
        self.b_out = nn.Parameter(torch.zeros(n_classes, device=device))

    def leaves(self) -> list:
        """The parameters in the reference's pytree order (each layer's
        ``w_self, w_nbr, b``, then ``w_out, b_out``) — the order the
        optimizer state and ``convert`` use; ``parameters()`` lists the
        read-out first."""
        return [p for layer in self.layers
                for p in (layer.w_self, layer.w_nbr, layer.b)] + [
                    self.w_out, self.b_out]

    def forward(self, batch: SubgraphBatch) -> torch.Tensor:
        """Bottom-up tree aggregation, hop L -> ... -> seed: logits
        ``[B, n_classes]``."""
        depth = batch.depth
        if len(self.layers) != depth:
            raise ValueError(f"params built for {len(self.layers)} hops, "
                             f"batch has {depth}")
        reps = [batch.x_seed] + list(batch.x_hops)
        for i, layer in enumerate(self.layers):
            reps = [layer(reps[v], _child_mean(reps[v + 1], batch.masks[v]))
                    for v in range(depth - i)]
        return reps[0] @ self.w_out + self.b_out


def _child_mean(child: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the last fanout axis: ``[..., k, D] -> [..., D]``."""
    k, d = child.shape[-2], child.shape[-1]
    agg = ops.fanout_mean(child.reshape(-1, k, d), mask.reshape(-1, k))
    return agg.reshape(child.shape[:-2] + (d,))


def _glorot_(w: torch.Tensor, gen: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=gen) * 2 - 1) * limit)


def init_gcn(cfg: ModelConfig, seed: int = 0, device="cuda") -> GCN:
    """A GCN for ``cfg`` on ``device`` with Glorot-uniform weights and zero
    biases, drawn from a CPU ``torch.Generator`` seeded with ``seed`` (the
    draws differ from ``repro.models.gcn.init_gcn``'s; use ``convert`` to
    share weights)."""
    device = resolve_device(device)
    depth = max(len(cfg.fanouts), 1)
    model = GCN(cfg.gcn_in_dim, cfg.gcn_hidden, cfg.n_classes, depth)
    gen = torch.Generator().manual_seed(seed)
    for layer in model.layers:
        _glorot_(layer.w_self, gen)
        _glorot_(layer.w_nbr, gen)
    _glorot_(model.w_out, gen)
    return model.to(device)


def gcn_forward(model: GCN, batch: SubgraphBatch) -> torch.Tensor:
    """Logits of ``batch`` (``model(batch)``, named as in ``repro``)."""
    return model(batch)


def gcn_loss(model: GCN, batch: SubgraphBatch) -> torch.Tensor:
    """Mean negative log-likelihood of the seeds' labels."""
    logp = torch.log_softmax(model(batch), dim=-1)
    nll = -torch.gather(logp, 1, batch.labels.to(torch.int64)[:, None])[:, 0]
    return nll.mean()
