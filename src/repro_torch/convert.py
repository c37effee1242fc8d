"""Carry GCN weights, optimizer state and cache state from ``repro`` to
the port.

Each function takes the reference's pytree as numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the caller's side — this module
never imports jax): ``gcn_params_from_numpy`` returns the port's ``GCN``
holding the same weights, ``adam_state_from_numpy`` the port's
``AdamState`` (moments in ``GCN.leaves()`` order), and
``cache_state_from_numpy`` a flat ``FeatureCache`` or a ``TieredCache``,
so a run of the port can start from the reference's state mid-run.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import resolve_device
from .core.feature_cache import FeatureCache, TieredCache
from .models.gcn import GCN
from .train.optimizer import AdamState


def _gcn_leaves(tree_np):
    """``GCNParams``-shaped numpy tree -> its leaves in ``GCN.leaves()``
    order: each layer's ``w_self, w_nbr, b``, then ``w_out, b_out``."""
    layers, w_out, b_out = tree_np
    return [a for layer in layers for a in layer] + [w_out, b_out]


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).to(device)


def gcn_params_from_numpy(params_np, device="cuda") -> GCN:
    """``GCNParams(layers=((w_self, w_nbr, b), ...), w_out, b_out)`` of
    numpy arrays -> a ``GCN`` on ``device`` with those weights (``[d_in,
    d_out]`` layout in both packages, so every tensor is a straight
    copy)."""
    device = resolve_device(device)
    layers, w_out, b_out = params_np
    w_self0 = np.asarray(layers[0][0])
    model = GCN(w_self0.shape[0], w_self0.shape[1], np.asarray(w_out).shape[1],
                len(layers))
    with torch.no_grad():
        for mod, (w_self, w_nbr, b) in zip(model.layers, layers):
            mod.w_self.copy_(torch.tensor(np.asarray(w_self, np.float32)))
            mod.w_nbr.copy_(torch.tensor(np.asarray(w_nbr, np.float32)))
            mod.b.copy_(torch.tensor(np.asarray(b, np.float32)))
        model.w_out.copy_(torch.tensor(np.asarray(w_out, np.float32)))
        model.b_out.copy_(torch.tensor(np.asarray(b_out, np.float32)))
    return model.to(device)


def adam_state_from_numpy(state_np, device="cuda") -> AdamState:
    """``AdamState(step, m, v)`` with ``m``/``v`` ``GCNParams``-shaped trees
    of numpy arrays -> the port's ``AdamState`` on ``device``."""
    device = resolve_device(device)
    step, m, v = state_np
    return AdamState(
        step=torch.tensor(np.asarray(step), dtype=torch.int32).to(device),
        m=[_tensor(a, device) for a in _gcn_leaves(m)],
        v=[_tensor(a, device) for a in _gcn_leaves(v)])


def cache_state_from_numpy(state_np, device="cuda"):
    """A cache state of numpy arrays -> the port's: ``(keys, rows, tags,
    counts)`` becomes a ``FeatureCache``, ``(l1, l2)`` of two such tuples a
    ``TieredCache``; per-worker or stacked ``[W, ...]`` alike."""
    device = resolve_device(device)
    if len(state_np) == 2:
        return TieredCache(*(cache_state_from_numpy(t, device)
                             for t in state_np))
    return FeatureCache(*(_tensor(a, device) for a in state_np))
