"""Carry GCN weights from ``repro`` to the port.

``gcn_params_from_numpy`` takes the reference's ``GCNParams`` pytree as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side —
this module never imports jax) and returns the port's ``GCN`` holding
the same weights, so both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import resolve_device
from .models.gcn import GCN


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
