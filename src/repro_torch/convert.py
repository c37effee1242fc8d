"""Carry GCN, dense-LM and Mamba-2 weights, optimizer state, cache state,
KV caches and SSM states from ``repro`` to the port.

Each function takes the reference's pytree as numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the caller's side — this module
never imports jax): ``gcn_params_from_numpy`` returns the port's ``GCN``
holding the same weights, ``adam_state_from_numpy`` the port's
``AdamState`` (moments in ``GCN.leaves()`` order),
``cache_state_from_numpy`` a flat ``FeatureCache`` or a ``TieredCache``,
``lm_params_from_numpy`` a ``DenseLM`` and ``lm_cache_from_numpy`` its
KV cache, ``mamba_params_from_numpy`` a ``Mamba2LM`` and
``mamba_cache_from_numpy`` its recurrent state, so a run of the port can
start from the reference's state mid-run.

The other direction, ``gcn_params_to_numpy``, ``adam_state_to_numpy``
and ``cache_state_to_numpy``, gives the port's GCN, AdamW and cache state
back as numpy trees of the reference's structure — NamedTuples with the
reference's field names — so ``train.checkpoint`` writes them under the
reference's pytree paths.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .core.config import ModelConfig, resolve_device
from .core.feature_cache import FeatureCache, TieredCache
from .models.gcn import GCN
from .models.ssm import Mamba2LM
from .models.transformer import DenseLM
from .train.optimizer import AdamState


class GCNLayerParams(NamedTuple):
    """One layer's weights in the reference's pytree form."""
    w_self: np.ndarray
    w_nbr: np.ndarray
    b: np.ndarray


class GCNParams(NamedTuple):
    """The reference's ``GCNParams`` as numpy: layers, then the read-out."""
    layers: Tuple[GCNLayerParams, ...]
    w_out: np.ndarray
    b_out: np.ndarray


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _gcn_tree(leaves) -> GCNParams:
    """Leaves in ``GCN.leaves()`` order -> a ``GCNParams`` tree."""
    depth = (len(leaves) - 2) // 3
    return GCNParams(
        layers=tuple(GCNLayerParams(*leaves[3 * i:3 * i + 3])
                     for i in range(depth)),
        w_out=leaves[-2], b_out=leaves[-1])


def gcn_params_to_numpy(model: GCN) -> GCNParams:
    """A ``GCN``'s weights as the reference's ``GCNParams`` of numpy
    arrays (the inverse of ``gcn_params_from_numpy``)."""
    return _gcn_tree([_numpy(p) for p in model.leaves()])


def adam_state_to_numpy(state: AdamState) -> AdamState:
    """The port's ``AdamState`` as the reference's: ``step`` an int32
    scalar and ``m``/``v`` ``GCNParams`` trees of numpy arrays (the
    inverse of ``adam_state_from_numpy``)."""
    return AdamState(step=np.asarray(_numpy(state.step), np.int32),
                     m=_gcn_tree([_numpy(a) for a in state.m]),
                     v=_gcn_tree([_numpy(a) for a in state.v]))


def cache_state_to_numpy(state):
    """A ``FeatureCache`` or ``TieredCache`` (per-worker or stacked) with
    numpy leaves, same NamedTuple types (the inverse of
    ``cache_state_from_numpy``)."""
    if isinstance(state, TieredCache):
        return TieredCache(*(cache_state_to_numpy(t) for t in state))
    return FeatureCache(*(_numpy(a) for a in state))


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


def _put(dst: torch.Tensor, a, cfg: ModelConfig) -> None:
    """Copy the numpy weight ``a`` (as float32) into ``dst``; raises if
    the shapes differ."""
    a = np.array(a, np.float32)       # a writable copy
    if dst.shape != a.shape:
        raise ValueError(f"weight of shape {a.shape} does not fit "
                         f"{tuple(dst.shape)} of {cfg.name!r}")
    dst.copy_(torch.from_numpy(a))


def lm_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                         ) -> DenseLM:
    """``transformer.init_lm``'s pytree of numpy arrays (``embed/tok``,
    ``embed/norm_f``, and ``layers/attn|mlp|ln1|ln2`` stacked on a leading
    ``[L]`` axis) -> a ``DenseLM`` for ``cfg`` on ``device`` holding the
    same weights (``[d_in, d_out]`` layout in both packages)."""
    device = resolve_device(device)
    model = DenseLM(cfg)
    stack = params_np["layers"]
    with torch.no_grad():
        _put(model.tok, params_np["embed"]["tok"], cfg)
        _put(model.norm_f, params_np["embed"]["norm_f"], cfg)
        for i, block in enumerate(model.layers):
            for name in ("wq", "wk", "wv", "wo"):
                _put(getattr(block.attn, name), stack["attn"][name][i], cfg)
            for name in ("wg", "wu", "wd"):
                _put(getattr(block.mlp, name), stack["mlp"][name][i], cfg)
            _put(block.ln1, stack["ln1"][i], cfg)
            _put(block.ln2, stack["ln2"][i], cfg)
    return model.to(device)


def lm_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``transformer.init_cache``-shaped ``{"k", "v"}`` of numpy arrays
    (``[L, B, S, Hkv Dh]``, bfloat16 or float32) -> the port's bfloat16 KV
    cache on ``device`` (bfloat16 values pass through float32 exactly)."""
    device = resolve_device(device)
    return {name: torch.from_numpy(np.asarray(cache_np[name], np.float32))
            .to(device, torch.bfloat16) for name in ("k", "v")}


def mamba_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                            ) -> Mamba2LM:
    """``ssm.init_mamba2``'s pytree of numpy arrays (``embed/tok``,
    ``embed/norm_f``, ``embed/head`` and ``layers/w_in|conv_k|a_log|
    d_skip|dt_bias|w_out|ln`` stacked on a leading ``[L]`` axis) -> a
    ``Mamba2LM`` for ``cfg`` on ``device`` holding the same weights
    (``[d_in, d_out]`` layout in both packages)."""
    model = Mamba2LM(cfg, device)
    embed, stack = params_np["embed"], params_np["layers"]
    with torch.no_grad():
        _put(model.tok, embed["tok"], cfg)
        _put(model.norm_f, embed["norm_f"], cfg)
        if model.head is not None:
            _put(model.head, embed["head"], cfg)
        for i, blk in enumerate(model.layers):
            for name in ("w_in", "conv_k", "a_log", "d_skip", "dt_bias",
                         "w_out", "ln"):
                _put(getattr(blk, name), stack[name][i], cfg)
    return model


def mamba_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``ssm.init_cache``-shaped ``{"ssm" [L, B, H, P, N] float32, "conv"
    [L, B, W - 1, C] bfloat16}`` of numpy arrays -> the port's recurrent
    state on ``device`` (bfloat16 values pass through float32 exactly)."""
    device = resolve_device(device)
    return {"ssm": torch.from_numpy(np.array(cache_np["ssm"], np.float32))
            .to(device),
            "conv": torch.from_numpy(np.asarray(cache_np["conv"], np.float32))
            .to(device, torch.bfloat16)}
