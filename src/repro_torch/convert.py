"""Carry GCN and LM weights (dense, Mamba-2, Zamba2 hybrid, Qwen3-MoE,
DeepSeek-V2, Llama-3.2-Vision, Whisper), optimizer state, cache state,
KV caches, SSM states, MLA latent caches and cross-attention caches from
``repro`` to the port.

Each function takes the reference's pytree as numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the caller's side — this module
never imports jax): ``gcn_params_from_numpy`` returns the port's ``GCN``
holding the same weights, ``adam_state_from_numpy`` the port's
``AdamState`` (moments in ``GCN.leaves()`` order),
``cache_state_from_numpy`` a flat ``FeatureCache`` or a ``TieredCache``,
``lm_params_from_numpy`` a ``DenseLM`` and ``lm_cache_from_numpy`` its
KV cache, ``mamba_params_from_numpy`` a ``Mamba2LM`` and
``mamba_cache_from_numpy`` its recurrent state, ``hybrid_params_from_
numpy`` a ``Zamba2LM`` and ``hybrid_cache_from_numpy`` its state and
per-site KV caches, ``moe_params_from_numpy`` a ``Qwen3MoeLM`` (its KV
cache through ``moe_cache_from_numpy``), ``deepseek_params_from_numpy`` a
``DeepSeekLM`` and ``deepseek_cache_from_numpy`` its latent cache,
``vlm_params_from_numpy`` a ``VisionLM`` and ``vlm_cache_from_numpy`` its
KV and vision caches, ``whisper_params_from_numpy`` a ``WhisperLM`` and
``whisper_cache_from_numpy`` its KV cache and encoder states, so a run of
the port can start from the reference's state mid-run.  The
reference stacks each kind of layer on a leading ``[n]`` axis; the port
holds one module per layer (and one shared block in the hybrid).

The other direction, ``gcn_params_to_numpy``, ``adam_state_to_numpy``
and ``cache_state_to_numpy``, gives the port's GCN, AdamW and cache state
back as numpy trees of the reference's structure — NamedTuples with the
reference's field names — so ``train.checkpoint`` writes them under the
reference's pytree paths.

For the LMs, ``lm_leaves`` lists a model's parameters with their
``LeafLayout``: the reference's leaves (dict paths in its flatten order,
each layer kind stacked on a leading ``[n]`` axis) over the port's
per-layer tensors.  ``flat_to_numpy`` gives any list in that order
(parameters, gradients, Adam moments) as the reference's numpy tree,
``flat_from_numpy`` reads one back, ``lm_params_to_numpy`` is the
model's, and ``train_state_to_numpy`` / ``train_state_from_numpy`` carry
a whole LM ``TrainState`` (params, ``AdamState(step, m, v)`` and the
error-feedback residual, one per reference leaf) both ways.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .core.config import ModelConfig, resolve_device
from .core.feature_cache import FeatureCache, TieredCache
from .models import layers as L
from .models import zoo
from .models.deepseek import DeepSeekLM
from .models.gcn import GCN
from .models.hybrid import Zamba2LM
from .models.moe import Qwen3MoeLM
from .models.ssm import Mamba2LM
from .models.transformer import DenseLM
from .models.vlm import VisionLM
from .models.whisper import WhisperLM
from .train.optimizer import AdamState
from .train.train_loop import TrainState


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
    """Copy the numpy weight ``a`` (as float32) into ``dst`` (its slice
    of ``a`` where ``dst`` is a rank's shard, ``layers.take``); raises if
    the shapes differ."""
    a = np.array(L.take(dst, np.asarray(a)), np.float32)   # a writable copy
    if dst.shape != a.shape:
        raise ValueError(f"weight of shape {a.shape} does not fit "
                         f"{tuple(dst.shape)} of {cfg.name!r}")
    dst.copy_(torch.from_numpy(a))


def _put_module(mod, names, tree, cfg: ModelConfig, i=None) -> None:
    """``_put`` each named leaf of ``tree`` (its row ``i`` of a stacked
    leaf when ``i`` is given) into the same-named parameter of ``mod``."""
    for name in names:
        a = tree[name] if i is None else tree[name][i]
        _put(getattr(mod, name), a, cfg)


_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("wg", "wu", "wd")
_MAMBA = ("w_in", "conv_k", "a_log", "d_skip", "dt_bias", "w_out", "ln")
_MLA = ("wdq", "wuq", "wdkv", "wkr", "wukv", "wo", "lnq", "lnkv")


def _put_embed(model, embed, cfg: ModelConfig) -> None:
    """``embed/tok``, ``embed/norm_f`` and, untied, ``embed/head``."""
    _put(model.tok, embed["tok"], cfg)
    _put(model.norm_f, embed["norm_f"], cfg)
    if model.head is not None:
        _put(model.head, embed["head"], cfg)


def _put_moe(mod, stack, cfg: ModelConfig, i: int) -> None:
    """Row ``i`` of the reference's stacked MoE leaves (``router``,
    ``wg``, ``wu``, ``wd`` and the shared experts' ``shared`` MLP)."""
    _put_module(mod, ("router",) + _MLP, stack, cfg, i)
    if mod.shared is not None:
        _put_module(mod.shared, _MLP, stack["shared"], cfg, i)


def _put_blocks(blocks, stack, cfg: ModelConfig, attns=("attn",),
                norms=("ln1", "ln2")) -> None:
    """Row ``i`` of the reference's stacked dense-block leaves (the
    attentions ``attns``, ``mlp`` and the norms ``norms``) into block
    ``i`` of ``blocks``."""
    for i, block in enumerate(blocks):
        for a in attns:
            _put_module(getattr(block, a), _ATTN, stack[a], cfg, i)
        _put_module(block.mlp, _MLP, stack["mlp"], cfg, i)
        _put_module(block, norms, stack, cfg, i)


def _bf16(a, device) -> torch.Tensor:
    """A bfloat16 cache leaf on ``device`` (bfloat16 values pass through
    float32 exactly)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device,
                                                          torch.bfloat16)


def lm_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                         ) -> DenseLM:
    """``transformer.init_lm``'s pytree of numpy arrays (``embed/tok``,
    ``embed/norm_f``, untied ``embed/head``, and ``layers/attn|mlp|ln1|
    ln2`` stacked on a leading ``[L]`` axis) -> a ``DenseLM`` for ``cfg``
    on ``device`` holding the same weights (``[d_in, d_out]`` layout in
    both packages)."""
    model = DenseLM(cfg, resolve_device(device))
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        _put_blocks(model.layers, params_np["layers"], cfg)
    return model


def lm_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``transformer.init_cache``-shaped ``{"k", "v"}`` of numpy arrays
    (``[L, B, S, Hkv Dh]``, bfloat16 or float32) -> the port's bfloat16 KV
    cache on ``device`` (bfloat16 values pass through float32 exactly)."""
    device = resolve_device(device)
    return {name: _bf16(cache_np[name], device) for name in ("k", "v")}


def mamba_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                            ) -> Mamba2LM:
    """``ssm.init_mamba2``'s pytree of numpy arrays (``embed/tok``,
    ``embed/norm_f``, ``embed/head`` and ``layers/w_in|conv_k|a_log|
    d_skip|dt_bias|w_out|ln`` stacked on a leading ``[L]`` axis) -> a
    ``Mamba2LM`` for ``cfg`` on ``device`` holding the same weights
    (``[d_in, d_out]`` layout in both packages)."""
    model = Mamba2LM(cfg, device)
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        for i, blk in enumerate(model.layers):
            _put_module(blk, _MAMBA, params_np["layers"], cfg, i)
    return model


def mamba_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``ssm.init_cache``-shaped ``{"ssm" [L, B, H, P, N] float32, "conv"
    [L, B, W - 1, C] bfloat16}`` of numpy arrays -> the port's recurrent
    state on ``device`` (bfloat16 values pass through float32 exactly)."""
    device = resolve_device(device)
    return {"ssm": torch.from_numpy(np.array(cache_np["ssm"], np.float32))
            .to(device),
            "conv": _bf16(cache_np["conv"], device)}


def hybrid_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                             ) -> Zamba2LM:
    """``hybrid.init_zamba2``'s pytree of numpy arrays (``embed``,
    ``mamba`` stacked on a leading ``[L]`` axis, and the one ``shared``
    block's ``attn``, ``mlp``, ``ln1``, ``ln2``) -> a ``Zamba2LM`` for
    ``cfg`` on ``device`` holding the same weights."""
    model = Zamba2LM(cfg, device)
    shared = params_np["shared"]
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        for i, blk in enumerate(model.layers):
            _put_module(blk, _MAMBA, params_np["mamba"], cfg, i)
        _put_module(model.shared.attn, _ATTN, shared["attn"], cfg)
        _put_module(model.shared.mlp, _MLP, shared["mlp"], cfg)
        _put_module(model.shared, ("ln1", "ln2"), shared, cfg)
    return model


def hybrid_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``hybrid.init_cache``-shaped ``{"ssm" [L, B, H, P, N] float32,
    "conv" [L, B, W - 1, C], "k"/"v" [sites, B, S, Hkv Dh]}`` of numpy
    arrays -> the port's state (conv and KV in bfloat16) on ``device``."""
    device = resolve_device(device)
    out = mamba_cache_from_numpy(cache_np, device)
    out.update({name: _bf16(cache_np[name], device) for name in ("k", "v")})
    return out


def moe_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                          ) -> Qwen3MoeLM:
    """``moe.init_qwen3_moe``'s pytree of numpy arrays (``embed``, and
    ``layers/attn|moe|ln1|ln2`` stacked on a leading ``[L]`` axis; the
    experts ``[L, E, D, F]``) -> a ``Qwen3MoeLM`` for ``cfg`` on
    ``device`` holding the same weights."""
    model = Qwen3MoeLM(cfg, device)
    stack = params_np["layers"]
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        for i, blk in enumerate(model.layers):
            _put_module(blk.attn, _ATTN, stack["attn"], cfg, i)
            _put_moe(blk.moe, stack["moe"], cfg, i)
            _put_module(blk, ("ln1", "ln2"), stack, cfg, i)
    return model


def moe_cache_from_numpy(cache_np, device="cuda") -> dict:
    """The Qwen3-MoE KV cache: the dense LM's layout
    (``lm_cache_from_numpy``)."""
    return lm_cache_from_numpy(cache_np, device)


def deepseek_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                               ) -> DeepSeekLM:
    """``deepseek.init_deepseek``'s pytree of numpy arrays (``embed``;
    ``dense/attn|mlp|ln1|ln2`` and ``layers/attn|moe|ln1|ln2`` each
    stacked on a leading axis) -> a ``DeepSeekLM`` for ``cfg`` on
    ``device`` holding the same weights."""
    model = DeepSeekLM(cfg, device)
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        for group, mods in (("dense", model.dense), ("layers", model.layers)):
            stack = params_np[group]
            for i, blk in enumerate(mods):
                _put_module(blk.attn, _MLA, stack["attn"], cfg, i)
                if blk.moe is not None:
                    _put_moe(blk.moe, stack["moe"], cfg, i)
                else:
                    _put_module(blk.mlp, _MLP, stack["mlp"], cfg, i)
                _put_module(blk, ("ln1", "ln2"), stack, cfg, i)
    return model


def deepseek_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``deepseek.init_cache``-shaped ``{"ckv_dense", "kr_dense", "ckv",
    "kr"}`` of numpy arrays -> the port's bfloat16 latent cache on
    ``device``."""
    device = resolve_device(device)
    return {name: _bf16(cache_np[name], device)
            for name in ("ckv_dense", "kr_dense", "ckv", "kr")}


def vlm_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                          ) -> VisionLM:
    """``vlm.init_vlm``'s pytree of numpy arrays (``embed``, ``vproj``,
    ``layers/attn|mlp|ln1|ln2`` stacked on ``[L]`` and ``cross/attn|ln|
    gate`` stacked on ``[sites]``; ``gate [sites, 1]``) -> a ``VisionLM``
    for ``cfg`` on ``device`` holding the same weights."""
    model = VisionLM(cfg, device)
    cross = params_np["cross"]
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        _put(model.vproj, params_np["vproj"], cfg)
        _put_blocks(model.layers, params_np["layers"], cfg)
        for i, site in enumerate(model.cross):
            _put_module(site.attn, _ATTN, cross["attn"], cfg, i)
            _put_module(site, ("ln", "gate"), cross, cfg, i)
    return model


def vlm_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``vlm.init_cache``-shaped ``{"k", "v" [L, B, S, Hkv Dh], "vis_k",
    "vis_v" [sites, B, T, Hkv Dh]}`` of numpy arrays -> the port's
    bfloat16 caches on ``device``."""
    device = resolve_device(device)
    return {name: _bf16(cache_np[name], device)
            for name in ("k", "v", "vis_k", "vis_v")}


def whisper_params_from_numpy(params_np, cfg: ModelConfig, device="cuda"
                              ) -> WhisperLM:
    """``whisper.init_whisper``'s pytree of numpy arrays (``embed``,
    ``aproj``, ``encoder/attn|mlp|ln1|ln2`` stacked on the encoder's
    layers and ``decoder/attn|xattn|mlp|ln1|lnx|ln2`` on the decoder's)
    -> a ``WhisperLM`` for ``cfg`` on ``device`` holding the same
    weights."""
    model = WhisperLM(cfg, device)
    with torch.no_grad():
        _put_embed(model, params_np["embed"], cfg)
        _put(model.aproj, params_np["aproj"], cfg)
        _put_blocks(model.encoder, params_np["encoder"], cfg)
        _put_blocks(model.decoder, params_np["decoder"], cfg,
                    attns=("attn", "xattn"), norms=("ln1", "lnx", "ln2"))
    return model


def whisper_cache_from_numpy(cache_np, device="cuda") -> dict:
    """``whisper.init_cache``-shaped ``{"k", "v" [L, B, S, Hkv Dh], "enc"
    [B, T, D]}`` of numpy arrays -> the port's bfloat16 caches on
    ``device``."""
    device = resolve_device(device)
    return {name: _bf16(cache_np[name], device)
            for name in ("k", "v", "enc")}


def params_from_numpy(params_np, cfg: ModelConfig, device="cuda"):
    """The reference's params of any LM family (numpy) -> the port's model
    of ``cfg`` on ``device``.  Under an installed model axis
    (``zoo.settings``) the model is this rank's shard, each split weight
    holding its slice of the reference's array."""
    fn = {"dense": lm_params_from_numpy, "moe_qwen": moe_params_from_numpy,
          "moe_deepseek": deepseek_params_from_numpy,
          "vlm": vlm_params_from_numpy, "audio": whisper_params_from_numpy,
          "ssm": mamba_params_from_numpy,
          "hybrid": hybrid_params_from_numpy}[zoo._family_key(cfg)]
    return fn(params_np, cfg, device)


def cache_slice(cache: dict, model) -> dict:
    """A whole cache (numpy or torch leaves) as ``model``'s rank holds
    it: the KV leaves (``k``, ``v``, ``vis_k``, ``vis_v``) cut to the
    rank's kv heads on their trailing ``Hkv Dh`` axis where the model's
    attention splits them (the reference's ``cache_pspec``); every other
    leaf (SSM state, MLA latents, Whisper's ``enc``) whole."""
    split = next((m.split for m in model.modules()
                  if isinstance(getattr(m, "split", None), L.HeadSplit)
                  and hasattr(m, "wk")), None)
    if split is None or split.kv_whole:
        return dict(cache)
    hd = model.cfg.resolved_head_dim
    lo, hi = split.kv0 * hd, (split.kv0 + split.nkv) * hd
    return {name: a[..., lo:hi] if name in ("k", "v", "vis_k", "vis_v")
            else a for name, a in cache.items()}


class LeafLayout(NamedTuple):
    """The reference's pytree leaves of an LM over the port's tensors.

    ``names`` are the model's parameter names in the port's flat order
    (the order of ``lm_leaves``' tensors, the optimizer's moments and the
    gradients); leaf ``j`` has the dict path ``paths[j]`` (sorted, the
    order ``jax.tree`` flattens the reference's dicts in) and covers the
    next ``counts[j]`` tensors of the flat order, stacked on a new
    leading axis when ``stacked[j]`` (one per layer) or the one tensor
    itself (the embedding, the final norm, the hybrid's shared block).
    ``shapes[j]`` is the shape of each of leaf ``j``'s tensors as this
    process holds them, and ``shards[j]`` their ``layers.Shard`` on a
    model axis (None: whole)."""
    names: Tuple[str, ...]
    paths: Tuple[Tuple[str, ...], ...]
    counts: Tuple[int, ...]
    stacked: Tuple[bool, ...]
    shapes: Tuple[Tuple[int, ...], ...] = ()
    shards: Tuple = ()

    def parts(self, flat: Sequence) -> Iterator[Tuple[Tuple[str, ...],
                                                      list, bool]]:
        """``(path, its tensors, stacked)`` for each leaf of ``flat``."""
        if len(flat) != len(self.names):
            raise ValueError(f"{len(flat)} tensors for a layout of "
                             f"{len(self.names)}")
        i = 0
        for path, n, st in zip(self.paths, self.counts, self.stacked):
            yield path, list(flat[i:i + n]), st
            i += n

    def group(self, flat: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The flat tensors as the reference's leaves (stacked copies
        where a leaf covers layers)."""
        return [torch.stack(ts) if st else ts[0]
                for _, ts, st in self.parts(flat)]

    def split(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The reference's leaves back in the flat order (views of
        them)."""
        out = []
        for leaf, st in zip(leaves, self.stacked):
            out.extend(leaf.unbind(0) if st else [leaf])
        return out


def _stacks(model):
    """``({reference key: ModuleList attribute}, {reference key: shared
    module attribute}, (top-level parameters outside ``embed``))`` of
    ``model``'s family."""
    if isinstance(model, Zamba2LM):
        return {"mamba": "layers"}, {"shared": "shared"}, ()
    if isinstance(model, DeepSeekLM):
        return {"dense": "dense", "layers": "layers"}, {}, ()
    if isinstance(model, VisionLM):
        return {"layers": "layers", "cross": "cross"}, {}, ("vproj",)
    if isinstance(model, WhisperLM):
        return ({"encoder": "encoder", "decoder": "decoder"}, {},
                ("aproj",))
    if isinstance(model, (DenseLM, Mamba2LM, Qwen3MoeLM)):
        return {"layers": "layers"}, {}, ()
    raise TypeError(f"lm_leaves takes an LM of the port, got "
                    f"{type(model).__name__}")


def lm_leaves(model) -> Tuple[List[torch.Tensor], LeafLayout]:
    """The parameters of an LM of the port (dense, SSM, hybrid, Qwen3-MoE,
    DeepSeek, VLM, Whisper) in the flat order of its ``LeafLayout``, and
    the layout.  The reference's keys are the port's attribute names:
    ``embed/tok``, ``embed/norm_f``, ``embed/head`` (untied), the VLM's
    ``vproj`` and Whisper's ``aproj``, then per layer kind the block's own
    parameter names (``layers/attn/wq``, ``layers/moe/shared/wg``,
    ``mamba/w_in``, ``shared/ln1``, ``cross/gate``, ``decoder/xattn/wk``
    ...)."""
    stacks, singles, tops = _stacks(model)
    entries = [(("embed", n), [(n, getattr(model, n))], False)
               for n in ("tok", "norm_f", "head")
               if getattr(model, n, None) is not None]
    entries += [((n,), [(n, getattr(model, n))], False) for n in tops]
    for key, attr in stacks.items():
        blocks = list(getattr(model, attr))
        if not blocks:
            continue
        for name, _ in blocks[0].named_parameters():
            entries.append(((key,) + tuple(name.split(".")),
                            [(f"{attr}.{i}.{name}", b.get_parameter(name))
                             for i, b in enumerate(blocks)], True))
    for key, attr in singles.items():
        for name, p in getattr(model, attr).named_parameters():
            entries.append(((key,) + tuple(name.split(".")),
                            [(f"{attr}.{name}", p)], False))
    entries.sort(key=lambda e: e[0])
    named = [nt for _, nts, _ in entries for nt in nts]
    firsts = [e[1][0][1] for e in entries]
    layout = LeafLayout(names=tuple(n for n, _ in named),
                        paths=tuple(e[0] for e in entries),
                        counts=tuple(len(e[1]) for e in entries),
                        stacked=tuple(e[2] for e in entries),
                        shapes=tuple(tuple(t.shape) for t in firsts),
                        shards=tuple(getattr(t, "shard", None)
                                     for t in firsts))
    return [t for _, t in named], layout


def _nest(pairs) -> dict:
    """``(path, value)`` pairs as nested dicts."""
    tree: dict = {}
    for path, value in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def _leaf(tree: dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def flat_to_numpy(flat: Sequence[torch.Tensor], layout: LeafLayout) -> dict:
    """Tensors in ``layout``'s flat order (parameters, gradients, Adam
    moments) as the reference's numpy tree: nested dicts, each layer kind
    stacked on its leading axis.  One leaf at a time reaches the host."""
    return _nest((path, _numpy(torch.stack(ts) if st else ts[0]))
                 for path, ts, st in layout.parts(flat))


def leaves_to_numpy(leaves: Sequence[torch.Tensor],
                    layout: LeafLayout) -> dict:
    """Tensors already grouped as the reference's leaves (``layout.
    group``; the error-feedback residual) as its numpy tree."""
    return _nest((path, _numpy(t)) for path, t in zip(layout.paths, leaves))


def flat_from_numpy(tree: dict, layout: LeafLayout, device="cuda"
                    ) -> List[torch.Tensor]:
    """The reference's numpy tree of an LM (parameters, gradients or
    moments) as tensors on ``device`` in ``layout``'s flat order."""
    device = resolve_device(device)
    out = []
    for path, n, st in zip(layout.paths, layout.counts, layout.stacked):
        a = np.asarray(_leaf(tree, path))
        if st and a.shape[0] != n:
            raise ValueError(f"leaf {'/'.join(path)} stacks {a.shape[0]} "
                             f"layers, the model {n}")
        out.extend(_tensor(r, device) for r in (a if st else [a]))
    return out


def leaves_from_numpy(tree: dict, layout: LeafLayout, device="cuda"
                      ) -> List[torch.Tensor]:
    """The reference's numpy tree as tensors, one per reference leaf."""
    device = resolve_device(device)
    return [_tensor(_leaf(tree, path), device) for path in layout.paths]


def lm_params_to_numpy(model) -> dict:
    """An LM's weights as the reference's numpy params tree (the inverse of
    the ``*_params_from_numpy`` converters)."""
    return flat_to_numpy(*lm_leaves(model))


def train_state_to_numpy(state: TrainState, layout: LeafLayout,
                         mesh=None) -> TrainState:
    """An LM ``TrainState`` of the port as the reference's, with numpy
    leaves: ``params``, ``opt = AdamState(step int32, m, v)`` and
    ``error`` (one residual per reference leaf, or None).  With ``mesh``
    (a ``train.fsdp.ShardPlan``) ``state`` holds the rank's slices and
    every leaf is gathered whole over both axes (every rank must call
    this)."""
    opt = state.opt
    if mesh is not None:
        def tree(slices):
            return _nest((path, _numpy(t)) for path, t in
                         zip(layout.paths, mesh.whole(slices)))
        return TrainState(
            params=tree(state.params),
            opt=AdamState(step=np.asarray(_numpy(opt.step), np.int32),
                          m=tree(opt.m), v=tree(opt.v)),
            error=None if state.error is None else tree(state.error))
    return TrainState(
        params=flat_to_numpy(state.params, layout),
        opt=AdamState(step=np.asarray(_numpy(opt.step), np.int32),
                      m=flat_to_numpy(opt.m, layout),
                      v=flat_to_numpy(opt.v, layout)),
        error=(None if state.error is None
               else leaves_to_numpy(state.error, layout)))


def train_state_from_numpy(tree: TrainState, layout: LeafLayout,
                           device="cuda", mesh=None) -> TrainState:
    """The reference's LM ``TrainState`` of numpy arrays as the port's on
    ``device`` (the inverse of ``train_state_to_numpy``); with ``mesh``
    (a ``train.fsdp.ShardPlan``) each leaf's slice on the rank
    (``ShardPlan.take``: the model rank's slice, then the data rank's)."""
    device = resolve_device(device)
    params, (step, m, v), error = tree
    if mesh is not None:
        def slices(t):
            return [_tensor(np.ascontiguousarray(
                mesh.take(lf, np.asarray(_leaf(t, lf.path)))), device)
                for lf in mesh.leaves]
        return TrainState(
            params=slices(params),
            opt=AdamState(step=torch.tensor(np.asarray(step),
                                            dtype=torch.int32).to(device),
                          m=slices(m), v=slices(v)),
            error=None if error is None else slices(error))
    return TrainState(
        params=flat_from_numpy(params, layout, device),
        opt=AdamState(step=torch.tensor(np.asarray(step),
                                        dtype=torch.int32).to(device),
                      m=flat_from_numpy(m, layout, device),
                      v=flat_from_numpy(v, layout, device)),
        error=(None if error is None
               else leaves_from_numpy(error, layout, device)))
