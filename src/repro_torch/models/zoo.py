"""Model zoo of the port (``repro/models/zoo.py``'s ``build`` and
``forward_logits``) for every family of the reference: the paper's GCN,
the dense LM, the mixture-of-experts LMs (Qwen3-MoE; DeepSeek-V2 with
MLA, told apart by ``kv_lora_rank``), the Llama-3.2-Vision VLM, Whisper,
the Mamba-2 SSM LM and the Zamba2 hybrid.

``settings(group, ...)`` installs a model-axis ``group`` (one
``ProcessWorkers`` rank per process, ``layers.set_mesh``) and the
reference's four switches for the block: every model that ``build``'s
``init`` makes inside it is this rank's shard (the heads under
``shard_heads``, the experts where M divides them), drawn tensor by
tensor as the single process draws them, and its forward and decode run
the model axis's collectives.

``param_pspec``, ``param_pspecs``, ``cache_pspecs`` and ``batch_pspecs``
are the reference's sharding rules over a ``(data, model)`` mesh, as
plain tuples (one axis name, a tuple of names, or None per dimension):
experts over ``model`` and their input over ``data``, a matrix's output
over ``model`` and its input over ``data`` (FSDP), vectors replicated,
each only where the axis divides the dimension; a batch over the data
axes; a cache's batch over the data axes, else its sequence over
``data``, and its feature axis over ``model``.  ``train/fsdp.py``
stores each leaf's ``data`` dimension sliced.  ``input_specs`` and
``prefill_specs`` are the dry-run's inputs of a workload shape (the
reference's ``ShapeDtypeStruct`` trees) as ``{name: (shape, dtype)}``."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.config import ModelConfig, ShapeConfig, resolve_device
from . import deepseek, gcn, hybrid, moe, ssm, transformer, vlm, whisper
from . import layers as L

#: the LM families
LM_FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
#: family key -> (module, name of its seeded initialiser)
_INITS = {"dense": (transformer, "init_dense_lm"),
          "moe_qwen": (moe, "init_qwen3_moe"),
          "moe_deepseek": (deepseek, "init_deepseek"),
          "vlm": (vlm, "init_vlm"),
          "audio": (whisper, "init_whisper"),
          "ssm": (ssm, "init_mamba2"),
          "hybrid": (hybrid, "init_zamba2")}


def _family_key(cfg: ModelConfig) -> str:
    """``cfg.family``, with ``moe`` split into ``moe_deepseek`` (MLA:
    ``kv_lora_rank`` set) and ``moe_qwen``."""
    if cfg.family == "moe":
        return "moe_deepseek" if cfg.kv_lora_rank else "moe_qwen"
    return cfg.family


def _lm_init(cfg: ModelConfig) -> Callable:
    """The seeded initialiser ``(cfg, seed, device) -> model`` of ``cfg``'s
    LM family, looked up when the model is made."""
    module, name = _INITS[_family_key(cfg)]
    return getattr(module, name)


class ModelAPI(NamedTuple):
    """Uniform entry points of one config: ``init(seed) -> model``,
    ``loss(model, batch)``, and for LMs ``decode(model, cache, tokens,
    pos) -> (logits, cache)`` and ``init_cache(model, batch, seq)``."""
    cfg: ModelConfig
    init: Callable[[int], Any]
    loss: Callable[[Any, Any], torch.Tensor]
    decode: Optional[Callable]
    init_cache: Optional[Callable]


@contextlib.contextmanager
def settings(group=None, *, moe_impl: str = "gather",
             shard_heads: bool = False, seq_parallel: bool = False,
             attn_impl: str = "naive", data=None):
    """The model axis ``group`` (None: one process) and the reference's
    switches (``moe.set_moe_impl``, ``layers.set_shard_heads``,
    ``set_seq_parallel``, ``set_attn_impl``) inside the block, restored on
    exit; ``data``, the data axis of a training mesh whose ranks each run
    a slice of the batch (``layers.set_data_axis``).  Build and run a
    model inside the same settings."""
    saved = (L.get_mesh(), moe.MOE_IMPL, L.SHARD_HEADS, L.SEQ_PARALLEL,
             L.ATTN_IMPL, L.get_data_axis())
    setters = (L.set_mesh, moe.set_moe_impl, L.set_shard_heads,
               L.set_seq_parallel, L.set_attn_impl, L.set_data_axis)
    try:
        for fn, value in zip(setters, (group, moe_impl, shard_heads,
                                       seq_parallel, attn_impl, data)):
            fn(value)
        yield
    finally:
        for fn, value in zip(setters, saved):
            fn(value)


def build(cfg: ModelConfig, device="cuda") -> ModelAPI:
    """The ``ModelAPI`` of ``cfg`` with models made on ``device``; inside
    ``settings(group)`` each model is this rank's shard (module
    docstring)."""
    device = resolve_device(device)
    if cfg.family == "gcn":
        return ModelAPI(cfg=cfg,
                        init=lambda seed: gcn.init_gcn(cfg, seed, device),
                        loss=gcn.gcn_loss, decode=None, init_cache=None)
    if cfg.family in LM_FAMILIES:
        return ModelAPI(
            cfg=cfg,
            init=lambda seed: _lm_init(cfg)(cfg, seed, device),
            loss=lambda m, batch: m.loss(batch),
            decode=lambda m, cache, tokens, pos: m.forward_decode(
                cache, tokens, pos),
            init_cache=lambda m, batch, seq: m.init_cache(batch, seq))
    raise ValueError(f"unknown family {cfg.family!r} of {cfg.name!r}")


def forward_logits(cfg: ModelConfig, model, batch: dict) -> torch.Tensor:
    """Full-sequence forward (prefill) without an autograd graph: float32
    logits ``[B, S, V_pad]`` of ``batch["tokens"]``, with
    ``batch["vision"]`` for the VLM and ``batch["frames"]`` for Whisper
    (as the reference's ``forward_logits``).  ``cfg`` must be the model's
    own config (the model reads its own, flash switch included).  The SSM
    family runs ``ops.ssd_scan`` in every layer, the hybrid in every Mamba
    layer and, with flash on, ``ops.flash_attention`` at every site of
    its shared block; with flash on the dense, Qwen3-MoE and VLM families
    run it in every self-attention layer and Whisper in every decoder
    layer (DeepSeek's MLA, the cross-attention and Whisper's encoder take
    the plain path)."""
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"forward_logits takes an LM config, got family "
                         f"{cfg.family!r}")
    if cfg != model.cfg:
        raise ValueError(f"forward_logits got a config other than the "
                         f"model's own: {cfg} vs {model.cfg}")
    with torch.no_grad():
        if cfg.family == "vlm":
            return model.forward_train(batch["tokens"], batch["vision"])
        if cfg.family == "audio":
            return model.forward_train(batch["tokens"], batch["frames"])
        return model.forward_train(batch["tokens"])


# ------------------------------------------------------------ input specs --
def _stub_specs(cfg: ModelConfig, b: int) -> dict:
    """The VLM's ``vision`` or Whisper's ``frames`` stub of a batch of
    ``b`` (float32), or nothing."""
    if cfg.family == "vlm":
        return {"vision": ((b, cfg.n_vision_tokens, cfg.d_vision),
                           torch.float32)}
    if cfg.family == "audio":
        return {"frames": ((b, cfg.n_audio_frames, cfg.d_audio),
                           torch.float32)}
    return {}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Every model input of ``shape`` as ``{name: (shape, dtype)}``: a
    train shape's int32 ``tokens`` and ``labels [B, S]`` (with the
    stub's embeddings), a decode shape's one new token ``tokens [B, 1]``
    against a ``seq_len`` cache."""
    b = shape.global_batch
    if shape.kind == "train":
        return {"tokens": ((b, shape.seq_len), torch.int32),
                "labels": ((b, shape.seq_len), torch.int32),
                **_stub_specs(cfg, b)}
    return {"tokens": ((b, 1), torch.int32)}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A prefill's inputs (the full-sequence forward, no labels):
    ``tokens [B, S]`` int32 with the stub's embeddings."""
    b = shape.global_batch
    return {"tokens": ((b, shape.seq_len), torch.int32),
            **_stub_specs(cfg, b)}


# ---------------------------------------------------------- the mesh rules --
def _axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of ``mesh`` (a ``launch.mesh.Mesh`` or a
    ``{name: size}`` dict); 1 where it has no such axis."""
    return getattr(mesh, "shape", mesh).get(name, 1)


def _dp_names(mesh):
    shape = getattr(mesh, "shape", mesh)
    return ("pod", "data") if "pod" in shape else ("data",)


def _dp_size(mesh) -> int:
    n = 1
    for a in _dp_names(mesh):
        n *= _axis_size(mesh, a)
    return n


def param_pspec(path: str, shape, mesh, fsdp: bool = True) -> tuple:
    """The reference's sharding rule for one parameter leaf (``path`` its
    keys joined by ``/``, ``shape`` the whole, layer-stacked leaf's):
    expert stacks ``[L?, E, D, F]`` (``wg``/``wu``/``wd`` under ``moe``,
    3-D or more) put ``E`` over ``model`` and, with ``fsdp``, ``D`` over
    ``data``; other matrices ``[..., in, out]`` put ``out`` over
    ``model`` and ``in`` over ``data``; vectors stay replicated; an axis
    only where it divides the dimension."""
    m, d = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    dims = [None] * len(shape)
    if len(shape) < 2:
        return tuple(dims)
    is_expert = (any(k in path for k in ("wg", "wu", "wd"))
                 and "moe" in path and len(shape) >= 3)
    if is_expert and shape[-3] % m == 0:
        dims[-3] = "model"
        if fsdp and shape[-2] % d == 0:
            dims[-2] = "data"
        return tuple(dims)
    if shape[-1] % m == 0:
        dims[-1] = "model"
    if fsdp and shape[-2] % d == 0:
        dims[-2] = "data"
    return tuple(dims)


def param_pspecs(cfg: ModelConfig, shapes: dict, mesh) -> dict:
    """``param_pspec`` of every leaf: ``shapes`` maps each reference leaf's
    path (a tuple of keys, ``convert.LeafLayout.paths``) to its whole
    shape; ``cfg.fsdp_params`` decides the ``data`` dimensions."""
    return {path: param_pspec("/".join(path), tuple(shape), mesh,
                              fsdp=cfg.fsdp_params)
            for path, shape in shapes.items()}


def _dp_spec(mesh):
    """The data axes as a ``PartitionSpec`` holds them: one as its name,
    two as a tuple."""
    names = _dp_names(mesh)
    return names[0] if len(names) == 1 else names


def cache_pspec(shape, mesh, batch_axis: int) -> tuple:
    """The reference's rule for one cache leaf: the feature (last) axis
    over ``model`` where it divides; the batch axis over the data axes
    where they divide it and it is more than 1, else (``long_500k``'s
    batch of 1) the sequence axis after it over ``data`` where that
    divides it."""
    m, dp = _axis_size(mesh, "model"), _dp_size(mesh)
    dims = [None] * len(shape)
    if shape[-1] % m == 0:
        dims[-1] = "model"
    if (batch_axis < len(shape) and shape[batch_axis] % dp == 0
            and shape[batch_axis] > 1):
        dims[batch_axis] = _dp_spec(mesh)
    elif len(shape) >= 3:
        seq, d = batch_axis + 1, _axis_size(mesh, "data")
        if dims[seq] is None and shape[seq] % d == 0 and shape[seq] >= d:
            dims[seq] = "data"
    return tuple(dims)


def cache_pspecs(cfg: ModelConfig, shapes: dict, mesh) -> dict:
    """``cache_pspec`` of every leaf of a cache (``{name: shape}``, the
    reference's layout: ``[L, B, ...]``, Whisper's ``enc [B, T, D]``)."""
    return {name: cache_pspec(tuple(shape), mesh, 0 if name == "enc" else 1)
            for name, shape in shapes.items()}


def batch_pspecs(cfg: ModelConfig, shapes: dict, mesh) -> dict:
    """Each batch input (``{name: shape}``) split over the data axes on
    its leading (batch) dimension, unless that is 1 or the axes do not
    divide it (then replicated)."""
    dp, axes = _dp_size(mesh), _dp_spec(mesh)

    def one(shape):
        dims = [None] * len(shape)
        if shape[0] % dp == 0 and shape[0] > 1:
            dims[0] = axes
        return tuple(dims)
    return {name: one(tuple(shape)) for name, shape in shapes.items()}
