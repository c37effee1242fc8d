"""Checkpoints in the reference's on-disk layout (port of
``repro/train/checkpoint.py``).

``<dir>/step_<10 digits>/arrays.npz`` holds one array per leaf under
its pytree path (``"/"``-joined: a NamedTuple field as ``.name``, a
tuple index as its number, a dict key as itself), and ``meta.json`` the
step, the sorted keys, the bfloat16 leaves (stored as a ``uint16`` view
and tagged ``"bfloat16"``) and the caller's ``extra``.  A commit writes
``tmp.<step>`` and renames it, so a torn write is never taken for a
checkpoint; only the newest ``keep`` are retained.

Trees are nested dicts, tuples and NamedTuples whose leaves are numpy
arrays or torch tensors; a None holds no leaf (as in ``jax.tree``: the
reference's ``TrainState.error`` unless compressing).  The port's GCN,
AdamW and cache states go through ``convert``'s ``*_to_numpy`` /
``*_from_numpy`` functions, which give them the reference's structure —
so a checkpoint written by either package restores in the other.  An LM
``TrainState`` (``save_lm_state``, ``restore_lm_state``) goes through
``convert.train_state_to_numpy`` and its layout: stacked layers under the
reference's dict keys.  Reading needs numpy alone.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..convert import (LeafLayout, _nest, gcn_params_from_numpy,
                       gcn_params_to_numpy, train_state_from_numpy,
                       train_state_to_numpy)
from .optimizer import AdamState
from .train_loop import TrainState


def _items(tree, prefix=()):
    """``(path, leaf)`` pairs of ``tree`` in the reference's flatten order
    (dict keys sorted, as jax flattens them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf):
    """A leaf as numpy, bfloat16 as its ``uint16`` bits: ``(array,
    is_bf16)``."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), True
        return leaf.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomically commit ``tree`` as ``<ckpt_dir>/step_<step>`` (npz +
    meta.json), keeping only the newest ``keep`` checkpoints; ``extra``
    is recorded verbatim.  Returns the committed path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, ext = {}, {}
    for key, leaf in _items(tree):
        arrays[key], bf16 = _to_numpy(leaf)
        if bf16:
            ext[key] = "bfloat16"
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": int(step), "keys": sorted(arrays), "ext_dtypes": ext,
            "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # the atomic commit
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step under ``ckpt_dir`` (None when there is none;
    a leftover ``tmp.<step>`` never counts)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _like_leaf(arr: np.ndarray, bf16: bool, like):
    """``arr`` as ``like``'s type, dtype and (for a tensor) device."""
    if isinstance(like, torch.Tensor):
        if bf16 or like.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} "
                             f"does not fit {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    like_dtype = np.asarray(like).dtype
    return arr.view(like_dtype) if bf16 else arr.astype(like_dtype)


def _rebuild(like, leaf_fn, prefix=()):
    """``like`` with every leaf replaced by ``leaf_fn(path, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaf_fn, prefix + (str(k),))
                for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaf_fn, prefix + (f".{n}",))
                            for n, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaf_fn, prefix + (str(i),))
                          for i, v in enumerate(like))
    return None if like is None else leaf_fn("/".join(prefix), like)


def restore(ckpt_dir: str, step: int, like: Any, select=None) -> Any:
    """The tree saved at ``step``, in the structure of ``like``: each leaf
    takes the saved array under its path (or ``select(path, array)`` of
    it, when given), in ``like``'s leaf type, dtype and device."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    ext = meta.get("ext_dtypes", {})
    missing = [k for k, _ in _items(like) if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing[:4]}")
    if select is not None:
        arrays = {k: select(k, a) for k, a in arrays.items()}
    return _rebuild(like, lambda key, leaf: _like_leaf(arrays[key],
                                                      key in ext, leaf))


def save_serving_state(ckpt_dir: str, step: int, model, cache, *,
                       keep: int = 3, cache_cfg=None) -> str:
    """Checkpoint the serving bundle: a ``GCN``'s params and the warm
    cache state, under the reference's ``{"params", "cache"}`` paths.
    ``cache_cfg`` (a ``CacheConfig``) is recorded so that
    :func:`restore_serving_state` can refuse a mismatched layout."""
    extra = {"kind": "serving"}
    if cache_cfg is not None:
        extra["cache_cfg"] = dict(cache_cfg._asdict())
    return save(ckpt_dir, step, {"params": gcn_params_to_numpy(model),
                                 "cache": cache}, keep=keep, extra=extra)


def restore_serving_state(ckpt_dir: str, model_like, cache_like, *,
                          step: Optional[int] = None,
                          expect_cache_cfg=None, group=None) -> tuple:
    """``(model, cache)`` saved by :func:`save_serving_state` (by either
    package).  ``model_like`` (a ``GCN``) gives the shapes and the device
    of the returned ``GCN``, ``cache_like`` (an empty cache state) the
    structure, dtypes and device of the cache; ``step=None`` takes the
    latest.  The file holds every worker's cache (``[W, ...]``); with a
    worker ``group`` the cache returned is the held workers' block
    (``group.block``: a process's own shard).  With ``expect_cache_cfg`` a state whose recorded ``n_rows``,
    ``assoc``, ``mode`` or ``l1_rows`` differ raises ``ValueError``: the
    state only probes correctly under the layout it was warmed with."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no serving checkpoint under {ckpt_dir!r}")
    if expect_cache_cfg is not None:
        meta_path = os.path.join(ckpt_dir, f"step_{step:010d}", "meta.json")
        with open(meta_path) as f:
            saved = json.load(f).get("extra", {}).get("cache_cfg")
        if saved is not None:
            now = dict(expect_cache_cfg._asdict())
            # the serve view flips frozen/store without changing the layout
            diff = {k: (saved.get(k), now.get(k))
                    for k in ("n_rows", "assoc", "mode", "l1_rows")
                    if saved.get(k) != now.get(k)}
            if diff:
                raise ValueError(
                    f"serving checkpoint cache layout mismatch: {diff} "
                    f"(saved vs serving CacheConfig) — the cache state "
                    f"only probes correctly under the layout it was "
                    f"warmed with")
    def select(key, arr):
        if group is None or not key.startswith("cache/"):
            return arr
        if arr.shape[0] != group.world:
            raise ValueError(f"serving checkpoint leaf {key} holds "
                             f"{arr.shape[0]} workers' state, the group "
                             f"{group.world}")
        return group.block(arr)
    tree = restore(ckpt_dir, step, {"params": gcn_params_to_numpy(model_like),
                                    "cache": cache_like}, select=select)
    device = model_like.w_out.device
    return gcn_params_from_numpy(tree["params"], device=device), tree["cache"]


def _lm_like(state: TrainState, layout: LeafLayout) -> TrainState:
    """The reference's ``TrainState`` structure of ``state``, its leaves
    float32 (int32 step) arrays of the stacked shapes, never written."""
    def like(flat):
        return _nest((path, np.empty(((len(ts),) if st else ())
                                     + tuple(ts[0].shape), np.float32))
                     for path, ts, st in layout.parts(flat))
    err = None
    if state.error is not None:
        err = _nest((p, np.empty(tuple(e.shape), np.float32))
                    for p, e in zip(layout.paths, state.error))
    return TrainState(params=like(state.params),
                      opt=AdamState(step=np.zeros((), np.int32),
                                    m=like(state.opt.m), v=like(state.opt.v)),
                      error=err)


def save_lm_state(ckpt_dir: str, step: int, state: TrainState,
                  layout: LeafLayout, mesh=None, *, keep: int = 3) -> str:
    """Commit an LM ``TrainState`` as the reference's ``train_lm`` saves
    its own: ``.params/...``, ``.opt/.step``, ``.opt/.m/...``,
    ``.opt/.v/...`` and, when compressing, ``.error/...``, each layer kind
    stacked.  Returns the committed path.  With ``mesh`` (a
    ``train.fsdp.ShardPlan``) every rank gathers the whole leaves and
    rank 0 alone writes them (the others return the path it commits)."""
    tree = train_state_to_numpy(state, layout, mesh)
    if mesh is not None and not mesh.mesh.world.lead:
        return os.path.join(ckpt_dir, f"step_{step:010d}")
    return save(ckpt_dir, step, tree, keep=keep)


def _whole_like(state: TrainState, mesh) -> TrainState:
    """``_lm_like`` of a sharded state: the whole leaves' shapes."""
    def like():
        return _nest((lf.path, np.empty(lf.full, np.float32))
                     for lf in mesh.leaves)
    return TrainState(params=like(),
                      opt=AdamState(step=np.zeros((), np.int32), m=like(),
                                    v=like()),
                      error=None if state.error is None else like())


def restore_lm_state(ckpt_dir: str, step: int, like: TrainState,
                     layout: LeafLayout, mesh=None) -> TrainState:
    """The LM ``TrainState`` saved at ``step`` (by either package, from
    one process or a mesh) in the structure of ``like``, on ``like``'s
    device; a leaf whose shape differs from ``like``'s raises
    ``ValueError``.  With ``mesh`` (a ``train.fsdp.ShardPlan``) each rank
    reads the whole leaves and keeps its slices."""
    dev = like.params[0].device
    if mesh is not None:
        tree = restore(ckpt_dir, step, _whole_like(like, mesh))
        out = train_state_from_numpy(tree, layout, device=dev, mesh=mesh)
        for name, a, b in zip(("params", "m", "v"),
                              (out.params, out.opt.m, out.opt.v),
                              (like.params, like.opt.m, like.opt.v)):
            for lf, x, y in zip(mesh.leaves, a, b):
                if x.shape != y.shape:
                    raise ValueError(f"checkpoint {name} "
                                     f"{'/'.join(lf.path)} of shape "
                                     f"{tuple(x.shape)} does not fit "
                                     f"{tuple(y.shape)}")
        return out
    tree = restore(ckpt_dir, step, _lm_like(like, layout))
    out = train_state_from_numpy(tree, layout, device=dev)
    for name, a, b in zip(("params", "m", "v"),
                          (out.params, out.opt.m, out.opt.v),
                          (like.params, like.opt.m, like.opt.v)):
        for key, x, y in zip(layout.names, a, b):
            if x.shape != y.shape:
                raise ValueError(f"checkpoint {name} {key} of shape "
                                 f"{tuple(x.shape)} does not fit "
                                 f"{tuple(y.shape)}")
    return out
