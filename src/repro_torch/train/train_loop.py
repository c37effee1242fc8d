"""Train-step builders (port of ``repro/train/train_loop.py``).

``make_train_step`` builds the LM step: loss -> gradients (with optional
microbatch accumulation) -> int8 error-feedback compression (optional)
-> AdamW, over a ``TrainState`` whose ``params`` is a flat list of
tensors (an LM's ``convert.lm_leaves`` order, the optimizer moments'
order).  The step never writes its inputs: like the reference's, it
returns a new state, so ``nan_guard`` can keep the old one.  Where the
reference's pytree leaves stack layers (``LeafLayout``), the compression
quantizes and keeps its residual per reference leaf.  ``module_loss``
turns a module's loss into the ``loss(params, batch)`` the step takes
(``torch.func.functional_call``: the step's tensors stand in for the
module's parameters).

The workers' gradient sync: ``repro`` leaves the gradient AllReduce to
the SPMD partitioner (``grad_sync="psum"``) or routes it through an
explicit butterfly (``"tree"``, ``make_shardmap_grad_sync``).  Here the
stacked group needs neither: one process holds every worker and
differentiates the global mean loss.  Where each worker runs in its own
process (``core/collectives.py``'s ``ProcessWorkers``), every rank
differentiates the mean over its own seeds and the sync averages the
gradients: the group's ``all_reduce`` (``psum``) or ``tree_psum`` over the
group (``tree``), each then divided by the worker count.  The sync runs
before the optimizer's global-norm clip, which must see the global
gradient.

Over a ``(data, model)`` process mesh (``make_train_step(..., mesh=
plan)``, ``plan`` a ``fsdp.ShardPlan``) the state holds each reference
leaf's slice on the rank (FSDP over ``data``, the model's own split
over ``model``); a step gathers the leaves over ``data``, differentiates
the rank's loss on its batch slice seeded ``1 / M``, makes every
gradient whole and averaged and cuts it back to the slice
(``ShardPlan.reduce``), then clips by the whole gradient's norm and
compresses with each whole leaf's scale (``fsdp.py``).  ``mesh=None``
is the one-process step.  Layer bodies that ``maybe_remat`` checkpoints
read their weights again in the backward, so ``module_loss`` takes the
gradients while its tensors are still in the model.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..core.collectives import WorkerGroup
from ..core.config import GRAD_SYNC_MODES, TrainConfig
from ..core.tree_reduce import tree_psum
from . import compression
from .optimizer import AdamState, adam_update, global_norm, init_adam

_F32 = torch.float32


class TrainState(NamedTuple):
    """``params`` (a flat list of tensors), the AdamW state and the
    error-feedback residual (one float32 tensor per reference leaf, or
    None unless compressing)."""
    params: Any
    opt: AdamState
    error: Any


def init_state(params: Sequence[torch.Tensor], cfg: TrainConfig,
               layout, mesh=None) -> TrainState:
    """Step 0: ``params`` as given, zero moments, and with
    ``cfg.compress_grads`` a zero residual per reference leaf of
    ``layout`` (a ``convert.LeafLayout``).  With ``mesh`` (a
    ``fsdp.ShardPlan``) ``params`` are the rank's model's tensors and
    the state holds each leaf's data slice."""
    params = [p.detach() for p in params]
    if mesh is not None:
        params = mesh.shard(layout.group(params))
        err = (compression.init_error(params) if cfg.compress_grads
               else None)
        return TrainState(params=params, opt=init_adam(params), error=err)
    err = None
    if cfg.compress_grads:
        err = compression.init_error(layout.group(params))
    return TrainState(params=params, opt=init_adam(params), error=err)


def _grad(loss, wrt, seed):
    """``autograd.grad`` of ``loss`` (seeded ``seed`` unless None)."""
    out = None if seed is None else torch.full_like(loss, seed)
    return torch.autograd.grad(loss, wrt, grad_outputs=out,
                               allow_unused=True)


class _Objective(nn.Module):
    """``run(model, fn)`` as a module's forward (so that
    ``functional_call`` can swap the model's parameters around it)."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, run):
        return run(self.model, self.fn)


class ModuleLoss:
    """``loss(params, batch)``: ``loss(model, batch)`` with the tensors
    ``params`` in place of the model's parameters ``names`` (its
    ``named_parameters`` names; ``convert.LeafLayout.names``).  The
    model's own parameters are not read (they may be on ``meta``).
    ``value_and_grad`` differentiates inside the swap, where
    ``maybe_remat``'s recomputed bodies find the same tensors."""

    def __init__(self, model: nn.Module, loss: Callable,
                 names: Sequence[str]):
        self._obj = _Objective(model, loss)
        self._keys = [f"model.{n}" for n in names]

    def _call(self, params, run):
        return torch.func.functional_call(
            self._obj, dict(zip(self._keys, params)), (run,))

    def __call__(self, params, batch):
        return self._call(params, lambda model, fn: fn(model, batch))

    def value_and_grad(self, params, batch, wrt, seed=None):
        """``(loss, grads of wrt)`` of ``loss(params, batch)``."""
        def run(model, fn):
            loss = fn(model, batch)
            return loss, _grad(loss, wrt, seed)
        return self._call(params, run)


def module_loss(model: nn.Module, loss: Callable, names: Sequence[str]
                ) -> ModuleLoss:
    """The ``ModuleLoss`` of ``loss`` over ``model``'s parameters
    ``names``."""
    return ModuleLoss(model, loss, names)


def value_and_grad(loss_fn: Callable, params: Sequence[torch.Tensor], batch,
                   wrt=None, seed=None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached
    and one gradient per parameter, zeros where the loss does not reach
    it, as ``jax.grad`` gives (a hybrid with fewer layers than
    ``attn_every`` never runs its shared block).  With ``wrt`` the
    gradients are of those tensors, of which ``params`` are views (the
    mesh step's whole leaves); ``seed`` scales the backward."""
    if wrt is None:
        params = wrt = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        if isinstance(loss_fn, ModuleLoss):
            loss, grads = loss_fn.value_and_grad(params, batch, wrt, seed)
        else:
            loss = loss_fn(params, batch)
            grads = _grad(loss, wrt, seed)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(wrt, grads)]


def microbatch_grads(loss_fn: Callable, params: Sequence[torch.Tensor],
                     batch: dict, n_micro: int, wrt=None, seed=None):
    """``(loss, grads)`` over ``batch`` split into ``n_micro`` equal
    microbatches along its leading axis, in order: ``loss_acc + loss /
    n`` and ``acc + g / n`` from float32 zeros, as the reference's scan
    (one ``value_and_grad`` when ``n_micro <= 1``); ``wrt`` and ``seed``
    as ``value_and_grad``'s."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch, wrt, seed)
    micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
             for k, v in batch.items()}
    loss_acc = torch.zeros((), dtype=_F32, device=params[0].device)
    acc = [torch.zeros(p.shape, dtype=_F32, device=p.device)
           for p in (params if wrt is None else wrt)]
    for i in range(n_micro):
        loss, grads = value_and_grad(loss_fn, params,
                                     {k: v[i] for k, v in micro.items()},
                                     wrt, seed)
        loss_acc = loss_acc + loss / n_micro
        for a, g in zip(acc, grads):
            a.add_(g / n_micro)
        del grads
    return loss_acc, acc


def apply_grads(tcfg: TrainConfig, state: TrainState, loss: torch.Tensor,
                grads: Sequence[torch.Tensor], layout, mesh=None):
    """``(new_state, metrics)`` from the step's loss and gradients: the
    int8 round trip with error feedback per reference leaf when
    ``tcfg.compress_grads``, then ``adam_update``.  Metrics: ``loss``,
    ``grad_norm`` (before the clip) and ``step``.  With ``mesh`` (a
    ``fsdp.ShardPlan``) ``grads`` are the rank's leaf slices, the scale
    and the norm the whole leaves'."""
    error = state.error
    if tcfg.compress_grads and mesh is not None:
        packed, error = compression.compress_grads(grads, error, mesh.amax)
        grads = compression.decompress_grads(packed)
        del packed
    elif tcfg.compress_grads:
        packed, error = compression.compress_grads(layout.group(grads),
                                                   error)
        grads = layout.split(compression.decompress_grads(packed))
        del packed
    norm_fn = global_norm if mesh is None else mesh.global_norm
    params, opt, gnorm = adam_update(tcfg, state.params, grads, state.opt,
                                     norm_fn)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": opt.step}
    return TrainState(params=params, opt=opt, error=error), metrics


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, layout,
                    mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``: ``microbatch_grads``
    over ``tcfg.microbatches``, then ``apply_grads``.  ``loss_fn(params,
    batch)`` takes the flat parameter list (``module_loss``); ``layout``
    groups it into the reference's leaves.  With ``mesh`` (a
    ``fsdp.ShardPlan``; module docstring) ``batch`` is the rank's data
    slice and the metrics are the global batch's."""
    if mesh is None:
        def step(state: TrainState, batch: dict):
            loss, grads = microbatch_grads(loss_fn, state.params, batch,
                                           tcfg.microbatches)
            return apply_grads(tcfg, state, loss, grads, layout)
        return step

    def mesh_step(state: TrainState, batch: dict):
        loss, grads = mesh_grads(loss_fn, tcfg, layout, mesh,
                                 mesh.gather(state.params), batch)
        grads = mesh.reduce(grads)
        return apply_grads(tcfg, state, mesh.mean_loss(loss), grads, layout,
                           mesh)
    return mesh_step


def mesh_grads(loss_fn: Callable, tcfg: TrainConfig, layout, mesh, whole,
               batch: dict):
    """A mesh step's ``(loss, grads)`` before the sync: the rank's loss on
    its batch slice and its share of each leaf's gradient (seeded
    ``mesh.seed``), differentiated at ``whole``, the leaves as the rank's
    model holds them (``mesh.gather`` of the state's slices)."""
    whole = [t.detach().requires_grad_() for t in whole]
    with torch.enable_grad():
        flat = layout.split(whole)
    return microbatch_grads(loss_fn, flat, batch, tcfg.microbatches,
                            wrt=whole, seed=mesh.seed)


def _where(ok, new, old):
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_where(ok, n, o) for n, o in zip(new, old)))
    return [_where(ok, n, o) for n, o in zip(new, old)]


def nan_guard(state: TrainState, new_state: TrainState, metrics
              ) -> TrainState:
    """``new_state`` where the step's loss is finite, else ``state``,
    leaf by leaf (a blown-up step is skipped instead of desyncing the
    replicas)."""
    return _where(torch.isfinite(metrics["loss"]), new_state, state)


def make_grad_sync(group: WorkerGroup, mode: str = "psum"
                   ) -> Callable[[Sequence[torch.Tensor]], List[torch.Tensor]]:
    """``sync(blocks) -> blocks``: per-worker ``[L, ...]`` gradient blocks
    in, every worker's block holding the mean over all ``W`` workers out
    (``psum``: the group's ``all_reduce``; ``tree``: the butterfly of
    additions, then ``/ W`` as in ``make_shardmap_grad_sync``)."""
    if mode not in GRAD_SYNC_MODES:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNC_MODES}, "
                         f"got {mode!r}")

    def sync(blocks):
        if mode == "psum":
            summed = [group.all_reduce(b) for b in blocks]
        else:
            summed = list(tree_psum(tuple(blocks), group))
        return [s / group.world for s in summed]
    return sync


def make_step_sync(group: WorkerGroup, mode: str = "psum"
                   ) -> Callable[..., Tuple[List[torch.Tensor], torch.Tensor]]:
    """``sync(grads, loss) -> (grads, loss)`` for one process's step: its
    gradients and its loss packed into ONE flat block, averaged over the
    workers by ``make_grad_sync`` (one collective, or one butterfly),
    and unpacked.  The loss comes back as the global mean."""
    sync = make_grad_sync(group, mode)

    def step_sync(grads, loss):
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        out = sync([flat[None]])[0][0]
        parts = torch.split(out, [g.numel() for g in grads] + [1])
        return ([p.reshape(g.shape) for p, g in zip(parts, grads)],
                parts[-1][0])
    return step_sync
