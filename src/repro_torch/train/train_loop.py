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
gradient.  LM training over the model axis waits for ROADMAP Queue 1
item 7.4 (``serve_lm --dist`` runs over it).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..core.collectives import WorkerGroup
from ..core.config import GRAD_SYNC_MODES, TrainConfig
from ..core.tree_reduce import tree_psum
from . import compression
from .optimizer import AdamState, adam_update, init_adam

_F32 = torch.float32


class TrainState(NamedTuple):
    """``params`` (a flat list of tensors), the AdamW state and the
    error-feedback residual (one float32 tensor per reference leaf, or
    None unless compressing)."""
    params: Any
    opt: AdamState
    error: Any


def init_state(params: Sequence[torch.Tensor], cfg: TrainConfig,
               layout) -> TrainState:
    """Step 0: ``params`` as given, zero moments, and with
    ``cfg.compress_grads`` a zero residual per reference leaf of
    ``layout`` (a ``convert.LeafLayout``)."""
    params = [p.detach() for p in params]
    err = None
    if cfg.compress_grads:
        err = compression.init_error(layout.group(params))
    return TrainState(params=params, opt=init_adam(params), error=err)


class _Objective(nn.Module):
    """``fn(model, batch)`` as a module's forward (so that
    ``functional_call`` can swap the model's parameters)."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, batch):
        return self.fn(self.model, batch)


def module_loss(model: nn.Module, loss: Callable, names: Sequence[str]
                ) -> Callable:
    """``loss(params, batch)``: ``loss(model, batch)`` with the tensors
    ``params`` in place of the model's parameters ``names`` (its
    ``named_parameters`` names; ``convert.LeafLayout.names``).  The
    model's own parameters are not read (they may be on ``meta``)."""
    obj = _Objective(model, loss)
    keys = [f"model.{n}" for n in names]

    def fn(params, batch):
        return torch.func.functional_call(obj, dict(zip(keys, params)),
                                          (batch,))
    return fn


def value_and_grad(loss_fn: Callable, params: Sequence[torch.Tensor], batch
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached
    and one gradient per parameter, zeros where the loss does not reach
    it, as ``jax.grad`` gives (a hybrid with fewer layers than
    ``attn_every`` never runs its shared block)."""
    ps = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        loss = loss_fn(ps, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


def microbatch_grads(loss_fn: Callable, params: Sequence[torch.Tensor],
                     batch: dict, n_micro: int):
    """``(loss, grads)`` over ``batch`` split into ``n_micro`` equal
    microbatches along its leading axis, in order: ``loss_acc + loss /
    n`` and ``acc + g / n`` from float32 zeros, as the reference's scan
    (one ``value_and_grad`` when ``n_micro <= 1``)."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
             for k, v in batch.items()}
    loss_acc = torch.zeros((), dtype=_F32, device=params[0].device)
    acc = [torch.zeros(p.shape, dtype=_F32, device=p.device) for p in params]
    for i in range(n_micro):
        loss, grads = value_and_grad(loss_fn, params,
                                     {k: v[i] for k, v in micro.items()})
        loss_acc = loss_acc + loss / n_micro
        for a, g in zip(acc, grads):
            a.add_(g / n_micro)
        del grads
    return loss_acc, acc


def apply_grads(tcfg: TrainConfig, state: TrainState, loss: torch.Tensor,
                grads: Sequence[torch.Tensor], layout):
    """``(new_state, metrics)`` from the step's loss and gradients: the
    int8 round trip with error feedback per reference leaf when
    ``tcfg.compress_grads``, then ``adam_update``.  Metrics: ``loss``,
    ``grad_norm`` (before the clip) and ``step``."""
    error = state.error
    if tcfg.compress_grads:
        packed, error = compression.compress_grads(layout.group(grads),
                                                   error)
        grads = layout.split(compression.decompress_grads(packed))
        del packed
    params, opt, gnorm = adam_update(tcfg, state.params, grads, state.opt)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": opt.step}
    return TrainState(params=params, opt=opt, error=error), metrics


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, layout
                    ) -> Callable:
    """``step(state, batch) -> (state, metrics)``: ``microbatch_grads``
    over ``tcfg.microbatches``, then ``apply_grads``.  ``loss_fn(params,
    batch)`` takes the state's flat parameter list (``module_loss``);
    ``layout`` groups it into the reference's leaves for the
    compression."""

    def step(state: TrainState, batch: dict):
        loss, grads = microbatch_grads(loss_fn, state.params, batch,
                                       tcfg.microbatches)
        return apply_grads(tcfg, state, loss, grads, layout)
    return step


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
