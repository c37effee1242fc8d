"""AdamW with linear-warmup cosine decay and a global-norm clip (port of
``repro/train/optimizer.py``).

Plain functions over a sequence of parameter tensors (a GCN's
``leaves()``, the reference's pytree order): ``adam_update`` returns new tensors and a new
``AdamState`` and never touches its inputs.  Not ``torch.optim.AdamW``:
the reference divides by ``sqrt(v / bc2) + eps`` (torch by
``sqrt(v) / sqrt(bc2) + eps``), applies the weight decay to every
parameter inside the same ``lr * (...)`` term, and clips by the global
norm of all gradients (where each worker runs in its own process, the
gradients reach it already averaged over the ranks: ``launch/train.py``
syncs them first, so the clip sees the global gradient, as the
reference's does).  The schedule and the bias corrections are float32
tensor arithmetic, as in the reference, where Python floats would round
differently.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence

import torch

from ..core.config import TrainConfig

_F32 = torch.float32


class AdamState(NamedTuple):
    """Step count (int32 scalar) and the float32 moment lists."""
    step: torch.Tensor
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    """Zero moments beside each parameter, step 0."""
    params = list(params)
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=params[0].device),
        m=[torch.zeros_like(p, dtype=_F32) for p in params],
        v=[torch.zeros_like(p, dtype=_F32) for p in params])


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup over ``warmup_steps``, then
    cosine decay to a tenth of ``learning_rate`` at ``total_steps``."""
    s = step.to(_F32)
    warm = torch.clamp(s / float(max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps).to(_F32)
        / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Euclidean norm of all ``tensors`` together, in float32."""
    sq = sum(torch.sum(torch.square(t.to(_F32))) for t in tensors)
    return torch.sqrt(sq)


def adam_update(cfg: TrainConfig, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: AdamState,
                norm_fn: Callable = global_norm):
    """One AdamW step: ``(new_params, new_state, grad_norm)``, the
    gradients first scaled so that their global norm (``norm_fn``'s) is
    at most ``cfg.grad_clip``.  Over a training mesh the tensors are the
    rank's slices and ``norm_fn`` the whole gradient's norm
    (``fsdp.ShardPlan.global_norm``)."""
    gnorm = norm_fn(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(_F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32, device=sf.device), sf)
    # the reference's expressions, op for op, a leaf at a time (its clipped
    # gradient a temporary), each temporary reused in place: the same
    # roundings, a fraction of the allocations of a parameter's size
    new_params, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, state.m, state.v):
        g = (g * scale).to(_F32)
        new_m.append((b1 * m).add_((1 - b1) * g))
        new_v.append((b2 * v).add_(torch.square(g).mul_(1 - b2)))
        del g
        pf = p.detach().to(_F32)
        upd = (new_m[-1] / bc1).div_((new_v[-1] / bc2).sqrt_().add_(cfg.eps))
        upd.add_(cfg.weight_decay * pf)
        new_params.append((pf - upd.mul_(lr)).to(p.dtype))
    return new_params, AdamState(step=step, m=new_m, v=new_v), gnorm
