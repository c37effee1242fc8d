"""Synchronized subgraph generation + in-memory training (paper §2 step 4;
port of ``repro/core/pipeline.py``, device store).

GraphGen+'s design: the subgraphs are generated straight into device
memory and trained on there, with no storage in between.  One pipelined
step generates batch *t+1* and then trains on batch *t*; the last
iteration has nothing left to generate and only trains.  The two halves
share no data, so a later PR can run them on two CUDA streams; here they
run in order on PyTorch's current stream, and the batch never leaves the
device.

Random draws are an input, as in ``core/generation.py``: batch *t* is
generated with ``draws(t, n_workers, batch)`` (``SeededDraws`` in
production, the reference's own draws in the parity tests).  The host
(L3) store's split dispatch and the offline baseline wait for later
slices.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch


def make_pipelined_step(gen_fn: Callable[..., Any],
                        train_fn: Callable[..., Tuple[Any, Any, torch.Tensor]],
                        cached: bool = False):
    """Fuse generation(t+1) with training(t) into one step.

    ``carry = (params, opt_state, next_batch)`` — with ``cached=True``
    ``(params, opt_state, next_batch, cache)`` and the stateful
    ``gen_fn(device_args, seeds, draws, cache) -> (batch, cache)``.
    ``step(carry, device_args, seeds, draws) -> (carry, loss)`` generates
    the next batch from ``seeds``/``draws``, then trains on the carried
    one with ``train_fn(params, opt_state, batch) -> (params, opt_state,
    loss)``."""
    if cached:
        def step(carry, device_args, seeds, draws):
            params, opt_state, batch, cache = carry
            with torch.no_grad():
                next_batch, cache = gen_fn(device_args, seeds, draws, cache)
            params, opt_state, loss = train_fn(params, opt_state, batch)
            return (params, opt_state, next_batch, cache), loss
    else:
        def step(carry, device_args, seeds, draws):
            params, opt_state, batch = carry
            with torch.no_grad():
                next_batch = gen_fn(device_args, seeds, draws)
            params, opt_state, loss = train_fn(params, opt_state, batch)
            return (params, opt_state, next_batch), loss
    return step


def pipelined_loop(gen_fn, train_fn, device_args, seed_schedule: np.ndarray,
                   params, opt_state, draws, cache=None, before_step=None,
                   after_step=None):
    """Run the pipeline over ``seed_schedule [steps, W, b]``.

    Batch *t* is generated from ``seed_schedule[t]`` and ``draws(t, W,
    b)``; the final iteration trains only.  ``before_step(t, carry,
    gen_fn) -> (carry, gen_fn)``, when given, runs before step *t* trains
    on the carried batch *t*: it may replace that batch and the generator
    of the batches after it (``train_gcn``'s warm re-calibration and its
    rollback).  ``after_step(t, carry, loss)``, when given, runs once step
    *t* has been issued; ``carry`` then holds batch *t+1* (batch *t* after
    the last step).  Returns ``(params, opt_state, losses [steps])``, and
    the threaded cache state last when ``cache`` is given."""
    cached = cache is not None
    n_steps, w, b = seed_schedule.shape
    dev = device_args[0].device

    def seeds(t):
        return torch.from_numpy(np.ascontiguousarray(seed_schedule[t])).to(dev)

    with torch.no_grad():
        if cached:
            batch, cache = gen_fn(device_args, seeds(0), draws(0, w, b), cache)
            carry = (params, opt_state, batch, cache)
        else:
            batch = gen_fn(device_args, seeds(0), draws(0, w, b))
            carry = (params, opt_state, batch)
    step = make_pipelined_step(gen_fn, train_fn, cached=cached)
    losses = []
    for t in range(n_steps):
        if before_step is not None:
            carry, new_gen = before_step(t, carry, gen_fn)
            if new_gen is not gen_fn:
                gen_fn = new_gen
                step = make_pipelined_step(gen_fn, train_fn, cached=cached)
        if t + 1 < n_steps:
            carry, loss = step(carry, device_args, seeds(t + 1),
                               draws(t + 1, w, b))
        else:
            p, o, loss = train_fn(carry[0], carry[1], carry[2])
            carry = (p, o) + carry[2:]
        losses.append(loss)
        if after_step is not None:
            after_step(t, carry, loss)
    if cached:
        return carry[0], carry[1], torch.stack(losses), carry[3]
    return carry[0], carry[1], torch.stack(losses)
