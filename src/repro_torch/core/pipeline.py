"""Synchronized subgraph generation + in-memory training (paper §2 step 4;
port of ``repro/core/pipeline.py``).

GraphGen+'s design: the subgraphs are generated straight into device
memory and trained on there, with no storage in between.  One pipelined
step generates batch *t+1* and then trains on batch *t*; the last
iteration has nothing left to generate and only trains.  The two halves
share no data, so a later PR can run them on two CUDA streams; here they
run in order on PyTorch's current stream, and the batch never leaves the
device.

With the host (L3) feature store the loop runs a SPLIT dispatch per
iteration instead: collect the previous gather's landed rows, generate
batch *t* (admitting them), issue batch *t*'s gather, then patch and
train batch *t-1* (``make_host_consume_step``) — so the gather's host
work runs while the card trains.

``offline_loop`` is the GraphGen baseline the paper compares against:
every batch is generated first, round-tripped through "storage" (one
device-to-host copy, pickle protocol 5 with out-of-band buffers) and
read back for training.

Random draws are an input, as in ``core/generation.py``: batch *t* is
generated with ``draws(t, n_workers, batch)`` in every loop
(``SeededDraws`` in production, the reference's own draws in the parity
tests), so the loops' losses agree bit for bit.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from .host_store import empty_admit, patch_batch


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


def make_host_consume_step(train_fn):
    """The host store's train step: ``consume(params, opt_state, batch,
    req, landed)`` patches batch *t*'s feature holes with its landed L3
    rows (``patch_batch``), then trains on it."""
    def consume(params, opt_state, batch, req, landed):
        with torch.no_grad():
            batch = patch_batch(batch, req, landed)
        return train_fn(params, opt_state, batch)
    return consume


def _host_generate(gen_fn, device_args, seeds, draws, cache, admit):
    """One host-store generation: ``(batch, cache, req)`` (``cache`` None
    when uncached)."""
    with torch.no_grad():
        if cache is None:
            batch, req = gen_fn(device_args, seeds, draws)
            return batch, None, req
        return gen_fn(device_args, seeds, draws, cache, *admit)


def pipelined_loop(gen_fn, train_fn, device_args, seed_schedule: np.ndarray,
                   params, opt_state, draws, cache=None, before_step=None,
                   after_step=None, host_store=None):
    """Run the pipeline over ``seed_schedule [steps, L, b]`` (the ``L``
    workers the generator holds: all ``W`` on the stacked group, the
    rank's own one in a process per worker, where every rank runs this
    loop over its own seeds and the train step syncs the gradients).

    Batch *t* is generated from ``seed_schedule[t]`` and ``draws(t, L,
    b)``; the final iteration trains only.  ``before_step(t, carry,
    gen_fn) -> (carry, gen_fn)``, when given, runs before step *t* trains
    on the carried batch *t*: it may replace that batch and the generator
    of the batches after it (``train_gcn``'s warm re-calibration and its
    rollback).  ``after_step(t, carry, loss)``, when given, runs once step
    *t* has been issued; ``carry`` then holds batch *t+1* (batch *t* after
    the last step).  Returns ``(params, opt_state, losses [steps])``, and
    the threaded cache state last when ``cache`` is given.

    With a ``host_store`` (the generator built with
    ``feature_store="host"``) each iteration is the split dispatch of the
    module docstring, and ``carry`` is ``(params, opt_state, batch,
    req)`` (the cache stays out of it); the first generation admits
    ``empty_admit``, and the last landed buffer is collected and consumed
    last."""
    n_steps, w, b = seed_schedule.shape
    dev = device_args[0].device

    def seeds(t):
        return torch.from_numpy(np.ascontiguousarray(seed_schedule[t])).to(dev)

    if host_store is not None:
        return _host_loop(gen_fn, train_fn, device_args, seeds, n_steps, w, b,
                          params, opt_state, draws, cache, before_step,
                          after_step, host_store)
    cached = cache is not None
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


def _host_loop(gen_fn, train_fn, device_args, seeds, n_steps, w, b, params,
               opt_state, draws, cache, before_step, after_step, store):
    """``pipelined_loop``'s host-store branch (the split dispatch)."""
    cached = cache is not None
    consume = make_host_consume_step(train_fn)
    dev = device_args[0].device
    admit = empty_admit(w, store.feat_dim, device=dev)
    batch, cache, req = _host_generate(gen_fn, device_args, seeds(0),
                                       draws(0, w, b), cache, admit)
    pending = store.issue(req.ids)
    carry = (params, opt_state, batch, req)
    losses = []
    for t in range(n_steps):
        if before_step is not None:
            carry, _ = before_step(t, carry, gen_fn)
        landed = pending.rows()               # batch t's misses, landed
        if t + 1 < n_steps:
            batch, cache, req = _host_generate(
                gen_fn, device_args, seeds(t + 1), draws(t + 1, w, b), cache,
                (carry[3].ids, landed))
            pending = store.issue(req.ids)    # rides under the consume step
        p, o, loss = consume(carry[0], carry[1], carry[2], carry[3], landed)
        carry = (p, o, batch, req)
        losses.append(loss)
        if after_step is not None:
            after_step(t, carry, loss)
    # every handle is collected above; rows() memoizes, so this costs
    # nothing (and joins the gather an empty schedule primed)
    pending.rows()
    if cached:
        return carry[0], carry[1], torch.stack(losses), cache
    return carry[0], carry[1], torch.stack(losses)


def _tree_map(fn, tree):
    """``fn`` over the array leaves of dicts, (Named)tuples and lists
    (``None`` passes through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _store_roundtrip(payload):
    """GraphGen baseline storage: one device-to-host copy of every tensor
    (numpy leaves, such as the L3 store's landed host buffer, are taken
    as they are), then pickle protocol 5 with the array bodies handed out
    of band.  Returns ``(header_bytes, buffers)``."""
    host = _tree_map(lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a), payload)
    buffers = []
    header = pickle.dumps(host, protocol=5, buffer_callback=buffers.append)
    return header, buffers


def _load_roundtrip(blob, device="cpu"):
    """Read a stored payload back as tensors on ``device``."""
    header, buffers = blob
    host = pickle.loads(header, buffers=buffers)
    return _tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), host)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def offline_loop(gen_fn, train_fn, device_args, seed_schedule: np.ndarray,
                 params, opt_state, draws, cache=None, host_store=None,
                 group=None):
    """The GraphGen baseline: generate every batch, store it, read it all
    back, train.

    Batch *t* is generated from ``seed_schedule[t]`` and ``draws(t, W,
    b)``, as in ``pipelined_loop``, so the two loops' losses are equal
    bit for bit.  The cache threads through the generation phase only
    (storage carries batches, never cache state).  With a ``host_store``
    each generation's misses are gathered at once (the baseline is
    sequential), the landed rows admitted by the next generation, and the
    payload stored is ``(batch, req, rows)`` with ``rows`` the gather's
    host buffer; the train phase patches the holes on load.  Returns
    ``(params, opt_state, losses, {"t_gen", "t_train"})``, with the cache
    last when one is given; the times are seconds of the host clock, each
    phase ending with the card idle.  On a process ``group`` (one worker
    per process, ``seed_schedule [steps, 1, b]`` its own seeds) each
    time is the max over the ranks."""
    cached = cache is not None
    n_steps, w, b = seed_schedule.shape
    dev = device_args[0].device

    def seeds(t):
        return torch.from_numpy(np.ascontiguousarray(seed_schedule[t])).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    storage = []
    if host_store is not None:
        admit = empty_admit(w, host_store.feat_dim, device=dev)
        for t in range(n_steps):
            batch, cache, req = _host_generate(gen_fn, device_args, seeds(t),
                                               draws(t, w, b), cache, admit)
            pending = host_store.issue(req.ids)
            admit = (req.ids, pending.rows())
            storage.append(_store_roundtrip((batch, req,
                                             pending.host_rows())))
    else:
        with torch.no_grad():
            for t in range(n_steps):
                if cached:
                    batch, cache = gen_fn(device_args, seeds(t),
                                          draws(t, w, b), cache)
                else:
                    batch = gen_fn(device_args, seeds(t), draws(t, w, b))
                storage.append(_store_roundtrip(batch))
    _sync(dev)
    t_gen = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for blob in storage:
        if host_store is not None:
            batch, req, rows = _load_roundtrip(blob, dev)
            with torch.no_grad():
                batch = patch_batch(batch, req, rows)
        else:
            batch = _load_roundtrip(blob, dev)
        params, opt_state, loss = train_fn(params, opt_state, batch)
        losses.append(loss)
    _sync(dev)
    t_train = time.perf_counter() - t0
    if group is not None and group.local < group.world:
        t = torch.tensor([[t_gen, t_train]], dtype=torch.float64, device=dev)
        t_gen, t_train = group.all_reduce(t, "max")[0].tolist()
    stats = {"t_gen": t_gen, "t_train": t_train}
    if cached:
        return params, opt_state, torch.stack(losses), stats, cache
    return params, opt_state, torch.stack(losses), stats
