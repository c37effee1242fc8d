"""Cost accounting of one traced step (the counterpart of
``repro/launch/hlo_analysis.py``).

The reference reads FLOPs, bytes, collective bytes and memory from the
HLO XLA compiled.  The port has no compiler to ask: the dry-run runs one
rank's step eagerly on fake tensors (``FakeTensorMode``: shapes and
dtypes, no storage) and counts what the eager program does.

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the aten operators (2 M N K per matrix product, the reference's
  ``_dot_flops`` convention; ``CostMode`` calls the mode's own per-op
  formulas, without its per-module attribution, which doubled the
  trace's time), plus each hand-written kernel's own count
  (``kernels/ops.py``'s fake branch and ``<kernel>_work``), since a
  CUDA kernel is not an aten operator.
* **HBM bytes**: ``CostMode`` sums each aten operator's input and output
  bytes, views and allocations free, a gather's or an indexed read's
  table counted only as the rows it returns and an in-place update as
  twice its update (``trip_weighted_cost``'s conventions), plus each
  kernel's counted bytes.  Eager PyTorch fuses nothing, so this is the
  eager program's traffic, not the fused figure the reference reads.
* **Collective bytes**: the output bytes per device by kind that the
  mesh's ``FakeWorkers`` tally (``core/collectives.py``).
* **Memory**: the four keys of XLA's ``memory_analysis``:
  ``argument_bytes`` the step's inputs, ``output_bytes`` its outputs,
  ``temp_bytes`` the peak of live storages during the step less the
  arguments (so outputs live at the peak are inside it), and
  ``generated_code_bytes`` 0.  ``CostMode`` tracks every storage an
  operator creates until it is freed (``weakref.finalize``).

What replaces the reference's trip-count weighting: XLA counts a
``while`` body once and ``computation_multipliers`` scales it by the
loop's trip count; an eager trace runs every layer, so a loop of N
layers is counted N times by construction.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import ops

_aten = torch.ops.aten

#: operators that move no data: views, metadata and bare allocations
FREE_OPS = frozenset(
    op.default if hasattr(op, "default") else op for op in (
        _aten.view, _aten._unsafe_view, _aten.alias, _aten.detach,
        _aten.t, _aten.transpose.int, _aten.permute, _aten.expand,
        _aten.slice.Tensor, _aten.select.int, _aten.unsqueeze,
        _aten.squeeze.dim, _aten.squeeze.dims, _aten.squeeze,
        _aten.as_strided, _aten.split.Tensor, _aten.split_with_sizes,
        _aten.unbind.int, _aten.narrow, _aten.diagonal, _aten.unfold,
        _aten.view_as_real, _aten.view_as_complex, _aten.lift_fresh,
        _aten.empty.memory_format, _aten.empty_like, _aten.new_empty,
        _aten.empty_strided, _aten.new_empty_strided, _aten.sym_size.int,
        _aten.sym_stride.int, _aten.sym_numel, _aten.sym_storage_offset,
        _aten.is_same_size, _aten._local_scalar_dense))
#: sparse reads: their first operand (the table) counts only as the rows
#: they return
GATHER_OPS = frozenset((
    _aten.index.Tensor, _aten.gather.default, _aten.index_select.default,
    _aten.embedding.default))
#: in-place updates: twice the bytes of the operands after the first
UPDATE_OPS = frozenset((
    _aten.index_put_.default, _aten.index_put.default,
    _aten._index_put_impl_.default, _aten.scatter.src,
    _aten.scatter_.src, _aten.scatter.value, _aten.scatter_.value,
    _aten.scatter_add.default, _aten.scatter_add_.default,
    _aten.index_add_.default, _aten.index_add.default,
    _aten.index_copy_.default, _aten.copy_.default,
    _aten.masked_fill_.Scalar, _aten.masked_fill_.Tensor))


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (views counted
    once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


class CostMode(TorchDispatchMode):
    """Per aten operator: its FLOPs (``FlopCounterMode``'s formulas) into
    ``flops``, its HBM bytes (module docstring) into ``bytes``, and every
    storage it creates into ``live`` until freed, with ``peak`` the most
    ever live.  ``track(tree)`` counts storages made before the mode (the
    step's arguments) as live."""

    def __init__(self):
        super().__init__()
        self._flop_fns = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held = weakref.WeakKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def _hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        if s in self._held:
            return
        n = s.nbytes()
        self._held[s] = n
        self.live += n
        weakref.finalize(s, self._free, n)

    def track(self, tree) -> None:
        """Count the storages under ``tree`` as live."""
        for t in _tensors(tree):
            self._hold(t)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or func in FREE_OPS:  # prim: metadata
            return out
            return out
        flop_fn = self._flop_fns.get(func._overloadpacket)
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func in GATHER_OPS:
            n = sum(_nbytes(t) for t in outs + ins[1:])
        elif func in UPDATE_OPS:
            n = 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            n = sum(_nbytes(t) for t in ins + outs)
        self.bytes += n
        for t in outs:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        return out


def trace_step(fn: Callable, args: tuple, tally: Dict[str, int] = None,
               held=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counters (on fake tensors: the
    caller's ``FakeTensorMode`` is active) and return the step's costs;
    ``held`` are arguments ``fn`` reaches otherwise (a module's
    parameters), counted with ``args``:

    ``flops_per_device`` (aten + kernels), ``bytes_per_device`` (aten +
    kernels), ``aten_flops``, ``aten_bytes``, ``kernels`` (``{name:
    {calls, flops, bytes}}``), ``collective_bytes_per_device`` (``tally``
    by kind and its ``total``; zeros where no tally is given),
    ``memory`` and ``t_lower_s`` (the trace's seconds)."""
    from ..core.collectives import COLLECTIVE_KINDS
    cost = CostMode()
    t0 = time.perf_counter()
    with ops.fake_tally() as kernels:
        cost.track((args, held))
        arg_bytes = storage_bytes((args, held))
        base = cost.live
        with cost:
            out = fn(*args)
        out_bytes = storage_bytes(out)
    seconds = time.perf_counter() - t0
    coll = {k: float((tally or {}).get(k, 0)) for k in COLLECTIVE_KINDS}
    coll["total"] = sum(coll.values())
    aten_flops = int(cost.flops)
    k_flops = sum(r["flops"] for r in kernels.values())
    k_bytes = sum(r["bytes"] for r in kernels.values())
    return {
        "flops_per_device": float(aten_flops + k_flops),
        "bytes_per_device": float(cost.bytes + k_bytes),
        "aten_flops": aten_flops,
        "aten_bytes": cost.bytes,
        "kernels": {name: dict(r) for name, r in sorted(kernels.items())},
        "collective_bytes_per_device": coll,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(cost.peak - base, 0),
                   "generated_code_bytes": 0},
        "t_lower_s": seconds,
    }

