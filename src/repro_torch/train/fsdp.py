"""The LM's training state over a ``(data, model)`` process mesh: FSDP,
the gradient sync, and the sharded global norm and compression scale
(what the reference's ``jax.jit`` of ``make_train_step`` gets from the
in/out shardings of ``zoo.param_pspecs``).

A ``ShardPlan`` places each of the reference's leaves (``convert.
LeafLayout``: one tensor stacked over the layers where the reference
stacks them) on the mesh:

* **over ``data``** as ``zoo.param_pspec`` says (``cfg.fsdp_params``):
  the dimension it names ``data`` is cut into ``D`` slices
  (``data_dim``; the layer axis of a stacked vector too), where ``D``
  divides the rank's leaf; elsewhere the leaf is whole on each data
  rank.
* **over ``model``** as the model is built (``models/layers.py``): a
  head-split attention's or MLA's heads and a MoE layer's experts are
  this rank's slice for the compute (``model_dim``).  A leaf the model
  holds whole and FSDP cuts over ``data`` is also stored cut into ``M``
  slices along the dimension ``param_pspec`` names ``model``
  (``store_dim``; a matrix's output, a stacked vector's width) where
  ``M`` divides it, as the reference stores it: FSDP spans the whole
  mesh.  Without a data cut (one data rank) a leaf is stored as the
  model holds it and nothing is gathered: every step's gathers over
  the model axis would cost as much as its gradient sync.

The params, Adam moments and error-feedback residual hold the rank's
slice of each leaf: the reference's own device shard wherever the
model's split and the spec's agree (experts, the query and kv heads'
columns), and the data rank's slice of the rank's heads where they do
not (``wo``'s rows carry the heads, its spec puts ``model`` on its
columns).

The step (``train_loop.make_train_step(..., mesh=plan)``) gathers each
leaf's slices before the loss (``gather``), differentiates the
rank's loss seeded ``1 / M`` (``models/layers.py``: every collective's
backward is its adjoint, so each rank's gradient is its share of the
derivative of the ranks' summed objectives), and ``reduce`` makes each
gradient whole and averaged: a leaf whole on the model axis sums its
gradient over the whole mesh (the model ranks' shares and the data
ranks' batches at once), a model-split leaf over ``data`` only (over
``pod`` and ``data`` on a multi-pod mesh: ``Mesh.dp``); both are divided
by the data-parallel width and cut to the rank's slice.  gloo has no
reduce-scatter: an ``all_reduce`` and a slice (an ``all_to_all`` of the
slices, summed locally, moved half the bytes but took longer on the
card's host: PERF.md).  ``global_norm`` counts
each element once and ``amax`` takes a leaf's max over all its shards.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models import zoo

_F32 = torch.float32


class LeafShard(NamedTuple):
    """Where one reference leaf lies: ``shape`` the leaf as the rank's
    model holds it (its compute slice, stacked), ``full`` the
    reference's, ``spec`` its ``param_pspec``, and the dimensions of
    ``shape`` cut for the compute over ``model`` and for storage over
    ``model`` and ``data`` (None: not cut)."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    full: Tuple[int, ...]
    spec: tuple
    data_dim: Optional[int]
    model_dim: Optional[int]
    store_dim: Optional[int]

    @property
    def model_cut(self) -> Optional[int]:
        """The dimension of the reference's leaf cut over ``model``
        (compute or storage)."""
        return self.model_dim if self.model_dim is not None \
            else self.store_dim


class ShardPlan:
    """The leaves of ``layout`` (``convert.LeafLayout`` of the rank's
    model) on ``mesh`` (``launch.mesh.Mesh``), ``fsdp`` as the config's
    ``fsdp_params`` (module docstring)."""

    def __init__(self, layout, mesh, fsdp: bool = True):
        if len(layout.shapes) != len(layout.paths):
            raise ValueError("the layout holds no tensor shapes: take it "
                             "from convert.lm_leaves")
        self.layout, self.mesh = layout, mesh
        d, m = mesh.data.world, mesh.model.world
        self.leaves: List[LeafShard] = []
        for path, n, st, shape, shard in zip(
                layout.paths, layout.counts, layout.stacked, layout.shapes,
                layout.shards):
            lead = (n,) if st else ()
            full = list(shape)
            model_dim = None
            if shard is not None:
                full[shard.dim] = shard.full
                model_dim = shard.dim + len(lead)
            local, full = lead + tuple(shape), lead + tuple(full)
            spec = zoo.param_pspec("/".join(path), full, mesh.shape, fsdp)
            data_dim = spec.index("data") if "data" in spec else None
            if d == 1 or (data_dim is not None and local[data_dim] % d):
                data_dim = None
            store_dim = spec.index("model") if "model" in spec else None
            if m == 1 or model_dim is not None or data_dim is None or (
                    store_dim is not None and local[store_dim] % m):
                store_dim = None
            self.leaves.append(LeafShard(path, local, full, spec, data_dim,
                                         model_dim, store_dim))

    # ------------------------------------------------------------ slices --
    @staticmethod
    def _cut(a, dim: Optional[int], group):
        """``a``'s slice ``group.rank`` of ``group.world`` along ``dim``
        (numpy or torch; ``a`` itself for ``dim`` None)."""
        if dim is None:
            return a
        n = a.shape[dim] // group.world
        idx = [slice(None)] * len(a.shape)
        idx[dim] = slice(group.rank * n, (group.rank + 1) * n)
        return a[tuple(idx)]

    def slice(self, leaf: LeafShard, t):
        """The rank's stored slice of ``t``, the leaf as its model holds
        it (a view; ``t`` itself where the leaf is stored whole)."""
        t = self._cut(t, leaf.store_dim, self.mesh.model)
        return self._cut(t, leaf.data_dim, self.mesh.data)

    def shard(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The leaves as the rank's model holds them -> its stored slices
        (copies)."""
        return [self.slice(lf, t).clone() for lf, t in zip(self.leaves,
                                                          leaves)]

    def _gather(self, group, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``'s slices of ``group`` concatenated along ``dim``."""
        got = group.all_gather(t.contiguous().reshape(1, -1))[0]
        parts = got.reshape((group.world,) + tuple(t.shape)).unbind(0)
        return torch.cat(parts, dim=dim)

    def _unslice(self, lf: LeafShard, t: torch.Tensor, model_dim):
        if lf.data_dim is not None:
            t = self._gather(self.mesh.data, t, lf.data_dim)
        if model_dim is not None:
            t = self._gather(self.mesh.model, t, model_dim)
        return t

    def gather(self, slices: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The stored slices -> the leaves as the rank's model holds them
        (an ``all_gather`` over each axis a leaf is stored cut on)."""
        return [self._unslice(lf, t, lf.store_dim)
                for lf, t in zip(self.leaves, slices)]

    def whole(self, slices: Sequence[torch.Tensor]):
        """The stored slices -> the reference's whole leaves, gathered
        over both axes one leaf at a time (the checkpoint's and
        ``convert``'s view; every rank of the mesh must iterate it)."""
        for lf, t in zip(self.leaves, slices):
            yield self._unslice(lf, t, lf.model_cut)

    def take(self, leaf: LeafShard, a):
        """The rank's stored slice of the reference's whole leaf ``a``
        (numpy or torch): its slice over ``model``, then over ``data``."""
        a = self._cut(a, leaf.model_cut, self.mesh.model)
        return self._cut(a, leaf.data_dim, self.mesh.data)

    # ------------------------------------------------------- the sync --
    @property
    def seed(self) -> float:
        """The loss's backward seed on each rank: ``1 / M``."""
        return 1.0 / self.mesh.model.world

    def reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The rank's gradient shares of its model's leaves (on its device
        or the host) -> its stored slices of the averaged gradient
        (module docstring); empties ``grads`` as it goes, so one leaf's
        gradient at a time outlives its sum."""
        mesh, d = self.mesh, self.mesh.dp.world
        out = []
        for lf in self.leaves:
            g = grads.pop(0)
            group = mesh.world if lf.model_dim is None else mesh.dp
            if group.world > 1:
                g = group.all_reduce(g[None])[0]
            if d > 1:                 # the sum is a fresh tensor
                g.div_(d)
            out.append(self.slice(lf, g.to(mesh.world.device)).clone())
            del g
        return out

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's mean loss from each data rank's."""
        data = self.mesh.dp
        if data.world == 1:
            return loss
        return data.all_reduce(loss.reshape(1, 1))[0, 0] / data.world

    def global_norm(self, slices: Sequence[torch.Tensor]) -> torch.Tensor:
        """The Euclidean norm of the whole gradient, each element once:
        a leaf whole on an axis counts on that axis's rank 0 only, the
        squares summed over the mesh in one ``all_reduce``."""
        dr, mr = self.mesh.coords
        total = torch.zeros((), dtype=_F32, device=slices[0].device)
        for lf, t in zip(self.leaves, slices):
            if ((lf.data_dim is not None or dr == 0)
                    and (lf.model_cut is not None or mr == 0)):
                total = total + torch.sum(torch.square(t.to(_F32)))
        return torch.sqrt(self.mesh.world.all_reduce(total.reshape(1, 1))
                          [0, 0])

    def amax(self, maxima: torch.Tensor) -> torch.Tensor:
        """Each leaf's max over all its shards, from the rank's
        ``maxima [n_leaves]`` (one ``all_reduce(max)`` over the mesh)."""
        return self.mesh.world.all_reduce(maxima[None], op="max")[0]
