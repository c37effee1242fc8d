"""Baseline subgraph-generation strategies the paper compares against
(§3), the port of ``repro/core/baselines.py``.

1. ``sql_like_sample`` — the "traditional SQL-like" method: each hop is a
   JOIN of the frontier against the full edge table, with no adjacency
   index: every frontier node is compared with every edge (O(F x E) per
   hop), which is the cost behind the paper's 27x.
2. ``node_centric_sample`` — AGL's node-centric paradigm: each frontier
   node walks its neighbour list serially (a reservoir over ``max_degree``
   steps, each step vectorised over the frontier).  One hot node sets the
   loop bound for the whole batch.
3. ``edge_centric_sample`` — GraphGen+'s sampler in single-partition form:
   the generator's ``local_candidates``, one parallel gather.

As in the port's generator, the random draws are INPUTS (``pri``, ``j``,
``(offs, e)``): production makes them with the ``*_draws`` helpers from a
seeded ``torch.Generator``; the tests feed ``repro``'s own ``jax.random``
draws, and the outputs then agree.  These samplers have no TPU kernel in
the reference, so they are plain torch.
"""
from __future__ import annotations

import torch

from .generation import local_candidates, sample_draws

#: frontier rows compared against the edge table at once: a block's
#: scores are ``SQL_BLOCK x E`` float32 (1.1 GB at E = 276 735); rows are
#: independent, so the block size changes no result
SQL_BLOCK = 1024
_I32_MAX = 2**31 - 1


def sql_priorities(generator: torch.Generator, n_edges: int,
                   device) -> torch.Tensor:
    """``sql_like_sample``'s draw: one priority per edge, uniform in
    ``[1e-6, 1)`` (the reference's ``uniform(rng, (E,), minval=1e-6)``)."""
    u = torch.rand(n_edges, generator=generator, dtype=torch.float32,
                   device=device)
    return u * (1.0 - 1e-6) + 1e-6


def sql_like_sample(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    frontier: torch.Tensor, k: int, pri: torch.Tensor,
                    block: int = SQL_BLOCK):
    """JOIN ``frontier [F]`` with the edge table ``(edge_src, edge_dst)
    [E]`` with no index: every (frontier node, edge) pair is compared,
    matches are ranked by ``pri [E]`` and the top ``k`` kept.  Returns
    ``(ids [F, k] int32, mask [F, k] bool)``; masked slots hold whatever
    edge the ``-inf`` ties put there."""
    ids, mask = [], []
    for lo in range(0, frontier.shape[0], block):
        f = frontier[lo:lo + block]
        match = edge_src[None, :] == f[:, None]           # full table scan
        score = torch.where(match, pri[None, :], float("-inf"))
        top, idx = torch.topk(score, k, dim=1)
        ids.append(edge_dst[idx])
        mask.append(torch.isfinite(top))
    return torch.cat(ids).to(torch.int32), torch.cat(mask)


def node_centric_draws(generator: torch.Generator, n_frontier: int,
                       max_degree: int, device) -> torch.Tensor:
    """``node_centric_sample``'s draws: ``j [F, max_degree]`` int32 with
    ``j[:, i]`` uniform in ``[0, i]`` (the serial reservoir's slot draw
    at step ``i``)."""
    r = torch.randint(0, _I32_MAX, (n_frontier, max_degree),
                      generator=generator, dtype=torch.int32, device=device)
    bound = torch.arange(1, max_degree + 1, dtype=torch.int32, device=device)
    return r % bound


def node_centric_sample(indptr: torch.Tensor, indices: torch.Tensor,
                        frontier: torch.Tensor, k: int, j: torch.Tensor,
                        max_degree: int):
    """AGL-style: every frontier node walks its neighbour list one edge
    per step, ``max_degree`` steps, a serial reservoir: step ``i`` takes
    neighbour ``i`` into slot ``i`` while ``i < k``, else into slot
    ``j[:, i]`` when that is below ``k``.  Returns ``(ids [F, k] int32,
    mask [F, k] bool)`` with ``mask = slot < min(deg, k)``."""
    f = frontier.shape[0]
    node = torch.clamp(frontier, 0, indptr.shape[0] - 2).to(torch.int64)
    start = indptr[node].to(torch.int64)
    deg = indptr[node + 1].to(torch.int64) - start
    last = indices.shape[0] - 1
    res = torch.zeros((f, k + 1), dtype=torch.int32, device=frontier.device)
    for i in range(max_degree):
        nbr = indices[torch.clamp(start + i, 0, last)]
        active = deg > i
        if i < k:
            slot = torch.where(active, i, k)
        else:
            ji = j[:, i].to(torch.int64)
            slot = torch.where(active & (ji < k), ji, k)
        # slot k is the discard column: rows that take nothing write there
        res.scatter_(1, slot[:, None], nbr[:, None])
    mask = (torch.arange(k, device=frontier.device)[None, :]
            < torch.clamp(deg, max=k)[:, None])
    return res[:, :k].contiguous(), mask


def edge_centric_draws(generator: torch.Generator, n_frontier: int, k: int,
                       device):
    """``edge_centric_sample``'s draws ``(offs, e) [F, k]`` (one hop of
    ``generation.sample_draws`` on one worker)."""
    ((offs, e),) = sample_draws(generator, 1, n_frontier, (k,), device)
    return offs[0], e[0]


def edge_centric_sample(indptr: torch.Tensor, indices: torch.Tensor,
                        frontier: torch.Tensor, k: int, offs: torch.Tensor,
                        e: torch.Tensor):
    """GraphGen+'s sampler, single-partition form: ``local_candidates``
    with the draws ``offs``/``e [F, k]`` (see ``generation.sample_draws``);
    returns ``(ids [F, k] int32, mask [F, k] bool)``, masked slots 0."""
    cand = local_candidates(indptr, indices, frontier, k, offs, e)
    mask = torch.isfinite(cand.keys)
    return torch.where(mask, cand.ids, 0), mask
