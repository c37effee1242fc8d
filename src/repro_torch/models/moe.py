"""Mixture-of-experts layer and the qwen3-moe-30b-a3b LM (port of
``repro/models/moe.py``): 48 layers of GQA attention and a 128-expert
top-8 MoE MLP.

``moe_forward`` is the reference's sort-based capacity dispatch: each
token's top-k experts (softmax over the float32 router logits, the top-k
weights renormalised), the assignments sorted by expert with a stable
sort, each one's rank in its expert's queue, ranks past the capacity
``max(int(T k / E * 1.25), 1)`` dropped, the ``[E, cap, D]`` buffer run
through each expert's SwiGLU as batched products, and the weighted
combine.  Three points follow the reference exactly, on both devices:

* **top-k ties** go to the lower expert index, as ``lax.top_k`` gives
  them: the port takes the first k of a stable descending sort;
* **the sort** is stable (``jnp.argsort`` is; ``torch.argsort`` only
  with ``stable=True``);
* **slot cap - 1.**  The reference clips every dropped assignment's
  rank to ``cap - 1`` and scatters its zeroed row there, after the kept
  assignment of that rank; of colliding writes the last wins, so every
  expert whose queue overflows ends with a zero row in slot ``cap - 1``
  and its last kept assignment contributes nothing.  The port scatters
  the kept rows only (no duplicate index) and then zeroes slot ``cap - 1``
  of each overflowing expert: the reference's answer, deterministically.

The combine adds each token's k contributions in the reference's order
(ascending expert id, the order of the sorted scatter-add) one rounding
at a time, with no atomics.  ``tally()`` counts the dispatch's kept,
dropped and collision-zeroed assignments while it is open (off by
default).

**The model axis** (``layers.set_mesh``, M ranks).  Where M divides the
experts, an ``MoEMLP`` built on the axis holds the rank's ``E / M``
experts (``split``); the router and the shared experts stay whole.  Two
paths run it:

* ``moe_forward`` (the gather path, decode always): every rank routes
  all tokens and builds the dispatch as above, runs ``_expert_swiglu``
  on its own experts' rows, and the expert outputs are all-gathered
  before the combine (the reference's ``[E, cap, D]`` buffer and outputs
  sharded over ``model``): the unsharded result, bit for bit.
* ``moe_forward_ep`` (``set_moe_impl("ep_a2a")``, the reference's
  ``shard_map``), where M also divides the sequence: each rank routes
  its own ``S / M`` slice of the tokens, sends each assignment to the
  rank that owns its expert (``cap`` slots per destination), sorts what
  it receives by local expert (``c2`` slots each), runs its experts and
  sends the rows home.  Overflow past either capacity is dropped, not
  clipped.  Its combine adds a token's k contributions in top-k order,
  as the reference's ``y.at[ftok].add`` does.

Both paths train (``train/fsdp.py``): EP's two float all_to_alls and the
gather path's all_gather run under autograd, each backward its adjoint
(the rows' gradients sent back the way they came, the outputs'
reduce-scattered), the router's gradient reaching it through ``topv``
on the rank's own tokens and summed over the ranks.  On a training mesh
whose ranks each hold a slice of the batch (``layers.set_data_axis``)
the gather path gathers the batch over the data axis first and keeps
the rank's rows after, so that its capacity and sort see every token,
as the reference's jit of the global batch does; EP routes each rank's
own tokens, as the reference's ``shard_map`` does.  A dispatch
recomputed by ``maybe_remat`` is not tallied again.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from ..core import collectives as C
from ..core.config import ModelConfig, resolve_device
from . import layers as L
from .transformer import MLP, Attention, kv_cache

CAPACITY_FACTOR = 1.25
#: ``"gather"`` (``moe_forward``'s dispatch) or ``"ep_a2a"``
MOE_IMPLS = ("gather", "ep_a2a")
MOE_IMPL = "gather"

_TALLY: Optional[list] = None
_PLANS: Optional[list] = None


def set_moe_impl(impl: str) -> None:
    """``moe_forward``'s dispatch on a model axis: ``"gather"`` or
    ``"ep_a2a"``."""
    global MOE_IMPL
    if impl not in MOE_IMPLS:
        raise ValueError(f"MoE impl must be one of {MOE_IMPLS}, got "
                         f"{impl!r}")
    MOE_IMPL = impl


class ExpertSplit(NamedTuple):
    """A rank's experts ``[e0, e0 + n)`` on rank ``r`` of ``m``."""
    m: int
    r: int
    e0: int
    n: int


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``t`` tokens: ``max(int(t k / E * 1.25), 1)``."""
    return max(int(t * cfg.top_k / cfg.n_experts * CAPACITY_FACTOR), 1)


class Dispatch(NamedTuple):
    """The routing of ``T`` tokens, each of the ``T k`` assignments in
    expert-sorted order (``order`` maps sorted -> flat token-major
    index): its expert ``se``, rank in the expert's queue ``rank`` and
    ``keep = rank < cap``; ``count [E]`` the assignments each expert
    received; ``topv``/``topi [T, k]`` the renormalised weights and
    experts."""
    topv: torch.Tensor
    topi: torch.Tensor
    order: torch.Tensor
    se: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    count: torch.Tensor
    cap: int


def top_k(router: torch.Tensor, xf: torch.Tensor, k: int):
    """``(topv, topi) [T, k]``: router logits in ``xf``'s dtype, then
    float32; softmax; the top k with ties to the lower index (the first k
    of a stable descending sort, as ``lax.top_k``); the weights
    renormalised."""
    logits = (xf @ router.to(xf.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9), topi


def route(router: torch.Tensor, xf: torch.Tensor, cfg: ModelConfig
          ) -> Dispatch:
    """Top-k routing and the capacity plan of ``xf [T, D]``: router logits
    in ``xf``'s dtype, then float32; softmax; the top k with ties to the
    lower index (the first k of a stable descending sort, as
    ``lax.top_k``); the weights renormalised; the flat expert ids sorted
    stably and each assignment's rank in its expert's queue."""
    t, k, e = xf.shape[0], cfg.top_k, cfg.n_experts
    topv, topi = top_k(router, xf, k)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    count = _counts(flat_e, e)
    first = torch.cumsum(count, 0) - count          # each expert's start
    rank = torch.arange(t * k, device=xf.device) - first[se]
    cap = capacity(t, cfg)
    return Dispatch(topv, topi, order, se, rank, rank < cap, count, cap)


def _counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(key, minlength=n)`` for keys in ``[0, n)``: int64
    ``[n]``, as a scatter-add, whose shape (unlike ``bincount``'s) does
    not depend on the values (the dry-run traces it on fake tensors)."""
    return torch.zeros(n, dtype=torch.int64, device=key.device).index_add_(
        0, key.to(torch.int64), torch.ones_like(key, dtype=torch.int64))


def _kept(mask: torch.Tensor, bound: int) -> torch.Tensor:
    """The indices of ``mask``'s set entries.  On a fake or meta mask
    (the dry-run) they have no values: the dispatch is counted at its
    static capacity, the first ``min(bound, numel)`` indices, ``bound``
    being the slots they fill (the reference's own buffer shape)."""
    if mask.is_meta or is_fake(mask):
        return torch.nonzero_static(mask, size=min(bound, mask.numel()))[:, 0]
    return torch.nonzero(mask).squeeze(1)


def _expert_swiglu(p, buf: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its rows: ``buf [E, cap, D]`` ->
    ``[E, cap, D]`` as batched products in ``buf``'s dtype."""
    h = F.silu(torch.bmm(buf, p.wg.to(buf.dtype)))
    h = h * torch.bmm(buf, p.wu.to(buf.dtype))
    return torch.bmm(h, p.wd.to(buf.dtype))


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig,
                seq_len: Optional[int] = None) -> torch.Tensor:
    """The MoE MLP of ``x [B, S, D]`` in ``x``'s dtype (``p`` holds
    ``router [D, E]``, ``wg``/``wu [E, D, F]``, ``wd [E, F, D]`` and, with
    shared experts, ``shared``): the reference's capacity dispatch and its
    slot ``cap - 1`` collision (module docstring), the combine in its
    order, plus the shared experts' MLP.

    On the model axis ``x`` may hold the rank's slice of a ``seq_len``-
    token sequence (sequence parallelism; the result is the slice too).
    With ``MOE_IMPL == "ep_a2a"``, experts split and M dividing the
    sequence (the reference's predicate) it runs ``moe_forward_ep`` on
    the rank's slice; otherwise the gather path on the whole sequence."""
    s = x.shape[1] if seq_len is None else seq_len
    sliced = x.shape[1] != s
    sp = p.split
    if MOE_IMPL == "ep_a2a" and sp is not None and s % sp.m == 0:
        xs = x if sliced else L.seq_slice(x)
        y = moe_forward_ep(p, xs, cfg)
        if p.shared is not None:
            y = y + L.mlp_forward(p.shared, xs)
        return y if sliced else L.gather_seq(y, s)
    if sliced:
        return L.seq_slice(_moe_batch(p, L.gather_seq(x, s), cfg))
    return _moe_batch(p, x, cfg)


def _moe_batch(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``_moe_gather`` over the global batch: where a data axis is
    installed (each rank holds a slice of the batch) the slices are
    gathered first and the rank's rows kept after, so the capacity and
    the sort see every token, as under the reference's sharded jit."""
    data = L.get_data_axis()
    if data is None or data.world == 1:
        return _moe_gather(p, x, cfg)
    n = x.shape[0]
    y = _moe_gather(p, C.gather_over(data, x[None])[0], cfg)
    return y[data.rank * n:(data.rank + 1) * n]


def _moe_gather(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``moe_forward``'s gather path on the whole sequence; with experts
    split, each rank runs its experts' rows and the outputs are
    all-gathered before the combine."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    xf = x.reshape(t, d)
    r = route(p.router, xf, cfg)
    cap = r.cap
    tok = r.order // k                             # sorted -> token
    sp = p.split
    e0, el = (sp.e0, sp.n) if sp else (0, e)
    kept = _kept(r.keep & (r.se >= e0) & (r.se < e0 + el), el * cap)
    buf = torch.zeros((el, cap, d), dtype=x.dtype, device=x.device)
    buf[r.se[kept] - e0, r.rank[kept]] = xf[tok[kept]]
    over = r.count > cap
    buf[over[e0:e0 + el], cap - 1] = 0             # the reference's collision
    out = _expert_swiglu(p, buf)
    if sp is not None:
        out = C.gather_over(L._axis(sp.m, sp.r), out[None])[0]
    # sorted -> flat: assignment i of token t sits at t k + i; its weight
    # is zero where it was dropped (the reference reads slot cap - 1 there)
    rank_c = torch.clamp(r.rank, max=cap - 1)
    w = (r.topv.reshape(-1)[r.order] * r.keep).to(x.dtype)
    contrib = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    contrib[r.order] = out[r.se, rank_c] * w[:, None]
    contrib = contrib.reshape(t, k, d)
    # the reference's scatter-add visits a token's assignments in sorted
    # (ascending expert) order, one rounding per add from a zero row
    by_expert = torch.argsort(r.topi, dim=-1)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + torch.gather(contrib, 1, by_expert[:, j, None, None]
                             .expand(t, 1, d))[:, 0]
    if _TALLY is not None and not L.recomputing():
        _TALLY.append(torch.stack([r.keep.sum(), (~r.keep).sum(),
                                   over.sum()]))
    if p.shared is not None:
        y = y + L.mlp_forward(p.shared, xf)
    return y.reshape(b, s, d)


def _sorted_slots(key: torch.Tensor, n_keys: int):
    """``(order, sorted key, slot)``: a stable sort of ``key`` (values in
    ``[0, n_keys)``) and each sorted entry's rank among its equal keys,
    the reference's ``argsort`` and ``i - searchsorted(sk, sk)``."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    count = _counts(key, n_keys)
    first = torch.cumsum(count, 0) - count
    return order, sk, torch.arange(key.numel(), device=key.device) - first[sk]


def moe_forward_ep(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's expert-parallel MoE (``moe_forward_ep``'s
    ``shard_map`` body) on this rank's tokens ``x [B, S / M, D]``,
    without the shared experts: ``[B, S / M, D]``.

    1. route the rank's ``T`` tokens (``top_k``); assignment ``i`` goes
       to rank ``dest = expert // (E / M)``; a stable sort by ``dest``
       gives each its slot, kept below ``cap = max(int(T k / M * 2) + 8,
       8)``;
    2. three ``all_to_all``s send the rows, the local expert ids and the
       valid marks;
    3. the received rows sorted stably by local expert (the empty slots
       keyed after every expert), kept below ``c2 = max(int(M cap /
       (E / M) * 2) + 8, 8)``, through ``_expert_swiglu`` as ``[E / M,
       c2, D]``;
    4. one ``all_to_all`` sends the rows home; the combine adds each
       token's weighted contributions in top-k order.

    Everything dropped past a capacity contributes zero."""
    sp = p.split
    group = L._axis(sp.m, sp.r)
    m, el = sp.m, sp.n
    bl, sl, d = x.shape
    t, k = bl * sl, cfg.top_k
    xf = x.reshape(t, d)
    topv, topi = top_k(p.router, xf, k)
    fe = topi.reshape(-1)
    fw = topv.reshape(-1).to(xf.dtype)
    cap = max(int(t * k / m * 2.0) + 8, 8)
    order, dest, slot = _sorted_slots(fe // el, m)
    ok = slot < cap
    sel = _kept(ok, m * cap)
    at = (dest[sel], slot[sel])
    send_x = xf.new_zeros((m, cap, d))
    send_x[at] = xf[order[sel] // k]
    send_e = torch.zeros((m, cap), dtype=torch.int32, device=x.device)
    send_e[at] = (fe[order[sel]] % el).to(torch.int32)
    send_m = xf.new_zeros((m, cap))
    send_m[at] = 1
    rx = C.all_to_all_over(group, send_x[None])[0].reshape(m * cap, d)
    re = group.all_to_all(send_e[None])[0].reshape(m * cap)
    rm = group.all_to_all(send_m[None])[0].reshape(m * cap)
    c2 = max(int(m * cap / el * 2.0) + 8, 8)
    key2 = (re + (1 - rm.to(torch.int32)) * el).to(torch.int64)
    order2, sk2, slot2 = _sorted_slots(key2, el + 1)
    ok2 = (slot2 < c2) & (sk2 < el)
    sel2 = _kept(ok2, el * c2)
    buf = xf.new_zeros((el, c2, d))
    buf[sk2[sel2], slot2[sel2]] = rx[order2[sel2]]
    out = _expert_swiglu(p, buf)
    back = xf.new_zeros((m * cap, d))
    back[order2[sel2]] = out[sk2[sel2], slot2[sel2]]
    home = C.all_to_all_over(group, back.reshape(1, m, cap, d))[0]
    got = home[dest, torch.clamp(slot, max=cap - 1)] * ok[:, None].to(
        xf.dtype)
    contrib = torch.empty_like(got)
    contrib[order] = got
    prod = (contrib * fw[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + prod[:, j]
    if L.recomputing():
        return y.reshape(bl, sl, d)
    if _TALLY is not None:
        dropped = (~ok).sum() + ((sk2 < el) & ~ok2).sum()
        _TALLY.append(torch.stack([t * k - dropped, dropped,
                                   torch.zeros_like(dropped)]))
    if _PLANS is not None:
        _PLANS.append({"topi": topi, "order": order, "dest": dest,
                       "slot": slot, "ok": ok, "recv_e": re, "recv_m": rm,
                       "order2": order2, "slot2": slot2, "ok2": ok2,
                       "cap": cap, "c2": c2})
    return y.reshape(bl, sl, d)


def moe_drop_rate(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Share of the ``T k`` assignments dropped by capacity (the
    reference's benchmark metric), a float32 scalar.  It does not count
    the slot ``cap - 1`` collision (``tally`` does)."""
    t = x.shape[0] * x.shape[1]
    r = route(p.router, x.reshape(t, -1), cfg)
    return (~r.keep).to(torch.float32).mean()


@contextlib.contextmanager
def tally(plans: bool = False):
    """Count every ``moe_forward`` call's dispatch inside the block:
    yields a dict that holds, on exit, ``calls``, ``assignments``,
    ``dropped`` (past capacity) and ``zeroed`` (kept but zeroed by the
    slot ``cap - 1`` collision).  The counts stay on the device until
    the exit (no host sync per call).  The gather path counts the whole
    dispatch on every rank; ``moe_forward_ep`` counts the rank's own
    assignments and the drops it makes (its tokens past ``cap``, the
    rows it received past ``c2``), so the ranks' counts sum to the whole.
    With ``plans`` it also holds ``plans``: each ``moe_forward_ep``
    call's dispatch integers (top-k experts, both sorts, slots and kept
    masks, the received expert ids and marks, ``cap`` and ``c2``)."""
    global _TALLY, _PLANS
    saved, _TALLY = _TALLY, []
    saved_plans, _PLANS = _PLANS, ([] if plans else None)
    out: dict = {}
    try:
        yield out
    finally:
        rows, _TALLY = _TALLY, saved
        if plans:
            out["plans"], _PLANS = _PLANS, saved_plans
        kept, dropped, zeroed = (torch.stack(rows).sum(0).tolist() if rows
                                 else (0, 0, 0))
        out.update(calls=len(rows), assignments=kept + dropped,
                   dropped=dropped, zeroed=zeroed)


class MoEMLP(nn.Module):
    """``router [D, E]``, the experts' ``wg``/``wu [E, D, F]`` and ``wd
    [E, F, D]``, and with shared experts ``shared``, one SwiGLU MLP of
    width ``n_shared_experts x d_ff_expert``.  Built on a model axis that
    divides the experts, the rank's ``E / M`` of them (``split``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        m, r = L.model_axis()
        # every rank holds all experts where M does not divide them
        self.split = sp = (ExpertSplit(m, r, r * (e // m), e // m)
                           if m > 1 and e % m == 0 else None)
        el = sp.n if sp else e

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))
        self.router = zeros(d, e)
        self.wg = zeros(el, d, f)
        self.wu = zeros(el, d, f)
        self.wd = zeros(el, f, d)
        if sp is not None:
            for w in (self.wg, self.wu, self.wd):
                L.split_param(w, 0, sp.e0, e)
        self.shared = (MLP(cfg, device, d_ff=cfg.n_shared_experts * f)
                       if cfg.n_shared_experts else None)


class MoEBlock(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + moe(norm(x))``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.moe = MoEMLP(cfg, device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))

    def forward(self, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor,
                cache=None, cache_pos=None):
        """``(x', new_cache)`` for activations ``x [B, L, D]``."""
        h, new_cache = L.attn_forward(
            self.attn, L.rmsnorm(self.ln1, x, cfg.norm_eps), cfg, pos=pos,
            cache=cache, cache_pos=cache_pos)
        x = x + h
        x = x + moe_forward(self.moe, L.rmsnorm(self.ln2, x, cfg.norm_eps),
                            cfg, pos.shape[1])
        return x, new_cache


class Qwen3MoeLM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, ``n_layers`` MoE blocks, the
    final norm ``norm_f`` and, untied (qwen3-moe), the read-out ``head
    [D, V_pad]``; built on ``device`` (the card unless the caller asks for
    the CPU).  The KV cache is the dense LM's."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "moe" or cfg.kv_lora_rank:
            raise ValueError(f"Qwen3MoeLM needs a moe config without MLA, "
                             f"got {cfg.name!r} ({cfg.family})")
        device = resolve_device(device)
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.layers = nn.ModuleList(MoEBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    def forward_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward: ``tokens [B, S]`` -> float32 logits
        ``[B, S, V_pad]``; with ``use_flash_attention`` each layer runs
        ``ops.flash_attention`` once (both lengths multiples of 128)."""
        b, s = tokens.shape
        x = L.shard_batch(L.embed_tokens(self.tok, tokens))
        pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        for block in self.layers:
            x = L.maybe_remat(lambda x, b=block: b(x, self.cfg, pos)[0],
                              self.cfg)(x)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), self.cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` against ``batch["labels"]``."""
        return L.lm_loss(self.forward_train(batch["tokens"]), batch["labels"])

    def init_cache(self, batch: int, seq: int) -> dict:
        """Zeroed bfloat16 KV cache: ``k``/``v [L, B, S, Hkv Dh]`` (the
        rank's kv heads of a head-split model)."""
        return kv_cache(self.cfg, self.cfg.n_layers, batch, seq,
                        self.tok.device, self.layers[0].attn.split)

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens [B, 1]`` at position ``pos`` ->
        ``(logits [B, V_pad], cache)``; the cache is written in place."""
        b = tokens.shape[0]
        x = L.embed_tokens(self.tok, tokens)
        qpos = torch.full((b, 1), pos, dtype=torch.int64, device=tokens.device)
        for i, block in enumerate(self.layers):
            x, _ = block(x, self.cfg, qpos,
                         cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
        logits = L.lm_head(self.tok, self.norm_f, x, self.cfg, self.head)
        return logits[:, 0], cache



def init_moe_mlp(p: MoEMLP, gen: torch.Generator) -> None:
    """The reference's MoE scales: router x 0.006, experts and the shared
    MLP x 0.02."""
    L.draw(p.router, gen, 0.006)
    for w in (p.wg, p.wu, p.wd):
        L.draw(w, gen, 0.02)
    if p.shared is not None:
        for w in (p.shared.wg, p.shared.wu, p.shared.wd):
            L.draw(w, gen, 0.02)


def init_qwen3_moe(cfg: ModelConfig, seed: int = 0, device="cuda"
                   ) -> Qwen3MoeLM:
    """A ``Qwen3MoeLM`` on ``device`` with the reference's init scales
    (``tok`` and ``head`` x 0.01, attention and experts x 0.02, the router
    x 0.006, norms 1), drawn in place from a generator on ``device``
    seeded with ``seed``: the full config holds ~120 GB of float32
    weights, so they are not drawn on the host.  One seed gives the same
    weights on one device type, not across them (the draws also differ
    from ``repro.models.moe.init_qwen3_moe``'s): use ``convert`` or a
    state dict to share weights."""
    model = Qwen3MoeLM(cfg, device)
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        for block in model.layers:
            for w in (block.attn.wq, block.attn.wk, block.attn.wv,
                      block.attn.wo):
                L.draw(w, gen, 0.02)
            init_moe_mlp(block.moe, gen)
    return model
