"""Building blocks of the LMs (port of ``repro/models/layers.py``).

Plain functions on tensors.  Weights keep the reference's ``x @ W``
layout (``[d_in, d_out]``) and stay float32; activations run in
``COMPUTE_DTYPE`` (bfloat16, as in the reference), with the norms, rope,
softmax and logits in float32.  The attention's full-sequence branch is
``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
twin on the CPU; ``chunked_attention`` (``set_attn_impl("chunked")``)
is the reference's query-blocked plain path.

**The model axis** (the reference's ``set_mesh``/``shard*`` helpers).
``set_mesh(group)`` installs a ``WorkerGroup`` of M ranks, one process
each (``ProcessWorkers`` under ``--dist gloo|nccl``; none by default).
A module built while it is installed holds THIS rank's shard of the
single-process weights, and its forward runs the collectives:

* ``set_shard_heads(True)`` (the reference's ``shard_heads``): an
  attention whose ``n_heads`` divides M holds ``n_heads / M`` query
  heads (the columns of ``wq``), its kv heads' slice where ``n_kv_heads``
  divides M and all of them otherwise (each local query head reads kv
  head ``h // group`` of the whole set), and the matching rows of
  ``wo``; the rank's partial output is summed by one ``all_reduce``.
  Its KV cache holds the rank's kv heads: the reference's
  ``cache_pspec`` split of the trailing ``Hkv Dh`` axis.
* ``set_seq_parallel(True)`` (the reference's ``SEQ_PARALLEL``): where M
  divides the sequence, the residual stream between blocks holds this
  rank's ``S / M`` slice (``shard_batch``).  A block gathers what needs
  the whole sequence (self-attention's keys, the SSM scan) with one
  ``all_gather`` and hands back its slice; token-wise layers run on the
  slice.  A sequence that does not divide leaves everything whole.
* the MoE layers' experts split ``E / M`` per rank (``models/moe.py``).

A weight that holds a slice carries ``.shard`` (``Shard``): ``draw``
draws the whole tensor from the generator and keeps the slice, so a
rank's init is exactly its slice of the single-process init, one tensor
at a time, and ``convert`` slices the reference's arrays the same way.

**Training over the model axis.**  The collectives above run under
autograd (``core.collectives.sum_over``, ``gather_over``,
``all_to_all_over``), each backward its forward's adjoint: the head sum
sums the ranks' gradients, ``gather_seq``'s backward is the
reduce-scatter, a sequence slice's is its zero padding, EP's all-to-all
sends the gradients back.  So a rank's gradient is the derivative of
the SUM of the ranks' objectives: ``train/fsdp.py`` seeds the
replicated loss ``1 / M`` on each rank and sums over the ranks the
gradient of every weight they all hold whole.  ``set_data_axis(group)``
installs a training mesh's data axis, whose ranks each hold a slice of
the batch: the MoE's gather path then dispatches the global batch.

``maybe_remat(fn, cfg)`` (the reference's) checkpoints a layer body
under autograd: ``cfg.remat == "full"`` recomputes all of it in the
backward, ``"dots"`` keeps the outputs of its 2-D matrix products
(``aten.mm``/``aten.addmm``, the counterpart of
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest, batched
products included.  While a body is recomputed ``recomputing()`` is
True, so that counters (``moe.tally``) count each dispatch once.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import collectives as C
from ..core.config import ModelConfig
from ..kernels import ops

#: activation dtype of the forward and decode paths (tests set float32
#: here and in the reference to compare the two without bf16 rounding)
COMPUTE_DTYPE = torch.bfloat16
_NEG = -1e30

# ------------------------------------------------------------ model axis --
_MESH = None
#: a training mesh's data axis, where it splits the batch (the MoE's
#: gather path dispatches the global batch, as the reference's does)
_DATA = None
#: split attention heads over the model axis (the reference's variant)
SHARD_HEADS = False
#: shard the residual stream's sequence axis over the model axis
SEQ_PARALLEL = False
#: ``"naive"`` or ``"chunked"`` (``gqa_attention``'s non-flash branch)
ATTN_IMPL = "naive"
ATTN_IMPLS = ("naive", "chunked")


def set_mesh(group) -> None:
    """Install the model axis: a ``WorkerGroup`` with one worker per
    process (``ProcessWorkers``), or None for one process."""
    global _MESH
    if group is not None and group.local != 1:
        raise ValueError(f"the model axis holds one rank per process: "
                         f"got a group with {group.local} local workers")
    _MESH = group


def get_mesh():
    """The installed model-axis group, or None."""
    return _MESH


def set_data_axis(group) -> None:
    """Install the data axis whose ranks each hold a slice of the batch
    (``ProcessWorkers``), or None."""
    global _DATA
    _DATA = group


def get_data_axis():
    """The installed data-axis group, or None."""
    return _DATA


def model_axis():
    """``(M, rank)`` of the installed model axis; ``(1, 0)`` without."""
    return (1, 0) if _MESH is None else (_MESH.world, _MESH.rank)


def set_shard_heads(on: bool) -> None:
    """Split attention heads over the model axis in modules built from
    now on."""
    global SHARD_HEADS
    SHARD_HEADS = bool(on)


def set_seq_parallel(on: bool) -> None:
    """Keep a rank's slice of the sequence between blocks."""
    global SEQ_PARALLEL
    SEQ_PARALLEL = bool(on)


def set_attn_impl(impl: str) -> None:
    """``gqa_attention``'s non-flash path: ``"naive"`` or ``"chunked"``."""
    global ATTN_IMPL
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTN_IMPLS}, "
                         f"got {impl!r}")
    ATTN_IMPL = impl


def _axis(m: int, r: int):
    """The installed group, checked against a module built for rank ``r``
    of ``m``."""
    if _MESH is None or (_MESH.world, _MESH.rank) != (m, r):
        raise RuntimeError(f"a module built as rank {r} of a model axis of "
                           f"{m} runs under model axis {model_axis()}: "
                           f"install its group with set_mesh")
    return _MESH


class Shard(NamedTuple):
    """The slice ``[start, start + n)`` of axis ``dim`` (of length
    ``full``) that a weight of this rank holds."""
    dim: int
    start: int
    full: int


def split_param(p: torch.Tensor, dim: int, start: int, full: int
                ) -> torch.Tensor:
    """Mark ``p`` as the slice of axis ``dim`` from ``start`` of a weight
    whose axis is ``full`` long; returns ``p``."""
    p.shard = Shard(dim, start, full)
    return p


def take(p: torch.Tensor, a):
    """``p``'s slice of the whole weight ``a`` (numpy or torch): ``a``
    itself for an unsplit weight."""
    spec = getattr(p, "shard", None)
    if spec is None:
        return a
    idx = [slice(None)] * len(a.shape)
    idx[spec.dim] = slice(spec.start, spec.start + p.shape[spec.dim])
    return a[tuple(idx)]


class HeadSplit(NamedTuple):
    """A rank's attention heads: query heads ``[q0, q0 + nq)`` and kv
    heads ``[kv0, kv0 + nkv)`` (all of them when ``kv_whole``) of a layer
    with ``n_heads`` query heads, on rank ``r`` of ``m``."""
    m: int
    r: int
    q0: int
    nq: int
    kv0: int
    nkv: int
    kv_whole: bool
    n_heads: int


def head_split(n_heads: int, n_kv_heads: Optional[int] = None
               ) -> Optional[HeadSplit]:
    """This rank's heads under ``SHARD_HEADS`` on the installed axis, or
    None (no axis, the switch off, or ``n_heads`` not a multiple of M:
    the layer stays whole, as the reference's ``shard_heads`` no-op).
    ``n_kv_heads`` None: one kv head per query head (MLA)."""
    m, r = model_axis()
    if m == 1 or not SHARD_HEADS or n_heads % m:
        return None
    nq = n_heads // m
    hkv = n_heads if n_kv_heads is None else n_kv_heads
    if hkv % m == 0:
        return HeadSplit(m, r, r * nq, nq, r * (hkv // m), hkv // m, False,
                         n_heads)
    return HeadSplit(m, r, r * nq, nq, 0, hkv, True, n_heads)


def reduce_heads(out: torch.Tensor, split: Optional[HeadSplit]
                 ) -> torch.Tensor:
    """Sum a head-split layer's partial output over the model axis (one
    ``all_reduce``); the identity for a whole layer."""
    if split is None:
        return out
    return C.sum_over(_axis(split.m, split.r), out[None])[0]


def seq_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's ``1 / M`` of axis 1 of ``x``."""
    m, r = model_axis()
    n = x.shape[1] // m
    return x[:, r * n:(r + 1) * n]


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``shard_batch`` of a ``[B, S, ...]`` residual:
    this rank's ``S / M`` slice of the sequence under ``SEQ_PARALLEL`` on
    an axis of M > 1 that divides ``S``, else ``x`` itself."""
    m = model_axis()[0]
    if not SEQ_PARALLEL or m == 1 or x.ndim < 3 or x.shape[1] % m:
        return x
    return seq_slice(x)


def gather_seq(x: torch.Tensor, s: int) -> torch.Tensor:
    """The whole ``s``-token sequence of a residual ``x [B, S', ...]``:
    one ``all_gather`` over the model axis where ``x`` holds a rank's
    slice (``S' < s``), else ``x`` itself."""
    if x.shape[1] == s:
        return x
    got = C.gather_over(get_mesh(), x.transpose(0, 1).contiguous()[None])
    return got[0].transpose(0, 1)


def seq_apply(fn, x: torch.Tensor, s: int) -> torch.Tensor:
    """``fn`` (a layer that needs the whole sequence) of a residual that
    may hold a rank's slice: gathered, run, and sliced back."""
    if x.shape[1] == s:
        return fn(x)
    return shard_batch(fn(gather_seq(x, s)))


# ----------------------------------------------------------------- remat --
_RECOMPUTING = False


def recomputing() -> bool:
    """True while ``maybe_remat`` recomputes a layer body in the
    backward."""
    return _RECOMPUTING


def _dots_policy(ctx, op, *args, **kwargs):
    """``"dots"``: keep 2-D matrix products, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` (a layer body of tensors) checkpointed as ``cfg.remat``
    says (module docstring): ``fn`` itself for ``"none"`` or without
    autograd, else ``torch.utils.checkpoint.checkpoint`` (non-reentrant;
    ``"dots"`` with the selective policy).  The recompute runs with
    ``recomputing()`` True."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        calls = []

        def body(*a):
            global _RECOMPUTING
            if not calls:
                calls.append(1)
                return fn(*a)
            saved, _RECOMPUTING = _RECOMPUTING, True
            try:
                return fn(*a)
            finally:
                _RECOMPUTING = saved
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``w * x / rms(x)`` with float32 statistics and product, cast back
    to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (w * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Rotary frequencies ``theta ** (-2i / Dh)`` for ``i < Dh / 2``."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate ``x [..., L, H, Dh]`` by integer positions ``pos [..., L]``
    in the rotate-half layout: ``[x1 cos - x2 sin, x1 sin + x2 cos]`` over
    the two halves of Dh (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = pos[..., None].to(torch.float32) * freqs       # [..., L, Dh/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., L, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, block: int = 512) -> torch.Tensor:
    """The reference's ``chunked_attention``: the plain attention one
    query block at a time, so the ``[B, H, Lq, Lk]`` scores never exist
    whole (the peak is ``[B, H, block, Lk]``).  ``block`` is cut to
    ``Lq``, and an ``Lq`` it does not divide runs as one block.  Logits
    in float32, scaled after the cast, causal with offset ``Lk - Lq``.
    Under autograd each block runs in ``torch.utils.checkpoint``, so the
    backward recomputes its scores instead of keeping them."""
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    blk = min(block, lq)
    if lq % blk:
        blk = lq
    qb = q.reshape(b, lq // blk, blk, hkv, group, dh)
    scale = 1.0 / (dh ** 0.5)

    def one_block(qi: torch.Tensor, start: int) -> torch.Tensor:
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qi, k).to(torch.float32)
        logits = logits * scale
        if causal:
            rows = (start + torch.arange(blk, device=q.device)[:, None]
                    + (lk - lq))
            cols = torch.arange(lk, device=q.device)[None, :]
            logits = torch.where(rows >= cols, logits, _NEG)
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v)

    grad = torch.is_grad_enabled()
    outs = [checkpoint(one_block, qb[:, i], i * blk, use_reentrant=False)
            if grad else one_block(qb[:, i], i * blk)
            for i in range(lq // blk)]
    return torch.stack(outs, dim=1).reshape(b, lq, hq, v.shape[-1])


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, use_flash: bool = False,
                  kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention: ``q [B, Lq, Hq, Dh]``, ``k``/``v [B, Lk,
    Hkv, Dh]`` -> ``[B, Lq, Hq, Dh]``.

    With ``use_flash``, no ``kv_valid_len`` and both lengths multiples of
    128 (the reference's own predicate) it runs ``ops.flash_attention`` on
    ``[B, H, L, Dh]`` views of the operands (no copy: the card's bf16
    kernel reads these strides in place and returns the view of a
    ``[B, Lq, Hq, Dh]`` tensor, so the transpose back is contiguous).
    Otherwise, with ``ATTN_IMPL == "chunked"``, no ``kv_valid_len`` and
    ``Lq > 512``, ``chunked_attention``.  Otherwise the plain masked path:
    logits in float32, scaled after the cast, causal with offset ``Lk -
    Lq``, keys at or past ``kv_valid_len`` masked (decode against a
    cache), softmax in float32 and cast to the compute dtype before
    ``p @ v``."""
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if use_flash and kv_valid_len is None and lq % 128 == 0 \
            and lk % 128 == 0:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    if ATTN_IMPL == "chunked" and kv_valid_len is None and lq > 512:
        return chunked_attention(q, k, v, causal)
    qg = q.reshape(b, lq, hkv, hq // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = logits * (1.0 / dh ** 0.5)
    if causal and lq > 1:
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits, _NEG)
    if kv_valid_len is not None:
        valid = torch.arange(lk, device=q.device) < kv_valid_len
        logits = torch.where(valid, logits, _NEG)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, lq, hq, v.shape[-1])


def kv_for_heads(k: torch.Tensor, split: Optional[HeadSplit],
                 n_kv_heads: int) -> torch.Tensor:
    """The kv heads ``[B, L, Hkv', Dh]`` a rank's query heads read: ``k``
    itself unless ``split`` keeps the kv heads whole, then the kv head of
    each local query head (``h // group``), one per query head."""
    if split is None or not split.kv_whole:
        return k
    group = split.n_heads // n_kv_heads
    idx = torch.arange(split.q0, split.q0 + split.nq,
                       device=k.device) // group
    return k.index_select(2, idx)


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, *, pos: torch.Tensor,
                 causal: bool = True, rope: bool = True,
                 kv_x: Optional[torch.Tensor] = None,
                 cache: Optional[tuple] = None,
                 cache_pos: Optional[int] = None):
    """Self- or cross-attention of ``x [B, L, D]``; ``p`` holds ``wq``,
    ``wk``, ``wv``, ``wo`` and ``split`` (its ``HeadSplit`` or None).
    Returns ``(out, new_cache)``.

    Keys and values are projected from ``kv_x [B, Lk, D]`` when it is
    given (cross-attention), else from ``x``.  With ``rope`` the queries
    and keys are roped at ``pos [B, L]`` (the keys at ``cache_pos`` with
    a cache); without it neither is (the cross-attention of the VLM and
    Whisper).  The attention is causal only when ``causal`` is set and no
    cache is given.

    With ``cache = (k_cache, v_cache)`` (``[B, S, Hkv * Dh]`` bfloat16)
    the step's keys are roped at ``cache_pos``, written into the cache IN
    PLACE at ``cache_pos`` (the reference returns an updated copy; the
    port saves the copy), and the query attends over the whole cache with
    keys from ``cache_pos + L`` on masked.

    On the model axis: a head-split layer computes its heads only (its
    cache holds its kv heads) and sums the output over the ranks; where
    ``x`` holds a rank's slice of the sequence (``pos`` is the whole
    sequence's), self-attention gathers the sequence first and returns
    the rank's slice, and cross-attention, whose queries need no other
    token, runs on the slice as it is."""
    sp = getattr(p, "split", None)
    sliced = x.shape[1] != pos.shape[1]
    if sliced:
        if kv_x is None:
            x = gather_seq(x, pos.shape[1])
        else:
            pos = seq_slice(pos)
    b, l, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = (sp.nq, sp.nkv) if sp else (cfg.n_heads, cfg.n_kv_heads)
    src = x if kv_x is None else kv_x
    lk = src.shape[1]
    q = (x @ p.wq.to(x.dtype)).reshape(b, l, hq, hd)
    k = (src @ p.wk.to(x.dtype)).reshape(b, lk, hkv, hd)
    v = (src @ p.wv.to(x.dtype)).reshape(b, lk, hkv, hd)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        kpos = pos if cache is None else torch.full(
            (b, lk), cache_pos, dtype=pos.dtype, device=pos.device)
        k = apply_rope(k, kpos, cfg.rope_theta)
    new_cache = kv_valid = None
    if cache is not None:
        kc, vc = cache
        kc[:, cache_pos:cache_pos + l] = k.reshape(b, l, -1).to(kc.dtype)
        vc[:, cache_pos:cache_pos + l] = v.reshape(b, l, -1).to(vc.dtype)
        new_cache = (kc, vc)
        k = kc.reshape(b, kc.shape[1], hkv, hd).to(x.dtype)
        v = vc.reshape(b, vc.shape[1], hkv, hd).to(x.dtype)
        kv_valid = cache_pos + l
    k, v = (kv_for_heads(t, sp, cfg.n_kv_heads) for t in (k, v))
    out = gqa_attention(q, k, v, causal=causal and cache is None,
                        use_flash=cfg.use_flash_attention,
                        kv_valid_len=kv_valid)
    out = reduce_heads(out.reshape(b, l, hq * hd) @ p.wo.to(x.dtype), sp)
    if sliced and kv_x is None:
        out = seq_slice(out)
    return out, new_cache


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU in the compute dtype: ``(silu(x Wg) * x Wu) Wd``; ``p`` holds
    ``wg``, ``wu``, ``wd``."""
    h = F.silu(x @ p.wg.to(x.dtype)) * (x @ p.wu.to(x.dtype))
    return h @ p.wd.to(x.dtype)


def draw(p: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill the weight ``p`` in place with normal draws x ``scale`` from
    ``gen`` (a generator on ``p``'s device).  A rank's slice (``.shard``)
    draws the whole weight and keeps its slice: the single-process
    draws, the generator left where the single process leaves it."""
    spec = getattr(p, "shard", None)
    if spec is None:
        p.normal_(0.0, scale, generator=gen)
        return
    shape = list(p.shape)
    shape[spec.dim] = spec.full
    whole = torch.empty(shape, dtype=p.dtype, device=p.device)
    p.copy_(take(p, whole.normal_(0.0, scale, generator=gen)))


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """``vocab_size`` rounded up to a multiple of ``multiple``."""
    return -(-cfg.vocab_size // multiple) * multiple


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the float32 table ``tok`` in ``COMPUTE_DTYPE``.  The
    reference casts the whole table before the gather; gathering first
    gives the same values for a fraction of the bytes."""
    return tok[tokens].to(COMPUTE_DTYPE)


def lm_head(tok: torch.Tensor, norm_f: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig, head: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Final norm and the read-out: tied ``x @ tok.T``, or with untied
    embeddings ``x @ head`` (``head [D, V_pad]``); float32 logits over the
    padded vocab."""
    x = rmsnorm(norm_f, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return (x @ tok.to(x.dtype).T).to(torch.float32)
    if head is None:
        raise ValueError(f"{cfg.name!r} has untied embeddings: lm_head "
                         f"needs its head [D, V_pad]")
    return (x @ head.to(x.dtype)).to(torch.float32)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the PADDED vocab (labels < the true
    vocab)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return nll.mean()
