"""Mamba-2 (SSD, state-space duality) LM (port of ``repro/models/ssm.py``):
mamba2-1.3b.

The reference stacks every layer's weights on a leading ``[L]`` axis and
scans over them; here each layer is its own ``MambaBlock`` in an
``nn.ModuleList`` and the forward is a Python loop.  Weights are float32
in the reference's ``[d_in, d_out]`` layout, so
``repro_torch.convert.mamba_params_from_numpy`` copies them across.

The full-sequence forward runs the SSD recurrence through ``SSDScan``,
whose forward is ``kernels.ops.ssd_scan``: the hand-written CUDA kernel
on the card, its plain twin (``ref.ssd_scan_ref``, the chunked form of
the reference's ``ssd_chunked``) on the CPU.  Its backward is the
reference's gradient: the vjp of ``ssd_chunked`` (ported here as plain
torch, as ``jax.grad`` differentiates the reference's jnp form),
recomputed from the saved inputs.  Decode is the O(1)-state recurrence
in plain ops, as in the reference, with the cache ``{"ssm" [L, B, H, P,
N] float32, "conv" [L, B, W - 1, C] bfloat16}`` written in place.  The
casts follow the reference step by step: the input projection, the
causal conv, ``silu`` and the skip in ``layers.COMPUTE_DTYPE``; ``dt``,
the SSD operands and the state in float32.

On the model axis (``layers.set_mesh``) every Mamba layer and its state
are replicated on every rank, as the reference's mesh variants leave
them; under sequence parallelism each layer gathers the sequence for its
scan and keeps the rank's slice of its output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig, resolve_device
from ..kernels import ops
from . import layers as L


def dims(cfg: ModelConfig):
    """``(d_in, H, P, N)``: the expanded width, SSM heads, head dim and
    state width of ``cfg`` (the reference's defaults: P 64, H = d_in /
    P)."""
    d_in = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim or 64
    h = cfg.ssm_heads or d_in // p
    return d_in, h, p, cfg.ssm_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it (torch's
    ``F.softplus`` returns ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in two rounded steps, as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def causal_conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of ``x [B, L, C]`` with taps ``k [W, C]`` in
    ``x``'s dtype, accumulated in the reference's order: ``x k[-1]``, then
    ``+ shift_i(x) k[-1-i]`` for i = 1 .. W-1 (``F.conv1d`` would sum in
    another order)."""
    w = k.shape[0]
    out = x * k[-1]
    for i in range(1, w):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted * k[-1 - i]
    return out


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int
                ) -> torch.Tensor:
    """Chunked SSD in plain torch, the reference's ``ssd_chunked`` step
    by step: ``x [B, L, H, P]``, ``dt [B, L, H]`` (> 0), ``a [H]`` (< 0),
    ``bm``/``cm [B, L, N]``, all float32 -> ``y [B, L, H, P]``.

    Within a chunk of ``Q = min(chunk, L)`` rows: ``cum = cumsum(a dt)``,
    the masked decay ``L = exp(cum_i - cum_j) dt_j`` for ``j <= i`` and
    ``y = ((C B^T) * L) x``; each chunk's state summary ``(x w)^T B`` with
    ``w = dt exp(cum_{Q-1} - cum)`` and decay ``exp(cum_{Q-1})``; the
    inter-chunk scan (a loop over chunks: ``compose`` is associative, so
    only the rounding order differs from ``lax.associative_scan``), its
    exclusive shift, and ``(C exp(cum)) state^T`` added to each chunk's
    rows.  One departure, which changes no finite value: the exponent of
    the masked entries (``j > i``, where ``cum_i - cum_j > 0``) is set to
    ``-inf`` before ``exp`` instead of zeroing ``exp`` after it, so that
    no ``inf`` (a chunk whose decay passes e^88) meets a zero cotangent in
    the backward; the reference's form gives NaN gradients there."""
    bsz, l, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"ssd_chunked needs L a multiple of the chunk: "
                         f"L = {l}, chunk {q}")
    nc = l // q
    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    br = bm.reshape(bsz, nc, q, n)
    cr = cm.reshape(bsz, nc, q, n)
    adt = a[None, None, None, :] * dtr                          # [B,NC,Q,H]
    cum = torch.cumsum(adt, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,NC,Q,Q,H]
    ii = torch.arange(q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    l_mat = torch.exp(torch.where(tri, seg, -torch.inf)) \
        * dtr[:, :, None, :, :]
    scores = torch.einsum("bnqc,bnkc->bnqk", cr, br)[..., None] * l_mat
    y = torch.einsum("bnqkh,bnkhp->bnqhp", scores, xr)
    w = dtr * torch.exp(cum[:, :, -1:, :] - cum)                # [B,NC,Q,H]
    s_c = torch.einsum("bnqhp,bnqk,bnqh->bnhpk", xr, br, w)     # [B,NC,H,P,N]
    total = torch.exp(cum[:, :, -1, :])                         # [B,NC,H]
    state = torch.zeros_like(s_c[:, 0])
    prev = []
    for c in range(nc):            # the state BEFORE chunk c
        prev.append(state)
        state = state * total[:, c, :, None, None] + s_c[:, c]
    st_prev = torch.stack(prev, dim=1)
    y = y + torch.einsum("bnqk,bnqh,bnhpk->bnqhp", cr, torch.exp(cum),
                         st_prev)
    return y.reshape(bsz, l, h, p)


class SSDScan(torch.autograd.Function):
    """The SSM layer's SSD with the reference's gradient.

    Forward: ``ops.ssd_scan`` on the operands as the layer hands them
    (x, b and c in the compute dtype, dt and a float32): the CUDA kernel
    on the card (bfloat16 to the tensor-core route, float32 to the SIMT
    one), its twin on the CPU; the result in x's dtype.  Only the inputs
    are saved.  Backward: ``ssd_chunked`` recomputed from them under
    autograd, with the reference's casts (x, b and c to float32 in, the
    cotangent to float32), and its vjp; the gradients of x, b and c come
    back in their own dtype (the transpose of ``astype(float32)``), dt's
    and a's in float32."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk: int):
        """``y [B, L, H, P]`` in x's dtype."""
        ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        ctx.chunk = chunk
        return ops.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        """The vjp of ``ssd_chunked`` at the saved inputs; ``None`` for
        the chunk."""
        saved = ctx.saved_tensors
        f32 = torch.float32
        with torch.enable_grad():
            ins = [t.detach().to(f32).requires_grad_() for t in saved]
            y = ssd_chunked(*ins, ctx.chunk)
            grads = torch.autograd.grad(y, ins, gy.to(f32))
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None)


def ssd_operands(conv_out: torch.Tensor, heads: int, head_dim: int,
                 state: int):
    """``(xh [B, L, H, P], b [B, L, N], c [B, L, N])``: the SSD's operands
    as views of the conv output ``conv_out [B, L, H P + 2N]`` (no copy:
    the card's bfloat16 kernel reads these strides in place)."""
    bsz, l, _ = conv_out.shape
    xc, bmat, cmat = torch.split(conv_out, [heads * head_dim, state, state],
                                 dim=-1)
    return xc.reshape(bsz, l, heads, head_dim), bmat, cmat


class MambaBlock(nn.Module):
    """One mamba2 block: ``w_in [D, 2 d_in + 2N + H]``, ``conv_k [W,
    d_in + 2N]``, ``a_log``/``d_skip``/``dt_bias [H]``, ``w_out [d_in,
    D]`` and the pre-norm ``ln [D]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = dims(cfg)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))
        self.w_in = zeros(d, 2 * d_in + 2 * n + h)
        self.conv_k = zeros(cfg.conv_width, d_in + 2 * n)
        self.a_log = zeros(h)
        self.d_skip = nn.Parameter(torch.ones(h, device=device))
        self.dt_bias = zeros(h)
        self.w_out = zeros(d_in, d)
        self.ln = nn.Parameter(torch.ones(d, device=device))

    def _project(self, x: torch.Tensor, cfg: ModelConfig):
        """``(z, conv_in, dt_raw)`` of the input projection of ``x [...,
        D]``: the gate, the conv channels ``[xc | b | c]`` and the raw dt."""
        d_in, h, _, n = dims(cfg)
        z_all = x @ self.w_in.to(x.dtype)
        z, xc, bmat, cmat, dt = torch.split(z_all, [d_in, d_in, n, n, h],
                                            dim=-1)
        return z, torch.cat([xc, bmat, cmat], dim=-1), dt

    def _out(self, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
        """Skip, gate and output projection: ``(y + xh D) silu(z) W_out``
        in the compute dtype (``y``, ``xh`` with heads split)."""
        d_in = dims(cfg)[0]
        y = y + xh * self.d_skip.to(xh.dtype)[:, None]
        y = y.reshape(*y.shape[:-2], d_in) * silu(z)
        return y @ self.w_out.to(y.dtype)

    def mamba_train(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The block over a full sequence: ``x [B, L, D]`` -> ``[B, L, D]``
        (the SSD through ``SSDScan`` on views of the conv output, in the
        compute dtype; its result comes back in that dtype)."""
        _, h, pdim, n = dims(cfg)
        z, conv_in, dt = self._project(x, cfg)
        conv_out = silu(causal_conv(conv_in, self.conv_k.to(x.dtype)))
        xh, bmat, cmat = ssd_operands(conv_out, h, pdim, n)
        dt = softplus(dt.to(torch.float32) + self.dt_bias)
        a = -torch.exp(self.a_log)
        y = SSDScan.apply(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
        return self._out(y, xh, z, cfg)

    def mamba_decode(self, x: torch.Tensor, cfg: ModelConfig,
                     ssm: torch.Tensor, conv: torch.Tensor):
        """One recurrent step: ``x [B, 1, D]``, state ``ssm [B, H, P, N]``
        float32 and conv history ``conv [B, W-1, C]`` in ``x``'s dtype ->
        ``(out [B, 1, D], ssm', conv')``.  Cost independent of the
        history's length."""
        bsz = x.shape[0]
        d_in, h, pdim, n = dims(cfg)
        z, conv_in, dt = self._project(x[:, 0], cfg)
        hist = torch.cat([conv, conv_in[:, None]], dim=1)        # [B, W, C]
        # the reference's einsum: one float32 sum over the taps, one rounding
        conv_out = silu(torch.einsum(
            "bwc,wc->bc", hist.to(torch.float32),
            self.conv_k.to(x.dtype).to(torch.float32)).to(x.dtype))
        xc, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)
        dt = softplus(dt.to(torch.float32) + self.dt_bias)       # [B, H]
        a = -torch.exp(self.a_log)
        xh = xc.reshape(bsz, h, pdim).to(torch.float32)
        decay = torch.exp(a[None] * dt)
        upd = dt[..., None, None] * (
            xh[..., None] * bmat.to(torch.float32)[:, None, None, :])
        ssm = ssm * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", ssm,
                         cmat.to(torch.float32)).to(x.dtype)
        out = self._out(y, xh.to(x.dtype), z, cfg)
        return out[:, None], ssm, hist[:, 1:]

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig,
                    ssm: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
        """The residual step of the block: ``x + mamba_decode(norm(x))``
        for ``x [B, 1, D]``, with the layer's cache views ``ssm [B, H, P,
        N]`` float32 and ``conv [B, W - 1, C]`` bfloat16 updated in place
        (the history read in ``x``'s dtype and stored back in bfloat16, as
        the reference's cache does)."""
        h, new_ssm, new_conv = self.mamba_decode(
            L.rmsnorm(self.ln, x, cfg.norm_eps), cfg, ssm, conv.to(x.dtype))
        ssm.copy_(new_ssm)
        conv.copy_(new_conv.to(torch.bfloat16))
        return x + h


def mamba_body(blk: MambaBlock, x: torch.Tensor, cfg: ModelConfig,
               s: int) -> torch.Tensor:
    """One Mamba layer of the full-sequence forward (the reference's
    ``body``, ``maybe_remat``'s unit): ``x + mamba_train(norm(x))``, the
    scan over the whole ``s``-token sequence where ``x`` holds a rank's
    slice of it."""
    return x + L.seq_apply(lambda z: blk.mamba_train(z, cfg),
                           L.rmsnorm(blk.ln, x, cfg.norm_eps), s)


class Mamba2LM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, ``n_layers`` mamba2 blocks, the
    final norm ``norm_f`` and, with untied embeddings (mamba2-1.3b), the
    read-out ``head [D, V_pad]``; built on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2LM needs an ssm config, got "
                             f"{cfg.name!r} ({cfg.family})")
        device = resolve_device(device)
        self.cfg = cfg
        v, d = L.padded_vocab(cfg), cfg.d_model
        self.tok = nn.Parameter(torch.zeros(v, d, device=device))
        self.norm_f = nn.Parameter(torch.ones(d, device=device))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.zeros(d, v, device=device)))
        self.layers = nn.ModuleList(MambaBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    def forward_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward: ``tokens [B, S]`` -> float32 logits
        ``[B, S, V_pad]``; every layer runs ``ops.ssd_scan`` once.  On
        the model axis the layers are replicated: under sequence
        parallelism each gathers the sequence for its scan and keeps the
        rank's slice of its output."""
        s = tokens.shape[1]
        x = L.shard_batch(L.embed_tokens(self.tok, tokens))
        for blk in self.layers:
            x = L.maybe_remat(lambda x, b=blk: mamba_body(b, x, self.cfg, s),
                              self.cfg)(x)
        return L.lm_head(self.tok, self.norm_f, L.gather_seq(x, s), self.cfg,
                         self.head)

    def loss(self, batch: dict) -> torch.Tensor:
        """Cross entropy of ``batch["tokens"]`` against ``batch["labels"]``,
        differentiable on both devices (``SSDScan``)."""
        return L.lm_loss(self.forward_train(batch["tokens"]), batch["labels"])

    def init_cache(self, batch: int, seq: int = 0) -> dict:
        """Zeroed recurrent state: ``ssm [L, B, H, P, N]`` float32 and
        ``conv [L, B, W - 1, d_in + 2N]`` bfloat16.  O(1) in the sequence:
        ``seq`` is taken for the interface and ignored."""
        d_in, h, p, n = dims(self.cfg)
        nl, dev = self.cfg.n_layers, self.tok.device
        return {"ssm": torch.zeros((nl, batch, h, p, n), dtype=torch.float32,
                                   device=dev),
                "conv": torch.zeros((nl, batch, self.cfg.conv_width - 1,
                                     d_in + 2 * n), dtype=torch.bfloat16,
                                    device=dev)}

    def forward_decode(self, cache: dict, tokens: torch.Tensor, pos: int = 0):
        """One decode step: ``tokens [B, 1]`` -> ``(logits [B, V_pad],
        cache)``; the state is updated in place (``pos`` is taken for the
        interface: the recurrence needs no position)."""
        x = L.embed_tokens(self.tok, tokens)
        for i, blk in enumerate(self.layers):
            x = blk.decode_step(x, self.cfg, cache["ssm"][i],
                                cache["conv"][i])
        logits = L.lm_head(self.tok, self.norm_f, x, self.cfg, self.head)
        return logits[:, 0], cache


def init_mamba2(cfg: ModelConfig, seed: int = 0, device="cuda") -> Mamba2LM:
    """A ``Mamba2LM`` on ``device`` with the reference's init scales:
    normal x 0.01 for ``tok`` and ``head``, x 0.02 for ``w_in`` and
    ``w_out``, x 0.5 for ``conv_k``; ``a_log`` and ``dt_bias`` 0 (so a =
    -1), ``d_skip`` and the norms 1.  Drawn in place from a generator on
    ``device`` seeded with ``seed`` (as ``moe.init_qwen3_moe``: the same
    weights on one device type, not across them; mamba2-1.3b's 1.3 G
    weights take seconds to draw on the host).  The draws differ from
    ``repro.models.ssm.init_mamba2``'s — use ``convert`` to share
    weights."""
    model = Mamba2LM(cfg, resolve_device(device))
    gen = torch.Generator(device=model.tok.device).manual_seed(seed)
    with torch.no_grad():
        L.draw(model.tok, gen, 0.01)
        if model.head is not None:
            L.draw(model.head, gen, 0.01)
        for blk in model.layers:
            L.draw(blk.w_in, gen, 0.02)
            L.draw(blk.conv_k, gen, 0.5)
            L.draw(blk.w_out, gen, 0.02)
    return model
