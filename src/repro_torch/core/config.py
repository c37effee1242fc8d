"""The GCN, cache, LM, MoE, MLA, SSM, hybrid, VLM and audio fields of
``repro.core.config.ModelConfig``, and ``TrainConfig``.

Only what the ported slices read is carried over: the GCN dims, the
fanouts and the cache policy, with the same construction-time validation
(``cache_rows`` is rounded UP to a power of two); the LM's dims, rope and
norm constants and its flash switch; the mixture-of-experts fields
(experts, top-k, shared experts, expert width, leading dense layers),
DeepSeek's multi-head latent attention ranks and head dims, the Mamba-2
SSM dims (state, heads, head dim, expansion, chunk, conv width), the
hybrid's shared-attention period, the VLM's cross-attention period and
vision-token stub and Whisper's encoder depth and audio-frame stub, each
with the reference's defaults;
the optimizer's schedule; the autotuner's ``TuneCandidate`` and
``ModelConfig.with_candidate``; and the roofline constants of the card
the port runs on (an NVIDIA H100, not the reference's TPU); the
analytic ``ModelConfig.param_count`` and ``active_param_count``, the
four workload ``SHAPES`` and the production ``MeshConfig`` of the
dry-run (``launch/dryrun.py``).  The LM's model and data axes of a real
run take their widths from the process groups
(``launch/mesh.py::make_local_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

#: cache associativities the probe/insert paths implement, the cache
#: placement modes, the shard-probe wire formats and the feature stores
VALID_CACHE_ASSOC = (1, 2, 4)
VALID_CACHE_MODES = ("replicated", "sharded", "tiered")
VALID_CACHE_WIRES = ("dense", "compact")
VALID_FEATURE_STORES = ("device", "host")
#: how the workers' gradients are summed (``TrainConfig.grad_sync``)
GRAD_SYNC_MODES = ("psum", "tree")
#: ``ModelConfig.remat``: keep every activation, recompute each layer
#: body in the backward, or keep only its 2-D matrix products' outputs
REMAT_MODES = ("none", "full", "dots")

# Roofline constants of the card the port runs on: one NVIDIA H100 80GB
# HBM3 (SXM) at a 700.00 W power limit.  The autotuner's cost model
# (``launch/autotune.py``) reads them through ``launch/roofline.py``.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores (data
                                # sheet; chip_smoke.py's bound uses it too)
HBM_BW = 3.35e12                # bytes/s, HBM3 (data sheet)
PCIE_BW = 53e9                  # bytes/s host -> device: the pinned L3
                                # staging copies measured on this card
                                # (55.5 MB in 1.04 ms; PERF.md section 6)
# The collective term: the W workers of the stacked worker axis (the
# default backend) share one card, so their all_to_all "wire" is a
# device-memory copy, not a link between chips; it moves at the HBM rate.
WIRE_BW = HBM_BW
# The collective term across cards (the dry-run's production mesh): a
# 16-rank axis of H100s spans two 8-GPU NVLink nodes, so its slowest hop
# is the node's 400 Gb/s InfiniBand NIC, one per GPU: 50 GB/s a GPU
# (data sheet, not measured).
LINK_BW = 50e9


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing ``cuda`` on a machine without a
    card (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False — pass device='cpu' to run the plain-torch path")
    return dev


def _round_up_pow2(n: int) -> int:
    """``n`` itself when it is 0 or a power of two, else the next one."""
    if n and n & (n - 1):
        return 1 << n.bit_length()
    return n


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A GCN architecture plus its distributed feature-fetch policy, or
    an LM: dense, mixture-of-experts (Qwen3-MoE, DeepSeek-V2 with MLA),
    Mamba-2 SSM, the Zamba2 hybrid, the Llama-3.2-Vision VLM (a dense
    decoder with gated cross-attention) or the Whisper encoder-decoder.

    Field meanings and defaults match ``repro.core.config.ModelConfig``;
    see the reference for the long-form comments on each cache knob.
    The reference's ``scan_layers`` is an XLA knob with no counterpart
    here (each layer is its own module); ``remat`` (``none | full |
    dots``) is ``models/layers.py::maybe_remat``'s activation
    checkpointing of every layer body, and ``fsdp_params`` puts a
    parameter's ``data`` dimension of ``zoo.param_pspec`` on the data
    axis of a training mesh (``train/fsdp.py``)."""
    name: str
    family: str                 # gcn | dense | moe | ssm | hybrid | vlm
                                # | audio
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_experts: int = 0          # MoE: routed experts
    top_k: int = 0              # experts per token
    n_shared_experts: int = 0   # always-on experts (one MLP of n x width)
    d_ff_expert: int = 0        # per-expert FFN width
    first_dense_layers: int = 0  # DeepSeek: leading dense-MLP layers
    kv_lora_rank: int = 0       # MLA: the latent KV width (0: no MLA)
    q_lora_rank: int = 0        # MLA: the latent query width
    qk_rope_head_dim: int = 0   # MLA: the roped part of a q/k head
    qk_nope_head_dim: int = 0   # MLA: the unroped part of a q/k head
    v_head_dim: int = 0         # MLA: a value head's width
    ssm_state: int = 0          # N, the state width per head
    ssm_heads: int = 0          # 0 -> expand * d_model // ssm_head_dim
    ssm_head_dim: int = 0       # P (0 -> 64)
    ssm_expand: int = 2
    ssm_chunk: int = 128        # SSD chunk length Q
    conv_width: int = 4
    attn_every: int = 0         # hybrid: the shared attention block runs
                                # after every attn_every-th Mamba layer
    cross_attn_every: int = 0   # vlm: a gated cross-attention block after
                                # every cross_attn_every-th self layer
    n_vision_tokens: int = 0    # vlm: patch embeddings per image (stub)
    d_vision: int = 0           # vlm: their width
    n_encoder_layers: int = 0   # audio: encoder depth (n_layers: decoder)
    n_audio_frames: int = 0     # audio: frame embeddings per clip (stub)
    d_audio: int = 0            # audio: their width
    gcn_hidden: int = 0
    gcn_in_dim: int = 0
    n_classes: int = 0
    fanouts: Tuple[int, ...] = ()
    cache_rows: int = 0         # slots per worker, rounded up to 2^k
    cache_admit: int = 2        # misses before an id is admitted
    cache_assoc: int = 1        # ways per set
    cache_mode: str = "replicated"
    cache_l1_rows: int = 0      # tiered mode: L1 slots (0 = auto)
    cache_l1_promote: int = 3   # tiered mode: observations before promotion
    cache_wire: str = "compact"
    cache_hit_cap: int = 0      # compact wire payload rows (0 = auto)
    capacity_slack: Optional[float] = None  # None = the launcher sizes it
    feature_store: str = "device"
    host_gather_depth: int = 2  # host store: 2 overlaps the gather, 1 blocks
    use_flash_attention: bool = False
    remat: str = "none"         # none | full | dots (maybe_remat)
    fsdp_params: bool = True    # shard params over the data axis (ZeRO-3)

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{self.remat!r}")
        if self.cache_rows < 0:
            raise ValueError(f"cache_rows must be >= 0, got {self.cache_rows}")
        object.__setattr__(self, "cache_rows", _round_up_pow2(self.cache_rows))
        if self.cache_assoc not in VALID_CACHE_ASSOC:
            raise ValueError(
                f"cache_assoc must be one of {VALID_CACHE_ASSOC}, "
                f"got {self.cache_assoc}")
        if self.cache_rows and self.cache_assoc > self.cache_rows:
            raise ValueError(
                f"cache_assoc {self.cache_assoc} exceeds cache_rows "
                f"{self.cache_rows}")
        if self.cache_mode not in VALID_CACHE_MODES:
            raise ValueError(
                f"cache_mode must be one of {VALID_CACHE_MODES}, "
                f"got {self.cache_mode!r}")
        if self.cache_l1_rows < 0:
            raise ValueError(
                f"cache_l1_rows must be >= 0, got {self.cache_l1_rows}")
        object.__setattr__(self, "cache_l1_rows",
                           _round_up_pow2(self.cache_l1_rows))
        if self.cache_l1_promote < 1:
            raise ValueError(
                f"cache_l1_promote must be >= 1, got {self.cache_l1_promote}")
        if self.cache_wire not in VALID_CACHE_WIRES:
            raise ValueError(
                f"cache_wire must be one of {VALID_CACHE_WIRES}, "
                f"got {self.cache_wire!r}")
        if self.cache_hit_cap < 0:
            raise ValueError(
                f"cache_hit_cap must be >= 0 (0 = auto), "
                f"got {self.cache_hit_cap}")
        if self.feature_store not in VALID_FEATURE_STORES:
            raise ValueError(
                f"feature_store must be one of {VALID_FEATURE_STORES}, "
                f"got {self.feature_store!r}")
        if self.host_gather_depth not in (1, 2):
            raise ValueError(
                f"host_gather_depth must be 1 (synchronous) or 2 "
                f"(double-buffered), got {self.host_gather_depth}")

    def with_candidate(self, cand: "TuneCandidate") -> "ModelConfig":
        """Self with an autotuner ``TuneCandidate`` applied: the fanouts,
        cache sizes, associativity, hit cap and capacity slack replaced,
        everything else kept; ``__post_init__`` re-validates, so an
        infeasible candidate raises here."""
        return dataclasses.replace(
            self, fanouts=tuple(cand.fanouts), cache_rows=cand.cache_rows,
            cache_l1_rows=cand.l1_rows, cache_assoc=cand.assoc,
            cache_hit_cap=cand.hit_cap, capacity_slack=cand.capacity_slack)

    @property
    def resolved_head_dim(self) -> int:
        """Per-head attention dim: ``head_dim`` when set explicitly,
        else ``d_model // n_heads``."""
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's
        ``ModelConfig.param_count``: the 6 N D roofline's N, not an
        allocation)."""
        if self.family == "gcn":
            d, h = self.gcn_in_dim, self.gcn_hidden
            depth = max(len(self.fanouts), 1)
            # per conv layer: self + neighbor transforms + bias
            total = 2 * d * h + h + (depth - 1) * (2 * h * h + h)
            return total + h * self.n_classes + self.n_classes
        emb = self.vocab_size * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if self.family == "ssm":
            return emb + out + self.n_layers * _mamba2_layer_params(self)
        if self.family == "hybrid":
            # one shared attention + MLP block, whatever its sites
            attn = _attn_params(self) + _mlp_params(self.d_model, self.d_ff)
            return (emb + out + self.n_layers * _mamba2_layer_params(self)
                    + attn)
        per = _attn_params(self)
        if self.family == "moe":
            dense_ff = _mlp_params(
                self.d_model, self.d_ff if self.d_ff else self.d_ff_expert)
            moe_ff = ((self.n_experts + self.n_shared_experts)
                      * _mlp_params(self.d_model, self.d_ff_expert)
                      + self.d_model * self.n_experts)
            n_moe = self.n_layers - self.first_dense_layers
            ff_total = self.first_dense_layers * dense_ff + n_moe * moe_ff
        else:
            ff_total = self.n_layers * _mlp_params(self.d_model, self.d_ff)
        total = emb + out + self.n_layers * per + ff_total
        if self.family == "audio":
            total += self.n_encoder_layers * (
                _attn_params(self) + _mlp_params(self.d_model, self.d_ff))
            total += self.n_layers * _attn_params(self)  # decoder cross-attn
        if self.family == "vlm":
            n_cross = self.n_layers // max(self.cross_attn_every, 1)
            total += n_cross * _attn_params(self)
        return total

    def active_param_count(self) -> int:
        """Parameters a token passes through (``param_count`` but for the
        MoE, which counts its top-k and shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        emb = self.vocab_size * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        active_ff = ((self.top_k + self.n_shared_experts)
                     * _mlp_params(self.d_model, self.d_ff_expert)
                     + self.d_model * self.n_experts)
        dense_ff = _mlp_params(self.d_model,
                               self.d_ff if self.d_ff else self.d_ff_expert)
        n_moe = self.n_layers - self.first_dense_layers
        return (emb + out + self.n_layers * _attn_params(self)
                + self.first_dense_layers * dense_ff + n_moe * active_ff)


def _attn_params(cfg: ModelConfig) -> int:
    """One attention block's matrices (MLA's latent projections where
    ``kv_lora_rank`` is set)."""
    hd = cfg.resolved_head_dim
    if cfg.kv_lora_rank:
        q = cfg.d_model * cfg.n_heads * (cfg.qk_rope_head_dim
                                         + cfg.qk_nope_head_dim)
        kv = (cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
              + cfg.kv_lora_rank * cfg.n_heads
              * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        return q + kv + cfg.n_heads * cfg.v_head_dim * cfg.d_model
    return (cfg.d_model * cfg.n_heads * hd + 2 * cfg.d_model * cfg.n_kv_heads
            * hd + cfg.n_heads * hd * cfg.d_model)


def _mlp_params(d_model: int, d_ff: int) -> int:
    """A SwiGLU MLP's gate, up and down matrices."""
    return 3 * d_model * d_ff


def _mamba2_layer_params(cfg: ModelConfig) -> int:
    """One Mamba-2 layer: in projection, conv, out projection, and the
    per-head ``a_log`` and ``dt_bias``."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(d_in // max(cfg.ssm_head_dim, 1), 1)
    in_proj = cfg.d_model * (2 * d_in + 2 * cfg.ssm_state + nh)
    conv = (d_in + 2 * cfg.ssm_state) * cfg.conv_width
    return in_proj + conv + d_in * cfg.d_model + 2 * nh


class TuneCandidate(NamedTuple):
    """One point of the autotuner's joint search space (fields and order
    of ``repro.core.config.TuneCandidate``): applying one to a
    ``ModelConfig`` (``with_candidate``) or a ``CacheConfig``
    (``autotune.candidate_cache_cfg``) is the rebuild seam."""
    fanouts: Tuple[int, ...]    # per-hop fanout shape
    cache_rows: int             # main-tier (L2) cache slots per worker
    l1_rows: int                # tiered mode: replicated L1 slots (0 else)
    assoc: int                  # cache ways per set, in VALID_CACHE_ASSOC
    hit_cap: int                # compact-wire payload bound (0 = auto)
    capacity_slack: float       # exchange-capacity slack factor


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A workload shape (``repro.core.config.ShapeConfig``): its name,
    kind (train, prefill or decode), sequence length and global batch."""
    name: str
    kind: str
    seq_len: int
    global_batch: int


#: the four workload shapes of the dry-run sweep (the reference's)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The production mesh of the dry-run: ``(data 16, model 16)``, or
    ``(pod 2, data 16, model 16)`` with ``multi_pod``."""
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        """The grid's shape."""
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The axis names, ``launch/mesh.py::make_production_mesh``'s."""
        return ("pod", "data", "model") if self.multi_pod \
            else ("data", "model")

    @property
    def n_devices(self) -> int:
        """Ranks in the mesh (the product of ``shape``)."""
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """AdamW with linear warmup, cosine decay and a global-norm clip, the
    gradient accumulation, the gradient sync, the int8 error-feedback
    compression and the checkpoint cadence (``repro.core.config.
    TrainConfig``'s fields, with the same defaults)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1       # gradient accumulation
    grad_sync: str = "psum"     # psum | tree (explicit butterfly tree
                                # reduction); read where each worker runs
                                # in its own process (train/train_loop.py)
    compress_grads: bool = False
    checkpoint_every: int = 100
    keep_checkpoints: int = 3

    def __post_init__(self):
        if self.grad_sync not in GRAD_SYNC_MODES:
            raise ValueError(f"grad_sync must be one of {GRAD_SYNC_MODES}, "
                             f"got {self.grad_sync!r}")
