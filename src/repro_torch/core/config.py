"""The GCN, cache, dense-LM and SSM fields of
``repro.core.config.ModelConfig``, and ``TrainConfig``.

Only what the ported slices read is carried over: the GCN dims, the
fanouts and the cache policy, with the same construction-time validation
(``cache_rows`` is rounded UP to a power of two); the LM's dims, rope and
norm constants and its flash switch; the Mamba-2 SSM dims (state, heads,
head dim, expansion, chunk, conv width), each with the reference's
defaults; the optimizer's schedule; the autotuner's ``TuneCandidate``
and ``ModelConfig.with_candidate``; and the roofline constants of the
card the port runs on (an NVIDIA H100, not the reference's TPU).  The
MoE/MLA/hybrid/VLM/audio fields and the shape/mesh configs wait for the
slices that need them (ROADMAP Queue 1 items 6-7).
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
    """A GCN architecture plus its distributed feature-fetch policy, a
    dense decoder-only LM, or a Mamba-2 SSM LM.

    Field meanings and defaults match ``repro.core.config.ModelConfig``;
    see the reference for the long-form comments on each cache knob.
    The reference's ``scan_layers`` and ``remat`` are XLA knobs with no
    counterpart here: ``DenseLM`` holds one module per layer and keeps
    its activations (ROADMAP Queue 1 item 6)."""
    name: str
    family: str                 # "gcn", "dense" or "ssm"
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
    ssm_state: int = 0          # N, the state width per head
    ssm_heads: int = 0          # 0 -> expand * d_model // ssm_head_dim
    ssm_head_dim: int = 0       # P (0 -> 64)
    ssm_expand: int = 2
    ssm_chunk: int = 128        # SSD chunk length Q
    conv_width: int = 4
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

    def __post_init__(self):
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
class TrainConfig:
    """AdamW with linear warmup, cosine decay and a global-norm clip, the
    checkpoint cadence and the gradient sync (the fields of
    ``repro.core.config.TrainConfig`` that the GCN trainer reads, with
    the same defaults)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    grad_sync: str = "psum"     # psum | tree (explicit butterfly tree
                                # reduction); read where each worker runs
                                # in its own process (train/train_loop.py)

    def __post_init__(self):
        if self.grad_sync not in GRAD_SYNC_MODES:
            raise ValueError(f"grad_sync must be one of {GRAD_SYNC_MODES}, "
                             f"got {self.grad_sync!r}")
