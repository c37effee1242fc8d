"""Device dispatch for the port's kernels.

A CPU tensor goes to the plain-torch twin in ``ref``; a CUDA tensor goes
to the hand-written CUDA kernel, which launches or raises — there is no
fallback from the kernel to the twin, and no switch that picks one.
``launch_counts``/``reset_launch_counts`` read and zero the kernels'
launch counters (the proof that a run went through the kernels).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref
from .cache_gather import cache_probe_compact_cuda, cache_probe_gather_cuda
from .gather_reduce import fanout_mean_cuda

#: kernel name -> its CUDA wrapper (each carries a ``launches`` counter)
KERNELS = {
    "fanout_mean": fanout_mean_cuda,
    "cache_probe_gather": cache_probe_gather_cuda,
    "cache_probe_compact": cache_probe_compact_cuda,
}


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True when every operand is on a CUDA device, False when every one is
    on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on the CPU or all on CUDA, got "
                     f"{sorted(kinds)}")


def fanout_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the fanout axis: ``x [M, K, D]``, ``mask [M, K]``
    -> ``[M, D]`` (the GCN aggregation step on a padded fanout tree)."""
    if _on_cuda(x, mask):
        return fanout_mean_cuda(x.contiguous(), mask.contiguous())
    return ref.fanout_mean_ref(x, mask)


def cache_probe_gather(keys: torch.Tensor, rows: torch.Tensor,
                       ids: torch.Tensor, assoc: int = 1):
    """Fused hot-node cache probe + gather: ``(hit [R], rows [R, D])``."""
    if _on_cuda(keys, rows, ids):
        return cache_probe_gather_cuda(keys.contiguous(), rows.contiguous(),
                                       ids.contiguous(), assoc=assoc)
    return ref.cache_probe_gather_ref(keys, rows, ids, assoc=assoc)


def cache_probe_compact(keys: torch.Tensor, rows: torch.Tensor,
                        ids: torch.Tensor, assoc: int = 1, hit_cap: int = 1):
    """Fused probe + compact-wire encode of an ``[H, W, R]`` stack of
    holders' probe blocks: ``(words, raw_words, payload)`` — the
    post-demotion wire bitmap, the pre-demotion telemetry bitmap, and the
    compacted hit rows (see ``ref.cache_probe_compact_ref``)."""
    if _on_cuda(keys, rows, ids):
        return cache_probe_compact_cuda(keys.contiguous(), rows.contiguous(),
                                        ids.contiguous(), assoc=assoc,
                                        hit_cap=hit_cap)
    return ref.cache_probe_compact_ref(keys, rows, ids, assoc=assoc,
                                       hit_cap=hit_cap)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every kernel's launch counter."""
    for fn in KERNELS.values():
        fn.launches = 0
