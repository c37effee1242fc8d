"""Roofline terms of one step on the card (the seam of
``repro/launch/roofline.py`` that the autotuner's cost model calls).

Per step, each term is a count over the rate the card moves it at:

    compute    = FLOPs / PEAK_FLOPS_BF16     (989 TFLOP/s bf16)
    memory     = HBM bytes / HBM_BW          (3.35 TB/s)
    collective = wire bytes / WIRE_BW        (the W simulated workers
                                              share one card: HBM rate)
    host       = L3 gather bytes / PCIE_BW   (53 GB/s, measured)

The constants are the H100's (``core/config.py``).  The reference's
dry-run analysis (``analyse``, the markdown tables and ``main``, which
read ``launch/dryrun.py``'s JSONL) waits for the dry-run tooling
(ROADMAP Queue 1 item 7.6).
"""
from __future__ import annotations

from ..core.config import HBM_BW, PCIE_BW, PEAK_FLOPS_BF16, WIRE_BW


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   wire_bytes_per_device: float,
                   host_gather_bytes: float = 0.0) -> dict:
    """Per-device roofline time terms (seconds) for one step: compute,
    memory, collective and host.  Any count may be zero; every term is
    non-negative."""
    return {
        "compute": max(float(flops_per_device), 0.0) / PEAK_FLOPS_BF16,
        "memory": max(float(hbm_bytes_per_device), 0.0) / HBM_BW,
        "collective": max(float(wire_bytes_per_device), 0.0) / WIRE_BW,
        "host": max(float(host_gather_bytes), 0.0) / PCIE_BW,
    }


def step_lower_bound(terms: dict) -> float:
    """Step-time lower bound from roofline terms: their ``max`` (the
    perfect-overlap assumption)."""
    return max(terms.values()) if terms else 0.0
