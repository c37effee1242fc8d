"""Roofline terms of one step on the card, and the analysis of dry-run
results (the counterpart of ``repro/launch/roofline.py``).

Per step, each term is a count over the rate the card moves it at:

    compute    = FLOPs / PEAK_FLOPS_BF16     (989 TFLOP/s bf16)
    memory     = HBM bytes / HBM_BW          (3.35 TB/s)
    collective = wire bytes / WIRE_BW        (the W simulated workers
                                              share one card: HBM rate)
    host       = L3 gather bytes / PCIE_BW   (53 GB/s, measured)

``roofline_terms`` and ``step_lower_bound`` are the seam the autotuner's
cost model calls.  ``analyse`` reads one record of ``launch/dryrun.py``
(the port's or the reference's: the keys are the same) on the
production mesh, whose collective term crosses cards: collective bytes
over ``LINK_BW`` (50 GB/s, the InfiniBand hop of a 16-rank axis; data
sheet, not measured).  It derives the model FLOPs ``6 N D`` (train) or
``2 N D`` (forward), ``N`` the active parameters, their share of the
traced FLOPs, the dominant term and the step's lower bound (the ``max``:
perfect overlap), and ``markdown_table`` prints them per mesh:

    PYTHONPATH=src python -m repro_torch.launch.roofline --in dryrun_results.jsonl

A port record's ``temp_bytes`` holds the outputs live at its peak, so
its ``HBM/dev`` column (arguments + temp + outputs, the reference's sum)
counts those twice: an upper bound.  The constants are the H100's
(``core/config.py``), data sheet where not marked measured.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

from ..core.config import HBM_BW, LINK_BW, PCIE_BW, PEAK_FLOPS_BF16, WIRE_BW

# one decode step generates 1 token/sequence; 6*N_active*tokens is the
# model-flops floor for train (fwd+bwd); 2*N_active for forward-only.
_FWD_BWD = {"train": 6.0, "prefill": 2.0, "decode": 2.0}


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   wire_bytes_per_device: float,
                   host_gather_bytes: float = 0.0,
                   wire_bw: float = None) -> dict:
    """Per-device roofline time terms (seconds) for one step: compute,
    memory, collective (over ``wire_bw``; None: ``WIRE_BW``, the stacked
    workers' HBM rate) and host.  Any count may be zero; every term is
    non-negative."""
    wire_bw = WIRE_BW if wire_bw is None else wire_bw
    return {
        "compute": max(float(flops_per_device), 0.0) / PEAK_FLOPS_BF16,
        "memory": max(float(hbm_bytes_per_device), 0.0) / HBM_BW,
        "collective": max(float(wire_bytes_per_device), 0.0) / wire_bw,
        "host": max(float(host_gather_bytes), 0.0) / PCIE_BW,
    }


def step_lower_bound(terms: dict) -> float:
    """Step-time lower bound from roofline terms: their ``max`` (the
    perfect-overlap assumption)."""
    return max(terms.values()) if terms else 0.0


def analyse(rec: dict) -> dict | None:
    """One ``ok`` dry-run record with its terms: ``compute_s``,
    ``memory_s``, ``collective_s`` (over ``LINK_BW``), ``dominant``,
    ``model_flops``, ``useful_ratio`` (model over traced FLOPs),
    ``step_bound_s`` and ``mfu_bound``; None for any other status."""
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    terms = roofline_terms(rec["flops_per_device"], rec["bytes_per_device"],
                           rec["collective_bytes_per_device"]["total"],
                           wire_bw=LINK_BW)
    comp, mem, coll = terms["compute"], terms["memory"], terms["collective"]
    terms = {"compute": comp, "memory": mem, "collective": coll}
    dominant = max(terms, key=terms.get)
    model_flops = (
        _FWD_BWD[rec["kind"]] * rec["active_params"] * rec["tokens"]
    )
    hlo_global = rec["flops_per_device"] * chips
    useful = model_flops / hlo_global if hlo_global else 0.0
    bound = step_lower_bound(terms)
    mfu_bound = (model_flops / chips / PEAK_FLOPS_BF16) / bound if bound else 0.0
    return {
        **rec,
        "compute_s": comp,
        "memory_s": mem,
        "collective_s": coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": useful,
        "step_bound_s": bound,
        "mfu_bound": mfu_bound,
    }


def _fmt(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def markdown_table(rows: list[dict], mesh: str) -> str:
    """The rows of one mesh (``analyse``'s, or ``skipped`` records) as the
    reference's markdown table."""
    out = [
        f"### Mesh {mesh}",
        "",
        "| arch | shape | compute | memory | collective | dominant | "
        "model/HLO FLOPs | MFU bound | HBM/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") == "skipped":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | — |"
            )
            continue
        hbm = ""
        if isinstance(r.get("memory"), dict):
            tot = (r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]
                   + r["memory"]["output_bytes"])
            hbm = f"{tot/2**30:.1f}GiB"
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt(r['compute_s'])} | "
            f"{_fmt(r['memory_s'])} | {_fmt(r['collective_s'])} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['mfu_bound']*100:.1f}% | {hbm} |"
        )
    return "\n".join(out)


def load(path: str) -> dict:
    """The records of a JSONL file by ``(arch, shape, mesh)``; a later
    line of a cell replaces an earlier one (re-runs)."""
    cells = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            key = (r["arch"], r["shape"], r["mesh"])
            cells[key] = r          # later lines win (re-runs)
    return cells


def main(argv=None) -> None:
    """CLI entry (module docstring): print the tables of ``--in``, and
    write them to ``--md`` when given."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in", dest="inp", default="dryrun_results.jsonl")
    ap.add_argument("--md", default=None, help="write markdown here")
    args = ap.parse_args(argv)
    cells = load(args.inp)
    by_mesh = defaultdict(list)
    for (arch, shape, mesh), r in sorted(cells.items()):
        a = analyse(r) or r
        by_mesh[mesh].append(a)
    md = []
    for mesh in sorted(by_mesh):
        md.append(markdown_table(by_mesh[mesh], mesh))
        md.append("")
    text = "\n".join(md)
    print(text)
    if args.md:
        with open(args.md, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
