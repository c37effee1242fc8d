#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Phases, each of which fails the run (nonzero exit, no result line):

1. device   — a CUDA card must be present; print ``nvidia-smi``'s name and
              power limit.
2. build    — compile the CUDA kernels (``nvcc``, sm_90a, one process per
              source, all started together) from the sources in this
              checkout; print each tensor-core kernel's ptxas report
              (registers, spills) per instantiation (flash: Dh 64 and 128;
              ssd_scan: chunk x state 64/128 x 64/128), its dynamic shared
              memory per CTA and its HGMMA / UTMALDG / UTMASTG counts from
              ``cuobjdump -sass`` of the built library (either of the first
              two at 0 fails); and ptxas's report (registers, shared
              memory, spills) of every instantiation of the compact probe,
              fanout_mean, fanout_mean_bwd, tiered probe and gather_reduce
              kernels.
3. kernels  — each kernel against its plain-torch twin on the card, at the
              main paths' shapes and at edge cases (assoc 1/2/4, single-set
              tiers, probe counts off a multiple of 32, -1 ids, double hits,
              hit_cap 1): probes exact, fanout_mean and gather_reduce
              (ids off both ends of the table, all-masked rows) within rtol
              1e-5 / atol 1e-6 in float32 and 2e-2 in bfloat16,
              fanout_mean_bwd exact (one division and one rounding in
              both); ssd_scan within rtol 1e-5 plus 1e-5 of the output's
              largest magnitude at mamba2-1.3b's prefill shape (B 8, L
              2048, H 64, P 64, N 128, chunk 128) with the reference
              test's dt (softplus(N(0, 1))) and with small dt (U[0.005,
              0.05], where the carry across chunks must hold over 1e-2 of
              the output), at L = chunk and at smaller widths and chunks
              (the float32 route); then bf16 copies (the tensor-core route,
              x, b and c as views of one [B, L, H P + 2N] conv output) at
              the prefill shape with both dt kinds, L = chunk, zamba2-
              1.2b's state of 64 and a chunk of 64, within the derived gate
              (ssd_scan.bf16_error_bound: (2 * 2^-8 + 2^-7 + 2^-12) *
              ref(|x|, dt, a, |b|, |c|)); each check prints its error (as a
              share of its gate for bf16) and the carry's share, and for
              bf16 how far a dropped carry would land past the gate.
4. serve    — ``serve_gcn`` at full width, 20 000 nodes, 8 warmup sweeps,
              buckets (8, 16, 32), Zipf requests: graphgen-gcn (128 -> 256 ->
              64, fanouts (40, 20), 4096-row 4-way sharded compact cache) at
              W = 1 and at W = 4 on the stacked worker axis, and
              graphgen-gcn-deep (fanouts (15, 10, 5), a 512-row L1 in front
              of the 4096-row 4-way L2) at W = 1.  Launch counters are zeroed
              before each run and read after it: every kernel of the path
              must have launched.  No request may add a step shape outside
              the ladder; every prediction lies in [0, 64).
5. train    — ``train_gcn`` for 20 steps, 20 000 nodes, batch 32 per worker:
              graphgen-gcn-deep at W = 1 (must launch cache_probe_tiered)
              and graphgen-gcn at W = 4 (must run both calibration ladders
              and launch cache_probe_compact).  Per train step fanout_mean
              launches L(L+1)/2 times and fanout_mean_bwd L(L-1)/2 times;
              every loss is finite, no trained batch dropped a request, and
              the padded nodes per iteration equal batch x slots_per_seed.
              Rates: padded nodes/s over all 20 steps and over the untraced
              warm steps, the two start-up steps' seconds, the median step.
              Then, at the train runs' own inputs: fanout_mean at every
              layer call of the trained model on each run's last batch
              (rtol 1e-5 / atol 1e-6), and cache_probe_compact on the W = 4
              run's own probe round with its calibrated hit cap (exact).
   host     — the L3 host-RAM feature store: graphgen-gcn-deep W = 1 at
              gather depth 2 and 1, graphgen-gcn W = 4 at depth 2, each for
              20 steps beside a device-store run of the same seeds, all with
              --capacity-slack 2.0 --probe-hit-cap 0 (the values host mode
              takes, so both build the same exchange).  Gates: losses equal
              (torch.equal), no request dropped in either run, L3 rows and
              bytes issued, the launch counts equal to the device run's
              (fanout_mean L(L+1)/2, fanout_mean_bwd L(L-1)/2 per step, one
              probe per round).  Prints each run's median step, warm
              nodes/s, idle share, L3 bytes per step, the table's bytes and
              the traced steps' H2D copies (their stream and the ms that
              overlap a kernel).  Then the tiered probe on the deep host
              run's last round (its cache filled by deferred admission) and
              the compact probe on the W = 4 host run's round under the
              uncalibrated hit cap, each against its twin (exact).
   merge    — graphgen-gcn W = 4's 20 rounds generated with the butterfly
              and with the reduce-scatter merge in turns, same draws, cold
              caches: every batch and cache state equal; median ms per
              round of each.
   offline  — the GraphGen baseline (``train.offline_gcn``: generate all,
              store through pickle, read back, train) for graphgen-gcn
              W = 4 (device store) and graphgen-gcn-deep W = 1 (host store)
              over the host phase's schedule: losses equal to its
              pipelined runs'; t_gen, t_train, their sum and the pipelined
              wall time side by side.
   ckpt     — graphgen-gcn-deep W = 1: 10 steps saving every 5, then
              --resume to 20, beside an uninterrupted 20-step run exported
              with --export-serve: the resumed losses and final params
              equal the uninterrupted run's (each run's dropped count
              printed); serve --warm-from on the export (64 requests, no
              request-path step shape), its logits on 64 more requests
              equal to a server built from the in-process state; a serve
              view of another n_rows refused.
   autotune — ``train_gcn --autotune --autotune-steps 8`` for 20 steps at
              graphgen-gcn W = 4 (sharded, compact wire), graphgen-gcn-deep
              W = 1 (tiered) and graphgen-gcn-deep W = 1 on the host store
              (depth 2): the trace's length and violations, the
              candidates searched, the best predicted against the traced
              ms per step, each validated pick's measured ms and verdict
              (or the fallback reason), the accepted candidate, and the
              trained run's warm nodes/s, idle share and launches.  Gates:
              no violation; the anchor prediction's counts and bytes equal
              to the warm window's sums; in the host cell every record's L3
              bytes W x the static gather; finite losses, no request
              dropped; per step of the trained loop fanout_mean L(L+1)/2,
              fanout_mean_bwd L(L-1)/2 and one probe launch.  First, a
              fresh process splits a train run's first step (library
              start-up, kernel load, set-up, the first generation round,
              forward, backward and AdamW, then the second of each).
   agree    — the autotune trace on the card against the CPU's (the port's
   autotune   twins) on the same seeds and draws at the CPU differential
              test's shape (2 000 nodes, W = 4 sharded device and host
              store, W = 1 tiered): every record equal but wall_time_s.
   baselines — the SQL-like join, the node-centric walk and the
              edge-centric sampler on benchmarks/gen_throughput.py's task
              (20 000 nodes, 256 seeds, fanouts (40, 20): 215 296 padded
              nodes), both hops each: ms by host clock and by CUDA events
              (median of several calls after a warm one, with the range),
              nodes/s, the edge-centric speedups beside the paper's 27x,
              node-centric's launches; then edge-centric alone at the
              reference's --scale task (60 000 nodes, 1 189 seeds: 999 949
              padded nodes).  Gates: every kept id an out-neighbour of its
              node, the SQL-like and node-centric masks min(deg, k) per
              row, the edge-centric mask its finite keys.
   recovery — examples/distributed_pipeline.py on the port: W = 8 with a
              tiered cache and checkpoints every 10 steps loses workers 3
              and 6 at step 20; the survivors' table, a rebuild at W = 4
              with a cold cache, the step-20 checkpoint restored and a
              resume to step 40.  Gates: the resume at the checkpoint's
              step, equal shares, finite losses, and at both widths the L1
              gather probe, the compact probe and fanout_mean(_bwd)
              launched.
   dist     — graphgen-gcn's train cell (20 000 nodes, batch 32 per
              worker, 20 steps, both ladders) as ``train --dist gloo`` with
              W = 2 and W = 4 worker processes, all on the one card (gloo
              stages every collective's blocks through host memory), each
              beside the stacked run of the same flags in this process,
              both with ``--report``.  Gates: every rank picks the stacked
              run's slack and hit cap; its first three rounds' batch and
              cache digests and its FetchStats / CacheStats equal the
              stacked run's worker block; its losses within rtol 1e-5; the
              parameters and Adam moments bit-equal across ranks and
              within rtol 1e-5 / atol 1e-7 of the stacked run's; every rank
              launched cache_probe_compact once a round and fanout_mean /
              fanout_mean_bwd 3 / 1 times a step (printed per rank); a
              failed or hung rank fails the run.  Records: the median step
              of each backend, each rank's bytes and calls per round by
              collective, the compact probe wire's bytes per round beside
              the dense wire's, the shares of a step in the gloo transport
              and in its host staging, and the phase's seconds.
   dist paths — (PR 23) every other graph path with one process per worker
              over gloo on the card, at W = 2 and 4, one spawn of the ranks
              per width shared by its cells, each cell beside the stacked
              run of the same flags in this process: serve (graphgen-gcn,
              64 Zipf requests: every prediction and each rank's warm
              cache block equal to the stacked server's, no request-path
              step shape on any rank, the stop header ending every rank's
              loop); the tiered cache (graphgen-gcn-deep, 20 steps) and the
              L3 host store (graphgen-gcn, depth 2, --capacity-slack 2.0
              --probe-hit-cap 0) under the dist phase's gates, plus the L3
              rows and bytes summed over the ranks equal to the stacked
              run's; and at W = 4 the deep run's --export-serve file (cache
              leaves byte-equal to the stacked run's, parameters within
              rtol 1e-5 / atol 1e-7), a server warm-started from it
              (predictions equal to a stacked server warm-started from the
              same file), --offline (losses within rtol 1e-5, the first
              rounds equal) and --autotune (the trace reduced over the
              ranks equal to the stacked one in every field but the wall
              time, the ranking bit-equal; the validator's verdicts
              printed).  Every rank launches its path's kernels (exact
              counts per step in the train cells; never the W = 1 tiered
              probe).  Records: each rank's median step or request and the
              transport's share, and the phase's seconds.
   nccl     — the process backend's collectives over NCCL at world size 1
              (all_to_all, all_gather, all_reduce sum and max on the
              generator's int32 ids and words, bool masks, float32 rows,
              seeds and keys), each equal to the stacked backend's; the
              dist phase's cells over NCCL, with all its gates, at each
              width with that many visible cards (``scripts/
              dist_cards.py`` runs both phases on four), else a line
              saying why not.
6. LM       — the dense LM (smollm-135m, full width: 30 layers, d_model
              576, 9 query heads over 3 KV heads, head_dim 64, vocab
              49 152, random weights from a seed):
              flash     ``flash_attention`` against its twin at the prefill
                        shape (B 8, Hq 9, Hkv 3, L 2048, Dh 64, causal,
                        bf16), contiguous and as the model's strided
                        [B, L, H, Dh] views, and at bf16 Lq < Lk causal,
                        Dh 128 and tiles cut by Lq or Lk: bf16 (the
                        tensor-core route) within 2^-8 * ref(q, k, |v|) +
                        2^-7 * |twin| + 1e-5 (p rounded to bf16 before
                        P V, as the reference's plain path does, plus one
                        output rounding); f32 (the SIMT route) with
                        Lq < Lk, Dh 64 and 128, within rtol/atol 1e-5;
                        each prints its max and relative Frobenius error
                        and its distance to SDPA;
              prefill   ``forward_logits`` with flash attention on 8 x 2048
                        seeded tokens: 30 flash launches per forward, all
                        on the tensor-core route, finite logits, the first
                        forward's seconds apart from the median warm
                        forward, prefill tokens/s; in a profiled forward
                        the kernel's profiler row (its device time and
                        share) and the copy kernels' rows; the kernel
                        against its twin at layer 0's own q/k/v, in the
                        model's strided views; one layer's flash attention
                        (its [B, L, H, Dh] tensors in, attn_forward's
                        reshape out) dispatching views and one allocation
                        and no copy, around one kernel launch; and the
                        card's logits against the CPU port's (plain twin) on
                        a 2-layer cut of the same weights at 2 x 512 tokens
                        (atol 2e-2 on logits of scale ~1.5: bf16 rounds at
                        other places in cuBLAS and on the CPU);
              serve     ``serve_lm``, batch 8, prompt 128, gen 128: tokens in
                        [0, V_pad), decode tok/s over the timed loop of a
                        run with nothing else in it; a second run with CUDA
                        events between steps and a profiler over 4 steps
                        gives the median untraced step and the busy share.
                        Then float32 compute on the card against the CPU
                        port in float32 on the same weights, over the 128
                        prompt-fill steps and 8 generated steps: tokens
                        equal, every step's logits within LM_DECODE_ATOL
                        (1e-2) and the final bf16 KV cache within
                        LM_CACHE_ATOL (6.25e-2), beside the floor of the
                        CPU against itself with every weight one float32
                        ulp off (bf16 greedy tokens flip on near-ties, so
                        that gate is float32; random weights soon repeat
                        one token, so the logits carry the check).
   SSM      — mamba2-1.3b at full width and depth (48 layers, d_model
              2048, 64 SSM heads of 64 over a state of 128, chunk 128,
              vocab 50 280, untied, random weights from a seed):
              prefill   ``forward_logits`` on 8 x 2048 tokens, bf16 compute:
                        exactly 48 ssd_scan launches per forward, all on the
                        tensor-core route, and no other kernel, finite
                        logits, tokens/s over the five warm forwards' summed
                        wall (the first forward apart), one profiled
                        forward's busy share and ssd_scan's share, peak
                        memory; the kernel against its twin at layer 0's
                        own operands (the conv output's bf16 views) within
                        the bf16 gate at the seeded init (where the carry
                        vanishes: dt ~0.79, a = -1) and at a carry init
                        (dt_bias -4, a_log ~ N(0, 0.5)), where the carry
                        must hold over 1e-2; one layer's SSD, conv output
                        in to the scan's result out, dispatching views and
                        one allocation (no aten cast or copy) around one
                        tensor-core launch; the card
                        against the CPU port on a 2-layer cut at 2 x 256
                        tokens (two chunks), both inits, float32 (atol
                        1e-3) and bfloat16 (atol 5e-2);
              serve     ``serve_lm``, batch 8, prompt 128, gen 128 (no
                        kernel: the O(1) recurrence is plain torch), tok/s
                        of an uninstrumented loop, then the median step and
                        busy share of an instrumented one; on a 2-layer cut
                        in float32 at both inits, card vs CPU over a 248-
                        token prompt and 8 generated tokens (256 steps):
                        tokens equal but at greedy near-ties (top-two gap
                        within 2e-2; at least half the rows equal
                        throughout), logits within 2e-2 up to each row's
                        first difference, the final state of the equal rows
                        within 1e-2 of its largest entry and their bf16 conv
                        history within 6.25e-2, beside a printed one-ulp
                        floor; and the card's prefill of the same 256 tokens
                        against its decode at every position (within 1e-1:
                        decode keeps the conv history in bf16).
   gather   — ``gather_reduce`` (no model path) over 8 bucket-32 requests
              of the graphgen-gcn W = 1 server: the hop-2 level's mean from
              the 20 000 x 128 feature table, [1280, 20] ids and mask, 8
              launches; each result against its twin and against
              fanout_mean of the generator's own gathered features, and a
              copy with clamped ids and all-masked rows against the twin.
7. agree    — the port on the card against the port on the CPU (the plain
              twins) at a small size, same draws: serving graphgen-gcn (warm
              cache states and batches exact, logits within rtol/atol 1e-5)
              and three train steps of each train run's config (cache states
              and batches exact, losses and every parameter gradient within
              rtol 1e-4).
8. timing   — per bucket-32 request and per train step: kernel launches,
              and device busy time against wall time from a torch.profiler
              trace; then each kernel at its path's own inputs: kernel,
              plain-twin and library-call times, each read two ways: the
              median of 30 CUDA-event intervals (``ms``) and the median
              device duration per call from a torch.profiler trace of 30
              calls (``device_ms``: the call's device rows, start to end;
              the phase fails if the trace has none), beside the floor of
              both readings (a 4-byte ``zero_()``, the ``timing_floor``
              line); the bound (bytes over 3.35 TB/s or operations over
              the peak rate of the inputs' type, whichever is larger) and
              its share of both readings; fanout_mean_bwd at every shape
              of both train runs (W = 4: (128, 40, 256); deep: (32, 15,
              256) twice a step and (480, 10, 256) once), each with its
              launches and lost ms per step, the deep step's loss summed
              over its three launches (``shapes`` and
              ``deep_step_lost_ms`` in its JSON entry); the backward and
              the tiered probe also beside a ``zero_()`` of their output's
              bytes (``zero_ms``, ``zero_device_ms``), and the tiered
              probe's inputs counted (ids, distinct ids, id 0, hit and
              miss rows);
              flash_attention at layer 0's q/k/v of the prefill (the
              model's strided views), with ``scaled_dot_product_attention``
              on the same views as its library yardstick;
              the compact probe also at the W = 4 train run's own probe
              round (its calibrated slack and hit cap: shapes, kernel and
              bound ms, and their ratio on a line of its own, and as
              ``train_round`` in its JSON entry);
              ssd_scan at layer 0's operands of the SSM prefill on both
              routes: the conv output's bf16 views (the tensor-core route,
              bound at the bf16 rate) and their float32 upcast (the SIMT
              route); no library call computes it; gather_reduce at a W = 1
              request's hop-2 level, with ``embedding_bag`` (sum, mask
              weights) and the division as its yardstick, its kept slots
              and distinct rows counted (``kept_slots``, ``distinct_rows``,
              ``kept_row_bytes``), and the same ids over the table cast
              once to bfloat16 (``bf16_ms``, ``bf16_device_ms``).

The lines before the last are the timing floor's JSON, the kernel JSON
and ``nvidia-smi``'s line; the last line is ``{"ok": true, "device":
{...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""
import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
N_NODES, N_REQUESTS = 20_000, 64
TRAIN_STEPS, TRAIN_BATCH = 20, 32
LM_ARCH, LM_SEED = "smollm-135m", 0
PREFILL_B, PREFILL_S, PREFILL_WARM = 8, 2048, 5
LM_BATCH, LM_PROMPT, LM_GEN, LM_AGREE_GEN = 8, 128, 128, 8
# float32 decode, card vs CPU over the 136 steps: the random init's
# residual stream is small, so a k/v entry that rounds to the neighbouring
# bf16 value in the cache moves the normalised state by a few tenths of a
# percent; the phase prints this floor (the CPU against itself with every
# weight one float32 ulp off).  A misplaced rope position, an off-by-one
# valid length or a dropped mask moves the logits by tenths and the cache
# by units, far past both bounds.
LM_DECODE_ATOL = 1e-2          # logits, every step
LM_CACHE_ATOL = 6.25e-2        # final bf16 k/v cache (entries up to ~2.4)
SSM_ARCH, SSM_SEED = "mamba2-1.3b", 0
SSM_CUT, SSM_CUT_S = 2, 256
SSM_AGREE_PROMPT, SSM_AGREE_GEN = 248, 8    # 256 decode steps, two chunks
GATHER_REQUESTS = 8
# the SSM's card-vs-CPU bounds (2-layer cut, logits up to ~2.5): float32
# prefill differs only in the order of float32 sums; bfloat16 rounds at
# other places in cuBLAS and on the CPU, ~10 intermediates per block.
# Float32 decode over 256 steps carries a bf16 conv history, so a value
# that rounds to the neighbouring bf16 number moves the next steps; the
# phase prints the floor (the CPU against itself with every weight one
# float32 ulp off).  The card's prefill against its own decode: the
# decode keeps the conv history in bf16, the prefill in float32.  A
# dropped carry, a misplaced conv tap or a wrong decay moves the logits
# by tenths to units.
SSM_CUT_ATOL_F32 = 1e-3
SSM_CUT_ATOL_BF16 = 5e-2
SSM_DECODE_ATOL = 2e-2         # logits, every step
SSM_STATE_RTOL = 1e-2          # final float32 state, of its largest entry
SSM_CONV_ATOL = 6.25e-2        # final bf16 conv history (entries up to ~4)
SSM_PREFILL_DECODE_ATOL = 1e-1
DEVICE = "cuda"                # the device every phase drives
MIN_WHOLE_CALLS = 5            # device_ms: fewer whole calls: trace again

KERNEL_META = {
    "fanout_mean": ("src/repro_torch/kernels/csrc/fanout_mean.cu",
                    "src/repro/kernels/gather_reduce.py:38"),
    "fanout_mean_bwd": ("src/repro_torch/kernels/csrc/fanout_mean_bwd.cu",
                        "src/repro/kernels/ref.py:13 (no TPU kernel: "
                        "jax.grad of fanout_mean_ref)"),
    "cache_probe_gather": ("src/repro_torch/kernels/csrc/cache_probe_gather.cu",
                           "src/repro/kernels/cache_gather.py:79"),
    "cache_probe_compact": ("src/repro_torch/kernels/csrc/cache_probe_compact.cu",
                            "src/repro/kernels/cache_gather.py:170"),
    "cache_probe_tiered": ("src/repro_torch/kernels/csrc/cache_probe_tiered.cu",
                           "src/repro/kernels/cache_gather.py:282"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
                 "src/repro/kernels/ssd_scan.py:59"),
    # the float32 route of ssd_scan (off the bf16 main path since PR 16)
    "ssd_scan_f32": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:59"),
    "gather_reduce": ("src/repro_torch/kernels/csrc/gather_reduce.cu",
                      "src/repro/kernels/gather_reduce.py:86"),
}
#: train runs of the main path: arch -> workers, and the probe it must launch
TRAIN_RUNS = {"graphgen-gcn-deep": (1, "cache_probe_tiered"),
              "graphgen-gcn": (4, "cache_probe_compact")}


def fail(msg):
    """Abort the run: message to stderr, nonzero exit, no result line."""
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    """``fail(msg)`` unless ``cond``."""
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- helpers

def populated_cache(torch, c, d, assoc, seed, dev, dtype=None):
    """A cache block with unique keys per set, its id pool and a numpy rng."""
    import numpy as np
    from repro_torch.core.feature_cache import hash_slots
    rng = np.random.default_rng(seed)
    n_sets = c // assoc
    pool = rng.choice(10 * c, size=c, replace=False).astype(np.int32)
    sets = hash_slots(torch.from_numpy(pool), n_sets).numpy()
    keys = np.full(c, -1, np.int32)
    fill = np.zeros(n_sets, np.int64)
    for pid, s in zip(pool, sets):
        if fill[s] < assoc:
            keys[s * assoc + fill[s]] = pid
            fill[s] += 1
    rows = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    return (torch.from_numpy(keys).to(dev),
            rows.to(dev, dtype or torch.float32), pool, rng)


def tiered_cache(torch, c1, a1, c2, a2, d, seed, dev):
    """An L1 and an L2 with unique keys per set, half the L1's ids also L2
    residents (double hits), a few empty slots with zero rows as in a real
    state; returns the four blocks, the id pool and a numpy rng."""
    import numpy as np
    from repro_torch.core.feature_cache import hash_slots
    k2, r2, pool, rng = populated_cache(torch, c2, d, a2, seed, dev)
    k2 = k2.cpu().numpy()
    resident = k2[k2 >= 0]
    cand = np.concatenate([rng.choice(resident, c1 // 2, replace=False),
                           rng.choice(10 * c2, c1, replace=False)
                           .astype(np.int32) + 10 * c2])
    sets = hash_slots(torch.from_numpy(cand), c1 // a1).numpy()
    k1 = np.full(c1, -1, np.int32)
    fill = np.zeros(c1 // a1, np.int64)
    for pid, s in zip(cand, sets):
        if fill[s] < a1 and pid not in k1 and fill.sum() < c1 - c1 // 8 - 1:
            k1[s * a1 + fill[s]] = pid
            fill[s] += 1
    r1 = rng.standard_normal((c1, d)).astype(np.float32) + 100
    r1[k1 < 0] = 0
    r2 = r2.cpu().numpy()
    r2[k2 < 0] = 0
    blocks = [torch.from_numpy(a).to(dev) for a in (k1, r1, k2, r2)]
    return blocks, np.concatenate([pool, cand]), rng


def probe_ids(rng, pool, shape, c):
    """Half resident ids, half random, ~10% the -1 sentinel."""
    import numpy as np
    ids = np.where(rng.random(shape) < 0.5, rng.choice(pool, size=shape),
                   rng.integers(0, 10 * c, shape)).astype(np.int32)
    ids[rng.random(shape) < 0.1] = -1
    return ids


def gpu_ms(torch, fn, reps=30):
    """Median device time of ``fn`` in ms: the launches are queued behind a
    device-side sleep so host overhead never shows between the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(min(2e9 * host_s * (reps + 4), 2e10)))
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def traced_calls(torch, fn, reps):
    """One ``torch.profiler`` trace of ``reps`` calls of ``fn``, each
    behind a marker row (``torch.cuda._sleep``, a ``spin_kernel``, 0.5 us
    longer each call): the device-row durations (us) after each marker,
    the marker's first, in trace order.  A warm-up step runs first, so
    tracing is on before the first timed call; a ~0.5 ms marker and a
    50 ms pause on the host come last, since a trace can lose its last
    rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for n in (5, reps):
            for i in range(n):
                torch.cuda._sleep(1000 * (i + 1))
                fn()
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
    rows = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda e: e.time_range.start)
    calls, cur = [], None
    for e in rows:
        if "spin_kernel" in e.name:
            cur = [e.time_range.elapsed_us()]
            calls.append(cur)
        elif cur is not None:
            cur.append(e.time_range.elapsed_us())
    return calls


def device_ms(torch, fn, reps=30):
    """Median device duration of one call of ``fn`` in ms: the summed
    start-to-end times of the device rows (kernels, copies, sets) the call
    put on the card, from ``traced_calls``.  No launch gap lies inside a
    row, so this reading has no event-timing floor.  A trace can lose its
    last rows, or all of them (in a long process a few traces in a hundred
    kept none, some 4-26 of 30 calls), so only calls with the usual number
    of rows count, and a trace that keeps fewer than ``MIN_WHOLE_CALLS``
    of them is taken again, up to three times; fails when three traces
    record no device row or no whole call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(3):
        calls = traced_calls(torch, fn, reps)
        seen += len(calls)
        sizes = [len(c) for c in calls if len(c) > 1]
        per = max(set(sizes), key=sizes.count) if sizes else 0
        whole = [sum(c[1:]) for c in calls if len(c) == per]
        if len(whole) >= MIN_WHOLE_CALLS:
            break
    check(seen > 0, "the profiler recorded no device row in three traces: "
          "device durations cannot be measured on this machine")
    check(len(whole) > 0, f"the profiler kept no whole call of {reps} in "
          f"three traces")
    if len(whole) < reps:
        print(f"[timing] the trace kept {len(whole)} of {reps} calls whole "
              f"({per - 1} device rows each); the median is theirs")
    return statistics.median(whole) / 1e3


def both_ms(torch, fn, reps=30):
    """``(gpu_ms, device_ms)`` of ``fn``: the event median and the
    profiler's device duration."""
    return gpu_ms(torch, fn, reps), device_ms(torch, fn, reps)


def bound(n_bytes, n_ops, flops=F32_FLOPS):
    """Least time (ms) for the work, and which term sets it; ``flops`` is
    the peak rate for the inputs' type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases

def tensor_core_kernels(lib):
    """The build report's kernels: name -> (the regex of the template
    arguments in a mangled name, the instantiations expected, the dynamic
    shared memory of one, read from the loaded library ``lib``)."""
    return {
        "flash_attention_sm90_kernel": (
            r"kernelILi(\d+)E", {("64",), ("128",)},
            lambda k: lib.repro_flash_attention_sm90_smem(int(k[0]))),
        "ssd_scan_sm90_kernel": (
            r"kernelILi(\d+)ELi(\d+)E",
            {(q, n) for q in ("64", "128") for n in ("64", "128")},
            lambda k: lib.repro_ssd_scan_sm90_smem(int(k[0]), int(k[1]))),
    }


def phase_build_report(lib_path):
    """The tensor-core kernels as built (flash_attention per head dim,
    ssd_scan per chunk and state width): ptxas's registers, spills and
    static shared memory for each instantiation, its dynamic shared memory
    per CTA, and its counts of ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
    load) instructions in the library's SASS (``cuobjdump -sass``).  Fails
    if a report or either instruction is missing."""
    import re
    import shutil
    from repro_torch.kernels import _build
    log = _build.build_log(lib_path).read_text().splitlines()
    lib = _build.library()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(cuobjdump), "cuobjdump not found: cannot read the "
          "kernels' SASS")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    report = {}
    for kernel, (args, expected, smem_of) in tensor_core_kernels(lib).items():
        ptxas = {}
        for i, line in enumerate(log):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m and kernel in m.group(1):
                key = re.search(args, m.group(1)).groups()
                ptxas[key] = " ".join(x.strip() for x in log[i + 2:i + 4])
        check(set(ptxas) == expected, f"no ptxas report for every "
              f"instantiation of {kernel} in the build log: {sorted(ptxas)}")
        seen = set()
        for part in sass.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            if kernel not in name:
                continue
            key = re.search(args, name).groups()
            counts = {op: part.count(op) for op in ("HGMMA", "UTMALDG",
                                                     "UTMASTG")}
            smem = smem_of(key)
            label = f"{kernel}<{', '.join(key)}>"
            report[label] = {"ptxas": ptxas[key], "dynamic_smem": smem,
                             **counts}
            print(f"[build] {label}: {ptxas[key]}; {smem} bytes of dynamic "
                  f"shared memory per CTA; SASS: {counts['HGMMA']} HGMMA, "
                  f"{counts['UTMALDG']} UTMALDG, {counts['UTMASTG']} UTMASTG")
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                  f"{label} has no HGMMA or no UTMALDG in its SASS")
            seen.add(key)
        check(seen == expected, f"{kernel}: SASS found for {sorted(seen)}, "
              f"expected {sorted(expected)}")
    # the SIMT kernels redesigned for the card's SMs: ptxas's registers,
    # barriers, static shared memory and spills per instantiation (the
    # mangled template arguments: T, then the load unit V; the backward's
    # T; the tiered probe's row unit V; gather_reduce's T and V)
    for kernel, n_inst in (("probe_compact_kernel", 3),
                           ("fanout_mean_kernel", 4),
                           ("fanout_mean_bwd_kernel", 2),
                           ("probe_tiered_kernel", 3),
                           ("gather_reduce_kernel", 4)):
        found = {}
        for i, line in enumerate(log):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m and kernel in m.group(1):
                targs = re.search(kernel + r"I(\w+?)EEv", m.group(1)).group(1)
                found[targs] = " ".join(x.strip() for x in log[i + 2:i + 4])
        check(len(found) == n_inst, f"{kernel}: ptxas reports for "
              f"{sorted(found)}, expected {n_inst} instantiations")
        for targs, info in sorted(found.items()):
            print(f"[build] {kernel}<{targs}>: {info}")
            report[f"{kernel}<{targs}>"] = {"ptxas": info}
    return report


def phase_kernels(torch, dev):
    """Each kernel against its twin on the card, serve shapes + edge cases."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 0
    for (m, k, d), dtype, tol in (((128, 40, 128), torch.float32, None),
                                  ((5120, 20, 128), torch.float32, None),
                                  ((128, 40, 256), torch.float32, None),
                                  ((37, 9, 130), torch.float32, None),
                                  ((5120, 20, 128), torch.bfloat16, 2e-2),
                                  ((37, 9, 130), torch.bfloat16, 2e-2)):
        x = torch.randn((m, k, d), generator=gen, device=dev).to(dtype)
        mask = torch.rand((m, k), generator=gen, device=dev) < 0.7
        mask[:3] = False
        got, want = ops.fanout_mean(x, mask), ref.fanout_mean_ref(x, mask)
        rtol, atol = (1e-5, 1e-6) if tol is None else (tol, tol)
        check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
              f"fanout_mean {m, k, d} {dtype} disagrees with its twin: max "
              f"err {(got.float() - want.float()).abs().max().item()}")
        n += 1
    for c, d, r, assoc, dtype in ((4096, 128, 26912, 4, torch.float32),
                                  (4096, 128, 333, 1, torch.float32),
                                  (256, 40, 1000, 2, torch.float32),
                                  (4, 8, 77, 4, torch.float32),
                                  (256, 130, 333, 4, torch.bfloat16)):
        keys, rows, pool, rng = populated_cache(torch, c, d, assoc, c + r,
                                                dev, dtype)
        ids = torch.from_numpy(probe_ids(rng, pool, (r,), c)).to(dev)
        for a, b in zip(ops.cache_probe_gather(keys, rows, ids, assoc=assoc),
                        ref.cache_probe_gather_ref(keys, rows, ids,
                                                   assoc=assoc)):
            check(torch.equal(a, b), f"cache_probe_gather c={c} r={r} "
                  f"assoc={assoc} {dtype} disagrees with its twin")
        n += 1
    for c, d, h, w, r, assoc, caps in (
            (4096, 128, 4, 4, 13464, 4, (1, 6732, 1 << 20)),
            (4096, 128, 1, 4, 333, 1, (1, 40, 333)),
            (256, 40, 2, 3, 1000, 2, (1, 100)),
            (4, 8, 1, 2, 77, 4, (1, 5))):
        blocks = [populated_cache(torch, c, d, assoc, c + r + i, dev)
                  for i in range(h)]
        keys = torch.stack([bk[0] for bk in blocks])
        rows = torch.stack([bk[1] for bk in blocks])
        ids = torch.from_numpy(np.stack([probe_ids(bk[3], bk[2], (w, r), c)
                                         for bk in blocks])).to(dev)
        for hit_cap in caps:
            for a, b in zip(
                    ops.cache_probe_compact(keys, rows, ids, assoc=assoc,
                                            hit_cap=hit_cap),
                    ref.cache_probe_compact_ref(keys, rows, ids, assoc=assoc,
                                                hit_cap=hit_cap)):
                check(torch.equal(a, b), f"cache_probe_compact c={c} h={h} "
                      f"w={w} r={r} assoc={assoc} hit_cap={hit_cap} "
                      f"disagrees with its twin")
            n += 1
    # the tiered probe: the deep config's 2-way L1 before a 4-way L2 and
    # other associativities, 16-byte row units and the scalar route (D *
    # item off 16 bytes, or a base slid one element off, as in the "shift"
    # case), R = 1 and R off a multiple of 32, single-set tiers
    for c1, a1, c2, a2, d, r, dtype, shift in (
            (512, 2, 4096, 4, 128, 26912, torch.float32, False),
            (512, 2, 4096, 4, 128, 29312, torch.bfloat16, False),
            (512, 2, 4096, 4, 128, 1, torch.float32, False),
            (512, 2, 4096, 4, 128, 1000, torch.float32, True),
            (16, 1, 64, 1, 40, 77, torch.float32, False),
            (16, 2, 64, 2, 130, 96, torch.float32, False),
            (16, 4, 64, 1, 8, 33, torch.bfloat16, False),
            (2, 2, 64, 4, 8, 50, torch.float32, False),
            (8, 1, 4, 4, 8, 41, torch.float32, False)):
        blocks, pool, rng = tiered_cache(torch, c1, a1, c2, a2, d,
                                         c1 + c2 + r, dev)
        blocks[1], blocks[3] = blocks[1].to(dtype), blocks[3].to(dtype)
        if shift:
            blocks = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:]
                      .view(t.shape) for t in blocks]
        ids = torch.from_numpy(probe_ids(rng, pool, (r,), c2)).to(dev)
        for a, b in zip(ops.cache_probe_tiered(*blocks, ids, l1_assoc=a1,
                                               l2_assoc=a2),
                        ref.cache_probe_tiered_ref(*blocks, ids, l1_assoc=a1,
                                                   l2_assoc=a2)):
            check(torch.equal(a, b), f"cache_probe_tiered c1={c1}/{a1} "
                  f"c2={c2}/{a2} d={d} r={r} {dtype} shifted={shift} "
                  f"disagrees with its twin")
        n += 1
    # the backward: D a multiple of 32 and not, g one element off its base,
    # M = 1, K = 1, K > 32, all-masked rows (1 and 2), and inf / nan in g
    # (nan where the twin has nan)
    for (m, k, d), dtype, shift in (((128, 40, 256), torch.float32, False),
                                    ((480, 10, 256), torch.float32, False),
                                    ((32, 15, 256), torch.float32, False),
                                    ((480, 10, 256), torch.float32, True),
                                    ((1, 1, 256), torch.float32, False),
                                    ((3, 33, 128), torch.float32, False),
                                    ((37, 9, 130), torch.float32, False),
                                    ((5, 1100, 3), torch.float32, False),
                                    ((480, 10, 256), torch.bfloat16, False),
                                    ((32, 15, 256), torch.bfloat16, True),
                                    ((37, 9, 130), torch.bfloat16, False)):
        g = torch.randn((m * d + 1,), generator=gen, device=dev).to(dtype)
        g = (g[1:] if shift else g[:-1]).view(m, d)
        g[0, :3] = torch.tensor([float("inf"), -float("inf"), float("nan")],
                                dtype=dtype, device=dev)[:d]
        mask = torch.rand((m, k), generator=gen, device=dev) < 0.7
        mask[1:3] = False
        got = ops.fanout_mean_bwd(g, mask)
        want = ref.fanout_mean_bwd_ref(g, mask)
        nan = want.isnan()
        check(got.dtype == dtype and torch.equal(got.isnan(), nan)
              and torch.equal(got[~nan], want[~nan]),
              f"fanout_mean_bwd {m, k, d} {dtype} shifted={shift} disagrees "
              f"with its twin: max err "
              f"{(got.float() - want.float())[~nan].abs().max().item()}")
        n += 1
    for n_rows, d, m, k, dtype in ((N_NODES, 128, 1280, 20, torch.float32),
                                   (100, 64, 13, 5, torch.float32),
                                   (257, 96, 8, 40, torch.float32),
                                   (N_NODES, 128, 1280, 20, torch.bfloat16),
                                   (37, 130, 50, 9, torch.bfloat16)):
        table = torch.randn((n_rows, d), generator=gen, device=dev).to(dtype)
        idx = torch.randint(-5, n_rows + 5, (m, k), generator=gen,
                            device=dev, dtype=torch.int32)
        mask = torch.rand((m, k), generator=gen, device=dev) < 0.7
        mask[:3] = False
        ok, err = gather_close(torch, ops.gather_reduce(table, idx, mask),
                               ref.gather_reduce_ref(table, idx, mask))
        check(ok, f"gather_reduce {n_rows, d, m, k} {dtype} disagrees with "
              f"its twin: max err {err}")
        n += 1
    torch.cuda.synchronize()
    print(f"[kernels] {n} kernel-vs-twin checks passed on the card")


def gather_close(torch, got, want):
    """``gather_reduce`` against its twin: float32 within rtol 1e-5 / atol
    1e-6 (summation order), bfloat16 within 2e-2 (both round one float32
    mean once; fanout_mean's bounds).  Returns ``(ok, max abs err)``."""
    tol = (1e-5, 1e-6) if got.dtype == torch.float32 else (2e-2, 2e-2)
    err = (got.float() - want.float()).abs().max().item()
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.allclose(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])), err


def ssd_inputs(torch, dev, shape, dt_kind, seed, dtype=None):
    """Seeded SSD operands ``(x, dt, a, b, c)`` on ``dev`` for ``shape =
    (B, L, H, P, N)``: x, b, c standard normal, ``a = -exp(N(0, 1))`` (the
    reference test's), dt ``softplus(N(0, 1))`` (``"ref"``, the reference
    test's: mean ~0.8, so the carry dies within a 128-row chunk where
    ``a`` is near -1) or uniform in [0.005, 0.05] (``"small"``: the carry
    across chunks matters).  With ``dtype`` bfloat16, x, b and c are the
    same draws rounded to bf16, as views of one ``[B, L, H P + 2N]`` tensor
    (the SSM's conv output, ``ssm.ssd_operands``)."""
    b, l, h, p, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, l, h, p), generator=gen, device=dev)
    if dt_kind == "ref":
        dt = torch.nn.functional.softplus(
            torch.randn((b, l, h), generator=gen, device=dev))
    else:
        dt = 0.005 + 0.045 * torch.rand((b, l, h), generator=gen, device=dev)
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    bm = torch.randn((b, l, n), generator=gen, device=dev)
    cm = torch.randn((b, l, n), generator=gen, device=dev)
    if dtype is None or dtype == torch.float32:
        return x, dt, a, bm, cm
    from repro_torch.models.ssm import ssd_operands
    conv_out = torch.cat([x.reshape(b, l, h * p), bm, cm], dim=-1).to(dtype)
    xv, bv, cv = ssd_operands(conv_out, h, p, n)
    return xv, dt, a, bv, cv


def ssd_close(torch, got, want):
    """``ssd_scan`` against its twin: within rtol 1e-5 plus atol 1e-5 of
    the output's largest magnitude (float32 sums of up to N and Q terms in
    another order; cum is the same float64 running sum in both).  Returns
    ``(ok, max abs err, max abs err / largest |y|)``."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(scale, 1e-30))
    return ok, err, err / max(scale, 1e-30)


def ssd_gate(torch, ins, chunk, got, want):
    """The bfloat16 route against its twin (both bf16) under the derived
    gate ``ssd_scan.bf16_error_bound`` (elementwise).  Returns ``(ok, max
    abs err, the largest error as a share of its gate, the gate)``."""
    from repro_torch.kernels.ssd_scan import bf16_error_bound
    gate = bf16_error_bound(*ins, chunk=chunk)
    diff = (got.float() - want.float()).abs()
    ok = (got.dtype == want.dtype == torch.bfloat16
          and bool(torch.isfinite(got).all()) and bool((diff <= gate).all()))
    share = (diff / gate.clamp(min=1e-30)).max().item()
    return ok, diff.max().item(), share, gate


def carry_share(torch, x, dt, a, bm, cm, chunk, gate=None):
    """How much of the scan's output the carry across chunks holds: the
    twin's ``y`` against the same scan with every chunk started from a
    zero state (the sequence cut into chunk-long ones), as a share of the
    largest ``|y|``; with ``gate``, also the largest gap as a multiple of
    the gate (over 1: a dropped carry would fail it)."""
    from repro_torch.kernels import ref
    b, l, h, p = x.shape
    q = min(chunk, l)
    y = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=q).float()
    cut = ref.ssd_scan_ref(x.reshape(-1, q, h, p), dt.reshape(-1, q, h), a,
                           bm.reshape(-1, q, bm.shape[-1]),
                           cm.reshape(-1, q, cm.shape[-1]), chunk=q).float()
    gap = (y - cut.reshape(y.shape)).abs()
    share = (gap.max() / y.abs().max().clamp(min=1e-30)).item()
    if gate is None:
        return share
    return share, (gap / gate.clamp(min=1e-30)).max().item()


#: ssd_scan checks on the card: (B, L, H, P, N), chunk, dt kind; the
#: prefill's shape with both dt kinds, L = chunk, and the smoke config's
#: widths with a chunk of 8 and of 64 (float32, the SIMT route)
SSD_CHECKS = (((8, 2048, 64, 64, 128), 128, "ref"),
              ((8, 2048, 64, 64, 128), 128, "small"),
              ((2, 128, 64, 64, 128), 128, "small"),
              ((2, 64, 8, 16, 16), 8, "small"),
              ((3, 256, 5, 40, 72), 64, "ref"))
#: the bf16 copy (the tensor-core route, P 64): the prefill's shape with
#: both dt kinds, L = chunk, zamba2-1.2b's state of 64, a chunk of 64, and
#: L = chunk = 64
SSD_BF16_CHECKS = (((8, 2048, 64, 64, 128), 128, "ref"),
                   ((8, 2048, 64, 64, 128), 128, "small"),
                   ((2, 128, 64, 64, 128), 128, "small"),
                   ((4, 2048, 64, 64, 64), 128, "small"),
                   ((2, 512, 8, 64, 128), 64, "small"),
                   ((2, 64, 8, 64, 64), 64, "ref"))


def check_ssd_bf16(torch, ins, chunk, label, tag="[ssd]"):
    """One bf16 ``ssd_scan`` call through the tensor-core route (and no
    other launch) against its twin under the derived gate; prints the
    error as a share of the gate, the carry's share of y and how far a
    dropped carry lands past the gate.  Returns ``(max abs err, share of
    the gate, carry share, carry over the gate)``."""
    from repro_torch.kernels import ops, ref
    ops.reset_launch_counts()
    got = ops.ssd_scan(*ins, chunk=chunk)
    check(ops.ssd_route_counts() == {"tensor_core": 1, "float32": 0},
          f"ssd_scan bf16 {label} took the wrong route: "
          f"{ops.ssd_route_counts()}")
    ok, err, share, gate = ssd_gate(torch, ins, chunk, got,
                                    ref.ssd_scan_ref(*ins, chunk=chunk))
    check(ok, f"ssd_scan bf16 {label} is outside the bf16 gate: max err "
          f"{err}, {share:.3f} of the gate")
    carry, carry_gate = carry_share(torch, *ins, chunk, gate=gate)
    print(f"{tag} bf16 {label} within the gate (tensor-core route; max abs "
          f"err {err:.3e}, {share:.3f} of the gate; carry share {carry:.3e}, "
          f"a dropped carry at {carry_gate:.2f}x the gate)")
    return err, share, carry, carry_gate


def phase_ssd_kernels(torch, dev):
    """``ssd_scan`` against its twin on the card at ``SSD_CHECKS``
    (float32: the SIMT route, rtol 1e-5) and ``SSD_BF16_CHECKS`` (the
    tensor-core route, the derived gate), with the carry's share of the
    output printed (and required to matter, and for bf16 to land past the
    gate, for the small-dt inputs over more than one chunk)."""
    from repro_torch.kernels import ops, ref
    for i, (shape, chunk, kind) in enumerate(SSD_CHECKS):
        ins = ssd_inputs(torch, dev, shape, kind, seed=20 + i)
        ok, err, rel = ssd_close(torch, ops.ssd_scan(*ins, chunk=chunk),
                                 ref.ssd_scan_ref(*ins, chunk=chunk))
        check(ok, f"ssd_scan {shape} chunk {chunk} dt {kind} disagrees with "
              f"its twin: max err {err} ({rel:.2e} of the largest |y|)")
        share = carry_share(torch, *ins, chunk)
        if kind == "small" and shape[1] > chunk:
            check(share > 1e-2, f"ssd_scan {shape} small dt: the carry "
                  f"holds only {share:.2e} of y, the check cannot see it")
        print(f"[ssd] {shape} chunk {chunk} dt {kind} == twin (max abs err "
              f"{err:.3e}, {rel:.2e} of the largest |y|; carry share "
              f"{share:.3e})")
    for i, (shape, chunk, kind) in enumerate(SSD_BF16_CHECKS):
        ins = ssd_inputs(torch, dev, shape, kind, seed=40 + i,
                         dtype=torch.bfloat16)
        _, _, carry, carry_gate = check_ssd_bf16(
            torch, ins, chunk, f"{shape} chunk {chunk} dt {kind}")
        if kind == "small" and shape[1] > chunk:
            check(carry > 1e-2 and carry_gate > 1, f"ssd_scan bf16 {shape} "
                  f"small dt: a dropped carry lands at {carry_gate:.2f}x the "
                  f"gate, the check cannot see it")
    torch.cuda.synchronize()


def serve_args(arch, w):
    """Serving flags of the main path: 20 000 nodes (the reference serve
    driver's default), 8 warmup sweeps, buckets (8, 16, 32), 64
    requests."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", arch, "--workers", str(w), "--device", DEVICE,
        "--nodes", str(N_NODES), "--warmup-sweeps", "8",
        "--buckets", "8,16,32", "--requests", str(N_REQUESTS)])


#: served cells: (arch, W) -> the kernels that must launch on the path
SERVE_RUNS = {("graphgen-gcn", 1): ("cache_probe_gather", "fanout_mean"),
              ("graphgen-gcn", 4): ("cache_probe_compact", "fanout_mean"),
              ("graphgen-gcn-deep", 1): ("cache_probe_tiered",
                                         "fanout_mean")}


def phase_serve(torch):
    """build_server + serve_gcn for every served cell (the warmup sweeps,
    the ladder and the requests all count); returns per-cell results,
    launches and the ``(server, head_order)`` each run built and warmed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    results = {}
    for (arch, w), kernels in SERVE_RUNS.items():
        ops.reset_launch_counts()
        args = serve_args(arch, w)
        built = serve.build_server(args)
        res = serve.serve_gcn(args, built)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        res["launches"] = counts
        res["built"] = built
        results[arch, w] = res
        print(f"[serve {arch} W={w}] p50 {res['p50_ms']:.3f} ms  p99 "
              f"{res['p99_ms']:.3f} ms  QPS {res['qps']:.2f}  "
              f"({res['n_requests']} requests, {res['wall_s']:.2f} s)  "
              f"launches {counts}")
        for name in kernels:
            check(counts[name] > 0, f"{arch} W={w}: kernel {name} never "
                  f"launched on its path")
        check(counts["fanout_mean_bwd"] == 0, f"{arch} W={w}: serving ran "
              f"a backward kernel")
        check(res["request_path_compiles"] == 0, f"{arch} W={w}: requests "
              f"added step shapes outside the ladder")
        check(res["startup_compiles"] == 3, f"{arch} W={w}: ladder ran "
              f"{res['startup_compiles']} step shapes, expected 3")
        check(res["n_classes"] == 64, f"{arch} predicts 64 classes")
        check(res["n_requests"] == N_REQUESTS, f"{arch} W={w}: served "
              f"{res['n_requests']} of {N_REQUESTS} requests")
    return results


def train_args(arch, w, *extra):
    """Training flags of the main path: 20 000 nodes, batch 32 per worker,
    20 steps, full width, the calibration ladders left on unless
    ``extra`` flags pin them."""
    from repro_torch.launch import train
    return train.parse_args([
        "--arch", arch, "--workers", str(w), "--device", DEVICE,
        "--nodes", str(N_NODES), "--batch-per-worker", str(TRAIN_BATCH),
        "--steps", str(TRAIN_STEPS), "--log-every", "5", *extra])


class StepClock:
    """``train_gcn``'s step hook: the host-clock time of every step (each
    step ends with its loss on the host) and a ``torch.profiler`` trace of
    steps ``first .. first + n - 1``.  The profiler's own step calls are
    kept out of the step times and summed in ``prof_s`` (its warm-up
    initializes the device tracer, seconds once per process)."""

    def __init__(self, torch, first, n):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.first, self.n = first, n
        self.times = []
        self.prof_s = 0.0
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=first - 1, warmup=1, active=n, repeat=1))
        self.prof.__enter__()
        self.t = time.perf_counter()

    def __call__(self, step):
        now = time.perf_counter()
        self.times.append(now - self.t)
        self.prof.step()
        self.t = time.perf_counter()
        self.prof_s += self.t - now

    def close(self):
        """Stop the profiler."""
        self.prof.__exit__(None, None, None)

    def warm_window(self):
        """Host-clock times (s) of the untraced warm steps: steps 2 ..
        first - 2, past the two start-up steps and before the profiler's
        warm-up and traced steps (its overhead inflates those)."""
        return self.times[2:self.first - 1]

    def traced_ms(self):
        """Mean step time over the traced window."""
        win = self.times[self.first:self.first + self.n]
        return sum(win) / len(win) * 1e3


def summarize_profile(torch, prof, n, wall_ms, label):
    """Device busy time per step against ``wall_ms`` from a profiler's
    device-side rows, and the kernels that take it; returns the busy ms
    (None when the profiler saw no device activity)."""
    from torch.autograd import DeviceType
    # device-side rows only (kernels, copies, sets): a CPU op's row repeats
    # the device time of the kernels it launched, and a scheduled trace's
    # ProfilerStep annotation spans the whole step
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if dev_ms <= 0:
        print(f"[profile {label}] device time not measured (the profiler "
              f"saw no device activity); wall {wall_ms:.3f} ms")
        return None
    print(f"[profile {label}] wall {wall_ms:.3f} ms, device busy "
          f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - dev_ms / wall_ms):.1f}%")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"[profile {label}]   {e.self_device_time_total / 1e3 / n:8.4f} "
              f"ms  x{e.count / n:5.1f}  {e.key[:90]}")
    return dev_ms


def copy_overlap(torch, prof):
    """The L3 store's H2D copies in a profiler trace: their count, device
    ms, the ms of them that overlap a kernel on another stream, and
    whether any ran on the kernels' main stream (None when the trace
    holds no such copy)."""
    from collections import Counter
    from torch.autograd import DeviceType
    # device rows only; a scheduled trace's ProfilerStep row spans the step
    rows = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]
    copies = [e for e in rows if "HtoD" in e.name and "Pinned" in e.name]
    kernels = [e for e in rows if "Memcpy" not in e.name
               and "Memset" not in e.name]
    if not copies or not kernels:
        return None
    main = Counter(e.device_resource_id for e in kernels).most_common(1)[0][0]
    busy = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in kernels
                  if e.device_resource_id != copies[0].device_resource_id)
    total = over = 0.0
    names = Counter()
    for c in copies:
        lo, hi = c.time_range.start, c.time_range.end
        total += hi - lo
        cur = lo
        for s, e, name in busy:
            if e <= cur or s >= hi:
                continue
            over += min(e, hi) - max(s, cur)
            cur = min(e, hi)
            names[name[:40]] += 1
    return {"copies": len(copies), "copy_ms": total / 1e3,
            "overlap_ms": over / 1e3,
            "on_main_stream": any(c.device_resource_id == main
                                  for c in copies),
            "streams": sorted({c.device_resource_id for c in copies}
                              | {main}),
            "overlapped_by": dict(names.most_common(3))}


def clocked_train(torch, args, label):
    """``train_gcn`` with zeroed launch counters and a ``StepClock``: the
    result with its launches, step times, rates over all steps and over
    the untraced warm ones, the median untraced step, device busy ms per
    traced step and idle share, and the traced window's L3 H2D copies;
    and the clock."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    ops.reset_launch_counts()
    clock = StepClock(torch, first=TRAIN_STEPS - 6, n=4)
    res = train.train_gcn(args, step_hook=clock)
    clock.close()
    torch.cuda.synchronize()
    res["launches"] = ops.launch_counts()
    nodes = res["nodes_per_iter"]
    warm = clock.warm_window()
    # rates over whole windows, so a stall inside one shows: all the
    # steps (train_gcn's own clock, from batch 0 to the last loss on the
    # host, the two start-up steps and the traced ones included) and the
    # untraced warm steps; the median is a per-step statistic
    res["window_nodes_per_s"] = TRAIN_STEPS * nodes / res["wall_s"]
    res["warm_nodes_per_s"] = len(warm) * nodes / sum(warm)
    # steps 0-1: the run's wall time less the later steps and the
    # profiler's own step calls (which the step times leave out)
    res["profiler_s"] = clock.prof_s
    res["startup_s"] = res["wall_s"] - sum(clock.times[2:]) - clock.prof_s
    res["median_step_ms"] = statistics.median(warm) * 1e3
    res["step_times_ms"] = [1e3 * t for t in clock.times[1:]]
    res["traced_ms"] = clock.traced_ms()
    res["busy_ms"] = summarize_profile(torch, clock.prof, clock.n,
                                       res["traced_ms"], label)
    res["idle_share"] = (None if res["busy_ms"] is None else
                         1 - res["busy_ms"] / res["median_step_ms"])
    res["copy_overlap"] = copy_overlap(torch, clock.prof)
    return res, clock


def phase_train(torch):
    """train_gcn for both train runs with zeroed launch counters; the
    gates of phase 5.  Returns per-arch results (launches, step times, a
    profiler summary) and the trained state."""
    from repro_torch.graph.subgraph import slots_per_seed
    from repro_torch.launch import train
    results = {}
    for arch, (w, probe) in TRAIN_RUNS.items():
        args = train_args(arch, w)
        depth = len(train._model_config(args).fanouts)
        res, clock = clocked_train(
            torch, args, f"train {arch} W={w}, per traced pipelined step")
        counts = res["launches"]
        steps = TRAIN_STEPS
        if res["busy_ms"] is not None:
            print(f"[profile train {arch} W={w}] against the median untraced "
                  f"step ({res['median_step_ms']:.3f} ms): device busy "
                  f"{100 * res['busy_ms'] / res['median_step_ms']:.1f}%, "
                  f"idle "
                  f"{100 * (1 - res['busy_ms'] / res['median_step_ms']):.1f}%")
        results[arch] = res
        print(f"[train {arch} W={w}] {steps} steps in {res['wall_s']:.3f} s "
              f"({res['window_nodes_per_s']:,.0f} padded nodes/s over all "
              f"of them; steps 0-1 took {res['startup_s']:.3f} s, the "
              f"profiler's step calls {res['profiler_s']:.3f} s); warm "
              f"steps 2-{clock.first - 2}: {res['warm_nodes_per_s']:,.0f} "
              f"padded nodes/s, median step {res['median_step_ms']:.3f} ms; "
              f"slack {res['capacity_slack']}, ladders {res['ladders']}, "
              f"cache {tuple(res['cache_cfg'])}; hit rate "
              f"{res.get('cache_hit_rate', 0):.3f}; launches {counts}")
        print(f"[train {arch} W={w}] step times (ms, steps 1-{steps - 1}; "
              f"{clock.first}-{clock.first + clock.n - 1} traced) "
              f"{[round(t, 3) for t in res['step_times_ms']]}")
        print(f"[train {arch} W={w}] losses {res['losses']}")
        check(counts[probe] > 0, f"{arch}: {probe} never launched")
        check(counts["fanout_mean"] == steps * depth * (depth + 1) // 2,
              f"{arch}: fanout_mean launched {counts['fanout_mean']} times, "
              f"expected {depth * (depth + 1) // 2} per step")
        check(counts["fanout_mean_bwd"] == steps * depth * (depth - 1) // 2,
              f"{arch}: fanout_mean_bwd launched "
              f"{counts['fanout_mean_bwd']} times, expected "
              f"{depth * (depth - 1) // 2} per step")
        check(all(map(math.isfinite, res["losses"])),
              f"{arch}: a loss is not finite")
        check(res["n_dropped"] == 0, f"{arch}: trained batches dropped "
              f"{res['n_dropped']} requests")
        fanouts = train._model_config(args).fanouts
        check(res["nodes_per_iter"] == TRAIN_BATCH * w
              * slots_per_seed(fanouts),
              f"{arch}: {res['nodes_per_iter']} padded nodes/iter")
        if w > 1:
            check(res["ladders"] == ["slack", "hit_cap"],
                  f"{arch}: calibration ladders {res['ladders']}")
    return results


def fanout_mean_calls(torch, model, batch):
    """The ``(x, mask)`` of every ``fanout_mean`` call of one forward of
    ``model`` on ``batch``, in call order (hidden levels hold the model's
    own activations)."""
    from repro_torch.kernels import ops
    real, calls = ops.fanout_mean, []

    def record(x, mask):
        calls.append((x.detach().clone(), mask.clone()))
        return real(x, mask)
    ops.fanout_mean = record
    try:
        with torch.no_grad():
            model(batch)
    finally:
        ops.fanout_mean = real
    return calls


def train_probe_round(torch, res, w):
    """The compact probe's inputs on a W > 1 train run's own probe round:
    its last batch's deduplicated requests routed to their shard holders
    at the run's calibrated slack, against its warm cache; returns
    ``(keys, rows, recv, hit_cap)`` with the calibrated hit cap."""
    from repro_torch.core.collectives import StackedGroup
    from repro_torch.core.generation import (dedup_requests, probe_hit_cap,
                                             probe_round_capacity, probe_send)
    batch, cache, cfg = res["batch"], res["cache"], res["cache_cfg"]
    need = torch.cat([batch.seeds.reshape(w, -1)] + [
        h.reshape(w, -1) for h in batch.hops], dim=1)
    uniq, _, valid, _ = dedup_requests(need)
    cap = probe_round_capacity(need.shape[1], w, res["capacity_slack"])
    recv = probe_send(uniq, valid, cap, StackedGroup(w, uniq.device))[1]
    return cache.keys, cache.rows, recv, probe_hit_cap(cfg, cap)


def phase_train_kernels(torch, train_res):
    """The forward and compact-probe kernels against their twins at the
    train runs' own inputs: ``fanout_mean`` at every layer's call of the
    trained model on each run's last batch (rtol 1e-5 / atol 1e-6, f32
    summation order), and ``cache_probe_compact`` on the W = 4 run's own
    probe round with its calibrated hit cap (exact).  The tiered probe and
    the backward are held at the train inputs in the timing phase."""
    from repro_torch.kernels import ops, ref
    for arch, (w, _) in TRAIN_RUNS.items():
        res = train_res[arch]
        calls = fanout_mean_calls(torch, res["model"], res["batch"])
        depth = len(res["batch"].masks)
        check(len(calls) == depth * (depth + 1) // 2,
              f"{arch}: one forward made {len(calls)} fanout_mean calls")
        worst = 0.0
        for x, mask in calls:
            got, want = ops.fanout_mean(x, mask), ref.fanout_mean_ref(x, mask)
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"{arch}: fanout_mean {tuple(x.shape)} disagrees with its "
                  f"twin at the train inputs: max err {err}")
            worst = max(worst, err)
        print(f"[train kernels {arch} W={w}] fanout_mean == twin at every "
              f"layer call {[tuple(x.shape) for x, _ in calls]} (max abs "
              f"err {worst})")
        if w == 1:
            continue
        keys, rows, recv, hc = train_probe_round(torch, res, w)
        check(hc == res["cache_cfg"].hit_cap,
              f"{arch}: hit cap {hc} is not the calibrated "
              f"{res['cache_cfg'].hit_cap}")
        assoc = res["cache_cfg"].assoc
        got = ops.cache_probe_compact(keys, rows, recv, assoc=assoc,
                                      hit_cap=hc)
        want = ref.cache_probe_compact_ref(keys, rows, recv, assoc=assoc,
                                           hit_cap=hc)
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"{arch}: cache_probe_compact disagrees "
                  f"with its twin on the train run's probe round")
        print(f"[train kernels {arch} W={w}] cache_probe_compact == twin on "
              f"the train probe round: ids {tuple(recv.shape)}, hit_cap "
              f"{hc}")
    torch.cuda.synchronize()


def store_args(arch, w, store, depth=2):
    """The main path's training flags with the values host mode takes
    (``--capacity-slack 2.0``, ``--probe-hit-cap 0``: no ladder), so a
    device-store and a host-store run build the same exchange."""
    return train_args(arch, w, "--capacity-slack", "2.0", "--probe-hit-cap",
                      "0", "--feature-store", store, "--host-gather-depth",
                      str(depth))


#: host-store cells: (arch, W) -> the gather depths run beside the device
#: store, and the probe kernel of the path
HOST_RUNS = {("graphgen-gcn-deep", 1): ((2, 1), "cache_probe_tiered"),
             ("graphgen-gcn", 4): ((2,), "cache_probe_compact")}


def phase_host(torch):
    """Phase 9: each host-store run beside a device-store run of the same
    seeds and flags.  Gates: losses equal, no request dropped in either,
    L3 rows and bytes issued, the same kernel launches as the device run
    (fanout_mean L(L+1)/2 and fanout_mean_bwd L(L-1)/2 per step, one
    probe launch per round).  Returns the runs by ``(arch, W, store,
    depth)``."""
    from repro_torch.launch import train
    results = {}
    for (arch, w), (depths, probe) in HOST_RUNS.items():
        depth_l = len(train._model_config(train_args(arch, w)).fanouts)
        runs = [("device", 2)] + [("host", d) for d in depths]
        for store, depth in runs:
            label = f"{arch} W={w} {store} store" + (
                f" depth {depth}" if store == "host" else "")
            res, _ = clocked_train(torch, store_args(arch, w, store, depth),
                                   label)
            results[arch, w, store, depth] = res
            counts = res["launches"]
            over = res["copy_overlap"]
            idle = ("not measured" if res["idle_share"] is None
                    else f"{100 * res['idle_share']:.1f}%")
            print(f"[host {label}] median step {res['median_step_ms']:.3f} "
                  f"ms, {res['warm_nodes_per_s']:,.0f} padded nodes/s "
                  f"(warm), idle {idle}, wall {res['wall_s']:.3f} s, "
                  f"dropped {res['n_dropped']}, launches {counts}")
            check(res["n_dropped"] == 0, f"{label}: trained batches dropped "
                  f"{res['n_dropped']} requests")
            check(counts["fanout_mean"]
                  == TRAIN_STEPS * depth_l * (depth_l + 1) // 2,
                  f"{label}: fanout_mean launched {counts['fanout_mean']}")
            check(counts["fanout_mean_bwd"]
                  == TRAIN_STEPS * depth_l * (depth_l - 1) // 2,
                  f"{label}: fanout_mean_bwd launched "
                  f"{counts['fanout_mean_bwd']}")
            check(counts[probe] == TRAIN_STEPS, f"{label}: {probe} launched "
                  f"{counts[probe]} times in {TRAIN_STEPS} rounds")
            if store == "device":
                continue
            ref = results[arch, w, "device", 2]
            check(torch.equal(torch.tensor(res["losses"]),
                              torch.tensor(ref["losses"])),
                  f"{label}: losses {res['losses']} differ from the device "
                  f"store's {ref['losses']}")
            check(counts == ref["launches"], f"{label}: launches {counts} "
                  f"differ from the device store's {ref['launches']}")
            check(res["n_l3_hits"] > 0 and res["host_gather_bytes"] > 0,
                  f"{label}: no row came from the L3 store")
            print(f"[host {label}] losses == device store's; "
                  f"{res['n_l3_hits']} L3 rows, "
                  f"{res['host_gather_bytes'] / TRAIN_STEPS / 1e6:.3f} MB "
                  f"issued per step, table {res['table_bytes'] / 1e6:.1f} MB "
                  f"in host RAM; H2D copies in the traced steps: "
                  f"{'none in the trace' if over is None else over}")
    return results


def phase_host_kernels(torch, host_res):
    """The probe kernels against their twins at the host runs' own
    operands: the tiered probe on the deep depth-2 run's last round (its
    cache filled by deferred admission) and the compact probe on the W = 4
    run's round under the uncalibrated hit cap (exact)."""
    from repro_torch.core.generation import dedup_requests
    from repro_torch.kernels import ops, ref
    res = host_res["graphgen-gcn-deep", 1, "host", 2]
    batch, cache, cfg = res["batch"], res["cache"], res["cache_cfg"]
    need = torch.cat([batch.seeds.reshape(1, -1)]
                     + [h.reshape(1, -1) for h in batch.hops], dim=1)
    ids = dedup_requests(need)[0][0]
    blocks = (cache.l1.keys[0], cache.l1.rows[0], cache.l2.keys[0],
              cache.l2.rows[0], ids)
    kw = dict(l1_assoc=cfg.l1_assoc, l2_assoc=cfg.assoc)
    got, want = ops.cache_probe_tiered(*blocks, **kw), \
        ref.cache_probe_tiered_ref(*blocks, **kw)
    for a, b in zip(got, want):
        check(torch.equal(a, b), "cache_probe_tiered disagrees with its twin "
              "on the deep host run's probe round")
    print(f"[host kernels] cache_probe_tiered == twin on the deep host run's "
          f"round: ids {tuple(ids.shape)}, {int((got[0] > 0).sum())} hits")
    res = host_res["graphgen-gcn", 4, "host", 2]
    keys, rows, recv, hc = train_probe_round(torch, res, 4)
    check(res["cache_cfg"].hit_cap == 0, "the W = 4 host run calibrated a "
          "hit cap")
    assoc = res["cache_cfg"].assoc
    got = ops.cache_probe_compact(keys, rows, recv, assoc=assoc, hit_cap=hc)
    want = ref.cache_probe_compact_ref(keys, rows, recv, assoc=assoc,
                                       hit_cap=hc)
    for a, b in zip(got, want):
        check(torch.equal(a, b), "cache_probe_compact disagrees with its twin "
              "on the W = 4 host run's probe round")
    print(f"[host kernels] cache_probe_compact == twin on the W = 4 host "
          f"run's round: ids {tuple(recv.shape)}, hit_cap {hc} (auto)")
    torch.cuda.synchronize()


def phase_merge(torch):
    """Phase 10: the 20 training rounds of graphgen-gcn W = 4 generated
    with the butterfly and with the reduce-scatter merge, from the same
    draws and cold caches, in turns.  Gate: every round's batch and the
    cache state after it equal.  Returns the median ms per round of each
    and the launches."""
    from repro_torch.core.feature_cache import init_cache_state
    from repro_torch.core.generation import make_generator_fn
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    run = train.build_gcn_run(store_args("graphgen-gcn", 4, "device"))
    w, b = run["w"], run["b"]
    ops.reset_launch_counts()
    gens, caches, times = {}, {}, {}
    for mode in ("butterfly", "reduce_scatter"):
        gens[mode] = make_generator_fn(
            fanouts=run["cfg"].fanouts, merge_mode=mode,
            capacity_slack=run["slack"], cache_cfg=run["cache_cfg"])
        caches[mode] = init_cache_state(run["cache_cfg"],
                                        run["cfg"].gcn_in_dim, w,
                                        device=DEVICE)
        times[mode] = []
    with torch.no_grad():
        for t in range(TRAIN_STEPS):
            out = {}
            for mode in gens:
                seeds, draws = run["seeds_for"](t), run["draws"](t, w, b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[mode], caches[mode] = gens[mode](
                    run["device_args"], seeds, draws, caches[mode])
                torch.cuda.synchronize()
                times[mode].append(1e3 * (time.perf_counter() - t0))
            for name, x, y in zip(out["butterfly"]._fields, out["butterfly"],
                                  out["reduce_scatter"]):
                xs = x if isinstance(x, tuple) else (x,)
                ys = y if isinstance(y, tuple) else (y,)
                check(all(torch.equal(u, v) for u, v in zip(xs, ys)),
                      f"merge: round {t} {name} differs between butterfly "
                      f"and reduce_scatter")
            for u, v in zip(caches["butterfly"], caches["reduce_scatter"]):
                check(torch.equal(u, v), f"merge: round {t} cache states "
                      f"differ")
    counts = ops.launch_counts()
    check(counts["cache_probe_compact"] == 2 * TRAIN_STEPS,
          f"merge: cache_probe_compact launched "
          f"{counts['cache_probe_compact']} times")
    med = {m: statistics.median(v) for m, v in times.items()}
    print(f"[merge graphgen-gcn W=4] batches, counters and cache states equal "
          f"over {TRAIN_STEPS} rounds; median ms per round: butterfly "
          f"{med['butterfly']:.3f}, reduce_scatter "
          f"{med['reduce_scatter']:.3f} (first rounds {times['butterfly'][0]:.1f} "
          f"/ {times['reduce_scatter'][0]:.1f}); launches {counts}")
    return {"median_round_ms": med, "launches": counts}


#: offline cells: (arch, W, store), each held to phase 9's pipelined run
OFFLINE_RUNS = (("graphgen-gcn", 4, "device"), ("graphgen-gcn-deep", 1, "host"))


def phase_offline(torch, host_res):
    """Phase 11: the GraphGen baseline (``offline_gcn``: generate all, store,
    read back, train) over phase 9's 20-step schedule.  Gate: losses equal
    to the pipelined run's.  Prints t_gen, t_train, their sum and the
    pipelined run's wall time."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    results = {}
    for arch, w, store in OFFLINE_RUNS:
        ops.reset_launch_counts()
        off = train.offline_gcn(store_args(arch, w, store))
        torch.cuda.synchronize()
        off["launches"] = ops.launch_counts()
        pipe = host_res[arch, w, store, 2]
        check(torch.equal(torch.tensor(off["losses"]),
                          torch.tensor(pipe["losses"])),
              f"offline {arch} W={w} {store}: losses {off['losses']} differ "
              f"from the pipelined loop's {pipe['losses']}")
        total = off["t_gen"] + off["t_train"]
        print(f"[offline {arch} W={w} {store} store] losses == pipelined; "
              f"t_gen {off['t_gen']:.3f} s + t_train {off['t_train']:.3f} s "
              f"= {total:.3f} s against the pipelined loop's "
              f"{pipe['wall_s']:.3f} s wall ({TRAIN_STEPS} x its median step "
              f"= {TRAIN_STEPS * pipe['median_step_ms'] / 1e3:.3f} s); "
              f"launches {off['launches']}")
        results[arch, w, store] = off
    return results


def phase_ckpt(torch):
    """Phase 12: graphgen-gcn-deep W = 1 for 10 steps with checkpoints
    every 5, then ``--resume`` to 20, beside an uninterrupted 20-step run
    exported for serving; then ``serve --warm-from`` on the export.
    Gates: the resumed steps' losses and the final params equal to the
    uninterrupted run's; the warm-from server's predictions and logits
    equal to a server built from the in-process state, with no new step
    shape on the request path; a serve view of another ``n_rows``
    refused."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.generation import SeededDraws
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.train import checkpoint as ckpt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt")
    try:
        def args(steps, *extra):
            return train.parse_args([
                "--arch", "graphgen-gcn-deep", "--device", DEVICE,
                "--nodes", str(N_NODES), "--batch-per-worker",
                str(TRAIN_BATCH), "--steps", str(steps), "--log-every", "10",
                "--ckpt-dir", os.path.join(tmp, "ck"), *extra])
        ops.reset_launch_counts()
        full = train.train_gcn(args(TRAIN_STEPS, "--ckpt-every", "1000",
                                    "--export-serve",
                                    os.path.join(tmp, "serve")))
        first = train.train_gcn(args(TRAIN_STEPS // 2, "--ckpt-every", "5"))
        resumed = train.train_gcn(args(TRAIN_STEPS, "--ckpt-every", "5",
                                       "--resume"))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"[ckpt] dropped: uninterrupted {full['n_dropped']}, first "
              f"{first['n_dropped']}, resumed {resumed['n_dropped']}; "
              f"checkpoints {sorted(os.listdir(os.path.join(tmp, 'ck')))}; "
              f"launches {counts}")
        check(resumed["start"] == TRAIN_STEPS // 2, f"resumed from step "
              f"{resumed['start']}")
        check(torch.equal(torch.tensor(first["losses"] + resumed["losses"]),
                          torch.tensor(full["losses"])),
              f"ckpt: losses {first['losses'] + resumed['losses']} differ "
              f"from the uninterrupted run's {full['losses']}")
        check(all(torch.equal(a, b) for a, b in zip(
            resumed["model"].leaves(), full["model"].leaves())),
              "ckpt: the resumed run's final params differ")
        check(counts["cache_probe_tiered"] > 0, "ckpt: cache_probe_tiered "
              "never launched")
        print("[ckpt] resumed steps 10-19: losses and final params == the "
              "uninterrupted run's")

        sargs = serve_args("graphgen-gcn-deep", 1)
        sargs.warm_from = os.path.join(tmp, "serve")
        ops.reset_launch_counts()
        built = serve.build_server(sargs)
        res = serve.serve_gcn(sargs, built)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(res["request_path_compiles"] == 0, "warm-from: requests added "
              "step shapes")
        check(counts["cache_probe_tiered"] > 0 and counts["fanout_mean"] > 0,
              f"warm-from: launches {counts}")
        warm = built[0]
        cfg = train._model_config(args(TRAIN_STEPS))
        servers = [serve.GraphServer(
            warm._gen_fn, warm._device_args, model, cache,
            draws=SeededDraws(cfg.fanouts, sargs.seed, DEVICE),
            buckets=warm.buckets, n_workers=1)
            for model, cache in ((warm._model, warm.cache),
                                 (full["model"], full["cache"]))]
        rng = np.random.default_rng(5)
        stream = list(serve._zipf_request_stream(rng, N_REQUESTS, built[1],
                                                 warm.capacity))
        for s in servers:
            s.warmup()
        for ids in stream:
            a, b = (s.logits(ids) for s in servers)
            check(torch.equal(a, b), "warm-from: logits differ from the "
                  "in-process state's")
            check(torch.equal(torch.argmax(a, -1), torch.argmax(b, -1)),
                  "warm-from: predictions differ")
        check(all(s.compile_count() == 3 for s in servers),
              "warm-from: the request path added step shapes")
        print(f"[ckpt] serve --warm-from: p50 {res['p50_ms']:.3f} ms, p99 "
              f"{res['p99_ms']:.3f} ms, QPS {res['qps']:.2f}, 0 request-path "
              f"step shapes; {N_REQUESTS} requests' logits == the in-process "
              f"server's; launches {counts}")
        wrong = built[0]._model
        try:
            ckpt.restore_serving_state(
                os.path.join(tmp, "serve"), wrong, full["cache"],
                expect_cache_cfg=full["cache_cfg"]._replace(
                    n_rows=2 * full["cache_cfg"].n_rows).serve_view())
        except ValueError as e:
            print(f"[ckpt] another n_rows refused: {e}")
        else:
            fail("ckpt: a serve view with another n_rows was accepted")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": counts}


# ------------------------------------------------- autotune, baselines, fleet

#: autotune cells: (arch, W, extra flags, the probe kernel of the path)
AUTOTUNE_RUNS = (
    ("graphgen-gcn", 4, (), "cache_probe_compact"),
    ("graphgen-gcn-deep", 1, (), "cache_probe_tiered"),
    ("graphgen-gcn-deep", 1, ("--feature-store", "host",
                              "--host-gather-depth", "2"),
     "cache_probe_tiered"))
AUTOTUNE_STEPS = 8


class LoopLaunches:
    """Within the context, ``train.pipelined_loop`` records the launches
    of the trained loop alone (``counts``), apart from the autotune
    windows and any ladder that ran before it."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.launch import train
        self.train, self.orig, self.counts = train, train.pipelined_loop, None

        def loop(*args, **kwargs):
            before = ops.launch_counts()
            out = self.orig(*args, **kwargs)
            self.counts = {k: v - before[k]
                           for k, v in ops.launch_counts().items()}
            return out
        train.pipelined_loop = loop
        return self

    def __exit__(self, *exc):
        self.train.pipelined_loop = self.orig


def first_step_split():
    """``--first-step``: in this fresh process, the once-per-process costs
    of a train run's step 0, each ended by a synchronize: library start-up
    (import torch, the CUDA context), loading the built kernels, the run's
    set-up (graph, tables, placement, model), the first generation round,
    forward, backward and AdamW, then the second of each (warm); then a
    ``torch.profiler`` set up as ``StepClock`` sets it up (entered, then
    stepped through its wait, warm-up and one traced step, then closed)
    around six more steps.  Prints one JSON line."""
    t = time.perf_counter()
    out = {}

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        out[name] = now - t
        t = now

    import torch
    lap("import_torch_s")
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    lap("cuda_context_s")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    _build.build()
    _build.library()
    lap("kernels_load_s")
    from repro_torch.launch import train
    from repro_torch.models.gcn import gcn_loss
    from repro_torch.train.optimizer import adam_update, init_adam
    run = train.build_gcn_run(train_args("graphgen-gcn-deep", 1))
    model, cache = run["model"], run["cache"]
    opt = init_adam(model.leaves())
    torch.cuda.synchronize()
    lap("setup_s")
    for rnd in ("first", "second"):
        i = 0 if rnd == "first" else 1
        with torch.no_grad():
            batch, cache = run["gen_fn"](run["device_args"],
                                         run["seeds_for"](i),
                                         run["draws"](i, 1, TRAIN_BATCH),
                                         cache)
        torch.cuda.synchronize()
        lap(f"{rnd}_generation_s")
        params = model.leaves()
        loss = gcn_loss(model, batch)
        torch.cuda.synchronize()
        lap(f"{rnd}_forward_s")
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        lap(f"{rnd}_backward_s")
        new, opt, _ = adam_update(run["tcfg"], params, grads, opt)
        with torch.no_grad():
            for p, n in zip(params, new):
                p.copy_(n)
        torch.cuda.synchronize()
        lap(f"{rnd}_adamw_s")
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=3, warmup=1, active=1, repeat=1))
    prof.__enter__()
    lap("profiler_enter_s")
    for i in range(2, 8):
        with torch.no_grad():
            batch, cache = run["gen_fn"](run["device_args"],
                                         run["seeds_for"](i),
                                         run["draws"](i, 1, TRAIN_BATCH),
                                         cache)
        model, opt, loss = run["train_fn"](model, opt, batch)
        float(loss)
        prof.step()
        lap(f"profiled_step{i - 2}_s")
    prof.__exit__(None, None, None)
    lap("profiler_exit_s")
    print(json.dumps({"first_step": out}))


def phase_first_step():
    """Satellite of phase 13: ``first_step_split`` in a fresh process (this
    one paid its once-per-process costs long ago).  Prints the split and
    returns it."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--first-step"], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"first-step process failed: "
          f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith('{"first_step"')]
    check(len(line) == 1, f"first-step process printed {proc.stdout[-2000:]}")
    split = json.loads(line[0])["first_step"]
    split["process_wall_s"] = wall
    print("[first step] a fresh process, graphgen-gcn-deep W=1 (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return split


def phase_autotune(torch):
    """Phase 13: ``train_gcn --autotune --autotune-steps 8`` for 20 steps
    in each of ``AUTOTUNE_RUNS``.  Prints the trace length and its
    violations, the candidates searched, the best predicted against the
    traced ms per step, each validated pick with its measured ms and its
    verdict (or the fallback reason), the accepted candidate, and the
    trained run's warm nodes/s, idle share and launches.  Gates: no
    violation; the anchor prediction's counts and bytes equal to the warm
    window's sums; in the host cell every record's L3 bytes equal to W x
    the static gather; finite losses and no request dropped; per step of
    the trained loop, fanout_mean L(L+1)/2 and fanout_mean_bwd L(L-1)/2
    launches and one probe launch."""
    from repro_torch.launch import autotune as at
    from repro_torch.launch import train
    results = {"first_step": phase_first_step()}
    for arch, w, extra, probe in AUTOTUNE_RUNS:
        store = "host" if "host" in extra else "device"
        label = f"{arch} W={w} {store}"
        args = train_args(arch, w, "--autotune", "--autotune-steps",
                          str(AUTOTUNE_STEPS), *extra)
        depth = len(train._model_config(args).fanouts)
        with LoopLaunches() as loop:
            res, _ = clocked_train(torch, args, f"autotune {label}, per "
                                   f"traced pipelined step")
        r = res["autotune"]
        trace = r.trace
        tc = trace.config
        viol = trace.violations()
        print(f"[autotune {label}] trace {len(trace.records)} steps, "
              f"violations {viol}; step ms "
              f"{[round(x.wall_time_s * 1e3, 3) for x in trace.records]}")
        check(len(trace.records) == AUTOTUNE_STEPS and viol == (),
              f"{label}: trace of {len(trace.records)} steps, violations "
              f"{viol}")
        model = at.CostModel.fit(trace)
        p = model.predict(tc.candidate())
        warm = trace.warm_records()
        probe_b, gather_b, _ = at.static_wire_bytes(tc, tc.candidate())
        check((p.n_hits, p.n_l1_hits, p.n_l3_hits, p.n_misses, p.n_distinct)
              == (sum(x.n_hits for x in warm), sum(x.n_l1_hits for x in warm),
                  sum(x.n_l3_hits for x in warm),
                  sum(x.n_misses for x in warm),
                  sum(x.n_distinct() for x in warm))
              and (p.probe_round_bytes, p.host_gather_bytes)
              == (probe_b, gather_b) and p.step_time_s == model.wall_mean_s,
              f"{label}: the anchor prediction {p} is not the warm window's")
        if store == "host":
            check(gather_b > 0 and all(x.host_gather_bytes == w * gather_b
                                       for x in trace.records),
                  f"{label}: L3 bytes {[x.host_gather_bytes for x in trace.records]}"
                  f" != W x {gather_b}")
        print(f"[autotune {label}] anchor exact: hits {p.n_hits:.0f}, L1 "
              f"{p.n_l1_hits:.0f}, L3 {p.n_l3_hits:.0f}, misses "
              f"{p.n_misses:.0f} of {p.n_distinct:.0f} distinct over "
              f"{len(warm)} warm steps; probe {p.probe_round_bytes} B, "
              f"gather {p.host_gather_bytes} B per worker")
        if r.picks:
            best = r.picks[0].prediction
            print(f"[autotune {label}] searched {r.n_searched} candidates; "
                  f"best predicted {best.step_time_s * 1e3:.3f} ms/step vs "
                  f"traced {model.wall_mean_s * 1e3:.3f}")
        for v in r.picks:
            c = v.prediction.candidate
            print(f"[autotune {label}] pick fanouts={c.fanouts} rows="
                  f"{c.cache_rows} l1={c.l1_rows} assoc={c.assoc} hit_cap="
                  f"{c.hit_cap} slack={c.capacity_slack}: predicted "
                  f"{v.prediction.step_time_s * 1e3:.3f} ms, measured "
                  f"{v.measured_step_s * 1e3:.3f} ms, dropped {v.n_dropped}, "
                  f"demoted {v.n_demoted}: "
                  f"{'accepted' if v.accepted else 'rejected'}")
        verdict = ("accepted " + str(tuple(r.candidate)) if r.accepted
                   else "fallback: " + r.reason)
        if res["autotune_rollback"] is not None:
            verdict += (f"; rolled back to the traced slack at step "
                        f"{res['autotune_rollback']} (the pick's exchange "
                        f"dropped requests)")
        counts = loop.counts
        idle = ("not measured" if res["idle_share"] is None
                else f"{100 * res['idle_share']:.1f}%")
        print(f"[autotune {label}] {verdict}; trained with slack "
              f"{res['capacity_slack']}, fanouts {res['fanouts']}, cache "
              f"{tuple(res['cache_cfg']) if res['cache_cfg'] else None}, "
              f"ladders {res['ladders']}: {res['warm_nodes_per_s']:,.0f} "
              f"padded nodes/s (warm), median step "
              f"{res['median_step_ms']:.3f} ms, idle {idle}, steps 0-1 "
              f"{res['startup_s']:.3f} s (the profiler's step calls "
              f"{res['profiler_s']:.3f} s apart); launches: all "
              f"{res['launches']}, trained loop {counts}")
        check(all(map(math.isfinite, res["losses"])),
              f"{label}: a loss is not finite")
        check(res["n_dropped"] == 0, f"{label}: the trained batches dropped "
              f"{res['n_dropped']} requests")
        # a rollback generates its batch once more: one more probe round
        rounds = TRAIN_STEPS + (res["autotune_rollback"] is not None)
        check(counts["fanout_mean"] == TRAIN_STEPS * depth * (depth + 1) // 2
              and counts["fanout_mean_bwd"]
              == TRAIN_STEPS * depth * (depth - 1) // 2
              and counts[probe] == rounds,
              f"{label}: trained-loop launches {counts} ({rounds} rounds)")
        res["autotune_summary"] = {
            "trace_steps": len(trace.records),
            "traced_ms": model.wall_mean_s * 1e3,
            "trace_step_ms": [x.wall_time_s * 1e3 for x in trace.records],
            "searched": r.n_searched, "accepted": r.accepted,
            "reason": r.reason, "rollback_at": res["autotune_rollback"],
            "candidate": list(r.candidate) if r.candidate else None,
            "picks": [{"candidate": list(v.prediction.candidate),
                       "predicted_ms": v.prediction.step_time_s * 1e3,
                       "measured_ms": v.measured_step_s * 1e3,
                       "dropped": v.n_dropped, "demoted": v.n_demoted,
                       "accepted": v.accepted} for v in r.picks],
            "loop_launches": counts}
        results[label] = res
    return results


#: the autotune agreement cells (the CPU differential test's shape): name
#: -> (W, store, cache policy)
AGREE_AUTOTUNE = {
    "sharded": (4, "device", dict(n_rows=256, admit=1, assoc=2,
                                  mode="sharded", wire="compact", hit_cap=0)),
    "host": (4, "host", dict(n_rows=256, admit=1, assoc=2, mode="sharded",
                             wire="compact", hit_cap=0, store="host")),
    "tiered": (1, "device", dict(n_rows=256, admit=1, assoc=2, mode="tiered",
                                 l1_rows=32, l1_promote=1)),
}


def phase_autotune_agree(torch):
    """Phase 14: the autotune trace of the card against the CPU's (the
    port's plain twins) on the same seeds and draws, at the CPU
    differential test's shape (2 000 nodes, W = 4 sharded device and host
    store, W = 1 tiered; b 8, dim 16, fanouts (3, 2), slack 1.0, 8 steps).
    Gate: every record equal in every field but wall_time_s; both
    consistent; the path's probe kernel launched on the card."""
    import numpy as np
    from repro_torch.core.balance import balance_table
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import SeededDraws
    from repro_torch.core.partition import partition_edges
    from repro_torch.graph.synthetic import (node_features, node_labels,
                                             powerlaw_graph)
    from repro_torch.kernels import ops
    from repro_torch.launch import autotune as at
    n, dim, b, fanouts, steps = 2000, 16, 8, (3, 2), 8
    g = powerlaw_graph(n, avg_degree=8, n_hot=3, hot_degree=400, seed=0)
    x, y = node_features(n, dim), node_labels(n, 5)
    launches = {}
    for name, (w, store, kw) in AGREE_AUTOTUNE.items():
        part = partition_edges(g, w)
        table = balance_table(np.arange(n), w, seed=0)
        cfg = CacheConfig(**kw).validated()
        tc = at._traced_config(fanouts, w, b, dim, cfg, 1.0, store)
        draws = SeededDraws(fanouts, 1, "cpu")
        cpu = [(torch.from_numpy(np.ascontiguousarray(
            table.per_worker[:, (np.arange(b) + t * b)
                             % table.per_worker.shape[1]])),
                draws(t, w, b)) for t in range(steps)]
        card = [(s.to(DEVICE), tuple((o.to(DEVICE), e.to(DEVICE))
                                     for o, e in d)) for s, d in cpu]
        ops.reset_launch_counts()
        got = at._instrumented_run(DEVICE, part, x, y, tc, cfg, card)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = at._instrumented_run("cpu", part, x, y, tc, cfg, cpu)
        a = [tuple(r)[:-1] for r in got.records]
        e = [tuple(r)[:-1] for r in want.records]
        check(a == e, f"autotune agree {name}: card records {a} != CPU {e}")
        check(got.violations() == () == want.violations(),
              f"autotune agree {name}: violations {got.violations()}")
        probe = "cache_probe_tiered" if w == 1 else "cache_probe_compact"
        check(counts[probe] == steps, f"autotune agree {name}: {probe} "
              f"launched {counts[probe]} times in {steps} rounds")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[autotune agree {name} W={w}] {steps} card records == the "
              f"CPU's in every field but wall_time_s (hits "
              f"{sum(r.n_hits for r in got.records)}, L1 "
              f"{sum(r.n_l1_hits for r in got.records)}, L3 "
              f"{sum(r.n_l3_hits for r in got.records)}, misses "
              f"{sum(r.n_misses for r in got.records)}); card step ms "
              f"{[round(r.wall_time_s * 1e3, 3) for r in got.records]}; "
              f"launches {counts}")
    return {"launches": launches}


#: the baselines' task (benchmarks/gen_throughput.py's defaults)
BASE_NODES, BASE_SEEDS, BASE_FANOUTS = 20_000, 256, (40, 20)
SCALE_NODES, SCALE_SEEDS = 60_000, 1_189
BASE_CALLS, NODE_CALLS = 5, 3


def timed_calls(torch, fn, n):
    """One warm call, then ``n`` calls each read by the host clock (to a
    synchronize) and by CUDA events: ``(host ms list, event ms list)``."""
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return host, dev


def launched_ops(torch, fn):
    """Non-view aten ops with a CUDA output that ``fn()`` dispatches: its
    kernel launches (every op the baselines run launches one kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if not func.is_view and any(
                    isinstance(o, torch.Tensor) and o.is_cuda for o in outs):
                self.n += 1
            return out

    with Count() as c:
        fn()
    torch.cuda.synchronize()
    return c.n


def csr_members(torch, indptr, indices, frontier, ids, mask):
    """Whether every kept id is an out-neighbour of its frontier node: a
    search of ``node * N + id`` in the sorted edge keys."""
    n = indptr.shape[0] - 1
    deg = (indptr[1:] - indptr[:-1]).to(torch.int64)
    src = torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)
    keys = torch.unique(src * n + indices.to(torch.int64))
    q = frontier.to(torch.int64)[:, None] * n + ids.to(torch.int64)
    pos = torch.clamp(torch.searchsorted(keys, q.reshape(-1)), max=len(keys) - 1)
    found = (keys[pos] == q.reshape(-1)).reshape(q.shape)
    return bool((found | ~mask).all())


def phase_baselines(torch):
    """Phase 15: the paper's three samplers on
    ``benchmarks/gen_throughput.py``'s default task (20 000 nodes, avg
    degree 10, 40 hot nodes of degree 2 000, seed 0; 256 seeds, fanouts
    (40, 20): 215 296 padded nodes per iteration), both hops each, draws
    from seeded ``torch.Generator``s on the card.  Prints each sampler's
    ms by host clock and CUDA events (median of several calls after a
    warm one, with the range), nodes/s, the edge-centric speedups beside
    the paper's 27x, and node-centric's launches; then edge-centric alone
    at the reference's ``--scale`` task (60 000 nodes, 1 189 seeds:
    999 949 padded nodes).  Gates: every kept id an out-neighbour of its
    node; the SQL-like and node-centric masks keep min(deg, k) per row;
    the edge-centric mask equals its finite keys."""
    import numpy as np
    from repro_torch.core import baselines as base
    from repro_torch.core.generation import local_candidates
    from repro_torch.graph.subgraph import slots_per_seed
    from repro_torch.graph.synthetic import powerlaw_graph

    def graph(n_nodes):
        g = powerlaw_graph(n_nodes, avg_degree=10, n_hot=n_nodes // 500,
                           hot_degree=2_000, seed=0)
        src, dst = g.edge_list()
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
             for a in (g.indptr, g.indices, src, dst)]
        return g, t

    g, (indptr, indices, src, dst) = graph(BASE_NODES)
    max_deg = int(g.degrees().max())
    seeds = torch.arange(BASE_SEEDS, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE)

    def draws(name, level, f, k):
        gen.manual_seed(1000 * level + {"sql": 1, "node": 2, "edge": 3}[name])
        if name == "sql":
            return (base.sql_priorities(gen, src.shape[0], DEVICE),)
        if name == "node":
            return (base.node_centric_draws(gen, f, max_deg, DEVICE),)
        return base.edge_centric_draws(gen, f, k, DEVICE)

    def sampler(name, frontier, k, d):
        if name == "sql":
            return base.sql_like_sample(src, dst, frontier, k, *d)
        if name == "node":
            return base.node_centric_sample(indptr, indices, frontier, k, *d,
                                            max_deg)
        return base.edge_centric_sample(indptr, indices, frontier, k, *d)

    # the draws of both hops are made once, outside the timed calls
    f1 = BASE_SEEDS
    f2 = BASE_SEEDS * BASE_FANOUTS[0]
    hop_draws = {name: [draws(name, 0, f1, BASE_FANOUTS[0]),
                        draws(name, 1, f2, BASE_FANOUTS[1])]
                 for name in ("sql", "node", "edge")}

    def expand(name):
        frontier, out = seeds, []
        for level, k in enumerate(BASE_FANOUTS):
            ids, m = sampler(name, frontier, k, hop_draws[name][level])
            out.append((frontier, ids, m))
            frontier = ids.reshape(-1)
        return out

    nodes = BASE_SEEDS * slots_per_seed(BASE_FANOUTS)
    deg_all = (indptr[1:] - indptr[:-1]).to(torch.int64)
    res = {"nodes_per_iter": nodes, "max_degree": max_deg,
           "n_edges": int(g.n_edges)}
    for name in ("edge", "sql", "node"):
        out = expand(name)
        torch.cuda.synchronize()
        for level, (frontier, ids, m) in enumerate(out):
            k = BASE_FANOUTS[level]
            check(csr_members(torch, indptr, indices, frontier, ids, m),
                  f"baselines {name} hop {level}: a kept id is not an "
                  f"out-neighbour of its node")
            deg = deg_all[frontier.to(torch.int64)]
            if name == "edge":
                cand = local_candidates(indptr, indices, frontier, k,
                                        *hop_draws[name][level])
                check(torch.equal(m, torch.isfinite(cand.keys))
                      and torch.equal(m, (deg > 0)[:, None].expand_as(m)),
                      f"baselines edge hop {level}: the mask is not its "
                      f"finite keys")
            else:
                check(torch.equal(m.sum(1), torch.clamp(deg, max=k)),
                      f"baselines {name} hop {level}: the mask does not keep "
                      f"min(deg, k) per row")
        n = NODE_CALLS if name == "node" else BASE_CALLS
        host, dev = timed_calls(torch, lambda: expand(name), n)
        entry = {"host_ms": statistics.median(host), "host_range":
                 [min(host), max(host)], "event_ms": statistics.median(dev),
                 "event_range": [min(dev), max(dev)], "calls": n,
                 "kept": [int(m.sum()) for _, _, m in out]}
        entry["nodes_per_s"] = nodes / (entry["event_ms"] / 1e3)
        if name == "node":
            entry["launches"] = launched_ops(torch, lambda: expand(name))
        res[name] = entry
        print(f"[baselines {name}] {entry['event_ms']:.3f} ms by events "
              f"(range {entry['event_range'][0]:.3f}-"
              f"{entry['event_range'][1]:.3f}), {entry['host_ms']:.3f} ms by "
              f"host clock ({entry['host_range'][0]:.3f}-"
              f"{entry['host_range'][1]:.3f}), median of {n} after a warm "
              f"call; {entry['nodes_per_s']:,.0f} padded nodes/s; kept "
              f"{entry['kept']}"
              + (f"; {entry['launches']} launches per call ({max_deg} "
                 f"serial steps per hop)" if name == "node" else ""))
    for other in ("sql", "node"):
        res[f"edge_vs_{other}"] = res[other]["event_ms"] / res["edge"][
            "event_ms"]
        res[f"edge_vs_{other}_host"] = res[other]["host_ms"] / res["edge"][
            "host_ms"]
    print(f"[baselines] edge-centric speedup over SQL-like "
          f"{res['edge_vs_sql']:.1f}x by events "
          f"({res['edge_vs_sql_host']:.1f}x by host clock; the paper: 27x), "
          f"over node-centric {res['edge_vs_node']:.1f}x "
          f"({res['edge_vs_node_host']:.1f}x)")
    del hop_draws
    # the reference's --scale task: edge-centric alone
    g, (indptr, indices, _, _) = graph(SCALE_NODES)
    seeds = torch.arange(SCALE_SEEDS, dtype=torch.int32, device=DEVICE)
    gen.manual_seed(7)
    sdraws = [base.edge_centric_draws(gen, SCALE_SEEDS, BASE_FANOUTS[0],
                                      DEVICE),
              base.edge_centric_draws(gen, SCALE_SEEDS * BASE_FANOUTS[0],
                                      BASE_FANOUTS[1], DEVICE)]

    def expand_scale():
        frontier, out = seeds, []
        for level, k in enumerate(BASE_FANOUTS):
            ids, m = base.edge_centric_sample(indptr, indices, frontier, k,
                                              *sdraws[level])
            out.append((frontier, ids, m))
            frontier = ids.reshape(-1)
        return out

    for level, (frontier, ids, m) in enumerate(expand_scale()):
        check(csr_members(torch, indptr, indices, frontier, ids, m),
              f"baselines scale hop {level}: a kept id is not an "
              f"out-neighbour")
    host, dev = timed_calls(torch, expand_scale, BASE_CALLS)
    nodes = SCALE_SEEDS * slots_per_seed(BASE_FANOUTS)
    res["scale"] = {"nodes_per_iter": nodes,
                    "event_ms": statistics.median(dev),
                    "event_range": [min(dev), max(dev)],
                    "host_ms": statistics.median(host),
                    "host_range": [min(host), max(host)],
                    "nodes_per_s": nodes / (statistics.median(dev) / 1e3)}
    print(f"[baselines scale] edge-centric at {SCALE_NODES} nodes, "
          f"{SCALE_SEEDS} seeds ({nodes:,} padded nodes per iteration): "
          f"{res['scale']['event_ms']:.3f} ms by events (range "
          f"{min(dev):.3f}-{max(dev):.3f}), {res['scale']['host_ms']:.3f} ms "
          f"by host clock; {res['scale']['nodes_per_s']:,.0f} padded "
          f"nodes/s")
    return res


#: the recovery run (examples/distributed_pipeline.py's): nodes, feature
#: dim, classes, batch per worker, fanouts; the failure, the checkpoint
#: cadence and the end
REC_N, REC_DIM, REC_CLASSES, REC_B, REC_FANOUTS = 20_000, 64, 8, 16, (8, 4)
REC_FAILED, REC_FAIL_AT, REC_CKPT_EVERY, REC_TOTAL = (3, 6), 20, 10, 40


def phase_recovery(torch):
    """Phase 16: the counterpart of ``examples/distributed_pipeline.py`` on
    the port: 20 000 nodes, dim 64, 8 classes, b 16, fanouts (8, 4), a
    tiered cache (1 024 rows, admit 2, 2-way, a 128-row L1, promote 2) at
    W = 8, checkpoints every 10 steps; two ``FailureInjector``s lose
    workers 3 and 6 at step 20; ``recover_assignment`` deals the pool
    over the 6 survivors, the butterfly merge's power of two takes 4 of
    them, the generator is rebuilt at W = 4 with a cold cache, the latest
    checkpoint restored, and the run resumes to step 40.  Gates: the
    resume starts at the checkpoint's step; the survivors' table deals
    equal shares; every loss finite; at both widths the L1 gather probe,
    the compact probe round and fanout_mean / fanout_mean_bwd launched."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import (adam_state_from_numpy,
                                     adam_state_to_numpy,
                                     gcn_params_from_numpy,
                                     gcn_params_to_numpy)
    from repro_torch.core.balance import balance_table, load_skew
    from repro_torch.core.config import TrainConfig
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import (SeededDraws,
                                             make_distributed_generator)
    from repro_torch.core.partition import partition_edges
    from repro_torch.core.pipeline import pipelined_loop
    from repro_torch.graph.synthetic import node_features, powerlaw_graph
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_gcn_train_fn
    from repro_torch.models.gcn import init_gcn
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import (FailureInjector, WorkerFailure,
                                         recover_assignment)
    from repro_torch.train.optimizer import init_adam

    graph = powerlaw_graph(REC_N, avg_degree=8, n_hot=20, hot_degree=1000,
                           seed=0)
    feats = node_features(REC_N, REC_DIM)
    labels = np.argmax(feats @ np.random.default_rng(0).standard_normal(
        (REC_DIM, REC_CLASSES)), 1).astype(np.int32)
    cfg = dataclasses.replace(get_config("graphgen-gcn"), gcn_in_dim=REC_DIM,
                              n_classes=REC_CLASSES, gcn_hidden=128,
                              fanouts=REC_FANOUTS)
    cache_cfg = CacheConfig(n_rows=1024, admit=2, assoc=2, mode="tiered",
                            l1_rows=128, l1_promote=2).validated()
    train_fn = make_gcn_train_fn(TrainConfig(learning_rate=3e-3,
                                             warmup_steps=0, total_steps=60))
    draws = SeededDraws(REC_FANOUTS, 1, DEVICE)
    injectors = [FailureInjector(fail_worker=f, fail_at_step=REC_FAIL_AT)
                 for f in REC_FAILED]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recovery")
    losses, widths = {}, {}

    def run(workers, table, start, model, opt):
        """Train steps ``start .. REC_TOTAL - 1`` at ``workers`` from a cold
        cache; returns the lost workers (and the step) on a failure."""
        gen_fn, dargs, cache = make_distributed_generator(
            partition_edges(graph, workers), feats, labels,
            fanouts=REC_FANOUTS, cache_cfg=cache_cfg, device=DEVICE)
        per = table.per_worker
        sched = np.stack([per[:, (np.arange(REC_B) + t * REC_B)
                              % per.shape[1]]
                          for t in range(start, REC_TOTAL)])
        lost = []

        def before(i, carry, gen):
            for inj in injectors:
                try:
                    inj.check(start + i)
                except WorkerFailure as e:
                    lost.append(e)
            if lost:
                raise lost[0]
            return carry, gen

        def after(i, carry, loss):
            t = start + i
            losses[t] = float(loss)
            if (t + 1) % REC_CKPT_EVERY == 0:
                ckpt.save(tmp, t + 1, (gcn_params_to_numpy(carry[0]),
                                       adam_state_to_numpy(carry[1])), keep=3)
                print(f"[recovery W={workers}] step {t + 1}: loss "
                      f"{losses[t]:.4f}, cache hit rate "
                      f"{carry[2].cache_hit_rate():.3f} [checkpointed]")

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            pipelined_loop(gen_fn, train_fn, dargs, sched, model, opt,
                           lambda i, *a: draws(start + i, *a), cache=cache,
                           before_step=before, after_step=after)
        except WorkerFailure:
            pass
        torch.cuda.synchronize()
        widths[workers] = {"launches": ops.launch_counts(),
                           "wall_s": time.perf_counter() - t0,
                           "steps": len([t for t in losses if t >= start])}
        return sorted(e.worker for e in lost), (lost[0].step if lost else None)

    try:
        table8 = balance_table(np.arange(REC_N), 8, seed=0)
        model = init_gcn(cfg, 0, device=DEVICE)
        lost, at_step = run(8, table8, 0, model, init_adam(model.leaves()))
        check(lost == sorted(REC_FAILED) and at_step == REC_FAIL_AT,
              f"recovery: lost {lost} at step {at_step}")
        table6 = recover_assignment(table8, failed=lost)
        shares = table6.per_worker.shape[1]
        check(table6.n_workers == 8 - len(lost)
              and load_skew(np.full(table6.n_workers, shares)) == 1.0
              and table6.n_discarded < table6.n_workers
              and set(table6.per_worker.reshape(-1).tolist())
              <= set(table8.per_worker.reshape(-1).tolist()),
              f"recovery: survivors' table {table6.per_worker.shape}, "
              f"{table6.n_discarded} discarded")
        # the butterfly merge needs a power-of-two worker axis: 4 of the 6
        # survivors run, the pool re-dealt over them
        table4 = recover_assignment(table6, failed=[4, 5], seed=2)
        restore = ckpt.latest_step(tmp)
        check(restore == REC_FAIL_AT, f"recovery: latest checkpoint "
              f"{restore}, expected {REC_FAIL_AT}")
        like = init_gcn(cfg, 0, device=DEVICE)
        params_np, opt_np = ckpt.restore(
            tmp, restore, (gcn_params_to_numpy(like),
                           adam_state_to_numpy(init_adam(like.leaves()))))
        resumed = gcn_params_from_numpy(params_np, device=DEVICE)
        for t in [t for t in losses if t >= restore]:
            del losses[t]
        print(f"[recovery] workers {lost} lost at step {at_step}; survivors' "
              f"table {table6.n_workers} x {shares} (discarded "
              f"{table6.n_discarded}), rebuilt at W=4 x "
              f"{table4.per_worker.shape[1]}; resuming from checkpoint "
              f"{restore}")
        lost2, _ = run(4, table4, restore, resumed,
                       adam_state_from_numpy(opt_np, device=DEVICE))
        check(lost2 == [], f"recovery: a second failure {lost2}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sorted(losses)
    check(steps == list(range(REC_TOTAL)), f"recovery: trained steps {steps}")
    check(all(map(math.isfinite, losses.values())),
          "recovery: a loss is not finite")
    for w, rec in widths.items():
        c = rec["launches"]
        check(c["cache_probe_gather"] > 0 and c["cache_probe_compact"] > 0
              and c["fanout_mean"] == 3 * rec["steps"]
              and c["fanout_mean_bwd"] == rec["steps"],
              f"recovery W={w}: launches {c} over {rec['steps']} steps")
        print(f"[recovery W={w}] {rec['steps']} steps in {rec['wall_s']:.3f} "
              f"s; launches {c}")
    print(f"[recovery] resumed at step {REC_FAIL_AT} on 4 workers; losses "
          f"{[round(losses[t], 4) for t in steps]}")
    launches = {}
    for rec in widths.values():
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "losses": [losses[t] for t in steps],
            "widths": {w: {k: r[k] for k in ("steps", "wall_s")}
                       for w, r in widths.items()},
            "resumed_at": REC_FAIL_AT}


#: the dist phase: graphgen-gcn's train cell (20 000 nodes, batch 32 per
#: worker, 20 steps) with one process per worker over gloo on the one
#: card, at these widths, each beside the stacked run of the same flags
DIST_WORKERS = (2, 4)
DIST_TIMEOUT_S = 300         # the launcher's wait for its ranks
#: kernels every rank must launch on the dist phase's path
DIST_KERNELS = ("cache_probe_compact", "fanout_mean", "fanout_mean_bwd")


def read_report(path, name):
    """A ``train --report`` run's ``(meta, arrays)`` for ``name``
    (``stacked`` or ``rank<r>``)."""
    import numpy as np
    with open(os.path.join(path, name + ".json")) as f:
        meta = json.load(f)
    return meta, dict(np.load(os.path.join(path, name + ".npz")))


def dist_compare(stacked, ranks, world, split=None):
    """The dist phase's gates for one width: the rungs, the first rounds'
    batch and cache digests and their FetchStats / CacheStats per
    worker, the losses (rtol 1e-5), and the parameters and Adam moments
    bit-equal across ranks and within rtol 1e-5 / atol 1e-7 of the
    stacked run's.  Returns the largest differences.

    With ``split`` (the ``(meta, arrays)`` of the stacked run with
    ``--per-worker-loss``: the ranks' arithmetic in one process) the
    final parameters and moments are held to that bound against the
    split run instead, and the split run's own distance from the stacked
    run is recorded (``split_rel_norm``, each leaf's norm share): the
    drift that averaging per-worker mean gradients alone makes.  The
    state after the first step (``p<i>@1``, ...) is always held to the
    stacked run: a gradient summed, scaled or clipped wrongly shows
    there at once."""
    import numpy as np
    want, want_np = stacked
    check(len(want["rounds"]) == 3, f"dist W={world}: the stacked report "
          f"holds {len(want['rounds'])} rounds")
    loss_rel = param_abs = param_rel = 0.0
    split_rel, stacked_rel, n_split_equal = {}, {}, 0
    for r, (meta, arrays) in enumerate(ranks):
        for key in ("capacity_slack", "hit_cap", "wire", "ladders"):
            check(meta[key] == want[key], f"dist W={world} rank {r}: {key} "
                  f"{meta[key]} against the stacked run's {want[key]}")
        for t, (a, b) in enumerate(zip(want["rounds"], meta["rounds"])):
            check(a["batch"][str(r)] == b["batch"][str(r)]
                  and a["cache"][str(r)] == b["cache"][str(r)],
                  f"dist W={world} rank {r}: round {t}'s batch or cache "
                  f"differs from the stacked worker block")
            for name, v in a["stats"].items():
                check(b["stats"][name] == [v[r]],
                      f"dist W={world} rank {r}: round {t} {name} "
                      f"{b['stats'][name]} against {v[r]}")
        lw, lg = np.asarray(want["losses"]), np.asarray(meta["losses"])
        check(np.allclose(lg, lw, rtol=1e-5, atol=0),
              f"dist W={world} rank {r}: losses {lg} against {lw}")
        loss_rel = max(loss_rel, float(np.max(np.abs(lg - lw) / np.abs(lw))))
        for name, a in want_np.items():
            if name[0] not in "pmv":
                continue
            got = arrays[name]
            check(got.tobytes() == ranks[0][1][name].tobytes(),
                  f"dist W={world}: {name} differs between rank {r} and 0")
            ref, by = a, "stacked run"
            if split is not None and "@" not in name:
                ref, by = split[1][name], "--per-worker-loss stacked run"
                if r == 0:
                    split_rel[name] = rel_norm(ref, a)
                    stacked_rel[name] = rel_norm(got, a)
                    n_split_equal += got.tobytes() == ref.tobytes()
            diff = np.abs(got - ref)
            check(np.allclose(got, ref, rtol=1e-5, atol=1e-7),
                  f"dist W={world}: {name} beyond rtol 1e-5 / atol 1e-7 "
                  f"of the {by} (max abs {np.max(diff)})")
            param_abs = max(param_abs, float(diff.max()))
            param_rel = max(param_rel, float(
                (diff / np.maximum(np.abs(ref), 1e-30)).max()))
    out = {"loss_max_rel": loss_rel, "state_max_abs": param_abs,
           "state_max_rel": param_rel}
    if split is not None:
        out["split_rel_norm"] = max(split_rel.values())
        out["stacked_rel_norm"] = max(stacked_rel.values())
        out["split_worst_leaf"] = max(split_rel, key=split_rel.get)
        out["split_bit_equal_leaves"] = f"{n_split_equal}/{len(split_rel)}"
    return out


def rel_norm(a, b):
    """``||a - b|| / ||b||``."""
    import numpy as np
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def dist_records(stacked, ranks, world):
    """Records of one width (no gate): the median step of each backend
    (steps 2 on), each rank's bytes per round by collective, the compact
    probe wire's bytes per round beside what the dense wire would ship,
    and the shares of a step in the transport and in gloo's staging."""
    from repro_torch.core.generation import probe_round_capacity
    from repro_torch.graph.subgraph import slots_per_seed
    want = stacked[0]
    steps = len(want["step_s"])
    out = {"stacked_median_step_ms":
           statistics.median(want["step_s"][2:]) * 1e3}
    per_rank = []
    for meta, _ in ranks:
        coll = meta["collectives"]
        loop_s = sum(meta["step_s"])
        per_rank.append({
            "median_step_ms": statistics.median(meta["step_s"][2:]) * 1e3,
            "bytes_per_round": {k: v["bytes"] / steps
                                for k, v in coll.items()},
            "calls_per_round": {k: v["calls"] / steps
                                for k, v in coll.items()},
            "transport_share": sum(v["seconds"] for v in coll.values())
            / loop_s,
            "staging_share": sum(v["staging_s"] for v in coll.values())
            / loop_s,
            "launches": meta["launches"]})
    out["ranks"] = per_rank
    out["process_median_step_ms"] = per_rank[0]["median_step_ms"]
    compact = ranks[0][0]["rounds"][0]["stats"]["fetch.probe_round_bytes"][0]
    cap = probe_round_capacity(TRAIN_BATCH * slots_per_seed((40, 20)), world,
                               want["capacity_slack"])
    out["probe_wire_bytes_per_round"] = {
        "compact": compact,
        "dense": world * cap * 4 + world * cap + world * cap * 128 * 4}
    return out


def dist_cell(torch, w, backend, tmp, launches):
    """One width of the dist phase over ``backend``: the stacked run in
    this process, then ``train --dist backend`` as ``w`` processes, both
    with ``--report``; every gate of ``dist_compare`` and the per-rank
    launch counts (each rank's loop: the compact probe once a round,
    fanout_mean / fanout_mean_bwd 3 / 1 times a step).  Adds both runs'
    launches to ``launches``; returns the records and differences."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    tag = f"dist W={w} {backend}"
    flags = ["--arch", "graphgen-gcn", "--workers", str(w),
             "--device", DEVICE, "--nodes", str(N_NODES),
             "--batch-per-worker", str(TRAIN_BATCH), "--steps",
             str(TRAIN_STEPS), "--log-every", "10"]
    sdir, pdir = (os.path.join(tmp, f"{k}{w}") for k in ("stacked", backend))
    ops.reset_launch_counts()
    train.train_gcn(train.parse_args(flags + ["--report", sdir]))
    torch.cuda.synchronize()
    for k, v in ops.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *flags,
         "--dist", backend, "--report", pdir, "--dist-timeout",
         str(DIST_TIMEOUT_S)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=DIST_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[:2]:
        print(f"[{tag}] {line}")
    check(proc.returncode == 0, f"{tag}: the process run exited "
          f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    stacked = read_report(sdir, "stacked")
    ranks = [read_report(pdir, f"rank{r}") for r in range(w)]
    diffs = dist_compare(stacked, ranks, w)
    rec = dist_records(stacked, ranks, w)
    for r, (meta, _) in enumerate(ranks):
        c = meta["launches"]
        check(c["cache_probe_compact"] == TRAIN_STEPS
              and c["fanout_mean"] == 3 * TRAIN_STEPS
              and c["fanout_mean_bwd"] == TRAIN_STEPS,
              f"{tag} rank {r}: launches {c} over {TRAIN_STEPS} steps")
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        rr = rec["ranks"][r]
        print(f"[{tag} rank {r}] on {meta['device']}: launches "
              f"{ {k: c[k] for k in DIST_KERNELS} }; median step "
              f"{rr['median_step_ms']:.3f} ms; bytes per round "
              f"{rr['bytes_per_round']}; transport "
              f"{100 * rr['transport_share']:.1f}% and staging "
              f"{100 * rr['staging_share']:.1f}% of the loop")
    print(f"[{tag}] rungs slack {stacked[0]['capacity_slack']} hit_cap "
          f"{stacked[0]['hit_cap']} on both backends; median step stacked "
          f"{rec['stacked_median_step_ms']:.3f} ms, {backend} processes "
          f"{rec['process_median_step_ms']:.3f} ms; probe wire per round "
          f"{rec['probe_wire_bytes_per_round']}; largest differences "
          f"{diffs}; the {backend} command took {wall:.1f} s")
    return {**rec, **diffs, "command_s": wall,
            "losses": ranks[0][0]["losses"],
            "stacked_losses": stacked[0]["losses"]}


def phase_dist(torch):
    """Phase 17: graphgen-gcn's train cell with one process per worker
    over gloo (on one card every rank shares it, the collectives staged
    through host memory) at W = 2 and 4, each beside the stacked run of
    the same flags in this process (``dist_cell``'s gates); a failed or
    hung rank fails the phase.  Records (``dist_records``): median
    steps, bytes per round, transport and staging shares."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist")
    launches = {}
    try:
        results = {w: dist_cell(torch, w, "gloo", tmp, launches)
                   for w in DIST_WORKERS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[dist] phase took {seconds:.1f} s")
    return {"launches": launches, "widths": results, "seconds": seconds}


#: the dist-paths phase (PR 23): every other graph path as one process per
#: worker over gloo on the one card, one spawn per width shared by all of
#: its cells, each cell beside the stacked run of the same flags
DIST_PATHS_TIMEOUT_S = 900
#: kernels every rank of each cell must launch on its path; the tiered
#: probe is the W = 1 fused probe and is not on a W > 1 path: there the
#: L1 is the gather probe and the L2 the compact probe round
DIST_PATH_KERNELS = {
    "serve": ("cache_probe_compact", "fanout_mean"),
    "deep": ("cache_probe_gather", "cache_probe_compact", "fanout_mean",
             "fanout_mean_bwd"),
    "host": ("cache_probe_compact", "fanout_mean", "fanout_mean_bwd"),
    "warm": ("cache_probe_gather", "cache_probe_compact", "fanout_mean"),
    "offline": ("cache_probe_compact", "fanout_mean", "fanout_mean_bwd"),
    "autotune": ("cache_probe_compact", "fanout_mean", "fanout_mean_bwd"),
}


def dist_path_cases(w, out):
    """The dist-paths phase's cells at ``W = w``: ``{cell: (driver
    module, argv)}``, each reporting to ``out/<cell>``.  W = 2: serve,
    deep train, host train; W = 4 adds the deep run's export, offline
    and autotune (the warm-started server is ``warm_path_case``).  The
    deep cell averages its gradients by the butterfly at W = 4
    (``--grad-sync tree``): gloo's ring all-reduce sums each segment of
    the gradient in its own rank order, which one process cannot
    reproduce, and its final state is held to a one-process run of the
    ranks' arithmetic (``split_case``).  At W = 2 both modes make one
    addition."""
    base = ["--workers", str(w), "--device", DEVICE, "--nodes",
            str(N_NODES)]
    served = ["--warmup-sweeps", "8", "--buckets", "8,16,32", "--requests",
              str(N_REQUESTS)]
    trained = ["--batch-per-worker", str(TRAIN_BATCH), "--steps",
               str(TRAIN_STEPS), "--log-every", "10"]

    def rep(cell):
        return ["--report", os.path.join(out, cell)]
    cells = {
        "serve": ("serve", ["--arch", "graphgen-gcn", *base, *served,
                            *rep("serve")]),
        "deep": ("train", ["--arch", "graphgen-gcn-deep", *base, *trained,
                           *rep("deep")] + (
            ["--grad-sync", "tree", "--export-serve",
             os.path.join(out, "export")] if w == 4 else [])),
        "host": ("train", ["--arch", "graphgen-gcn", *base, *trained,
                           "--feature-store", "host", "--host-gather-depth",
                           "2", "--capacity-slack", "2.0", "--probe-hit-cap",
                           "0", *rep("host")]),
    }
    if w == 4:
        cells["offline"] = ("train", ["--arch", "graphgen-gcn", *base,
                                      *trained, "--offline",
                                      *rep("offline")])
        cells["autotune"] = ("train", ["--arch", "graphgen-gcn", *base,
                                       *trained, "--autotune",
                                       "--autotune-steps",
                                       str(AUTOTUNE_STEPS),
                                       *rep("autotune")])
    return cells


def split_case(w, out):
    """The deep cell on the stacked group with ``--per-worker-loss``:
    each worker's mean loss differentiated on its own rows and the
    gradients averaged as the ranks average them, reporting to
    ``out/deep_split`` (and at W = 4 exporting to ``out/export_split``)."""
    module, argv = dist_path_cases(w, out)["deep"]
    argv = list(argv) + ["--per-worker-loss"]
    argv[argv.index("--report") + 1] = os.path.join(out, "deep_split")
    if "--export-serve" in argv:
        argv[argv.index("--export-serve") + 1] = os.path.join(
            out, "export_split")
    return module, argv


def warm_path_case(w, out, export):
    """The warm-started server: graphgen-gcn-deep served from ``export``
    (the W = 4 ``--dist`` train run's file) instead of sweeping."""
    return ("serve", ["--arch", "graphgen-gcn-deep", "--workers", str(w),
                      "--device", DEVICE, "--nodes", str(N_NODES),
                      "--buckets", "8,16,32", "--requests", str(N_REQUESTS),
                      "--warm-from", export, "--report",
                      os.path.join(out, "warm")])


def run_path_case(case, group=None):
    """One cell through its driver: in this process on the stacked group,
    or as this rank of a process ``group``."""
    from repro_torch.launch import serve, train
    module, argv = case
    mod = serve if module == "serve" else train
    fn = (mod.serve_gcn if module == "serve" else
          train.offline_gcn if "--offline" in argv else train.train_gcn)
    if group is None:
        return fn(mod.parse_args(argv))
    return fn(mod.parse_args(argv + ["--dist", "gloo"]), group=group)


#: the module settings a rank of the dist-paths phase takes from the
#: parent (a rehearsal on the CPU shrinks them)
PATH_SETTINGS = ("DEVICE", "N_NODES", "N_REQUESTS", "TRAIN_STEPS",
                 "TRAIN_BATCH", "AUTOTUNE_STEPS")


def dist_paths_battery(group, out, settings):
    """A rank's share of the dist-paths phase (``launch.mesh``'s target):
    the parent's ``settings``, then every cell at its width, in order,
    then at W = 4 the server warm-started from this run's export."""
    import torch
    globals().update(settings)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for case in dist_path_cases(group.world, out).values():
        run_path_case(case, group)
    if group.world == 4:
        run_path_case(warm_path_case(4, out, os.path.join(out, "export")),
                      group)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def path_reports(pdir, sdir, cell, w):
    """``(stacked, [rank r])`` reports of one cell (json only)."""
    return (read_json(os.path.join(sdir, cell, "stacked.json")),
            [read_json(os.path.join(pdir, cell, f"rank{r}.json"))
             for r in range(w)])


def check_path_launches(cell, w, ranks, per_step=None):
    """Every rank of a cell launched every kernel of its path (exactly
    ``per_step`` x steps where given); the tiered probe never at W > 1."""
    for r, meta in enumerate(ranks):
        c = meta["launches"]
        for name in DIST_PATH_KERNELS[cell]:
            want = per_step.get(name) if per_step else None
            check(c[name] > 0 if want is None else c[name] == want,
                  f"dist paths W={w} {cell} rank {r}: {name} launched "
                  f"{c[name]} times" + (f", expected {want}" if want else ""))
        check(c["cache_probe_tiered"] == 0, f"dist paths W={w} {cell} rank "
              f"{r}: the W = 1 tiered probe ran on a W > 1 path")
        if cell in ("serve", "warm"):
            check(c["fanout_mean_bwd"] == 0, f"dist paths W={w} {cell} rank "
                  f"{r}: serving ran a backward kernel")


def serve_path_gates(pdir, sdir, cell, w):
    """Serve gates: every prediction equal to the stacked server's, the
    warm cache blocks bit-equal, no request-path step shape on any rank,
    the stop header ending every rank's loop, the path's launches on
    every rank; returns the records."""
    want, ranks = path_reports(pdir, sdir, cell, w)
    tag = f"dist paths W={w} {cell}"
    check(want["n_requests"] == N_REQUESTS and want["request_path_compiles"]
          == 0, f"{tag}: the stacked server served {want['n_requests']} "
          f"requests with {want['request_path_compiles']} new shapes")
    rec = {"stacked_p50_ms": want["p50_ms"], "stacked_qps": want["qps"],
           "stacked_gen_median_ms": want["gen_median_ms"],
           "stacked_fwd_median_ms": want["fwd_median_ms"], "ranks": []}
    for r, meta in enumerate(ranks):
        check(meta["requests"] == want["requests"]
              and meta["predictions"] == want["predictions"],
              f"{tag} rank {r}: predictions differ from the stacked "
              f"server's")
        check(meta["cache"][str(r)] == want["cache"][str(r)],
              f"{tag} rank {r}: its warm cache block differs from the "
              f"stacked worker block")
        check(meta["request_path_compiles"] == 0 and meta["n_requests"]
              == N_REQUESTS, f"{tag} rank {r}: {meta['n_requests']} "
              f"requests, {meta['request_path_compiles']} new step shapes")
        coll = meta["collectives_per_request"]
        check(round(coll["broadcast"]["calls"] * N_REQUESTS)
              == N_REQUESTS + 1, f"{tag} rank {r}: "
              f"{coll['broadcast']['calls'] * N_REQUESTS} headers for "
              f"{N_REQUESTS} requests and the stop")
        rec["ranks"].append({
            "gen_median_ms": meta["gen_median_ms"],
            "fwd_median_ms": meta["fwd_median_ms"],
            "transport_share": sum(v["seconds"] for v in coll.values())
            * meta["n_requests"] / meta["wall_s"],
            "bytes_per_request": {k: v["bytes"] for k, v in coll.items()},
            "calls_per_request": {k: v["calls"] for k, v in coll.items()},
            "launches": meta["launches"]})
    rec["p50_ms"], rec["p99_ms"], rec["qps"] = (
        ranks[0]["p50_ms"], ranks[0]["p99_ms"], ranks[0]["qps"])
    check_path_launches(cell, w, ranks)
    return rec


def train_path_gates(pdir, sdir, cell, w, per_step, split=False):
    """Train gates: PR 22's ``dist_compare`` (rungs, three rounds per
    worker in every tier, losses, parameters and moments; with ``split``
    the final state against ``split_case``'s run) and the exact launches
    per rank; returns the records."""
    stacked = read_report(os.path.join(sdir, cell), "stacked")
    ranks = [read_report(os.path.join(pdir, cell), f"rank{r}")
             for r in range(w)]
    diffs = dist_compare(stacked, ranks, w, split=read_report(
        os.path.join(sdir, cell + "_split"), "stacked") if split else None)
    for r, (meta, _) in enumerate(ranks):
        check(meta["n_dropped"] == 0, f"dist paths W={w} {cell} rank {r}: "
              f"{meta['n_dropped']} requests dropped")
    check_path_launches(cell, w, [m for m, _ in ranks],
                        {k: v * TRAIN_STEPS for k, v in per_step.items()})
    rec = {"stacked_median_step_ms":
           statistics.median(stacked[0]["step_s"][2:]) * 1e3, "ranks": [],
           **diffs}
    for meta, _ in ranks:
        coll = meta["collectives"]
        loop_s = sum(meta["step_s"])
        rec["ranks"].append({
            "median_step_ms": statistics.median(meta["step_s"][2:]) * 1e3,
            "transport_share": sum(v["seconds"] for v in coll.values())
            / loop_s,
            "staging_share": sum(v["staging_s"] for v in coll.values())
            / loop_s, "launches": meta["launches"]})
    return rec


def export_gates(pdir, sdir):
    """The W = 4 ``--dist`` run's ``--export-serve`` file against the
    stacked runs': cache leaves byte-equal to the stacked run's file;
    parameters within rtol 1e-5 / atol 1e-7 of the ``--per-worker-loss``
    run's file (``split_case``: the ranks' arithmetic, as
    ``dist_compare`` holds the deep run's final state).  Returns the
    largest parameter difference and each file's largest norm share
    from the stacked run's parameters."""
    import glob
    import numpy as np

    def arrays(d, name="export"):
        [f] = glob.glob(os.path.join(d, name, "step_*", "arrays.npz"))
        return np.load(f)
    got, want = arrays(pdir), arrays(sdir)
    split = arrays(sdir, "export_split")
    check(sorted(got.files) == sorted(want.files) == sorted(split.files),
          "dist paths export: the files hold different leaves")
    worst, n_cache, rel = 0.0, 0, {"gloo": 0.0, "split": 0.0}
    for key in want.files:
        if key.startswith("cache/"):
            n_cache += 1
            check(got[key].shape[0] == 4 and got[key].tobytes()
                  == want[key].tobytes(), f"dist paths export: {key} differs "
                  f"from the stacked run's")
            continue
        diff = float(np.max(np.abs(got[key] - split[key])))
        check(np.allclose(got[key], split[key], rtol=1e-5, atol=1e-7),
              f"dist paths export: {key} beyond rtol 1e-5 / atol 1e-7 of "
              f"the --per-worker-loss run's (max abs {diff})")
        worst = max(worst, diff)
        rel["gloo"] = max(rel["gloo"], rel_norm(got[key], want[key]))
        rel["split"] = max(rel["split"], rel_norm(split[key], want[key]))
    return {"cache_leaves_byte_equal": n_cache, "param_max_abs": worst,
            "stacked_rel_norm": rel}


def dist_paths_cell(torch, w, tmp, launches):
    """One width of the dist-paths phase: ``dist_paths_battery`` as ``w``
    processes (``launch.mesh``, ranks on ``cuda:r`` with ``w`` cards, else
    ``cuda:0``), then every cell on the stacked group in this process,
    then every gate.  Adds the stacked runs' and each rank's launches to
    ``launches``; returns the records per cell."""
    import numpy as np
    from repro_torch.kernels import ops
    pdir, sdir = (os.path.join(tmp, f"{k}{w}") for k in ("gloo", "stacked"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.path.join(ROOT, "src"), env.get("PYTHONPATH"))
        if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh", "--workers",
         str(w), "--dist", "gloo", "--device", DEVICE, "--timeout",
         str(DIST_PATHS_TIMEOUT_S), "chip_smoke:dist_paths_battery",
         json.dumps({"out": pdir, "settings": {
             k: globals()[k] for k in PATH_SETTINGS}})],
        cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=DIST_PATHS_TIMEOUT_S + 60)
    spawn_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"dist paths W={w}: the ranks exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    cases = dist_path_cases(w, sdir)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for case in cases.values():
        run_path_case(case, None)
    run_path_case(split_case(w, sdir))
    if w == 4:
        run_path_case(warm_path_case(w, sdir, os.path.join(pdir, "export")))
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    for k, v in ops.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    from repro_torch.configs import get_config
    deep = len(get_config("graphgen-gcn-deep").fanouts)
    recs = {"serve": serve_path_gates(pdir, sdir, "serve", w)}
    recs["deep"] = train_path_gates(pdir, sdir, "deep", w, {
        "cache_probe_gather": 1, "cache_probe_compact": 1,
        "fanout_mean": deep * (deep + 1) // 2,
        "fanout_mean_bwd": deep * (deep - 1) // 2}, split=True)
    recs["host"] = train_path_gates(pdir, sdir, "host", w, {
        "cache_probe_compact": 1, "fanout_mean": 3, "fanout_mean_bwd": 1})
    want, ranks = path_reports(pdir, sdir, "host", w)
    for key in ("n_l3_hits", "host_gather_bytes"):
        check(want["store"][key] > 0 and all(
            m["store"][key] == want["store"][key] for m in ranks)
              and sum(m["store"]["rank_" + key] for m in ranks)
              == want["store"][key], f"dist paths W={w} host: {key} summed "
              f"over the ranks {[m['store'] for m in ranks]} against the "
              f"stacked run's {want['store'][key]}")
    recs["host"]["l3_rows"] = want["store"]["n_l3_hits"]
    recs["host"]["l3_bytes"] = want["store"]["host_gather_bytes"]
    if w == 4:
        recs["export"] = export_gates(pdir, sdir)
        recs["warm"] = serve_path_gates(pdir, sdir, "warm", w)
        want, ranks = path_reports(pdir, sdir, "offline", w)
        for r, meta in enumerate(ranks):
            lw, lg = np.asarray(want["losses"]), np.asarray(meta["losses"])
            check(np.allclose(lg, lw, rtol=1e-5, atol=0),
                  f"dist paths offline rank {r}: losses {lg} against {lw}")
            for t, (a, b) in enumerate(zip(want["rounds"], meta["rounds"])):
                check(a["batch"][str(r)] == b["batch"][str(r)]
                      and a["cache"][str(r)] == b["cache"][str(r)],
                      f"dist paths offline rank {r}: round {t} differs")
        check_path_launches("offline", w, ranks, {
            k: v * TRAIN_STEPS for k, v in (
                ("cache_probe_compact", 1), ("fanout_mean", 3),
                ("fanout_mean_bwd", 1))})
        recs["offline"] = {"stacked": {k: want[k] for k in ("t_gen",
                                                            "t_train")},
                           "gloo": {k: ranks[0][k] for k in ("t_gen",
                                                             "t_train")}}
        want, ranks = path_reports(pdir, sdir, "autotune", w)
        a = want["autotune"]
        check(len(a["records"]) == AUTOTUNE_STEPS and a["ranking"],
              f"dist paths autotune: the stacked trace has "
              f"{len(a['records'])} records")
        for r, meta in enumerate(ranks):
            b = meta["autotune"]
            check(b["records"] == a["records"], f"dist paths autotune rank "
                  f"{r}: the reduced trace differs from the stacked one")
            check(b["ranking"] == a["ranking"], f"dist paths autotune rank "
                  f"{r}: the ranking differs from the stacked one")
            check(b["picks"] == ranks[0]["autotune"]["picks"],
                  f"dist paths autotune rank {r}: its verdicts differ from "
                  f"rank 0's")
        check_path_launches("autotune", w, ranks)
        recs["autotune"] = {
            "searched": len(a["ranking"]),
            "verdicts": {"stacked": [(p["candidate"], p["accepted"],
                                      round(p["measured_ms"], 3))
                                     for p in a["picks"]],
                         "gloo": [(p["candidate"], p["accepted"],
                                   round(p["measured_ms"], 3))
                                  for p in ranks[0]["autotune"]["picks"]]},
            "accepted": {"stacked": a["accepted"],
                         "gloo": ranks[0]["autotune"]["accepted"]}}
    n_rank_reports = 0
    for cell in ("serve", "deep", "host", "warm", "offline", "autotune"):
        if cell not in recs:
            continue
        _, ranks = path_reports(pdir, sdir, cell, w)
        for meta in ranks:
            n_rank_reports += 1
            for k, v in meta["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for cell, rec in recs.items():
        print(f"[dist paths W={w} {cell}] {json.dumps(rec)}")
    print(f"[dist paths W={w}] every gate held; the {w} ranks took "
          f"{spawn_s:.1f} s (their start included), the stacked runs "
          f"{stacked_s:.1f} s; {n_rank_reports} rank reports")
    return {**recs, "spawn_s": spawn_s, "stacked_s": stacked_s}


def phase_dist_paths(torch):
    """Phase 17b (PR 23): every other graph path with one process per
    worker over gloo on the card (every rank on ``cuda:0``, the
    collectives staged through host memory) at W = 2 and 4, each cell
    beside the stacked run of the same flags in this process: serve
    (graphgen-gcn, 64 Zipf requests), the tiered cache (graphgen-gcn-deep,
    20 steps), the L3 host store (graphgen-gcn at depth 2), and at W = 4
    the deep run's ``--export-serve`` file, a server warm-started from
    it, ``--offline`` and ``--autotune``.  Gates: ``dist_paths_cell``'s.
    Records: each rank's median step or request and the transport's
    share, and the phase's seconds."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_paths")
    launches = {}
    try:
        widths = {w: dist_paths_cell(torch, w, tmp, launches)
                  for w in DIST_WORKERS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[dist paths] phase took {seconds:.1f} s")
    return {"launches": launches, "widths": widths, "seconds": seconds}


def nccl_cases(torch, dev):
    """The generator's dtype and shape families at the W = 4 train round's
    sizes, one worker's block (``[1, ...]``): routed ids, packed bitmap
    words, bool masks, float32 feature rows, the frontier's seeds and the
    candidates' float32 keys."""
    gen = torch.Generator(device=dev).manual_seed(3)
    return {
        "ids": torch.randint(-1, N_NODES, (1, 1, 6736), generator=gen,
                             device=dev, dtype=torch.int32),
        "words": torch.randint(-2**31, 2**31 - 1, (1, 1, 211),
                               generator=gen, device=dev, dtype=torch.int32),
        "mask": torch.rand((1, 1, 6736), generator=gen, device=dev) < 0.5,
        "rows": torch.randn((1, 1, 842, 128), generator=gen, device=dev),
        "seeds": torch.randint(0, N_NODES, (1, 32), generator=gen,
                               device=dev, dtype=torch.int32),
        "keys": torch.rand((1, 1280, 20), generator=gen, device=dev)}


def phase_nccl(torch):
    """Phase 18: the process backend's transport over NCCL at world size 1
    on the card: every collective the generator and the trainer call
    (all_to_all, all_gather, all_reduce sum and max) on each dtype and
    shape family (``nccl_cases``), equal to the stacked backend's; a
    world-1 ``ppermute`` is a local copy (torch refuses a send to its
    own rank).  The dist phase's cells over NCCL (``dist_cell``, every
    gate) run at each width with as many visible cards; otherwise a line
    says why not."""
    import shutil
    import tempfile
    from repro_torch.core.collectives import StackedGroup
    from repro_torch.launch import mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl")
    group = mesh.make_group("nccl", 1, 0, DEVICE,
                            f"file://{os.path.join(tmp, 'store')}")
    try:
        stacked = StackedGroup(1, group.device)
        n = 0
        for name, x in nccl_cases(torch, group.device).items():
            ops = [("all_to_all", ()), ("all_gather", ()),
                   ("ppermute", ([(0, 0)],))]
            if x.dtype != torch.bool:
                ops += [("all_reduce", ("sum",)), ("all_reduce", ("max",))]
            if name in ("seeds", "keys"):
                ops = [o for o in ops if o[0] != "all_to_all"]
            for op, extra in ops:
                got = getattr(group, op)(x, *extra)
                want = getattr(stacked, op)(x, *extra)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"nccl: {op}{extra} on {name} {tuple(x.shape)} "
                      f"differs from the stacked backend")
                n += 1
        calls = {k: v["calls"] for k, v in group.stats.items()}
        print(f"[nccl] world size 1 on {group.device}: {n} collective "
              f"calls equal to the stacked backend's ({calls}; ppermute "
              f"at world 1 is a local copy)")
    finally:
        mesh.close(group)
    cells, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_cells")
    try:
        for w in DIST_WORKERS:
            if torch.cuda.device_count() >= w:
                cells[w] = dist_cell(torch, w, "nccl", tmp, launches)
            else:
                print(f"[nccl] W={w} over NCCL not run: "
                      f"{torch.cuda.device_count()} card(s) visible, and "
                      f"NCCL refuses two ranks of one communicator on one "
                      f"card")
                cells[w] = "not run: fewer cards than workers"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"world1_calls": n, "launches": launches,
            "widths": {f"W={w}": c for w, c in cells.items()}}


#: flash_attention checks on the card: (B, Hq, Hkv, Lq, Lk, Dh, causal,
#: dtype, layout); layout "bhld" is a contiguous [B, H, L, Dh] tensor,
#: "blhd" the [B, H, L, Dh] view of a contiguous [B, L, H, Dh] tensor (the
#: dense LM's own operands).  The prefill's shape first, in both layouts;
#: then Lq < Lk causal, Dh 128, tiles cut by Lq or Lk (bf16, the
#: tensor-core route), and float32 shapes (the SIMT route).
FLASH_CHECKS = ((8, 9, 3, 2048, 2048, 64, True, "bfloat16", "bhld"),
                (8, 9, 3, 2048, 2048, 64, True, "bfloat16", "blhd"),
                (2, 9, 3, 256, 1024, 64, True, "bfloat16", "blhd"),
                (1, 4, 2, 384, 384, 128, True, "bfloat16", "blhd"),
                (1, 4, 2, 320, 448, 128, True, "bfloat16", "blhd"),
                (2, 9, 3, 192, 320, 64, True, "bfloat16", "blhd"),
                (2, 9, 3, 256, 1024, 64, True, "float32", "bhld"),
                (2, 9, 3, 256, 1024, 64, True, "float32", "blhd"),
                (1, 4, 2, 128, 384, 128, True, "float32", "bhld"),
                (2, 6, 2, 256, 256, 128, False, "bfloat16", "bhld"))


def flash_close(torch, q, k, v, got, want, causal=True):
    """Kernel against twin.  Float32: within rtol/atol 1e-5 (summation
    order).  Bfloat16: ``|got - want| <= 2^-8 * flash_attention_ref(q, k,
    |v|) + 2^-7 * |want| + 1e-5`` (``bf16_error_bound``: the tensor-core
    route rounds p to bf16 before P V, as the reference's plain path does,
    whose worst case is the first term; the second covers the output's
    rounding on both sides).  Returns ``(ok, max abs err, relative
    Frobenius err)``."""
    from repro_torch.kernels.flash_attention import bf16_error_bound
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm().clamp(min=1e-30)).item()
    if got.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ok = bool((diff.abs() <= bf16_error_bound(q, k, v, want,
                                                  causal)).all())
    return ok, err, rel


def flash_sdpa_gap(torch, q, k, v, got, causal=True):
    """Max ``|kernel - scaled_dot_product_attention|`` on the same inputs
    (a yardstick printed beside the gate, not a gate: SDPA rounds at other
    places); the causal mask aligns the last query with the last key."""
    lq, lk = q.shape[2], k.shape[2]
    mask = None
    if causal and lq != lk:
        mask = (torch.arange(lq, device=q.device)[:, None] + (lk - lq)
                >= torch.arange(lk, device=q.device)[None, :])
    want = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    return (got.float() - want.float()).abs().max().item()


def flash_operand(torch, shape, layout, dtype, gen, dev):
    """A seeded normal ``[B, H, L, Dh]`` operand in ``layout``."""
    b, h, l, dh = shape
    if layout == "blhd":
        return torch.randn((b, l, h, dh), generator=gen,
                           device=dev).to(dtype).transpose(1, 2)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def phase_flash(torch, dev):
    """``flash_attention`` against its twin on the card at the shapes and
    layouts of ``FLASH_CHECKS``; each bf16 check must go through the
    tensor-core route and each float32 one through the SIMT route."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    for b, hq, hkv, lq, lk, dh, causal, dtype, layout in FLASH_CHECKS:
        dt = getattr(torch, dtype)
        q = flash_operand(torch, (b, hq, lq, dh), layout, dt, gen, dev)
        k = flash_operand(torch, (b, hkv, lk, dh), layout, dt, gen, dev)
        v = flash_operand(torch, (b, hkv, lk, dh), layout, dt, gen, dev)
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal)
        route = "tensor_core" if dt == torch.bfloat16 else "float32"
        check(ops.flash_route_counts() == {
            "tensor_core": int(route == "tensor_core"),
            "float32": int(route == "float32")},
            f"flash_attention {dtype} took the wrong route: "
            f"{ops.flash_route_counts()}")
        want = ref.flash_attention_ref(q, k, v, causal)
        ok, err, rel = flash_close(torch, q, k, v, got, want, causal)
        label = f"{(b, hq, hkv, lq, lk, dh)} causal={causal} {dtype} {layout}"
        check(ok, f"flash_attention {label} disagrees with its twin: max "
              f"err {err}, relative {rel}")
        print(f"[flash] {label} == twin ({route} route; max abs err {err}, "
              f"relative Frobenius {rel:.3e}; |kernel - SDPA| max "
              f"{flash_sdpa_gap(torch, q, k, v, got, causal)})")
    torch.cuda.synchronize()


def lm_config(n_layers=None):
    """smollm-135m at full width with flash attention on (``n_layers``
    cuts the depth)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), use_flash_attention=True)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def first_call_operands(torch, name, forward):
    """The operands of the first ``ops.<name>`` call that ``forward()``
    makes (a layer's own inputs on the path), cloned with the caller's
    strides kept (a dense view's clone keeps its strides)."""
    from repro_torch.kernels import ops
    real, calls = getattr(ops, name), []

    def record(*operands, **kw):
        if not calls:
            calls.append(tuple(t.clone() for t in operands))
        return real(*operands, **kw)
    setattr(ops, name, record)
    try:
        forward()
    finally:
        setattr(ops, name, real)
    return calls[0]


def run_prefill(torch, cfg, seed, kernel, label):
    """``forward_logits`` of ``cfg`` (random weights from ``seed``) over
    ``PREFILL_B x PREFILL_S`` seeded tokens, ``1 + PREFILL_WARM`` times
    with zeroed launch counters: exactly one ``kernel`` launch per layer
    per forward and no other kernel, finite float32 logits over the padded
    vocab; then one profiled forward.  Returns ``(model, batch, tokens,
    res)``: ``res`` holds the init and first-forward seconds, the rate
    over the whole warm window (all warm forwards' tokens over their summed
    wall; the median is a per-forward statistic only), the launches, the
    peak memory, and the device busy ms and ``kernel``'s ms of the traced
    forward."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.models.layers import padded_vocab
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = zoo.build(cfg, DEVICE).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(DEVICE)}
    ops.reset_launch_counts()
    times = []
    for _ in range(1 + PREFILL_WARM):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = zoo.forward_logits(cfg, model, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    ssd_routes = ops.ssd_route_counts()
    n_fwd = len(times)
    check(counts[kernel] == cfg.n_layers * n_fwd,
          f"{label} launched {kernel} {counts[kernel]} times over {n_fwd} "
          f"forwards, expected {cfg.n_layers} per forward")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"{label} launched another kernel: {counts}")
    if kernel == "flash_attention":
        check(routes == {"tensor_core": cfg.n_layers * n_fwd, "float32": 0},
              f"{label}: flash_attention routes {routes}, expected every "
              f"launch on the tensor-core route")
    if kernel == "ssd_scan":
        check(ssd_routes == {"tensor_core": cfg.n_layers * n_fwd,
                             "float32": 0},
              f"{label}: ssd_scan routes {ssd_routes}, expected every launch "
              f"on the tensor-core route")
    v_pad = padded_vocab(cfg)
    check(tuple(logits.shape) == (PREFILL_B, PREFILL_S, v_pad)
          and logits.dtype == torch.float32, f"{label} logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), f"{label} logits not finite")
    del logits
    warm_ms = statistics.median(times[1:]) * 1e3
    res = {"init_s": init_s, "first_forward_s": times[0],
           "warm_forward_ms": warm_ms,
           "forward_ms": [t * 1e3 for t in times],
           "prefill_tok_s": PREFILL_B * PREFILL_S * PREFILL_WARM
           / sum(times[1:]),
           "launches": counts, "flash_routes": routes,
           "ssd_routes": ssd_routes, "max_memory_gb":
           torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[{label}] B={PREFILL_B} S={PREFILL_S}: first forward "
          f"{times[0]:.3f} s; {PREFILL_WARM} warm forwards at "
          f"{res['prefill_tok_s']:,.0f} tokens/s, median warm forward "
          f"{warm_ms:.3f} ms; forwards (ms) "
          f"{[round(t, 3) for t in res['forward_ms']]}; init {init_s:.2f} s; "
          f"launches {counts}; peak memory {res['max_memory_gb']:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        zoo.forward_logits(cfg, model, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    res["busy_ms"] = summarize_profile(torch, prof, 1, traced_ms,
                                       f"{label}, one traced forward")
    res["kernel_ms"] = kernel_device_ms(torch, prof, kernel)
    res["copy_launches"] = copy_rows(torch, prof, label)
    if res["busy_ms"]:
        check(res["kernel_ms"] > 0, f"{label}: {kernel} launched but no "
              f"profiler row holds its name")
        print(f"[{label}] {kernel}: {res['kernel_ms']:.3f} ms of the traced "
              f"forward's {res['busy_ms']:.3f} ms device time "
              f"({100 * res['kernel_ms'] / res['busy_ms']:.1f}%)")
    return model, batch, tokens, res


def kernel_device_ms(torch, prof, name):
    """Device time (ms) of the profiler rows whose kernel name holds
    ``name``."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key) / 1e3


def copy_rows(torch, prof, label):
    """Print the profiler's device rows of copy kernels (same-dtype and
    casting copies, ``cat``) with their launches and ms; returns the
    launches of all of them."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "copy" in e.key.lower()]
    for e in sorted(rows, key=lambda e: -e.count):
        print(f"[{label}] copy row x{e.count:4d} "
              f"{e.self_device_time_total / 1e3:8.4f} ms  {e.key[:150]}")
    return sum(e.count for e in rows)


#: aten ops that move no data: views of the operands and the output's
#: allocation (a layout copy would show as clone, copy_ or contiguous, a
#: cast as _to_copy)
VIEW_OPS = ("aten.transpose", "aten.view", "aten._reshape_alias",
            "aten.as_strided", "aten.alias", "aten.split_with_sizes",
            "aten.empty")


def recorded_ops(torch, fn):
    """``(the aten ops that fn() dispatches, its result)``; a kernel
    launched through ctypes does not show."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        out = fn()
    torch.cuda.synchronize()
    return rec.ops, out


def attention_ops(torch, qkv):
    """The aten ops that one flash ``gqa_attention`` call at layer 0's own
    ``[B, L, H, Dh]`` tensors dispatches, with ``attn_forward``'s reshape
    of its output (the kernel itself launches through ctypes, outside
    aten)."""
    from repro_torch.models import layers
    q, k, v = (t.transpose(1, 2) for t in qkv)   # back to [B, L, H, Dh]
    b, l = q.shape[:2]
    aten, out = recorded_ops(torch, lambda: layers.gqa_attention(
        q, k, v, causal=True, use_flash=True).reshape(b, l, -1))
    check(out.is_contiguous(), "gqa_attention's flash output is not "
          "contiguous after attn_forward's reshape")
    return aten


def phase_lm_prefill(torch):
    """``forward_logits`` of smollm-135m at full width, flash on, over
    ``PREFILL_B x PREFILL_S`` seeded tokens, with zeroed launch counters;
    then the kernel at layer 0's inputs and the card against the CPU on a
    2-layer cut.  Returns the results, launches and layer 0's q/k/v."""
    import copy
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.models import zoo
    from repro_torch.models.transformer import DenseLM
    cfg = lm_config()
    model, batch, tokens, res = run_prefill(
        torch, cfg, LM_SEED, "flash_attention", f"lm prefill {LM_ARCH}")

    # the kernel at the path's own inputs (layer 0 of a forward), in the
    # strided [B, H, L, Dh] views of [B, L, H, Dh] tensors the model passes
    qkv = first_call_operands(torch, "flash_attention",
                              lambda: zoo.forward_logits(cfg, model, batch))
    check(all(t.dim() == 4 and t.transpose(1, 2).is_contiguous()
              and t.stride(2) == t.shape[1] * t.shape[3] for t in qkv),
          f"layer 0's q/k/v are not the model's [B, L, H, Dh] views: "
          f"strides {[t.stride() for t in qkv]}")
    got = ops.flash_attention(*qkv)
    ok, err, rel = flash_close(torch, *qkv, got,
                               ref.flash_attention_ref(*qkv))
    check(ok, f"flash_attention disagrees with its twin at layer 0's "
          f"inputs: max err {err}, relative {rel}")
    print(f"[lm prefill] flash_attention == twin at layer 0's q/k/v "
          f"{[tuple(t.shape) for t in qkv]}, strides "
          f"{[t.stride() for t in qkv]} (max abs err {err}, relative "
          f"Frobenius {rel:.3e}; |kernel - SDPA| max "
          f"{flash_sdpa_gap(torch, *qkv, got)})")
    res["qkv"], res["layer0_err"], res["layer0_rel"] = qkv, err, rel
    # no layout copy around the kernel: the attention of a layer, from the
    # model's [B, L, H, Dh] tensors to attn_forward's reshape, dispatches
    # views and the output's allocation only, and launches the kernel once
    ops.reset_launch_counts()
    aten = attention_ops(torch, qkv)
    check(all(op.startswith(VIEW_OPS) for op in aten)
          and ops.flash_route_counts()["tensor_core"] == 1,
          f"one flash gqa_attention dispatched {aten} and launched "
          f"{ops.flash_route_counts()}: expected views, one allocation and "
          f"one tensor-core launch")
    print(f"[lm prefill] one layer's flash attention, [B, L, H, Dh] in to "
          f"the reshape out: aten ops {aten} (no copy), one tensor-core "
          f"launch")

    # card against CPU on a 2-layer cut of the same weights
    cut = lm_config(n_layers=2)
    cpu_model = DenseLM(cut)
    cpu_model.load_state_dict({
        k: v for k, v in model.state_dict().items()
        if not k.startswith("layers.") or int(k.split(".")[1]) < 2})
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    small = torch.from_numpy(np.ascontiguousarray(tokens[:2, :512]))
    lc = zoo.forward_logits(cut, cpu_model, {"tokens": small})
    lg = zoo.forward_logits(cut, card_model,
                            {"tokens": small.to(DEVICE)}).cpu()
    err = (lg - lc).abs().max().item()
    agree = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(lg).all()) and err <= 2e-2,
          f"2-layer cut: card logits differ from the CPU port's by {err}")
    print(f"[lm prefill] 2-layer cut, 2 x 512 tokens: card logits within "
          f"{err:.3e} of the CPU port's (scale {lc.abs().max().item():.3f}); "
          f"argmax agrees at {100 * agree:.2f}% of positions")
    res["cut_max_abs_err"], res["cut_argmax_agree"] = err, agree
    return res


def lm_serve_args(gen, device):
    """``serve_lm`` flags: smollm-135m, batch 8, prompt 128."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", LM_ARCH, "--device", device, "--seed", str(LM_SEED),
        "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
        "--gen-len", str(gen)])


def nudge_weights(torch, model, seed):
    """Move every weight of ``model`` by one float32 ulp, with a seeded
    random sign (the floor of a card-vs-CPU comparison)."""
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
            p.mul_(1 + sign.to(p) * 2.0 ** -23)


def record_decode(torch, args, nudge=False, cfg=None, prep=None):
    """``serve_lm(args)`` with every decode step's float32 logits copied
    to the host (prompt fill and generation); returns the tokens, the
    stacked logits ``[steps, B, V_pad]``, the final cache on the host and
    the model served.  ``cfg`` replaces the arch's config (a depth cut),
    ``prep(model)`` edits the freshly made model in place (the SSM's
    carry init), and ``nudge`` moves every weight by one float32 ulp
    after that, for the floor of the comparison."""
    from repro_torch.launch import serve
    from repro_torch.models import ssm, transformer
    family = serve.get_config(args.arch).family
    mod, cls, init_name = {
        "dense": (transformer, transformer.DenseLM, "init_dense_lm"),
        "ssm": (ssm, ssm.Mamba2LM, "init_mamba2")}[family]
    real_init, real_cfg = getattr(mod, init_name), serve.get_config
    real = cls.forward_decode
    logits, last, made = [], {}, []

    def init(cfg, seed=0, device="cuda"):
        model = real_init(cfg, seed, device)
        if prep is not None:
            prep(model)
        if nudge:
            nudge_weights(torch, model, seed)
        made.append(model)
        return model

    def record(self, cache, tokens, pos):
        out, cache = real(self, cache, tokens, pos)
        logits.append(out.float().cpu())
        last.update(cache)
        return out, cache
    cls.forward_decode = record
    setattr(mod, init_name, init)
    if cfg is not None:
        serve.get_config = lambda name: cfg
    try:
        toks = serve.serve_lm(args)["tokens"]
    finally:
        cls.forward_decode = real
        setattr(mod, init_name, real_init)
        serve.get_config = real_cfg
    return (toks, torch.stack(logits), {k: v.cpu() for k, v in last.items()},
            made[0])


def decode_gap(torch, a, b):
    """Per-step max abs logit gap ``[steps]`` and the final k/v caches'
    max abs gap and share of entries more than one bf16 ulp apart."""
    (la, ka), (lb, kb) = a[1:3], b[1:3]
    per_step = (la - lb).abs().amax(dim=(1, 2))
    kv = {}
    for name in ("k", "v"):
        x, y = ka[name].float(), kb[name].float()
        d = (x - y).abs()
        kv[name] = (d.max().item(),
                    (d > 2 ** -7 * y.abs()).float().mean().item())
    return per_step, kv


def phase_lm_serve(torch):
    """``serve_lm`` at full width with zeroed launch counters (decode runs
    plain torch: no kernel of the port is on this path) and nothing else
    in the loop, for its tok/s; a second, instrumented run (CUDA events
    between steps, a profiler over 4 steps) for the median step and the
    device's busy share; then the float32 card-vs-CPU gate on tokens,
    per-step logits and the final KV cache."""
    from repro_torch.models import layers
    from repro_torch.models.layers import padded_vocab
    v_pad = padded_vocab(lm_config())
    res = serve_and_time(torch, lambda: lm_serve_args(LM_GEN, DEVICE),
                         f"lm serve {LM_ARCH}", v_pad)
    toks = res["tokens"]

    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        card = record_decode(torch, lm_serve_args(LM_AGREE_GEN, DEVICE))
        cpu = record_decode(torch, lm_serve_args(LM_AGREE_GEN, "cpu"))
        floor = record_decode(torch, lm_serve_args(LM_AGREE_GEN, "cpu"),
                              nudge=True)
    finally:
        layers.COMPUTE_DTYPE = saved
    check((card[0] == cpu[0]).all(), f"float32 decode tokens differ card "
          f"vs CPU:\n{card[0]}\n{cpu[0]}")
    lg, lc = card[1], cpu[1]
    check(lg.shape == lc.shape == (LM_PROMPT + LM_AGREE_GEN, LM_BATCH, v_pad),
          f"decode logits {tuple(lg.shape)} vs {tuple(lc.shape)}")
    per_step, kv = decode_gap(torch, card, cpu)
    floor_step, floor_kv = decode_gap(torch, floor, cpu)
    err = per_step.max().item()
    print(f"[lm serve] float32, {LM_PROMPT} prompt + {LM_AGREE_GEN} "
          f"generated steps, card vs CPU: logits within {err:.3e} (scale "
          f"{lc.abs().max().item():.3f}; worst step {int(per_step.argmax())}, "
          f"median step {per_step.median().item():.3e}); final k/v caches "
          f"within {kv['k'][0]:.3e} / {kv['v'][0]:.3e}, "
          f"{100 * kv['k'][1]:.2f}% / {100 * kv['v'][1]:.2f}% of entries "
          f"more than one bf16 ulp apart. Floor, CPU with every weight one "
          f"float32 ulp off: logits {floor_step.max().item():.3e} (median "
          f"step {floor_step.median().item():.3e}), caches "
          f"{floor_kv['k'][0]:.3e} / {floor_kv['v'][0]:.3e}, "
          f"{100 * floor_kv['k'][1]:.2f}% / {100 * floor_kv['v'][1]:.2f}% "
          f"beyond one ulp")
    check(bool(torch.isfinite(lg).all()) and err <= LM_DECODE_ATOL,
          f"float32 decode logits differ card vs CPU by {err} (step "
          f"{int(per_step.argmax())}), over {LM_DECODE_ATOL}")
    check(max(kv["k"][0], kv["v"][0]) <= LM_CACHE_ATOL,
          f"float32 decode: the card's final k/v cache differs from the "
          f"CPU's by {kv}, over {LM_CACHE_ATOL}")
    same_bf16 = float((toks[:, :LM_AGREE_GEN] == card[0]).mean())
    print(f"[lm serve] float32 tokens card == CPU ({card[0][0].tolist()} "
          f"...); the bf16 run's tokens agree with them at "
          f"{100 * same_bf16:.1f}% of positions")
    res["bf16_vs_f32_agree"] = same_bf16
    res["f32_decode_max_abs_err"] = err
    res["f32_decode_cache_max_abs_err"] = max(kv["k"][0], kv["v"][0])
    res["f32_decode_floor"] = floor_step.max().item()
    return res


# ------------------------------------------------------------------ SSM LM

def ssm_config(n_layers=None):
    """mamba2-1.3b at full width (``n_layers`` cuts the depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def carry_init(torch, model):
    """Set every block's ``dt_bias`` to -4 and draw ``a_log`` from N(0,
    0.5) (a seeded CPU generator), in place: dt ~0.02, so the state keeps
    a visible share across a 128-row chunk, where the reference's init
    (dt ~0.79, a = -1) decays it by ~exp(-101)."""
    gen = torch.Generator().manual_seed(SSM_SEED + 7)
    with torch.no_grad():
        for blk in model.layers:
            blk.dt_bias.fill_(-4.0)
            blk.a_log.copy_(torch.randn(blk.a_log.shape, generator=gen) * 0.5)
    return model


def cut_model(torch, model, n_layers, device):
    """A ``Mamba2LM`` of the first ``n_layers`` blocks of ``model`` (and
    its embedding, norm and head) on ``device``."""
    from repro_torch.models.ssm import Mamba2LM
    cut = Mamba2LM(ssm_config(n_layers), device)
    cut.load_state_dict({
        k: v for k, v in model.state_dict().items()
        if not k.startswith("layers.") or int(k.split(".")[1]) < n_layers})
    return cut


def ssd_layer0(torch, model, batch):
    """Layer 0's SSD operands of ``model``'s forward over ``batch``, as the
    model passes them: ``(conv_out, (x, dt, a, b, c))`` with the conv
    output, dt and a cloned and x, b, c rebuilt as views of the clone by
    ``ssm.ssd_operands``; checks the model's own x, b and c were such views
    of one conv output (no copy)."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm, zoo
    real, calls = ops.ssd_scan, []

    def record(x, dt, a, bm, cm, **kw):
        if not calls:
            calls.append((x._base, [(t.shape, t.stride(),
                                     t.data_ptr() - x.data_ptr())
                                    for t in (x, bm, cm)],
                          x._base.clone(), dt.clone(), a.clone()))
        return real(x, dt, a, bm, cm, **kw)
    ops.ssd_scan = record
    try:
        zoo.forward_logits(model.cfg, model, batch)
    finally:
        ops.ssd_scan = real
    base, layout, conv_out, dt, a = calls[0]
    xh, bm, cm = ssm.ssd_operands(conv_out, *ssm.dims(model.cfg)[1:])
    want = [(t.shape, t.stride(), t.data_ptr() - xh.data_ptr())
            for t in (xh, bm, cm)]
    check(base is not None and layout == want,
          f"layer 0's x, b and c are not views of one conv output: "
          f"{layout}, expected {want}")
    return conv_out, (xh, dt, a, bm, cm)


def phase_ssm_prefill(torch):
    """``forward_logits`` of mamba2-1.3b at full width and depth over
    ``PREFILL_B x PREFILL_S`` seeded tokens, bf16 compute, with zeroed
    launch counters (48 ``ssd_scan`` launches per forward, nothing else);
    one profiled forward; the kernel at layer 0's own operands (the conv
    output's bf16 views) at the reference's init and at the carry init,
    and one layer's SSD dispatching no aten cast or copy; the card against
    the CPU on a
    2-layer cut at 2 x ``SSM_CUT_S`` tokens (two chunks), both inits, in
    float32 and bfloat16 compute."""
    import copy
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import layers, ssm, zoo
    cfg = ssm_config()
    model, batch, tokens, res = run_prefill(
        torch, cfg, SSM_SEED, "ssd_scan", f"ssm prefill {SSM_ARCH}")

    print(f"[ssm prefill] ssd_scan routes over the {1 + PREFILL_WARM} "
          f"forwards: {res['ssd_routes']}")
    # the kernel at layer 0's own operands (the conv output's bf16 views):
    # the reference's init (the state forgets a whole chunk, but each
    # chunk's first rows still read the previous chunk's last rows through
    # it), then the carry init
    conv_out, ins = ssd_layer0(torch, model, batch)
    (res["layer0_err"], res["layer0_gate_share"],
     res["layer0_carry_share"], _) = check_ssd_bf16(
        torch, ins, cfg.ssm_chunk, f"layer 0's operands (reference init) "
        f"{[tuple(t.shape) for t in ins]}, mean dt "
        f"{ins[1].mean().item():.4f},", tag="[ssm prefill]")
    res["ssd_inputs"] = ins
    one = carry_init(torch, cut_model(torch, model, 1, DEVICE))
    _, carry_ins = ssd_layer0(torch, one, batch)
    (res["carry_err"], res["carry_gate_share"], share,
     res["carry_over_gate"]) = check_ssd_bf16(
        torch, carry_ins, cfg.ssm_chunk, f"layer 0's operands (carry init), "
        f"mean dt {carry_ins[1].mean().item():.4f},", tag="[ssm prefill]")
    check(share > 1e-2 and res["carry_over_gate"] > 1,
          f"carry init: the carry holds only {share:.2e} of layer 0's scan "
          f"output ({res['carry_over_gate']:.2f}x the gate)")
    res["carry_share"] = share
    del one, carry_ins
    # no cast or copy around the kernel: one layer's SSD, from the conv
    # output to the scan's result, dispatches views and the output's
    # allocation only, and launches the tensor-core kernel once
    def one_layer_ssd():
        xh, bm, cm = ssm.ssd_operands(conv_out, *ssm.dims(cfg)[1:])
        return ops.ssd_scan(xh, ins[1], ins[2], bm, cm, chunk=cfg.ssm_chunk)
    ops.reset_launch_counts()
    aten, _ = recorded_ops(torch, one_layer_ssd)
    check(all(op.startswith(VIEW_OPS) for op in aten)
          and sum(op.startswith("aten.empty") for op in aten) == 1
          and ops.ssd_route_counts() == {"tensor_core": 1, "float32": 0},
          f"one layer's SSD dispatched {aten} and launched "
          f"{ops.ssd_route_counts()}: expected views, one allocation and one "
          f"tensor-core launch")
    print(f"[ssm prefill] one layer's SSD, conv output in to the scan's "
          f"result out: aten ops {aten} (no cast or copy), one tensor-core "
          f"launch")
    res["ssd_dispatch_ops"] = aten
    del conv_out

    # card against CPU on a 2-layer cut, two chunks, both inits
    small = torch.from_numpy(np.ascontiguousarray(tokens[:2, :SSM_CUT_S]))
    saved = layers.COMPUTE_DTYPE
    res["cut"] = {}
    try:
        for init in ("reference", "carry"):
            cpu_model = cut_model(torch, model, SSM_CUT, "cpu")
            if init == "carry":
                carry_init(torch, cpu_model)
            card_model = copy.deepcopy(cpu_model).to(DEVICE)
            for dtype, atol in ((torch.float32, SSM_CUT_ATOL_F32),
                                (torch.bfloat16, SSM_CUT_ATOL_BF16)):
                layers.COMPUTE_DTYPE = dtype
                lc = zoo.forward_logits(cpu_model.cfg, cpu_model,
                                        {"tokens": small})
                lg = zoo.forward_logits(card_model.cfg, card_model,
                                        {"tokens": small.to(DEVICE)}).cpu()
                err = (lg - lc).abs().max().item()
                agree = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
                name = str(dtype).split(".")[1]
                check(bool(torch.isfinite(lg).all()) and err <= atol,
                      f"ssm 2-layer cut, {init} init, {name}: card logits "
                      f"differ from the CPU port's by {err}, over {atol}")
                print(f"[ssm prefill] 2-layer cut, 2 x {SSM_CUT_S} tokens, "
                      f"{init} init, {name}: card logits within {err:.3e} "
                      f"of the CPU port's (scale {lc.abs().max().item():.3f},"
                      f" bound {atol}); argmax agrees at {100 * agree:.2f}%")
                res["cut"][f"{init} {name}"] = err
    finally:
        layers.COMPUTE_DTYPE = saved
    return res


def ssm_serve_args(gen, device, prompt=LM_PROMPT):
    """``serve_lm`` flags: mamba2-1.3b, batch 8, prompt 128."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", SSM_ARCH, "--device", device, "--seed", str(SSM_SEED),
        "--batch", str(LM_BATCH), "--prompt-len", str(prompt),
        "--gen-len", str(gen)])


def serve_and_time(torch, make_args, label, v_pad):
    """``serve_lm(make_args())`` with zeroed launch counters (decode is
    plain torch: no kernel of the port may launch) and nothing else in the
    loop, for its tok/s, its tokens in ``[0, v_pad)``; then a second,
    instrumented run (CUDA events between steps, a profiler over 4 steps)
    that must generate the same tokens, for the median untraced step and
    the device's busy share.  Returns the first run's result with those
    added."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.serve_lm(make_args())
    res["total_s"] = time.perf_counter() - t0
    res["launches"] = ops.launch_counts()
    check(all(n == 0 for n in res["launches"].values()),
          f"{label}: decode launched a kernel: {res['launches']}")
    toks = res["tokens"]
    check(toks.shape == (LM_BATCH, LM_GEN) and toks.min() >= 0
          and toks.max() < v_pad, f"{label}: served tokens {toks.shape} "
          f"outside [0, {v_pad})")
    events = []
    clock = StepClock(torch, first=LM_GEN - 8, n=4)

    def hook(step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        clock(step)
    try:
        timed = serve.serve_lm(make_args(), step_hook=hook)
    finally:
        clock.close()
    torch.cuda.synchronize()
    check((timed["tokens"] == toks).all(),
          f"{label}: the instrumented serve_lm run generated other tokens")
    steps = [events[i].elapsed_time(events[i + 1])
             for i in range(len(events) - 1)]
    # steps[i] is decode step i + 1; the median is over steps 1 ..
    # first - 2, before the profiler's warm-up step and its traced steps
    res["median_step_ms"] = statistics.median(steps[:clock.first - 2])
    res["instrumented_wall_s"] = timed["wall_s"]
    traced = steps[clock.first - 1:clock.first - 1 + clock.n]
    res["busy_ms"] = summarize_profile(
        torch, clock.prof, clock.n, sum(traced) / len(traced),
        f"{label}, per traced decode step")
    print(f"[{label}] batch {LM_BATCH}, prompt {LM_PROMPT}, gen {LM_GEN}: "
          f"{res['tok_s']:,.1f} tok/s over the uninstrumented timed loop "
          f"({res['wall_s']:.3f} s; whole call {res['total_s']:.2f} s), "
          f"launches {res['launches']}; instrumented run: median untraced "
          f"step {res['median_step_ms']:.3f} ms (events between steps), "
          f"timed loop {timed['wall_s']:.3f} s")
    return res


def phase_ssm_serve(torch):
    """``serve_lm`` of mamba2-1.3b at full width with zeroed launch
    counters (decode is plain torch: no kernel of the port runs) and
    nothing else in the loop, for its tok/s; a second, instrumented run for
    the median step and the busy share; then, on a 2-layer cut in float32
    compute at both inits, the card against the CPU port at every step of
    a 248-token prompt and 8 generated tokens (tokens equal but at
    near-ties, logits up to each row's first differing token, the final
    state of the rows that never differ), beside the floor of the CPU
    against itself with every weight one float32 ulp off, and the card's
    own prefill of the same 256 tokens (two chunks) against its decode at
    every position."""
    import numpy as np
    from repro_torch.models import layers, zoo
    from repro_torch.models.layers import padded_vocab
    v_pad = padded_vocab(ssm_config())
    res = serve_and_time(torch, lambda: ssm_serve_args(LM_GEN, DEVICE),
                         f"ssm serve {SSM_ARCH}", v_pad)

    cut = ssm_config(SSM_CUT)
    prompt = np.random.default_rng(SSM_SEED).integers(
        0, cut.vocab_size, (LM_BATCH, SSM_AGREE_PROMPT), dtype=np.int32)
    steps = SSM_AGREE_PROMPT + SSM_AGREE_GEN
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    res["agree"] = {}
    try:
        for init in ("reference", "carry"):
            prep = carry_init_fn(torch) if init == "carry" else None
            runs = [record_decode(torch, ssm_serve_args(
                SSM_AGREE_GEN, where, SSM_AGREE_PROMPT), cfg=cut, prep=prep,
                nudge=nudge) for where, nudge in ((DEVICE, False),
                                                  ("cpu", False),
                                                  ("cpu", True))]
            card, cpu, floor = runs
            check(card[1].shape == cpu[1].shape == (steps, LM_BATCH, v_pad),
                  f"ssm decode logits {tuple(card[1].shape)}")
            gap = decode_state_gap(torch, card, cpu, SSM_AGREE_PROMPT)
            floor_gap = decode_state_gap(torch, floor, cpu, SSM_AGREE_PROMPT)
            # the card's own prefill of the same tokens (two chunks)
            model = card[3]
            seq = np.concatenate([prompt, card[0]], axis=1)
            pre = zoo.forward_logits(cut, model, {
                "tokens": torch.from_numpy(seq).to(DEVICE)}).cpu()
            pd = (pre.transpose(0, 1) - card[1]).abs().amax(dim=(1, 2))
            print(f"[ssm serve] float32, 2-layer cut, {init} init, "
                  f"{SSM_AGREE_PROMPT} prompt + {SSM_AGREE_GEN} generated "
                  f"steps, card vs CPU: {gap['n_same']} of {LM_BATCH} rows "
                  f"generate the same tokens (first differing step per row "
                  f"{gap['first']}, top-two logit gaps there "
                  f"{[f'{t:.2e}' for t in gap['ties']]}); logits within "
                  f"{gap['logits']:.3e} up to each row's first difference "
                  f"(scale {cpu[1].abs().max().item():.3f}, worst step "
                  f"{gap['worst_step']}); final state of those rows within "
                  f"{gap['ssm']:.3e} (scale {gap['ssm_scale']:.3f}), conv "
                  f"history within {gap['conv']:.3e}. Floor, CPU with every "
                  f"weight one float32 ulp off: logits "
                  f"{floor_gap['logits']:.3e}, ssm {floor_gap['ssm']:.3e}, "
                  f"conv {floor_gap['conv']:.3e}, {floor_gap['n_same']} rows "
                  f"the same. Card prefill of the {steps} tokens vs its "
                  f"decode: last position {pd[-1].item():.3e}, median "
                  f"{pd.median().item():.3e}, max {pd.max().item():.3e}")
            check(gap["n_same"] >= LM_BATCH // 2 and all(
                t <= SSM_DECODE_ATOL for t in gap["ties"]),
                f"ssm float32 decode ({init}): tokens differ card vs CPU "
                f"away from near-ties (rows the same {gap['n_same']}, gaps "
                f"{gap['ties']}):\n{card[0]}\n{cpu[0]}")
            check(bool(torch.isfinite(card[1]).all())
                  and gap["logits"] <= SSM_DECODE_ATOL,
                  f"ssm float32 decode ({init}): logits differ card vs CPU "
                  f"by {gap['logits']}, over {SSM_DECODE_ATOL}")
            check(gap["ssm"] <= SSM_STATE_RTOL * gap["ssm_scale"],
                  f"ssm float32 decode ({init}): final state differs card vs "
                  f"CPU by {gap['ssm']}, over {SSM_STATE_RTOL} of "
                  f"{gap['ssm_scale']}")
            check(gap["conv"] <= SSM_CONV_ATOL, f"ssm float32 decode "
                  f"({init}): conv history differs card vs CPU by "
                  f"{gap['conv']}, over {SSM_CONV_ATOL}")
            check(pd.max().item() <= SSM_PREFILL_DECODE_ATOL,
                  f"ssm ({init}): the card's prefill differs from its "
                  f"decode by {pd.max().item()} (last position "
                  f"{pd[-1].item()}), over {SSM_PREFILL_DECODE_ATOL}")
            res["agree"][init] = {
                "logits": gap["logits"], "ssm": gap["ssm"],
                "conv": gap["conv"], "rows_same": gap["n_same"],
                "floor_logits": floor_gap["logits"],
                "prefill_vs_decode_last": pd[-1].item(),
                "prefill_vs_decode_max": pd.max().item()}
            del runs, card, cpu, floor, model
    finally:
        layers.COMPUTE_DTYPE = saved
    return res


def carry_init_fn(torch):
    """``carry_init`` as a ``record_decode`` ``prep``."""
    return lambda model: carry_init(torch, model)


def decode_state_gap(torch, a, b, prompt_len):
    """Gaps of two ``record_decode`` runs of the SSM, row by row up to
    the first generated token where the two differ (a greedy near-tie may
    go either way; the rows then decode other tokens).  Returns each row's
    first differing generated step (``G`` if none) and the top-two logit
    gap on both sides there (``ties``); the max abs logit gap over the
    steps before it (and its worst step); and over the rows that never
    differ, the final float32 state's and bf16 conv history's max abs
    gap (with the state's scale over every row)."""
    ta, tb = a[0], b[0]
    g = ta.shape[1]
    first = [int(r.argmax()) if r.any() else g for r in (ta != tb)]
    valid = torch.zeros(a[1].shape[:2], dtype=torch.bool)
    ties = []
    for row, f in enumerate(first):
        valid[:prompt_len + f, row] = True
        if f < g:
            s, x, y = prompt_len + f - 1, int(ta[row, f]), int(tb[row, f])
            ties.append(max((a[1][s, row, x] - a[1][s, row, y]).item(),
                            (b[1][s, row, y] - b[1][s, row, x]).item()))
    per_step = torch.where(valid[..., None], (a[1] - b[1]).abs(),
                           0).amax(dim=(1, 2))
    same = [row for row, f in enumerate(first) if f == g]

    def state_gap(name):
        if not same:
            return float("inf")
        return (a[2][name][:, same].float()
                - b[2][name][:, same].float()).abs().max().item()
    return {"first": first, "ties": ties, "n_same": len(same),
            "logits": per_step.max().item(),
            "worst_step": int(per_step.argmax()),
            "ssm": state_gap("ssm"),
            "ssm_scale": b[2]["ssm"].abs().max().item(),
            "conv": state_gap("conv")}


def gather_levels(torch, server, head_order):
    """The ``gather_reduce`` drive's operands on a graphgen-gcn W = 1
    ``server``: the 20 000 x 128 feature table, and ``GATHER_REQUESTS``
    bucket-32 requests of Zipf(1.5) seeds (seeded) with each one's hop-2
    ``(idx, mask)`` as ``[32 * 40, 20]``.  Returns ``(table, batches,
    levels)``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.graph.synthetic import node_features
    cfg = get_config("graphgen-gcn")
    k2 = cfg.fanouts[1]
    table = torch.from_numpy(node_features(N_NODES, cfg.gcn_in_dim,
                                           0)).to(DEVICE)
    rng = np.random.default_rng(13)
    batches = []
    for _ in range(GATHER_REQUESTS):
        ranks = np.minimum(rng.zipf(1.5, 32), head_order.size) - 1
        batches.append(server.generate(head_order[ranks]))
    levels = [(b.hops[1].reshape(-1, k2).contiguous(),
               b.masks[1].reshape(-1, k2).contiguous()) for b in batches]
    torch.cuda.synchronize()
    return table, batches, levels


def phase_gather_reduce(torch, serve_res):
    """``gather_reduce`` driven as edge-centric collection + aggregation
    at a graphgen-gcn W = 1 server's own requests (no model calls it):
    over ``GATHER_REQUESTS`` bucket-32 requests, the hop-2 level's mean
    straight from the 20 000 x 128 feature table (``idx``/``mask`` the
    request's hop-2 ids and mask as ``[32 * 40, 20]``), with zeroed launch
    counters.  Then, apart: each result against the twin and against
    ``fanout_mean`` of the features the generator gathered for that level
    (where the request dropped nothing), and the kernel against its twin
    on a copy with ids off both ends of the table and all-masked rows.
    Returns the launches and the first request's operands."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config("graphgen-gcn")
    k2 = cfg.fanouts[1]
    table, batches, levels = gather_levels(
        torch, *serve_res["graphgen-gcn", 1]["built"])
    ops.reset_launch_counts()
    outs = [ops.gather_reduce(table, idx, mask) for idx, mask in levels]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["gather_reduce"] == GATHER_REQUESTS
          and all(n == 0 for name, n in counts.items()
                  if name != "gather_reduce"),
          f"gather_reduce drive launched {counts}")
    worst, n_same = 0.0, 0
    for out, (idx, mask), b in zip(outs, levels, batches):
        ok, err = gather_close(torch, out, ref.gather_reduce_ref(table, idx,
                                                                 mask))
        check(ok, f"gather_reduce disagrees with its twin at a request's "
              f"hop-2 level: max err {err}")
        worst = max(worst, err)
        if int(b.n_dropped.sum()) == 0:
            x = b.x_hops[1].reshape(-1, k2, cfg.gcn_in_dim)
            want = ref.fanout_mean_ref(x, mask)
            check(torch.allclose(out, want, rtol=1e-5, atol=1e-6),
                  f"gather_reduce differs from fanout_mean of the gathered "
                  f"features by {(out - want).abs().max().item()}")
            n_same += 1
    idx, mask = (t.clone() for t in levels[0])
    idx[0, :5], idx[1, :5] = -3, N_NODES + 11
    mask[0:2, :5] = True
    mask[2:4] = False
    ok, err = gather_close(torch, ops.gather_reduce(table, idx, mask),
                           ref.gather_reduce_ref(table, idx, mask))
    check(ok, f"gather_reduce disagrees with its twin with clamped ids and "
          f"all-masked rows: max err {err}")
    print(f"[gather_reduce] {GATHER_REQUESTS} bucket-32 requests' hop-2 "
          f"levels {tuple(levels[0][0].shape)} from the "
          f"{tuple(table.shape)} table: launches {counts['gather_reduce']}; "
          f"== twin (max abs err {worst}); == fanout_mean of the gathered "
          f"features on {n_same} requests that dropped nothing; clamped ids "
          f"and all-masked rows == twin (max abs err {err})")
    return {"launches": counts, "inputs": (table, *levels[0])}


def phase_agree(torch, dev):
    """The port on the card vs on the CPU at a small size, same draws."""
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import (SeededDraws,
                                             make_distributed_generator,
                                             make_generator_fn)
    from repro_torch.core.partition import partition_edges
    from repro_torch.graph.synthetic import (node_features, node_labels,
                                             powerlaw_graph)
    from repro_torch.launch import serve
    from repro_torch.models.gcn import init_gcn

    cfg = dataclasses.replace(smoke_config(get_config("graphgen-gcn")),
                              cache_rows=64, cache_hit_cap=2)
    cache_cfg = CacheConfig.from_model(cfg)
    cpu_draws = SeededDraws(cfg.fanouts, 3, "cpu")
    g = powerlaw_graph(2000, n_hot=2, seed=3)
    feats, labels = node_features(2000, cfg.gcn_in_dim, 3), node_labels(
        2000, cfg.n_classes, 3)
    head = np.argsort(-np.diff(g.indptr)).astype(np.int32)[:256]
    for w in (1, 4):
        part = partition_edges(g, w)
        sides = {}
        for where in ("cpu", dev):
            def draws(n, nw, b, where=where):
                return tuple((o.to(where), e.to(where))
                             for o, e in cpu_draws(n, nw, b))
            gen_mut, args, cache0 = make_distributed_generator(
                part, feats, labels, fanouts=cfg.fanouts,
                cache_cfg=cache_cfg, device=where)
            warm = serve.warmup_sweep(gen_mut, args, cache0, head,
                                      n_workers=w, bucket=16, sweeps=3,
                                      draws=draws)
            server = serve.GraphServer(
                make_generator_fn(fanouts=cfg.fanouts,
                                  cache_cfg=cache_cfg.serve_view()),
                args, init_gcn(cfg, 3, device=where), warm, draws=draws,
                buckets=(8, 16), n_workers=w)
            sides[where] = server
        for a, b in zip(sides["cpu"].cache, sides[dev].cache):
            check(torch.equal(a, b.cpu()),
                  f"W={w}: warm cache differs between the card and the CPU")
        rng = np.random.default_rng(w)
        demoted = 0
        for size in (5, 16 * w, 3, 11):
            ids = head[rng.integers(0, head.size, size)]
            bc, bg = sides["cpu"].generate(ids), sides[dev].generate(ids)
            for name in ("seeds", "x_seed", "labels", "n_dropped",
                         "n_cache_hits", "n_cache_misses", "n_probe_demoted"):
                check(torch.equal(getattr(bc, name),
                                  getattr(bg, name).cpu()),
                      f"W={w}: batch field {name} differs card vs CPU")
            for name in ("hops", "masks", "x_hops"):
                for x, y in zip(getattr(bc, name), getattr(bg, name)):
                    check(torch.equal(x, y.cpu()),
                          f"W={w}: batch {name} differs card vs CPU")
            demoted += int(bg.n_probe_demoted.sum())
            lc = sides["cpu"].logits(ids)
            lg = sides[dev].logits(ids).cpu()
            check(torch.isfinite(lg).all() and lg.shape == lc.shape,
                  f"W={w}: logits not finite or misshapen")
            check(torch.allclose(lg, lc, rtol=1e-5, atol=1e-5),
                  f"W={w}: logits differ card vs CPU by "
                  f"{(lg - lc).abs().max().item()}")
        print(f"[agree W={w}] card == CPU: warm cache, batches exact, "
              f"logits within 1e-5 (probe demotions {demoted})")


def profile_requests(torch, server, next_ids, label, n=8):
    """Device busy time against wall time over ``n`` bucket-32 requests,
    from a ``torch.profiler`` trace (the profiler's own overhead inflates
    the wall time a little), and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server.serve(next_ids())
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    summarize_profile(torch, prof, n, wall_ms,
                      f"{label}, per bucket-32 request")


def phase_agree_train(torch, dev):
    """Three train steps of each train run's config on the card against
    the same three on the CPU (the twins) at a small size: same draws,
    seeds and initial weights; cache states and batches exact, losses and
    every parameter gradient within rtol 1e-4 (float32 reduction order,
    compounded over the Adam steps), atol 1e-6 for entries near zero."""
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.balance import balance_table
    from repro_torch.core.config import TrainConfig
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import (SeededDraws,
                                             make_distributed_generator)
    from repro_torch.core.partition import partition_edges
    from repro_torch.graph.synthetic import (node_features, node_labels,
                                             powerlaw_graph)
    from repro_torch.kernels import ops
    from repro_torch.models.gcn import gcn_loss, init_gcn
    from repro_torch.train.optimizer import adam_update, init_adam

    n, b = 2000, 8
    overrides = {"graphgen-gcn-deep": dict(cache_rows=64, cache_l1_rows=16,
                                           cache_l1_promote=2),
                 "graphgen-gcn": dict(cache_rows=64, cache_hit_cap=24)}
    g = powerlaw_graph(n, n_hot=2, seed=3)
    tcfg = TrainConfig(learning_rate=5e-3, total_steps=3, warmup_steps=0)
    for arch, (w, _) in TRAIN_RUNS.items():
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  **overrides[arch])
        cpu_draws = SeededDraws(cfg.fanouts, 3, "cpu")
        table = balance_table(np.arange(n), w, 3).per_worker
        feats = node_features(n, cfg.gcn_in_dim, 3)
        labels = node_labels(n, cfg.n_classes, 3)
        part = partition_edges(g, w)
        sides = {}
        for where in ("cpu", dev):
            gen_fn, args, cache = make_distributed_generator(
                part, feats, labels, fanouts=cfg.fanouts,
                cache_cfg=CacheConfig.from_model(cfg), device=where)
            model = init_gcn(cfg, 3, device=where)
            opt = init_adam(model.leaves())
            ops.reset_launch_counts()
            rec = []
            for t in range(3):
                seeds = torch.from_numpy(np.ascontiguousarray(
                    table[:, t * b:(t + 1) * b])).to(where)
                draws = tuple((o.to(where), e.to(where))
                              for o, e in cpu_draws(t, w, b))
                with torch.no_grad():
                    batch, cache = gen_fn(args, seeds, draws, cache)
                params = model.leaves()
                loss = gcn_loss(model, batch)
                grads = torch.autograd.grad(loss, params)
                new, opt, _ = adam_update(tcfg, params, grads, opt)
                with torch.no_grad():
                    for p, q in zip(params, new):
                        p.copy_(q)
                rec.append((batch, cache, loss.detach(), grads))
            sides[where] = (rec, ops.launch_counts())
        (cpu_rec, _), (dev_rec, counts) = sides["cpu"], sides[dev]
        check(counts["fanout_mean_bwd"] > 0, f"{arch}: the card's train "
              f"steps never launched fanout_mean_bwd")
        worst = 0.0
        for t, ((bc, cc, lc, gc), (bg, cg, lg, gg)) in enumerate(
                zip(cpu_rec, dev_rec)):
            for name in ("seeds", "x_seed", "labels", "n_dropped",
                         "n_cache_hits", "n_cache_misses", "n_probe_demoted"):
                check(torch.equal(getattr(bc, name), getattr(bg, name).cpu()),
                      f"{arch} step {t}: batch field {name} differs card vs "
                      f"CPU")
            for name in ("hops", "masks", "x_hops"):
                for x, y in zip(getattr(bc, name), getattr(bg, name)):
                    check(torch.equal(x, y.cpu()), f"{arch} step {t}: batch "
                          f"{name} differs card vs CPU")
            for x, y in zip(tree_leaves(cc), tree_leaves(cg)):
                check(torch.equal(x, y.cpu()), f"{arch} step {t}: cache "
                      f"state differs card vs CPU")
            check(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-6),
                  f"{arch} step {t}: loss {lg.item()} on the card, "
                  f"{lc.item()} on the CPU")
            for i, (x, y) in enumerate(zip(gc, gg)):
                y = y.cpu()
                check(torch.isfinite(y).all() and torch.allclose(
                    y, x, rtol=1e-4, atol=1e-6), f"{arch} step {t}: gradient "
                      f"{i} differs card vs CPU by {(y - x).abs().max()}")
                worst = max(worst, ((y - x).abs().max()
                                    / x.abs().max().clamp(min=1e-30)).item())
        print(f"[agree train {arch} W={w}] card == CPU over 3 steps: cache "
              f"states and batches exact, losses and gradients within rtol "
              f"1e-4 (largest gradient gap {worst:.2e} of its tensor's "
              f"largest entry)")


def tree_leaves(state):
    """The tensors of a flat or tiered cache state."""
    if hasattr(state, "l1"):
        return list(state.l1) + list(state.l2)
    return list(state)


def phase_timing(torch, serve_res, train_res, launches, qkv, ssd_ins,
                 gather_ins):
    """Per bucket-32 request, on the servers the serve phase built and
    warmed: kernel launches and a profiler trace.  Then kernel, twin and
    library-call times at each kernel's path's own inputs: at a bucket-32
    request of the graphgen-gcn servers, the gather probe (W = 1) and, at
    W = 4 (global batch 128), fanout_mean at its three layer shapes and
    the compact probe; at the last batch and the warm cache of the train
    runs, the tiered probe (graphgen-gcn-deep) and fanout_mean_bwd at the
    hidden-level shapes of both runs (real masks, a random gradient); and
    flash_attention at ``qkv``, layer 0's inputs of the LM prefill;
    ssd_scan at ``ssd_ins``, layer 0's operands of the SSM prefill (the
    conv output's bf16 views, the tensor-core route) and at their float32
    upcast (``ssd_scan_f32``, the SIMT route); and gather_reduce at
    ``gather_ins``, a W = 1 request's hop-2 level; and the compact probe
    again at the W = 4 train run's own probe round (``train_round`` in its
    entry).  Every time is read by events and by device duration.  Returns
    one JSON entry per kernel or route (its first shape; the backward's
    entry lists every shape) and the floor of both readings."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import dedup_requests
    from repro_torch.kernels import ops

    cfg = get_config("graphgen-gcn")
    entries = {}
    # the floor of each reading: a null launch, a 4-byte zero_()
    null = torch.zeros(1, device=DEVICE)
    floor_ms, floor_dev_ms = both_ms(torch, null.zero_)
    print(f"[timing floor] a 4-byte zero_(): {floor_ms:.4f} ms (events), "
          f"{floor_dev_ms:.4f} ms (device duration)")
    for (arch, w), res in serve_res.items():
        server, head_order = res["built"]
        rng = np.random.default_rng(11)

        def bucket32():
            ranks = np.minimum(rng.zipf(1.5, 32 * w), head_order.size) - 1
            return head_order[ranks]

        ops.reset_launch_counts()
        server.serve(bucket32())
        print(f"[per-request {arch} W={w}] launches of one bucket-32 "
              f"request: {ops.launch_counts()}")
        profile_requests(torch, server, bucket32, f"{arch} {w}")
        if arch != "graphgen-gcn":
            continue
        batch = server.generate(bucket32())
        if w == 1:
            uniq = dedup_requests(torch.cat([batch.seeds.reshape(1, -1)] + [
                h.reshape(1, -1) for h in batch.hops], dim=1))[0]
            items = [("cache_probe_gather", (server.cache.keys[0],
                                             server.cache.rows[0], uniq[0]),
                      {"assoc": cfg.cache_assoc})]
        else:
            items = request_items(torch, server, batch, w)
        items_timed(torch, items, launches, entries)

    # the compact probe at the W = 4 train run's own probe round (the main
    # path's: its calibrated slack and hit cap), beside the serve round
    res = train_res["graphgen-gcn"]
    keys, rows, recv, hc = train_probe_round(torch, res, 4)
    entry = time_kernel(torch, "cache_probe_compact", (keys, rows, recv),
                        {"assoc": res["cache_cfg"].assoc, "hit_cap": hc})
    print(f"[timing cache_probe_compact train round] ids "
          f"{tuple(recv.shape)}, hit_cap {hc}, D {rows.shape[-1]}: kernel "
          f"{entry['ms']:.4f} ms (events) {entry['device_ms']:.4f} ms "
          f"(device), bound {entry['bound_ms']:.4f} ms, "
          f"{entry['ms'] / entry['bound_ms']:.2f}x the bound")
    entries["cache_probe_compact"]["train_round"] = {
        "ids": list(recv.shape), "hit_cap": hc, "ms": entry["ms"],
        "device_ms": entry["device_ms"], "bound_ms": entry["bound_ms"],
        "plain_ms": entry["plain_ms"],
        "ratio": entry["ms"] / entry["bound_ms"]}

    # the train runs' own inputs: the backward at every shape of both runs
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    shapes = []
    for arch in ("graphgen-gcn", "graphgen-gcn-deep"):
        batch = train_res[arch]["batch"]
        hidden = get_config(arch).gcn_hidden
        depth = len(batch.masks)
        # the hidden levels whose mean the backward reaches: children of
        # levels 0 .. L-2 (level L-1's children are raw features); layers
        # 1 .. L-1-lvl each differentiate level lvl's mean once a step
        for lvl in range(depth - 1):
            mask = batch.masks[lvl]
            k = mask.shape[-1]
            mask = mask.reshape(-1, k).contiguous()
            g = torch.randn((mask.shape[0], hidden), generator=gen,
                            device=DEVICE)
            entry = time_kernel(torch, "fanout_mean_bwd", (g, mask), {})
            entry["launches"] = launches["fanout_mean_bwd"]
            entries.setdefault("fanout_mean_bwd", entry)
            per_step = depth - 1 - lvl
            shapes.append({
                "run": arch, "shape": [mask.shape[0], k, hidden],
                "launches_per_step": per_step,
                **{key: entry[key] for key in (
                    "ms", "device_ms", "bound_ms", "library_ms",
                    "library_device_ms", "zero_ms", "zero_device_ms")},
                "lost_ms": per_step * (entry["ms"] - entry["bound_ms"]),
                "lost_device_ms": per_step * (entry["device_ms"]
                                              - entry["bound_ms"])})
    for sh in shapes:
        print(f"[timing fanout_mean_bwd per shape] {sh['run']} "
              f"{tuple(sh['shape'])} x{sh['launches_per_step']} per step: "
              f"{sh['ms']:.4f} ms (events) {sh['device_ms']:.4f} ms "
              f"(device), bound {sh['bound_ms']:.4f} ms "
              f"({100 * sh['bound_ms'] / sh['device_ms']:.0f}% by device); "
              f"lost per step {sh['lost_ms']:.4f} / "
              f"{sh['lost_device_ms']:.4f} ms")
    deep_shapes = [sh for sh in shapes if sh["run"] == "graphgen-gcn-deep"]
    check(sum(sh["launches_per_step"] for sh in deep_shapes) == 3,
          "the deep step's backward launches are not 3 per step")
    bwd = entries["fanout_mean_bwd"]
    bwd["shapes"] = shapes
    bwd["deep_step_lost_ms"] = sum(sh["lost_ms"] for sh in deep_shapes)
    bwd["deep_step_lost_device_ms"] = sum(sh["lost_device_ms"]
                                          for sh in deep_shapes)
    print(f"[timing fanout_mean_bwd] lost per deep step (3 launches): "
          f"{bwd['deep_step_lost_ms']:.4f} ms (events), "
          f"{bwd['deep_step_lost_device_ms']:.4f} ms (device)")
    items = []
    deep = train_res["graphgen-gcn-deep"]
    dcfg = CacheConfig.from_model(get_config("graphgen-gcn-deep"))
    batch, cache = deep["batch"], deep["cache"]
    need = torch.cat([batch.seeds.reshape(1, -1)] + [
        h.reshape(1, -1) for h in batch.hops], dim=1)
    uniq = dedup_requests(need)[0]
    items.append(("cache_probe_tiered", (
        cache.l1.keys[0], cache.l1.rows[0], cache.l2.keys[0],
        cache.l2.rows[0], uniq[0]),
        {"l1_assoc": dcfg.l1_assoc, "l2_assoc": dcfg.assoc}))
    items.append(("flash_attention", qkv, {"causal": True}))
    chunk = {"chunk": ssm_config().ssm_chunk}
    items.append(("ssd_scan", ssd_ins, chunk))
    items.append(("ssd_scan_f32", tuple(t.float().contiguous()
                                        for t in ssd_ins), chunk))
    items.append(("gather_reduce", gather_ins, {}))
    items_timed(torch, items, launches, entries)
    floor = {"ms": floor_ms, "device_ms": floor_dev_ms}
    return [entries[name] for name in KERNEL_META], floor


def request_items(torch, server, batch, w):
    """The timed kernel calls of one request ``batch`` on a graphgen-gcn
    ``server`` at ``w`` > 1 workers: ``fanout_mean`` at its three layer
    shapes (the hidden level a seeded random activation) and the compact
    probe on the request's probe round at the serve slack (2.0) and hit
    cap."""
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import StackedGroup
    from repro_torch.core.feature_cache import CacheConfig
    from repro_torch.core.generation import (dedup_requests, probe_hit_cap,
                                             probe_round_capacity, probe_send)
    cfg = get_config("graphgen-gcn")
    need = torch.cat([batch.seeds.reshape(w, -1)] + [
        h.reshape(w, -1) for h in batch.hops], dim=1)
    uniq, _, valid, _ = dedup_requests(need)
    k2 = cfg.fanouts[1]
    gen = torch.Generator(device=need.device).manual_seed(5)
    hidden = torch.randn(batch.x_hops[0].shape[:-1] + (cfg.gcn_hidden,),
                         generator=gen, device=need.device)
    cap = probe_round_capacity(need.shape[1], w, 2.0)
    _, recv = probe_send(uniq, valid, cap, StackedGroup(w, uniq.device))
    hc = probe_hit_cap(CacheConfig.from_model(cfg), cap)
    return [
        ("fanout_mean", (batch.x_hops[1].reshape(-1, k2, cfg.gcn_in_dim),
                         batch.masks[1].reshape(-1, k2)), {}),
        ("fanout_mean", (batch.x_hops[0], batch.masks[0]), {}),
        ("fanout_mean", (hidden, batch.masks[0]), {}),
        ("cache_probe_compact", (server.cache.keys, server.cache.rows, recv),
         {"assoc": cfg.cache_assoc, "hit_cap": hc})]


def items_timed(torch, items, launches, entries):
    """Time each ``(name, inputs, kw)``; the first entry of a name is the
    one the JSON line reports."""
    for name, inputs, kw in items:
        if name not in ("flash_attention", "ssd_scan"):
            # flash and the bf16 scan run at the path's strides
            inputs = tuple(t.contiguous() for t in inputs)
        entry = time_kernel(torch, name, inputs, kw)
        entry["launches"] = launches[name]
        entries.setdefault(name, entry)


def time_kernel(torch, name, inputs, kw):
    """Times, error and bound of one kernel at ``inputs`` (``ssd_scan_f32``:
    ``ssd_scan`` at float32 inputs).  The bound counts each input byte read
    once and each output byte written once, at the operands' element sizes
    and the peak rate of their type; for the probes only the rows the hits
    need are counted (data-dependent)."""
    from repro_torch.kernels import ops, ref
    op = "ssd_scan" if name == "ssd_scan_f32" else name
    kern_fn = getattr(ops, op)
    plain_fn = getattr(ref, op + "_ref")
    kern = lambda: kern_fn(*inputs, **kw)              # noqa: E731
    plain = lambda: plain_fn(*inputs, **kw)            # noqa: E731
    got, want = kern(), plain()
    library = store = None
    extra = {}
    flops = F32_FLOPS
    if name == "fanout_mean":
        x, mask = inputs
        m, k, d = x.shape
        err = (got.float() - want.float()).abs().max().item()
        # the one-call yardstick: a batched matmul of the normalised mask
        # with x (the normalisation is precomputed and not timed)
        wts = mask.float() / mask.float().sum(1, keepdim=True).clamp(min=1)
        wts = wts[:, None, :].contiguous()
        library = lambda: torch.bmm(wts, x)            # noqa: E731
        n_bytes = x.numel() * x.element_size() + mask.numel() + m * d * 4
        n_ops = 2 * m * k * d + m * d
    elif name == "cache_probe_gather":
        keys, rows, ids = inputs
        for a, b in zip(got, want):
            check(torch.equal(a, b), "gather probe differs from its twin at "
                  "the serve inputs")
        err = (got[1] - want[1]).abs().max().item()
        r, d = ids.shape[0], rows.shape[1]
        n_hit_rows = int(torch.unique(ids[got[0]]).numel())
        n_bytes = (r * 4 + keys.numel() * 4 + n_hit_rows * d * 4
                   + r + r * d * 4)
        n_ops = r * (2 + kw["assoc"])
    elif name == "fanout_mean_bwd":
        g, mask = inputs
        (m, d), k = g.shape, mask.shape[1]
        check(torch.equal(got, want), f"fanout_mean_bwd differs from its "
              f"twin at the train inputs {m, k, d}")
        err = (got.float() - want.float()).abs().max().item()
        # the one-call yardstick: a batched matmul of the normalised mask
        # [M, K, 1] with g [M, 1, D] (the normalisation is precomputed)
        wts = mask.float() / mask.float().sum(1, keepdim=True).clamp(min=1)
        wts = wts[:, :, None].contiguous()
        g3 = g[:, None, :]
        library = lambda: torch.bmm(wts, g3)           # noqa: E731
        # what sets a store-bound kernel's time: a zero_() of its output
        store = torch.empty_like(got)
        item = g.element_size()
        n_bytes = m * d * item + m * k + m * k * d * item
        n_ops = m * k + m * d + m * k * d
    elif name == "cache_probe_tiered":
        k1, r1, k2, r2, ids = inputs
        for a, b in zip(got, want):
            check(torch.equal(a, b), "tiered probe differs from its twin at "
                  "the train inputs")
        err = (got[1] - want[1]).abs().max().item()
        r, d = ids.shape[0], r2.shape[1]
        src = got[0]
        n_hit_rows = sum(int(torch.unique(ids[src == tier]).numel())
                         for tier in (1, 2))
        n_bytes = (r * 4 + (k1.numel() + k2.numel()) * 4
                   + n_hit_rows * d * 4 + r * 4 + r * d * 4)
        n_ops = r * (4 + kw["l1_assoc"] + kw["l2_assoc"])
        store = torch.empty_like(got[1])
        n_uniq = int(torch.unique(ids).numel())
        n_hit = int((src > 0).sum())
        print(f"[timing cache_probe_tiered] R {r} ids, {n_uniq} distinct, "
              f"{int((ids == 0).sum())} of id 0 (dedup's pads and a real id "
              f"0), {n_hit} hit rows ({n_hit_rows} distinct: "
              f"{n_hit_rows * d * r2.element_size()} B read), {r - n_hit} "
              f"miss rows (zeros, no read); output {r * d * r2.element_size()}"
              f" B")
    elif name == "flash_attention":
        q, k, v = inputs
        ok, err, _ = flash_close(torch, q, k, v, got, want, kw["causal"])
        check(ok, f"flash_attention differs from its twin at the prefill "
              f"inputs: max err {err}")
        (b, hq, lq, dh), hkv, lk = q.shape, k.shape[1], k.shape[2]
        # visible (row, column) pairs of this run's mask; 2 Dh FLOP for
        # q.k and 2 Dh for p.v on each, at the peak rate of the inputs' type
        rows = torch.arange(lq, dtype=torch.int64)
        pairs = (int(torch.clamp(rows + (lk - lq) + 1, 0, lk).sum())
                 if kw["causal"] else lq * lk)
        n_ops = 4 * b * hq * dh * pairs
        n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
        flops = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            sdpa(q, k, v, is_causal=True, enable_gqa=True)
            library = lambda: sdpa(q, k, v, is_causal=kw["causal"],  # noqa: E731
                                   enable_gqa=True)
        except TypeError:       # a torch without enable_gqa: expand once
            kr = k.repeat_interleave(hq // hkv, dim=1)
            vr = v.repeat_interleave(hq // hkv, dim=1)
            library = lambda: sdpa(q, kr, vr, is_causal=kw["causal"])  # noqa: E731
    elif op == "ssd_scan":
        x, dt, a, bm, cm = inputs
        if x.dtype == torch.bfloat16:
            ok, err, share, _ = ssd_gate(torch, inputs, kw["chunk"], got,
                                         want)
            flops = BF16_FLOPS
        else:
            ok, err, share = ssd_close(torch, got, want)
        check(ok, f"ssd_scan ({x.dtype}) differs from its twin at the "
              f"prefill inputs: max err {err}")
        (b, l, h, p), n = x.shape, bm.shape[-1]
        q = min(kw["chunk"], l)
        nc, pairs = l // q, q * (q + 1) // 2
        # what the function needs: C B^T over the causal pairs once per
        # (batch, chunk), shared by the heads; per head the decay (exp and
        # two products) and scores x over the pairs; the inter-chunk
        # read-out and the state update, 2 P N each per row, after the
        # first chunk only (the state before it is zero)
        n_ops = (2 * b * nc * pairs * n + b * h * nc * pairs * (2 * p + 3)
                 + 2 * b * h * (l - q) * 2 * n * p)
        n_bytes = (x.element_size() * (2 * x.numel() + bm.numel() + cm.numel())
                   + 4 * (dt.numel() + a.numel()))
    elif name == "gather_reduce":
        table, idx, mask = inputs
        ok, err = gather_close(torch, got, want)
        check(ok, f"gather_reduce differs from its twin at the request "
              f"inputs: max err {err}")
        (n_rows, d), (m, k) = table.shape, idx.shape
        kept = idx.to(torch.int64).clamp(0, n_rows - 1)[mask]
        item = table.element_size()
        n_distinct = int(torch.unique(kept).numel())
        # the rows the kept slots need, once each; ids, mask, output
        n_bytes = n_distinct * d * item + m * k * 4 + m * k + m * d * item
        n_ops = kept.numel() * d + m * d
        # what the kernel reads: every kept slot's row, from L2 (the table
        # stays there); and the same ids over a bfloat16 table, cast once
        print(f"[timing gather_reduce] {kept.numel()} kept slots of {m * k}, "
              f"{n_distinct} distinct rows: {kept.numel() * d * item} B of "
              f"kept-slot rows against {n_distinct * d * item} B of distinct "
              f"rows")
        t16 = table.to(torch.bfloat16)
        ok, err16 = gather_close(torch, ops.gather_reduce(t16, idx, mask),
                                 ref.gather_reduce_ref(t16, idx, mask))
        check(ok, f"gather_reduce (bfloat16) differs from its twin at the "
              f"request inputs: max err {err16}")
        bf16_ms = both_ms(torch, lambda: ops.gather_reduce(t16, idx, mask))
        print(f"[timing gather_reduce bfloat16] the same ids over the table "
              f"cast once: {bf16_ms[0]:.4f} ms (events) {bf16_ms[1]:.4f} ms "
              f"(device), max_abs_err {err16}")
        extra = {"kept_slots": kept.numel(), "distinct_rows": n_distinct,
                 "kept_row_bytes": kept.numel() * d * item,
                 "bf16_ms": bf16_ms[0], "bf16_device_ms": bf16_ms[1]}
        # the one-call yardstick: embedding_bag's weighted sum, then the
        # division (clamped ids, float mask and counts precomputed)
        bag_idx = idx.to(torch.int64).clamp(0, n_rows - 1)
        wts = mask.to(table.dtype)
        den = mask.float().sum(1, keepdim=True).clamp(min=1).to(table.dtype)
        emb = torch.nn.functional.embedding_bag
        library = lambda: emb(                         # noqa: E731
            bag_idx, table, mode="sum", per_sample_weights=wts) / den
    else:
        keys, rows, ids = inputs
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"compact probe differs from its twin at "
                  f"ids {tuple(ids.shape)}, hit_cap {kw['hit_cap']}")
        err = (got[2] - want[2]).abs().max().item()
        h, w, r = ids.shape
        d = rows.shape[2]
        n_words, hc = got[0].shape[-1], got[2].shape[-2]
        kept = sum(bin(v & 0xFFFFFFFF).count("1")
                   for v in got[0].reshape(-1).tolist())
        n_bytes = (ids.numel() * 4 + keys.numel() * 4 + kept * d * 4
                   + 2 * h * w * n_words * 4 + h * w * hc * d * 4)
        n_ops = ids.numel() * (2 + kw["assoc"])
    ms, dev_ms = both_ms(torch, kern)
    plain_ms, plain_dev_ms = both_ms(torch, plain, reps=20)
    library_ms, library_dev_ms = (None, None) if library is None else \
        both_ms(torch, library)
    b_ms, b_by = bound(n_bytes, n_ops, flops)
    if name == "flash_attention":
        print(f"[timing flash_attention] strides "
              f"{[t.stride() for t in inputs]}: {n_ops / ms / 1e9:.1f} "
              f"TFLOP/s of needed work, {ms / b_ms:.2f}x the bound, "
              f"{ms / library_ms:.2f}x SDPA's time")
    if op == "ssd_scan":
        print(f"[timing {name}] {inputs[0].dtype}, strides "
              f"{[t.stride() for t in inputs]}: {n_bytes / ms / 1e6:.1f} "
              f"GB/s and {n_ops / ms / 1e9:.1f} TFLOP/s of needed work, "
              f"{ms / b_ms:.2f}x the bound; error {share:.3e} of "
              f"{'its gate' if x.dtype == torch.bfloat16 else 'the largest |y|'}")
    print(f"[timing {name}] shapes {[list(t.shape) for t in inputs]} kernel "
          f"{ms:.4f} ms (events) {dev_ms:.4f} ms (device)  plain "
          f"{plain_ms:.4f} / {plain_dev_ms:.4f} ms  bound {b_ms:.4f} ms "
          f"({b_by}: {n_bytes} B, {n_ops} ops; {100 * b_ms / ms:.0f}% by "
          f"events, {100 * b_ms / dev_ms:.0f}% by device)  library "
          f"{'null' if library_ms is None else f'{library_ms:.4f} / {library_dev_ms:.4f} ms'}"
          f"  max_abs_err {err}")
    src, replaces = KERNEL_META[name]
    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "device_ms": dev_ms, "plain_ms": plain_ms,
             "plain_device_ms": plain_dev_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": library_ms,
             "library_device_ms": library_dev_ms, **extra}
    if store is not None:
        entry["zero_ms"], entry["zero_device_ms"] = both_ms(torch, store.zero_)
        print(f"[timing {name}] a zero_() of the output's "
              f"{store.numel() * store.element_size()} B: "
              f"{entry['zero_ms']:.4f} ms (events) "
              f"{entry['zero_device_ms']:.4f} ms (device)")
    return entry


def main():
    """Run every phase; print the result lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (a first bring-up)")
    ap.add_argument("--dist-only", action="store_true",
                    help="stop after the kernel checks and the process "
                         "backend's phases (a first bring-up)")
    ap.add_argument("--first-step", action="store_true",
                    help="print the split of a fresh process's first train "
                         "step (run by the autotune phase)")
    opts = ap.parse_args()
    if opts.first_step:
        first_step_split()
        return

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # import the port only now: a directory holding chip_smoke.py and
    # nothing else of the repository fails here
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    phase_build_report(lib_path)

    phase_kernels(torch, dev)
    if opts.dist_only:
        phase_dist(torch)
        phase_dist_paths(torch)
        phase_nccl(torch)
        print("[dist-only] stopping after the process backend's phases")
        return
    if opts.kernels_only:
        phase_flash(torch, dev)
        phase_ssd_kernels(torch, dev)
        print("[kernels-only] stopping after the kernel checks")
        return
    serve_res = phase_serve(torch)
    train_res = phase_train(torch)
    phase_train_kernels(torch, train_res)
    host_res = phase_host(torch)
    phase_host_kernels(torch, host_res)
    merge_res = phase_merge(torch)
    offline_res = phase_offline(torch, host_res)
    ckpt_res = phase_ckpt(torch)
    autotune_res = phase_autotune(torch)
    agree_at = phase_autotune_agree(torch)
    baselines = phase_baselines(torch)
    recovery = phase_recovery(torch)
    dist_res = phase_dist(torch)
    paths_res = phase_dist_paths(torch)
    nccl_res = phase_nccl(torch)
    phase_flash(torch, dev)
    phase_ssd_kernels(torch, dev)
    prefill = phase_lm_prefill(torch)
    lm_serve = phase_lm_serve(torch)
    ssm_prefill = phase_ssm_prefill(torch)
    ssm_serve = phase_ssm_serve(torch)
    gather = phase_gather_reduce(torch, serve_res)
    runs = (list(serve_res.values()) + list(train_res.values())
            + list(host_res.values()) + [merge_res]
            + list(offline_res.values()) + [ckpt_res]
            + [r for k, r in autotune_res.items() if k != "first_step"]
            + [agree_at, recovery, dist_res, paths_res, nccl_res]
            + [prefill, lm_serve, ssm_prefill, ssm_serve, gather])
    launches = {name: sum(r["launches"].get(name, 0) for r in runs)
                for name in KERNEL_META}
    # the float32 route of ssd_scan: its launches on the main path (0 in a
    # bf16 forward, which run_prefill requires)
    launches["ssd_scan_f32"] = sum(r.get("ssd_routes", {}).get("float32", 0)
                                   for r in runs)
    phase_agree(torch, dev)
    phase_agree_train(torch, dev)
    kernels, floor = phase_timing(torch, serve_res, train_res, launches,
                           prefill["qkv"], ssm_prefill["ssd_inputs"],
                           gather["inputs"])
    print(json.dumps({"serve": {f"{arch} W={w}": {k: r[k] for k in (
        "p50_ms", "p99_ms", "qps", "n_requests", "wall_s", "launches")}
        for (arch, w), r in serve_res.items()}}))
    print(json.dumps({"train": {arch: {
        "workers": TRAIN_RUNS[arch][0], "nodes_per_iter": r["nodes_per_iter"],
        "window_nodes_per_s": r["window_nodes_per_s"],
        "startup_s": r["startup_s"], "profiler_s": r["profiler_s"],
        "warm_nodes_per_s": r["warm_nodes_per_s"],
        "median_step_ms": r["median_step_ms"],
        "step_times_ms": r["step_times_ms"], "traced_step_ms": r["traced_ms"],
        "busy_ms": r["busy_ms"], "wall_s": r["wall_s"],
        "losses": r["losses"], "capacity_slack": r["capacity_slack"],
        "hit_cap": r["cache_cfg"].hit_cap, "wire": r["cache_cfg"].wire,
        "cache_hit_rate": r.get("cache_hit_rate"),
        "launches": r["launches"]} for arch, r in train_res.items()}}))
    print(json.dumps({"host_store": {
        f"{arch} W={w} {store}" + (f" depth {d}" if store == "host" else ""):
        {k: r.get(k) for k in (
            "median_step_ms", "warm_nodes_per_s", "busy_ms", "idle_share",
            "wall_s", "n_dropped", "n_l3_hits", "host_gather_bytes",
            "table_bytes", "copy_overlap", "launches")}
        for (arch, w, store, d), r in host_res.items()},
        "merge": merge_res, "offline": {
            f"{arch} W={w} {store}": {k: r[k] for k in (
                "t_gen", "t_train", "launches")}
            for (arch, w, store), r in offline_res.items()}}))
    print(json.dumps({"autotune": {
        label: {**r["autotune_summary"], **{k: r[k] for k in (
                    "warm_nodes_per_s", "median_step_ms", "idle_share",
                    "wall_s", "startup_s", "profiler_s", "capacity_slack",
                    "n_dropped")},
                "fanouts": list(r["fanouts"]), "launches": r["launches"]}
        for label, r in autotune_res.items() if label != "first_step"},
        "first_step": autotune_res["first_step"],
        "baselines": baselines, "recovery": recovery}))
    print(json.dumps({"dist": {f"W={w}": r
                               for w, r in dist_res["widths"].items()},
                      "dist_seconds": dist_res["seconds"],
                      "dist_paths": {f"W={w}": r for w, r in
                                     paths_res["widths"].items()},
                      "dist_paths_seconds": paths_res["seconds"],
                      "nccl": nccl_res}))
    print(json.dumps({"lm": {"arch": LM_ARCH, "prefill": {
        "batch": PREFILL_B, "seq": PREFILL_S, **{k: prefill[k] for k in (
            "init_s", "first_forward_s", "warm_forward_ms", "forward_ms",
            "prefill_tok_s", "max_memory_gb", "busy_ms", "kernel_ms",
            "copy_launches", "layer0_err", "layer0_rel",
            "cut_max_abs_err", "cut_argmax_agree", "launches",
            "flash_routes")}}, "serve": {
        "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
        **{k: lm_serve[k] for k in ("tok_s", "wall_s", "median_step_ms",
                                     "instrumented_wall_s", "busy_ms",
                                     "total_s", "bf16_vs_f32_agree",
                                     "f32_decode_max_abs_err",
                                     "f32_decode_cache_max_abs_err",
                                     "f32_decode_floor",
                                     "launches")}}}}))
    print(json.dumps({"ssm": {"arch": SSM_ARCH, "prefill": {
        "batch": PREFILL_B, "seq": PREFILL_S, **{k: ssm_prefill[k] for k in (
            "init_s", "first_forward_s", "warm_forward_ms", "forward_ms",
            "prefill_tok_s", "max_memory_gb", "busy_ms", "kernel_ms",
            "layer0_err", "layer0_gate_share", "layer0_carry_share",
            "carry_err", "carry_gate_share", "carry_share",
            "carry_over_gate", "ssd_dispatch_ops", "cut", "launches",
            "ssd_routes")}}, "serve": {
        "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
        **{k: ssm_serve[k] for k in ("tok_s", "wall_s", "median_step_ms",
                                     "instrumented_wall_s", "busy_ms",
                                     "total_s", "agree", "launches")}},
        "gather_reduce": {"requests": GATHER_REQUESTS,
                          "launches": gather["launches"]}}}))
    print(json.dumps({"timing_floor": {"null_launch": "a 4-byte zero_()",
                                       **floor}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
