#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Phases, each of which fails the run (nonzero exit, no result line):

1. device   — a CUDA card must be present; print ``nvidia-smi``'s name and
              power limit.
2. build    — compile the CUDA kernels (``nvcc``, sm_90a, one process per
              source, all started together) from the sources in this
              checkout; print each tensor-core kernel's ptxas report
              (registers, spills) per instantiation (flash: Dh 64, 128
              and 160;
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
              fanout_mean_bwd L(L-1)/2 and one probe launch.
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
              over gloo on the card, at W = 4, one spawn of the ranks
              shared by its cells, each cell beside the stacked
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
                        Dh 128 and 160 (stablelm-12b's heads) and tiles
                        cut by Lq or Lk: bf16 (the tensor-core route)
                        within 2^-8 * ref(q, k, |v|) + 2^-7 * |twin| +
                        1e-5 (p rounded to bf16 before P V, as the
                        reference's plain path does, plus one output
                        rounding); f32 (the SIMT route) with Lq < Lk, Dh
                        64, 128 and 160, within rtol/atol 1e-5; each
                        prints its max and relative Frobenius error and
                        its distance to SDPA; then the Dh 160 instance
                        timed on both routes (bf16 at stablelm's layer-0
                        shape 8 x 32/8 x 2048 as [B, L, H, Dh] views, f32
                        at 2 x 32/8 x 1024) by events and device duration
                        beside its bound, its twin and SDPA (the
                        ``flash_dh160`` JSON line);
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
              serve     ``serve_lm``, batch 8, prompt 32, gen 64: tokens in
                        [0, V_pad), decode tok/s over the timed loop of a
                        run with nothing else in it; a second run of 32
                        generated tokens (LM_PROFILE_GEN: its tokens the
                        first run's) with CUDA events between steps and a
                        profiler over 4 steps gives the median untraced
                        step and the busy share.
                        Then float32 compute on the card against the CPU
                        port in float32 on the same weights, over 32
                        prompt-fill steps and 8 generated steps: tokens
                        equal, every step's logits within LM_DECODE_ATOL
                        (1e-2) and the final bf16 KV cache within
                        LM_CACHE_ATOL (6.25e-2), beside the floor of the
                        CPU against itself with every weight one float32
                        ulp up (bf16 greedy tokens flip on near-ties, so
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
              serve     ``serve_lm``, batch 8, prompt 32, gen 64 (no
                        kernel: the O(1) recurrence is plain torch), tok/s
                        of an uninstrumented loop, then the median step and
                        busy share of an instrumented one; on a 2-layer cut
                        in float32 at both inits, card vs CPU over a 120-
                        token prompt and 8 generated tokens (128 steps):
                        tokens equal but at greedy near-ties (top-two gap
                        within 2e-2; at least half the rows equal
                        throughout), logits within 2e-2 up to each row's
                        first difference, the final state of the equal rows
                        within 1e-2 of its largest entry and their bf16 conv
                        history within 6.25e-2; and the card's prefill of
                        the same tokens against its decode at every
                        position (within 1e-1: decode keeps the conv
                        history in bf16).
   lm zoo   — the rest of the LM zoo at published widths, random float32
              weights from a seed (drawn on the card): zamba2-1.2b at full
              depth (38 Mamba layers, the shared attention at 6 sites,
              32/32 heads of 64, SSM state 64), qwen3-moe-30b-a3b at 8 of
              48 layers (128 experts top 8, 32/4 heads of 128, vocab
              151 936), deepseek-v2-236b at 4 of 60 (the dense layer and 3
              MoE layers: 160 experts top 6, 2 shared, MLA with kv_lora 512
              and 128 heads), whisper-small whole (12 encoder layers over
              1 500 stub frames of 768, 12 decoder layers, 12/12 heads of
              64), llama-3.2-vision-11b whole (40 layers, 8 gated cross
              sites over 1 600 stub vision tokens of 1 280, 32/8 heads of
              128), stablelm-12b whole (40 layers, 32/8 heads of 160) and
              llama3-405b at 3 of 126 (128/8 heads of 128, d_model
              16 384); the cuts are what one 80 GB card holds.  Each:
              ``forward_logits`` on 8 x 2048 tokens (DeepSeek 1 x 2048),
              with the stub inputs, with zeroed counters (per forward:
              zamba2 38 ``ssd_scan`` and 6 flash, DeepSeek none, the others
              one flash per self-attention layer: whisper's 12 decoder
              layers at Dh 64, the VLM's 40 and llama3's 3 at 128,
              stablelm's 40 at 160; the encoder and the cross sites take
              the plain path; all on the tensor-core route), tokens/s,
              busy share and peak memory; flash at the path's layer-0
              q/k/v (zamba2's first site) within ``flash_close``'s gate and
              ``ssd_scan`` at zamba2's layer 0 within its bf16 gate, each
              timed by events and device duration beside its bound (flash
              also beside SDPA on the same views); for whisper, the VLM,
              stablelm and llama3 a float32 prefill card vs CPU on a cut of
              the same
              weights, 1 x 256 tokens with the stub inputs (the VLM's
              gates opened from the seed) within 1e-3, beside a one-ulp
              floor (not llama3's 30 GB cut); float32 decode card vs CPU
              on the cut (zamba2 one site and a tail layer, qwen3 2
              layers, DeepSeek the dense and one MoE layer, whisper 2 + 2
              layers, the VLM one layer and one cross site, stablelm and
              llama3 one layer: tokens equal but at near-ties, logits up
              to each row's first difference, every cache leaf of the rows
              that never differ, the VLM's vis_k/vis_v and whisper's enc
              among them, beside a one-ulp floor but for DeepSeek and
              llama3); ``serve_lm`` batch 8, prompt 32, gen 32 (tok/s and
              peak; for qwen3 and DeepSeek an instrumented run of 32
              tokens gives the median step, busy share and the decode
              dispatch's tally; the VLM and
              whisper decode against zero cross caches, as the
              reference's serve_lm); 3 warm prefill forwards and 5 timed
              twin calls a reading (not 5 and 20); and the MoE
              dispatch's drop rate and the assignments the slot ``cap -
              1`` collision zeroes, at prefill and at decode.
   lm train — ``train_lm`` (PR 25) at published widths through its
              function, bf16 compute, the card by default: smollm-135m
              whole (30 layers) 8 x 512 tokens, 8 steps, --microbatches
              2; mamba2-1.3b whole (48 layers) and zamba2-1.2b whole (38)
              4 x 512, 6 steps; qwen3-moe-30b-a3b at 2 of 48 layers 4 x
              512, 4 steps (1.83 G float32 parameters: weights, gradients,
              the clipped gradients, AdamW's moments and the new ones
              ~58 GB at the update's peak); whisper-small whole 4 x 512
              with 1 500 frames, 6 steps; llama-3.2-vision-11b at 5 of 40
              layers (one cross site) and stablelm-12b at 2 of 40, 4 x
              512, 4 steps (llama3-405b does not train on one card: one
              layer with its embedding and head is 7.4 G parameters, ~118
              GB with its AdamW state).  Gates: finite losses (nan_guard
              never fires: its predicate holds every step); ``ssd_scan``
              launched once per Mamba layer per microbatch forward (mamba2
              48, zamba2 38), all on the tensor-core route, its plain twin
              called zero times; float32 card vs CPU (``COMPUTE_DTYPE``
              float32) for each arch at 2 layers (zamba2 7: one site of
              its shared block and a tail layer; whisper 2 + 2; the VLM
              one layer and one cross site, gates opened; stablelm 1),
              full width, 1 x 256
              tokens, one ``make_train_step`` from the same state: the
              loss (rtol 1e-5), every reference leaf's gradient (within
              1e-3 of its largest |g|) and, for smollm, mamba2, zamba2
              and whisper (``LM_TRAIN_UPDATE``: the update is the same
              elementwise arithmetic for every family), the params after
              the step (within 2 lr(1) + 2^-22, the most one AdamW step
              can move a weight, and at most 1% of them apart by over
              lr(1) / 100),
              (no floor: a second CPU pass, informational, does not fit
              the script's 1200 s limit);
              --microbatches 2
              against 1 on smollm's first batch (bf16: loss rtol 1e-5,
              every reference leaf's gradient within 2e-2 of its largest
              |g|); 3 steps of smollm with ``compress_grads``: each
              reference leaf's residual equal to ``g - dequantize(q,
              scale)`` bit for bit; and ``ssd_scan`` against its twin at
              mamba2's and zamba2's training shapes (B 4, L 512) under
              the bf16 gate.  Prints per arch the median step,
              tokens/s, peak memory, busy share (a device-only trace),
              launches per step, ``ssd_scan`` device ms per step, a FLOP
              lower bound, and ``adam_update`` and one layer's
              ``SSDScan`` forward and backward timed at the cell's
              shapes, each beside the card's name and power limit.
   lm mesh  — the LM's model axis: qwen3-moe-30b-a3b at its
              published widths, 8 of 48 layers, over two gloo processes
              on the card (``launch.mesh``'s runner, ``--moe ep_a2a
              --shard-heads``: each rank 64 experts and 16/2 heads).
              Each rank: the bf16 prefill forward at 2 x 2048 (a warm
              forward, then one timed with zeroed launch and collective
              counters: flash launched once a layer on the tensor-core
              route at the per-rank (2, 16/2, 2048, 128), EP's 4
              all_to_alls and one all_reduce a layer; per-rank ms,
              bytes, calls, transport and staging seconds by collective,
              peak memory), then ``serve_lm --shard-heads`` over the
              group in bf16 (batch 8, prompt 32, gen 32: tok/s; decode
              takes the MoE's gather path).  Then in this
              process: the same forward in one process (ms, peak, busy
              share); flash at rank 0's layer-0 operands against its
              twin, timed beside its 0.0348 ms bound and SDPA; on a
              2-layer float32 cut, the ranks' logits on the gather path
              (experts split) with and without ``--seq-parallel`` within
              1e-3 of one process's, EP's without it within 1e-3 of the
              same ranks' whole EP forward repeated on the CPU (the
              rank's weights moved there, the gloo group's CPU view), EP's
              with it within 1e-3 of EP's without, layer 0's EP dispatch
              integers equal to the CPU's
              (the same inputs; the card's top-k may differ only at a
              near tie) and its output within 1e-4 of the CPU run's
              largest |y|; the float32 ``serve_lm --dist`` decode's
              tokens on both ranks equal to one process's, beside the
              one-ulp floor.  ``--mesh-only`` runs the build and this
              phase alone.
   lm train mesh — ``train_lm --dist gloo`` over a (data, model) mesh of
              gloo processes on the card (``TRAIN_MESH``): zamba2-1.2b
              whole on (1, 2) with heads split, sequence parallelism and
              remat dots, and qwen3-moe-30b-a3b at 2 of 48 layers on
              (2, 2) with EP, heads split, sequence parallelism, remat
              full and FSDP; bf16, 4 x 512, 2 steps.  Gates: every rank
              exits 0 with finite losses and grad norms; zamba2's ranks
              launch ``ssd_scan`` once a Mamba layer in the forward and
              again in remat's recompute, every step, and no twin; on a
              float32 cut (2 x 256 tokens) the gather path over the mesh
              (FSDP's gather and reduce, the sharded norm and AdamW)
              against one process's step on the card (loss rtol 1e-5,
              gradients 1e-3 of each leaf's largest |g|, params the lm
              train phase's AdamW bound), remat none and dots within 1e-6 of full,
              EP's step against the same ranks' EP on the CPU.  Prints
              per rank the step ms and their parts, collectives by axis
              and kind, peaks (and one forward and backward's under each
              remat setting), beside the card's name and power limit.
              ``--train-mesh-only`` runs the build and this phase alone.
   gather   —``gather_reduce`` (no model path) over 8 bucket-32 requests
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
import contextlib
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
PREFILL_B, PREFILL_S, PREFILL_WARM = 8, 2048, 2
# the serve cells' prompt and generated tokens, short because the prompt
# fills through the decode path, one host-paced step a token, in the
# timed and the instrumented run, and the whole script must end within
# its 1200 s limit on a slow host; the float32 card-vs-CPU decode runs
# LM_PROMPT + LM_AGREE_GEN steps
LM_BATCH, LM_PROMPT, LM_GEN, LM_AGREE_GEN = 8, 32, 16, 8
# float32 decode, card vs CPU over the 40 steps: the random init's
# residual stream is small, so a k/v entry that rounds to the neighbouring
# bf16 value in the cache moves the normalised state by a few tenths of a
# percent; the phase prints this floor (the CPU against itself with every
# weight one float32 ulp up).  A misplaced rope position, an off-by-one
# valid length or a dropped mask moves the logits by tenths and the cache
# by units, far past both bounds.
LM_DECODE_ATOL = 1e-2          # logits, every step
LM_CACHE_ATOL = 6.25e-2        # final bf16 k/v cache (entries up to ~2.4)
SSM_ARCH, SSM_SEED = "mamba2-1.3b", 0
SSM_CUT, SSM_CUT_S = 2, 256
# the float32 card-vs-CPU decode: 128 steps, one chunk for the card's
# prefill of the same tokens (ssm prefill's cut holds the carry across
# chunks, card vs CPU at 2 x 256); no floor (a third decode on the host,
# informational; PERF.md keeps its earlier readings): the CPU's steps
# cost ~0.1 s each, and the whole script must end within its 1200 s
# limit on a slow host
SSM_AGREE_PROMPT, SSM_AGREE_GEN = 120, 8
GATHER_REQUESTS = 8
# the SSM's card-vs-CPU bounds (2-layer cut, logits up to ~2.5): float32
# prefill differs only in the order of float32 sums; bfloat16 rounds at
# other places in cuBLAS and on the CPU, ~10 intermediates per block.
# Float32 decode over 256 steps carries a bf16 conv history, so a value
# that rounds to the neighbouring bf16 number moves the next steps; the
# phase prints the floor (the CPU against itself with every weight one
# float32 ulp up).  The card's prefill against its own decode: the
# decode keeps the conv history in bf16, the prefill in float32.  A
# dropped carry, a misplaced conv tap or a wrong decay moves the logits
# by tenths to units.
SSM_CUT_ATOL_F32 = 1e-3
SSM_CUT_ATOL_BF16 = 5e-2
SSM_DECODE_ATOL = 2e-2         # logits, every step
SSM_STATE_RTOL = 1e-2          # final float32 state, of its largest entry
SSM_CONV_ATOL = 6.25e-2        # final bf16 conv history (entries up to ~4)
SSM_PREFILL_DECODE_ATOL = 1e-1
# the LM zoo's cells: depth on the card (None: all; DeepSeek and llama3
# cut where one 80 GB card forces it: float32 weights of 15.9 and 12.75
# GB a layer; qwen3, 2.49 GB a layer, whose prefill peaked at 79.8 GB with
# 20 layers, ~10 GB of it float32 logits; llama3's 3 layers with its 16.8
# GB embedding and head were 55 GB, 4 would be 68 GB of weights and ~85
# GB at the read-out's peak of 8 x 2048 float32 and bf16 logits).  The
# script's 1200 s limit on a slow host sets the rest: qwen3 4
# layers, DeepSeek 2 (its dense layer and one MoE layer), the VLM and
# stablelm 10 of 40, llama3 1 (the decode is host-paced by the layer and
# the prefill's init and trace by the weights)), prefill B x S
# (DeepSeek's plain attention holds [B, 128, S, S] float32 scores), the
# float32 card-vs-CPU cut as config overrides (zamba2: one site and a
# tail layer; DeepSeek: the dense layer and one MoE layer; whisper: 2
# encoder and 2 decoder layers; the VLM: one self layer followed by one
# cross site; stablelm and llama3: one layer and the untied read-out) and
# its prompt and generated steps (the CPU reads the cut's weights every
# step: 21 GB for DeepSeek's, 30 GB for llama3's)
ZOO_SEED = 0
ZOO_DEPTH = {"zamba2-1.2b": None, "qwen3-moe-30b-a3b": 4,
             "deepseek-v2-236b": 2, "whisper-small": None,
             "llama-3.2-vision-11b": 10, "stablelm-12b": 10,
             "llama3-405b": 1}
ZOO_PREFILL = {"zamba2-1.2b": (8, 2048), "qwen3-moe-30b-a3b": (8, 2048),
               "deepseek-v2-236b": (1, 2048), "whisper-small": (8, 2048),
               "llama-3.2-vision-11b": (8, 2048), "stablelm-12b": (8, 2048),
               "llama3-405b": (8, 2048)}
ZOO_CUT = {"zamba2-1.2b": {"n_layers": 7},
           "qwen3-moe-30b-a3b": {"n_layers": 2},
           "deepseek-v2-236b": {"n_layers": 2},
           "whisper-small": {"n_layers": 2, "n_encoder_layers": 2},
           "llama-3.2-vision-11b": {"n_layers": 1, "cross_attn_every": 1},
           "stablelm-12b": {"n_layers": 1}, "llama3-405b": {"n_layers": 1}}
# steps, and whether the floor runs (a third decode on the host, at ~0.5
# s a step, informational: none runs, for the script's 1200 s limit;
# the floors' earlier readings are in PERF.md)
ZOO_AGREE = {"zamba2-1.2b": (16, 8, False),
             "qwen3-moe-30b-a3b": (8, 8, False),
             "deepseek-v2-236b": (4, 4, False),
             "whisper-small": (8, 8, False),
             "llama-3.2-vision-11b": (8, 8, False),
             "stablelm-12b": (8, 8, False), "llama3-405b": (4, 4, False)}
# float32 prefill card vs CPU on the same cut (the configs of this slice,
# whose cross-attention the decode path, with zero cross caches, cannot
# reach): B x S tokens with the stub inputs (one row: the CPU's float32
# pass over a cut takes seconds a row), and whether the floor (the CPU
# with every weight one ulp up, in place and back; none runs, as
# ZOO_AGREE's) runs; the VLM's
# gates set from the seed to non-zero values first.  Float32 sums in
# another order give ~1e-6; a wrong mask, rope or projection moves the
# logits by tenths.
ZOO_PREFILL_AGREE = {"whisper-small": (1, 256, False),
                     "llama-3.2-vision-11b": (1, 256, False),
                     "stablelm-12b": (1, 256, False),
                     "llama3-405b": (1, 256, False)}
ZOO_PREFILL_ATOL = 1e-3
# the instrumented serve_lm run of each serve cell (median step, busy
# share) generates this many tokens, not LM_GEN: its tokens must equal the
# first LM_PROFILE_GEN of the timed run's
LM_PROFILE_GEN = 16
# the zoo's serve cells: batch 8, prompt ZOO_SERVE_PROMPT, gen ZOO_SERVE_GEN
# (the smollm and mamba2 serve cells: prompt 32, gen 16): the
# prompt fills through the decode path one token a step, and the 40-layer
# configs take 77-95 ms a step, host-paced
ZOO_SERVE_PROMPT, ZOO_SERVE_GEN = 16, 16
# timing-only work the zoo's cells cut to fit the script's budget: warm
# prefill forwards and the plain twin's timed calls; and only the MoE
# cells, whose decode dispatch it tallies, run the instrumented serve run
ZOO_WARM, ZOO_PLAIN_REPS = 1, 2
# LM training (train_lm) at published widths: arch -> (layers on the
# card, None for all; batch; seq; steps; microbatches).  qwen3 is cut to 2
# of 48 layers: 1.83 G float32 parameters (2 x 0.60 G of experts, 0.62 G
# of embedding and head) are ~58 GB with the gradients, the clipped
# gradients, AdamW's moments and the new ones at the update's peak.
# deepseek-v2-236b is held on the CPU only: one full-width MoE layer
# (160 experts of 5120 x 1536 x 3) is 3.8 G parameters, ~60 GB with its
# AdamW state and gradients.
# whisper-small trains whole (0.34 G parameters); llama-3.2-vision-11b
# at 5 of 40 layers, one cross site (2.2 G: 10 layers, 3.3 G, would need
# ~105 GB at the update's peak, by qwen3's ~32 B a parameter); stablelm-12b
# at 2 of 40 (1.59 G, its embedding and head 1.03 G of them); llama3-405b
# not at all: one layer with its embedding and head is 7.4 G parameters,
# ~118 GB with the gradients and AdamW's moments (its smoke config trains
# in the CPU tests).
LM_TRAIN = {"smollm-135m": (None, 8, 512, 4, 2),
            "mamba2-1.3b": (None, 4, 512, 4, 1),
            "zamba2-1.2b": (None, 4, 512, 4, 1),
            "qwen3-moe-30b-a3b": (2, 4, 512, 3, 1),
            "whisper-small": (None, 4, 512, 4, 1),
            "llama-3.2-vision-11b": (5, 4, 512, 3, 1),
            "stablelm-12b": (2, 4, 512, 3, 1)}
LM_TRAIN_SEED = 0
# float32 card vs CPU, one train step on a cut at full width over 1 x 256
# tokens (two SSD chunks), 2 layers (zamba2: 7, one site of its shared
# block and a tail layer: its first site follows the 6th Mamba layer,
# as the zoo's decode cut): the loss within rtol 1e-5, every
# reference leaf's gradient within 1e-3 of its largest |g| (f32 sums in
# another order give ~1e-6; a wrong backward moves a leaf by its scale),
# and the params after the step within 2 lr(1) + 2^-22: at step 1 AdamW
# moves a weight by lr (m / sqrt(v) = +-1) plus the decay both sides
# share, so this is the most a sign flip of a near-zero gradient can
# leave, with each side's rounding of a weight of at most 1 (the norms'
# init); and
# only where a gradient lies within the two devices' rounding of zero may
# a weight move by more than lr(1) / 100 (at most LM_TRAIN_FLIP_SHARE of
# them: a wrong bias correction or decay moves every weight).  The cuts
# are config overrides: whisper 2 encoder and 2 decoder layers, the VLM
# one self layer and one cross site (its gates set from the seed to
# non-zero values, so that the cross path gets a gradient), stablelm one
# layer.
LM_TRAIN_CUT = {"smollm-135m": {"n_layers": 2}, "mamba2-1.3b": {"n_layers": 2},
                "zamba2-1.2b": {"n_layers": 7},
                "qwen3-moe-30b-a3b": {"n_layers": 2},
                "whisper-small": {"n_layers": 2, "n_encoder_layers": 2},
                "llama-3.2-vision-11b": {"n_layers": 1,
                                         "cross_attn_every": 1},
                "stablelm-12b": {"n_layers": 1}}
LM_TRAIN_CUT_S = 256
# the archs whose training check also runs the floor (a second CPU pass
# on a nudged copy of the cut, informational): none, for the script's
# 1200 s limit (its earlier readings for smollm, mamba2, zamba2 and
# whisper are in PERF.md)
LM_TRAIN_FLOOR = ()
# the archs whose training check also runs AdamW's update on the CPU and
# holds the card's new params to it.  ``apply_grads`` is the same
# elementwise arithmetic over every family's leaves, so these four cover
# it; the update of qwen3's, the VLM's and stablelm's 1.3-1.9 G-parameter
# cuts takes 15-29 s of host time each, more than the whole script's
# 1200 s limit on a slow host leaves room for: those three hold the loss
# and every leaf's gradient
LM_TRAIN_UPDATE = ("smollm-135m", "mamba2-1.3b", "zamba2-1.2b",
                   "whisper-small")
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_RTOL = 1e-5, 1e-3
LM_TRAIN_FLIP_SHARE = 1e-2
# bf16, 2 microbatches against 1 on one batch: the forward is row for row
# the same, so the loss within rtol 1e-5 (sums of 2 and 1 terms); the
# weight gradients reduce over 2048 tokens instead of 4096 and each
# half's is rounded to bf16 before the float32 mean, so every reference
# leaf within 2e-2 of its largest |g| (~5 bf16 ulps; a dropped microbatch
# or a wrong 1 / n moves a leaf by half its scale or more)
LM_TRAIN_MICRO_RTOL, LM_TRAIN_MICRO_GRAD_RTOL = 1e-5, 2e-2
LM_TRAIN_COMPRESS_STEPS = 3
DEVICE = "cuda"                # the device every phase drives
MIN_WHOLE_CALLS = 5            # device_ms: fewer whole calls: trace again
MAX_TRACES = 6                 # device_ms: traces pooled before it fails

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
    kept none, some 4-26 of 30 calls; the tiered probe's kept 6-13 of 30
    in PRs 23-25 and, once, none in three traces), so only calls with the
    usual number of rows count, pooled over traces (each the same
    function and inputs) until ``MIN_WHOLE_CALLS`` of them are kept, up
    to ``MAX_TRACES``; fails when those record no device row or no whole
    call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen, per, whole = 0, 0, []
    for _ in range(MAX_TRACES):
        calls = traced_calls(torch, fn, reps)
        seen += len(calls)
        sizes = [len(c) for c in calls if len(c) > 1]
        if not per and sizes:
            per = max(set(sizes), key=sizes.count)
        whole += [sum(c[1:]) for c in calls if len(c) == per]
        if len(whole) >= MIN_WHOLE_CALLS:
            break
    check(seen > 0, f"the profiler recorded no device row in {MAX_TRACES} "
          f"traces: device durations cannot be measured on this machine")
    check(len(whole) > 0, f"the profiler kept no whole call of {reps} in "
          f"{MAX_TRACES} traces")
    if len(whole) < seen:
        print(f"[timing] the traces kept {len(whole)} of {seen} calls whole "
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
            r"kernelILi(\d+)E", {("64",), ("128",), ("160",)},
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
    initializes the device tracer, seconds once per process).
    ``device_only`` records the device's activity alone (no host op
    rows: a train step of ~20 000 launches otherwise costs the trace
    seconds to process)."""

    def __init__(self, torch, first, n, device_only=False):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.first, self.n = first, n
        self.times = []
        self.prof_s = 0.0
        acts = [ProfilerActivity.CUDA]
        if not device_only:
            acts.insert(0, ProfilerActivity.CPU)
        self.prof = profile(
            activities=acts,
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
    results = {}
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
# timed calls after the checked call (the warm one; node-centric's also
# counts its launches): node-centric's take 6.4-9.1 s each, host-paced
BASE_CALLS, NODE_CALLS = 5, 1


def timed_calls(torch, fn, n):
    """``n`` calls of ``fn`` (the caller's checked call was the warm one),
    each read by the host clock (to a synchronize) and by CUDA events:
    ``(host ms list, event ms list)``."""
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
    """``(n, fn())``: the non-view aten ops with a CUDA output that
    ``fn()`` dispatches, its kernel launches (every op the baselines run
    launches one kernel), and what it returned."""
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
        out = fn()
    torch.cuda.synchronize()
    return c.n, out


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
        if name == "node":
            n_launches, out = launched_ops(torch, lambda: expand(name))
        else:
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
            entry["launches"] = n_launches
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
#: its widths: W = 4, whose spawn runs every cell (a W = 2 spawn would
#: repeat the serve, deep and host cells for ~50 s that the script's
#: 1200 s limit does not leave; two ranks run in the dist and lm mesh
#: phases)
DIST_PATH_WORKERS = (4,)
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
    collectives staged through host memory) at W = 4, each cell
    beside the stacked run of the same flags in this process: serve
    (graphgen-gcn, 64 Zipf requests), the tiered cache (graphgen-gcn-deep,
    20 steps), the L3 host store (graphgen-gcn at depth 2), the deep
    run's ``--export-serve`` file, a server warm-started from
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
                  for w in DIST_PATH_WORKERS}
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
                (2, 6, 2, 256, 256, 128, False, "bfloat16", "bhld"),
                (1, 4, 2, 320, 448, 160, True, "bfloat16", "blhd"),
                (2, 32, 8, 256, 256, 160, True, "bfloat16", "blhd"),
                (2, 6, 2, 256, 256, 160, False, "bfloat16", "bhld"),
                (1, 4, 2, 128, 384, 160, True, "float32", "bhld"),
                (2, 32, 8, 256, 256, 160, True, "float32", "blhd"))


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
    layouts of ``FLASH_CHECKS`` (head dims 64, 128 and 160); each bf16
    check must go through the tensor-core route and each float32 one
    through the SIMT route; then the Dh 160 instance timed on both routes.
    Returns the Dh 160 timings."""
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
    # the Dh 160 instance (stablelm-12b's heads) on both routes, timed by
    # events and device duration beside its bound, its twin and SDPA:
    # bf16 at stablelm's layer-0 shape as the model's [B, L, H, Dh] views,
    # float32 at (2, 32/8, 1024)
    out = {}
    for dtype, (b, hq, hkv, l) in (("bfloat16", (8, 32, 8, 2048)),
                                   ("float32", (2, 32, 8, 1024))):
        dt = getattr(torch, dtype)
        q, k, v = (flash_operand(torch, (b, h, l, 160), "blhd", dt, gen, dev)
                   for h in (hq, hkv, hkv))
        ops.reset_launch_counts()
        entry = time_kernel(torch, "flash_attention", (q, k, v),
                            {"causal": True})
        route = "tensor_core" if dt == torch.bfloat16 else "float32"
        routes = ops.flash_route_counts()
        check(routes[route] > 0 and sum(routes.values()) == routes[route],
              f"flash_attention Dh 160 {dtype} took routes {routes}")
        out[dtype] = {"shape": [b, hq, hkv, l, 160], "route": route,
                      **{key: entry[key] for key in (
                          "max_abs_err", "ms", "device_ms", "plain_ms",
                          "plain_device_ms", "bound_ms", "bound_by",
                          "library_ms", "library_device_ms")}}
        print(f"[flash] Dh 160 {dtype} ({route} route) at "
              f"{(b, hq, hkv, l, 160)} causal: {entry['ms']:.4f} ms "
              f"(events) {entry['device_ms']:.4f} ms (device), bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), SDPA "
              f"{entry['library_ms']:.4f} ms, twin {entry['plain_ms']:.4f} "
              f"ms; max abs err {entry['max_abs_err']}")
        del q, k, v
    torch.cuda.empty_cache()
    return out


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


def run_prefill(torch, cfg, seed, kernel, label, expect=None,
                shape=(PREFILL_B, PREFILL_S), warm=PREFILL_WARM):
    """``forward_logits`` of ``cfg`` (random weights from ``seed``) over
    ``shape`` (B x S, ``PREFILL_B x PREFILL_S`` by default) seeded tokens
    (``train.lm_batch``: with the VLM's vision or Whisper's frame
    embeddings),
    ``1 + warm`` times (``PREFILL_WARM`` by default) with zeroed launch
    counters: exactly
    ``expect[name]`` launches of each kernel per forward (by default one
    ``kernel`` launch per layer) and no other kernel, every flash and
    ssd_scan launch on the tensor-core route, finite float32 logits over
    the padded vocab; then one profiled forward.  Returns ``(model, batch,
    tokens, res)``: ``res`` holds the init and first-forward seconds, the
    rate over the whole warm window (all warm forwards' tokens over their
    summed wall; the median is a per-forward statistic only), the
    launches, the peak memory, and the device busy ms and each expected
    kernel's ms of the traced forward (``kernel_ms``: ``kernel``'s)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import padded_vocab
    from torch.profiler import ProfilerActivity, profile
    expect = {kernel: cfg.n_layers} if expect is None else expect
    n_b, n_s = shape
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = zoo.build(cfg, DEVICE).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = train.lm_batch(np.random.default_rng(seed), cfg, n_b, n_s,
                           DEVICE)
    del batch["labels"]
    tokens = batch["tokens"].cpu().numpy()
    ops.reset_launch_counts()
    times = []
    for _ in range(1 + warm):
        logits = None                   # free the last logits first
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = zoo.forward_logits(cfg, model, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    ssd_routes = ops.ssd_route_counts()
    n_fwd = len(times)
    want = {name: expect.get(name, 0) * n_fwd for name in counts}
    check(counts == want, f"{label} launched {counts} over {n_fwd} "
          f"forwards, expected {expect} per forward and no other kernel")
    check(routes == {"tensor_core": want["flash_attention"], "float32": 0}
          and ssd_routes == {"tensor_core": want["ssd_scan"], "float32": 0},
          f"{label}: flash_attention routes {routes}, ssd_scan routes "
          f"{ssd_routes}, expected every launch on the tensor-core route")
    v_pad = padded_vocab(cfg)
    check(tuple(logits.shape) == (n_b, n_s, v_pad)
          and logits.dtype == torch.float32, f"{label} logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), f"{label} logits not finite")
    del logits
    warm_ms = statistics.median(times[1:]) * 1e3
    res = {"init_s": init_s, "first_forward_s": times[0],
           "warm_forward_ms": warm_ms,
           "forward_ms": [t * 1e3 for t in times],
           "prefill_tok_s": n_b * n_s * warm / sum(times[1:]),
           "launches": counts, "flash_routes": routes,
           "ssd_routes": ssd_routes, "max_memory_gb":
           torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[{label}] B={n_b} S={n_s}: first forward "
          f"{times[0]:.3f} s; {warm} warm forwards at "
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
    res["traced_ms"] = traced_ms
    res["kernels_ms"] = {name: kernel_device_ms(torch, prof, name)
                         for name, n in expect.items() if n}
    res["kernel_ms"] = res["kernels_ms"].get(kernel, 0.0)
    res["copy_launches"] = copy_rows(torch, prof, label)
    for name, ms in res["kernels_ms"].items():
        if res["busy_ms"]:
            check(ms > 0, f"{label}: {name} launched but no profiler row "
                  f"holds its name")
            print(f"[{label}] {name}: {ms:.3f} ms of the traced forward's "
                  f"{res['busy_ms']:.3f} ms device time "
                  f"({100 * ms / res['busy_ms']:.1f}%)")
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
    """``serve_lm`` flags: smollm-135m, batch 8, prompt ``LM_PROMPT``."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", LM_ARCH, "--device", device, "--seed", str(LM_SEED),
        "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
        "--gen-len", str(gen)])


def nudge_weights(torch, model):
    """Move every weight of ``model`` one float32 ulp up, in place
    (``nextafter``: the floor of a card-vs-CPU comparison, with no random
    draw over a large cut's weights)."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.nextafter(p, torch.tensor(float("inf"),
                                                    device=p.device)))


def record_decode(torch, args, nudge=False, cfg=None, prep=None,
                  model=None, group=None):
    """``serve_lm(args)`` with every decode step's float32 logits copied
    to the host (prompt fill and generation); returns the tokens, the
    stacked logits ``[steps, B, V_pad]``, the final cache on the host and
    the model served.  ``cfg`` replaces the arch's config (a depth cut),
    ``model`` replaces the seeded init (moved to the served device: a cut
    carried across from another device), ``prep(model)`` edits the model
    in place (the SSM's carry init), and ``nudge`` moves every weight one
    float32 ulp up after that (``nudge_weights``), for the floor of the
    comparison.  ``group`` serves as that rank of a model axis."""
    from repro_torch.launch import serve
    from repro_torch.models import zoo
    real_lm_init = zoo._lm_init
    logits, last, made = [], {}, []

    def lm_init(c):
        def init(cfg, seed=0, device="cuda"):
            m = (model.to(device) if model is not None
                 else real_lm_init(c)(cfg, seed, device))
            if prep is not None:
                prep(m)
            if nudge:
                nudge_weights(torch, m)
            real = m.forward_decode

            def record(cache, tokens, pos):
                out, cache = real(cache, tokens, pos)
                logits.append(out.float().cpu())
                last.update(cache)
                return out, cache
            m.forward_decode = record
            made.append(m)
            return m
        return init
    zoo._lm_init = lm_init
    try:
        with launch_config(cfg):
            toks = serve.serve_lm(args, group=group)["tokens"]
    finally:
        zoo._lm_init = real_lm_init
        for m in made:
            del m.forward_decode
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
    t0 = time.perf_counter()
    res = serve_and_time(torch, lambda gen: lm_serve_args(gen, DEVICE),
                         f"lm serve {LM_ARCH}", v_pad)
    toks = res["tokens"]
    t1 = time.perf_counter()

    # the card's seeded init (drawn on the card) carried to the CPU runs
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        card = record_decode(torch, lm_serve_args(LM_AGREE_GEN, DEVICE))
        cpu = record_decode(torch, lm_serve_args(LM_AGREE_GEN, "cpu"),
                            model=card[3])
        floor = record_decode(torch, lm_serve_args(LM_AGREE_GEN, "cpu"),
                              nudge=True, model=card[3])
    finally:
        layers.COMPUTE_DTYPE = saved
    print(f"[lm serve] serve cell {t1 - t0:.1f} s, float32 card and CPU "
          f"decodes {time.perf_counter() - t1:.1f} s")
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
          f"float32 ulp up: logits {floor_step.max().item():.3e} (median "
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
    """``serve_lm`` flags: mamba2-1.3b, batch 8, the given prompt."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", SSM_ARCH, "--device", device, "--seed", str(SSM_SEED),
        "--batch", str(LM_BATCH), "--prompt-len", str(prompt),
        "--gen-len", str(gen)])


@contextlib.contextmanager
def launch_config(cfg, launcher=None):
    """``launcher`` (a ``repro_torch.launch`` module: ``serve`` by
    default, or ``train``) builds ``cfg`` (a cut or a switched config) in
    place of its arch's registered config inside the block (``cfg``
    None: no change)."""
    if launcher is None:
        from repro_torch.launch import serve as launcher
    real = launcher.get_config
    if cfg is not None:
        launcher.get_config = lambda name: cfg
    try:
        yield
    finally:
        launcher.get_config = real


def serve_and_time(torch, make_args, label, v_pad, cfg=None, wrap=None,
                   gen=LM_GEN, prompt=LM_PROMPT, profile=True):
    """``serve_lm(make_args(gen))`` (``gen`` generated tokens after a
    ``prompt``-token prompt) with zeroed launch counters (decode is plain
    torch: no kernel of the port may launch) and nothing else in the loop,
    for its tok/s, its tokens in ``[0, v_pad)``; then a second,
    instrumented run of ``LM_PROFILE_GEN`` generated tokens (CUDA events
    between steps, a profiler over 4 steps) that must generate the first
    ``LM_PROFILE_GEN`` of the same tokens, for the median untraced step and
    the device's busy share (with ``profile`` off, no second run: tok/s
    and the peak memory only).  ``cfg`` replaces the arch's config
    (``launch_config``); ``wrap()``, a context manager, runs around the
    instrumented run only and what it yields is returned as
    ``instrumented``.  Returns the first run's result with those added and
    the peak memory of both runs."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    with launch_config(cfg):
        return _serve_and_time(torch, serve, ops, make_args, label, v_pad,
                               wrap, gen, prompt, profile)


def _serve_and_time(torch, serve, ops, make_args, label, v_pad, wrap, gen,
                    prompt, profile):
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.serve_lm(make_args(gen))
    res["total_s"] = time.perf_counter() - t0
    res["launches"] = ops.launch_counts()
    check(all(n == 0 for n in res["launches"].values()),
          f"{label}: decode launched a kernel: {res['launches']}")
    toks = res["tokens"]
    check(toks.shape == (LM_BATCH, gen) and toks.min() >= 0
          and toks.max() < v_pad, f"{label}: served tokens {toks.shape} "
          f"outside [0, {v_pad})")
    if not profile:
        res["instrumented"] = None
        res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{label}] batch {LM_BATCH}, prompt {prompt}, gen {gen}: "
              f"{res['tok_s']:,.1f} tok/s over the uninstrumented timed loop "
              f"({res['wall_s']:.3f} s; whole call {res['total_s']:.2f} s), "
              f"launches {res['launches']}; no instrumented run")
        return res
    events = []
    clock = StepClock(torch, first=LM_PROFILE_GEN - 8, n=4)

    def hook(step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        clock(step)
    try:
        with (wrap() if wrap else contextlib.nullcontext()) as extra:
            timed = serve.serve_lm(make_args(LM_PROFILE_GEN), step_hook=hook)
    finally:
        clock.close()
    torch.cuda.synchronize()
    res["instrumented"] = extra
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    check((timed["tokens"] == toks[:, :LM_PROFILE_GEN]).all(),
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
    print(f"[{label}] batch {LM_BATCH}, prompt {prompt}, gen {gen}: "
          f"{res['tok_s']:,.1f} tok/s over the uninstrumented timed loop "
          f"({res['wall_s']:.3f} s; whole call {res['total_s']:.2f} s), "
          f"launches {res['launches']}; instrumented run of "
          f"{LM_PROFILE_GEN} tokens: median untraced step "
          f"{res['median_step_ms']:.3f} ms (events between steps), timed "
          f"loop {timed['wall_s']:.3f} s")
    return res


def phase_ssm_serve(torch):
    """``serve_lm`` of mamba2-1.3b at full width with zeroed launch
    counters (decode is plain torch: no kernel of the port runs) and
    nothing else in the loop, for its tok/s; a second, instrumented run for
    the median step and the busy share; then, on a 2-layer cut in float32
    compute at both inits, the card against the CPU port at every step of
    an ``SSM_AGREE_PROMPT``-token prompt and 8 generated tokens (tokens
    equal but at near-ties, logits up to each row's first differing token,
    the final state of the rows that never differ), beside (at the carry
    init) the floor of the CPU against itself with every weight one
    float32 ulp up, and the card's own prefill of the same 128 tokens (one
    chunk) against its decode at every position."""
    import numpy as np
    from repro_torch.models import layers, zoo
    from repro_torch.models.layers import padded_vocab
    v_pad = padded_vocab(ssm_config())
    t0 = time.perf_counter()
    res = serve_and_time(torch, lambda gen: ssm_serve_args(gen, DEVICE),
                         f"ssm serve {SSM_ARCH}", v_pad)
    print(f"[ssm serve] serve cell {time.perf_counter() - t0:.1f} s")

    cut = ssm_config(SSM_CUT)
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    res["agree"] = {}
    try:
        for init in ("reference", "carry"):
            t1 = time.perf_counter()
            n_prompt = SSM_AGREE_PROMPT
            prompt = np.random.default_rng(SSM_SEED).integers(
                0, cut.vocab_size, (LM_BATCH, n_prompt), dtype=np.int32)
            steps = n_prompt + SSM_AGREE_GEN
            prep = carry_init_fn(torch) if init == "carry" else None
            # the card's seeded init (drawn on the card), copied to the
            # host for the CPU runs
            card = record_decode(torch, ssm_serve_args(
                SSM_AGREE_GEN, DEVICE, n_prompt), cfg=cut, prep=prep)
            host = cut_model(torch, card[3], SSM_CUT, "cpu")
            cpu, *floor = (record_decode(torch, ssm_serve_args(
                SSM_AGREE_GEN, "cpu", n_prompt), cfg=cut, prep=prep,
                nudge=nudge, model=host) for nudge in (False,))
            check(card[1].shape == cpu[1].shape == (steps, LM_BATCH, v_pad),
                  f"ssm decode logits {tuple(card[1].shape)}")
            gap = decode_state_gap(torch, card, cpu, n_prompt)
            floor_gap = (decode_state_gap(torch, floor[0], cpu, n_prompt)
                         if floor else None)
            floor_text = ("no floor" if floor_gap is None else
                          f"Floor, CPU with every weight one float32 ulp "
                          f"up: logits {floor_gap['logits']:.3e}, ssm "
                          f"{floor_gap['ssm']:.3e}, conv "
                          f"{floor_gap['conv']:.3e}, {floor_gap['n_same']} "
                          f"rows the same")
            # the card's own prefill of the same tokens
            model = card[3]
            seq = np.concatenate([prompt, card[0]], axis=1)
            pre = zoo.forward_logits(cut, model, {
                "tokens": torch.from_numpy(seq).to(DEVICE)}).cpu()
            pd = (pre.transpose(0, 1) - card[1]).abs().amax(dim=(1, 2))
            print(f"[ssm serve] float32, 2-layer cut, {init} init, "
                  f"{n_prompt} prompt + {SSM_AGREE_GEN} generated "
                  f"steps, card vs CPU: {gap['n_same']} of {LM_BATCH} rows "
                  f"generate the same tokens (first differing step per row "
                  f"{gap['first']}, top-two logit gaps there "
                  f"{[f'{t:.2e}' for t in gap['ties']]}); logits within "
                  f"{gap['logits']:.3e} up to each row's first difference "
                  f"(scale {cpu[1].abs().max().item():.3f}, worst step "
                  f"{gap['worst_step']}); final state of those rows within "
                  f"{gap['ssm']:.3e} (scale {gap['ssm_scale']:.3f}), conv "
                  f"history within {gap['conv']:.3e}. {floor_text}. Card "
                  f"prefill of the {steps} tokens vs its "
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
                "prompt": n_prompt,
                "floor_logits": floor_gap and floor_gap["logits"],
                "prefill_vs_decode_last": pd[-1].item(),
                "prefill_vs_decode_max": pd.max().item()}
            del card, cpu, floor, model, host
            print(f"[ssm serve] {init} init agreement "
                  f"{time.perf_counter() - t1:.1f} s")
    finally:
        layers.COMPUTE_DTYPE = saved
    return res


def carry_init_fn(torch):
    """``carry_init`` as a ``record_decode`` ``prep``."""
    return lambda model: carry_init(torch, model)


def decode_state_gap(torch, a, b, prompt_len):
    """Gaps of two ``record_decode`` runs, row by row up to the first
    generated token where the two differ (a greedy near-tie may go either
    way; the rows then decode other tokens).  Returns each row's first
    differing generated step (``G`` if none) and the top-two logit gap on
    both sides there (``ties``); the max abs logit gap over the steps
    before it (per step and its worst step); and over the rows that never
    differ, every final cache leaf's max abs gap with its scale over
    every row and its dtype (``cache``; for the SSM also as ``ssm``,
    ``ssm_scale`` and ``conv``)."""
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
    out = {"first": first, "ties": ties, "n_same": len(same),
           "logits": per_step.max().item(),
           "worst_step": int(per_step.argmax()),
           "per_step": per_step,
           "cache": {name: (state_gap(name), w.float().abs().max().item(),
                            w.dtype) for name, w in b[2].items()}}
    if "ssm" in out["cache"]:
        out.update(ssm=out["cache"]["ssm"][0],
                   ssm_scale=out["cache"]["ssm"][1],
                   conv=out["cache"]["conv"][0])
    return out


# ------------------------------------------------------------------ LM zoo

def zoo_config(arch, n_layers=None, **over):
    """``arch`` at its published widths, flash switched on where its
    attention takes the kernel (every head dim but MLA's 192/128 heads,
    which take the plain path), ``n_layers`` cutting the depth and
    ``over`` replacing other fields (a cut's encoder depth or cross-
    attention period)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, use_flash_attention=not cfg.kv_lora_rank,
                              **over)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def open_gates(torch, model, seed):
    """Set every cross site's gate of a VLM ``model`` in place from
    ``seed`` to a non-zero value (|gate| in [0.5, 1.5), either sign): the
    init's gates are 0, where the cross path adds nothing."""
    import numpy as np
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for site in model.cross:
            g = rng.uniform(0.5, 1.5) * rng.choice([-1.0, 1.0])
            site.gate.fill_(float(g))


def zoo_expect(cfg):
    """Kernel launches per forward of ``cfg``: the hybrid one ``ssd_scan``
    per Mamba layer and one flash per site, DeepSeek none, every other
    family one flash per (self-attention) layer: the dense LMs', qwen3's
    and the VLM's layers, Whisper's decoder layers (the encoder's 1 500
    frames and the cross sites take the plain path)."""
    from repro_torch.models import hybrid
    if cfg.family == "hybrid":
        return {"ssd_scan": cfg.n_layers,
                "flash_attention": hybrid.grouped(cfg)[0]}
    return {} if cfg.kv_lora_rank else {"flash_attention": cfg.n_layers}


def zoo_serve_args(arch, gen, device, prompt=LM_PROMPT):
    """``serve_lm`` flags for ``arch``: batch 8, the given prompt and
    generation lengths."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", arch, "--device", device, "--seed", str(ZOO_SEED),
        "--batch", str(LM_BATCH), "--prompt-len", str(prompt),
        "--gen-len", str(gen)])


def zoo_cut(torch, model, cut, device="cpu"):
    """The leaves of ``model`` that a model of config ``cut`` (a depth cut
    of it) holds, copied to ``device`` a tensor at a time, as an LM of
    ``cut`` there (no second copy of the weights: the module takes the
    copied tensors)."""
    shell = type(model)(cut, "meta")
    full = model.state_dict()
    shell.load_state_dict({k: full[k].detach().to(device)
                           for k in shell.state_dict()}, assign=True)
    return shell


def zoo_layer0(torch, cfg, model, batch):
    """The path's own kernel operands from one more forward: flash at the
    first attention call (qwen3's layer 0, zamba2's first site) and, for
    the hybrid, ``ssd_scan`` at layer 0 (``ssd_layer0``: the conv output's
    bf16 views).  The MoE dispatch's counts over that forward come back
    as ``dispatch``."""
    from repro_torch.models import moe, zoo
    out = {}
    with moe.tally() as counts:
        if cfg.use_flash_attention:
            out["flash_attention"] = first_call_operands(
                torch, "flash_attention",
                lambda: zoo.forward_logits(cfg, model, batch))
        else:
            zoo.forward_logits(cfg, model, batch)
    if cfg.family == "hybrid":
        out["ssd_scan"] = ssd_layer0(torch, model, batch)[1]
    return out, counts


def zoo_kernels(torch, arch, cfg, operands):
    """Each kernel at the path's own operands against its twin (flash:
    ``flash_close``'s bf16 gate, through ``time_kernel``; ``ssd_scan``:
    ``check_ssd_bf16``), on the tensor-core route, then timed (events and
    device duration) beside its bound and, for flash, SDPA on the same
    views.  Returns ``{kernel: entry}``."""
    from repro_torch.kernels import ops
    out = {}
    for name, ins in operands.items():
        ops.reset_launch_counts()
        if name == "ssd_scan":
            err, share, carry, _ = check_ssd_bf16(
                torch, ins, cfg.ssm_chunk, f"{arch} layer 0's operands "
                f"{[tuple(t.shape) for t in ins]},", tag="[lm zoo]")
            routes = ops.ssd_route_counts()
            kw = {"chunk": cfg.ssm_chunk}
        else:
            got = ops.flash_attention(*ins)
            routes = ops.flash_route_counts()
            err, share, carry = flash_sdpa_gap(torch, *ins, got), None, None
            kw = {"causal": True}
            del got
        check(routes == {"tensor_core": 1, "float32": 0},
              f"{arch}: {name} at the path's operands took routes {routes}")
        entry = time_kernel(torch, name, ins, kw, plain_reps=ZOO_PLAIN_REPS)
        entry.update(shapes=[list(t.shape) for t in ins],
                     strides=[list(t.stride()) for t in ins])
        if name == "ssd_scan":
            entry.update(gate_share=share, carry_share=carry)
        else:
            entry["sdpa_gap"] = err
        print(f"[lm zoo] {arch} {name} at the path's operands "
              f"{entry['shapes']}: max abs err {entry['max_abs_err']}; "
              f"{entry['ms']:.4f} ms (events) {entry['device_ms']:.4f} ms "
              f"(device), bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}), {entry['device_ms'] / entry['bound_ms']:.2f}x "
              f"by device; library "
              f"{entry['library_ms'] if entry['library_ms'] is None else round(entry['library_ms'], 4)} ms")
        out[name] = entry
    return out


def zoo_agree(torch, arch, cut, model, card_model):
    """Float32 decode of the cut ``model`` (on the CPU) on the card (its
    copy ``card_model`` there) and on
    the CPU, ``serve_lm`` at batch 8 over ``ZOO_AGREE[arch]`` prompt and
    generated steps, beside the floor where ``ZOO_AGREE`` asks for it
    (the CPU against itself with every weight one float32 ulp up),
    compared as the SSM's decode is
    (``decode_state_gap``): tokens equal but at greedy near-ties (top-two
    gap within the logits bound; at least half the rows equal
    throughout), logits within the bound up to each row's first
    difference, and over the rows that never differ the final caches'
    float32 leaves (the SSM state) within ``SSM_STATE_RTOL`` of their
    largest entry, the conv history within ``SSM_CONV_ATOL`` and the
    KV or latent caches within ``LM_CACHE_ATOL``.  The logits bound is
    ``SSM_DECODE_ATOL`` for the hybrid (its conv history goes through
    bf16 as the SSM's does) and ``LM_DECODE_ATOL`` for the other LMs.  The
    VLM and Whisper decode against zero cross caches, as ``serve_lm``
    does; their ``vis_k``/``vis_v`` and ``enc`` are compared with the
    rest."""
    from repro_torch.models import layers
    prompt, gen, with_floor = ZOO_AGREE[arch]
    atol = SSM_DECODE_ATOL if cut.family == "hybrid" else LM_DECODE_ATOL
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        runs = [record_decode(torch, zoo_serve_args(arch, gen, where, prompt),
                              cfg=cut, model=m, nudge=nudge)
                for where, m, nudge in ((DEVICE, card_model, False),
                                        ("cpu", model, False),
                                        ("cpu", model, True)
                                        )[:3 if with_floor else 2]]
    finally:
        layers.COMPUTE_DTYPE = saved
    card, cpu = runs[:2]
    gap = decode_state_gap(torch, card, cpu, prompt)
    fgap = (decode_state_gap(torch, runs[2], cpu, prompt) if with_floor
            else {"logits": None, "n_same": None, "cache": {}})
    over = (gap["per_step"] > 1e-3).nonzero()
    res = {"prompt": prompt, "gen": gen, "layers": cut.n_layers,
           "logits_max_abs_err": gap["logits"], "rows_same": gap["n_same"],
           "first": gap["first"], "ties": gap["ties"],
           "logits_scale": cpu[1].abs().max().item(),
           "first_step_over_1e-3": int(over[0]) if len(over) else None,
           "cache": {k: v[0] for k, v in gap["cache"].items()},
           "cache_scale": {k: v[1] for k, v in gap["cache"].items()},
           "floor_logits": fgap["logits"], "floor_rows_same": fgap["n_same"],
           "floor_cache": {k: v[0] for k, v in fgap["cache"].items()}}
    print(f"[lm zoo] {arch} float32, {cut.n_layers}-layer cut, {prompt} "
          f"prompt + {gen} generated steps, card vs CPU: {gap['n_same']} of "
          f"{LM_BATCH} rows generate the same tokens (first differing step "
          f"per row {gap['first']}, top-two gaps there "
          f"{[f'{t:.2e}' for t in gap['ties']]}); logits within "
          f"{gap['logits']:.3e} up to each row's first difference (scale "
          f"{res['logits_scale']:.3f}, worst step {gap['worst_step']}, "
          f"first step over 1e-3 {res['first_step_over_1e-3']}); final "
          f"cache of those rows "
          f"{ {k: f'{v[0]:.3e} of {v[1]:.3f}' for k, v in gap['cache'].items()} }"
          f". Floor, CPU with every weight one float32 ulp up: logits "
          f"{fgap['logits']}, {fgap['n_same']} rows the same, caches "
          f"{ {k: f'{v[0]:.3e}' for k, v in fgap['cache'].items()} }")
    check(gap["n_same"] >= LM_BATCH // 2 and all(t <= atol
                                                 for t in gap["ties"]),
          f"{arch} float32 decode: tokens differ card vs CPU away from "
          f"near-ties (rows the same {gap['n_same']}, gaps {gap['ties']}):"
          f"\n{card[0]}\n{cpu[0]}")
    check(card[1].shape == cpu[1].shape and bool(torch.isfinite(card[1]).all())
          and gap["logits"] <= atol, f"{arch} float32 decode logits differ "
          f"card vs CPU by {gap['logits']}, over {atol}")
    for name, (g, scale, dtype) in gap["cache"].items():
        bound = (SSM_STATE_RTOL * scale if dtype == torch.float32
                 else SSM_CONV_ATOL if name == "conv" else LM_CACHE_ATOL)
        check(g <= bound, f"{arch} float32 decode: final cache {name} "
              f"differs card vs CPU by {g}, over {bound}")
    return res


def zoo_prefill_agree(torch, arch, cut, model, card_model):
    """Float32 prefill of the cut ``model`` (on the CPU) against its copy
    ``card_model`` on the card over ``ZOO_PREFILL_AGREE[arch]`` seeded
    tokens with the stub inputs (Whisper's encoder and cross-attention, the
    VLM's cross sites with open gates, flash on the card's float32 route
    where the length allows), within ``ZOO_PREFILL_ATOL``, beside the
    floor where it runs: the CPU with every weight one float32 ulp up
    (``nextafter`` in place, then back down)."""
    import numpy as np
    from repro_torch.launch import train
    from repro_torch.models import layers, zoo
    b, s, with_floor = ZOO_PREFILL_AGREE[arch]
    batch = train.lm_batch(np.random.default_rng(ZOO_SEED + 7), cut, b, s,
                           "cpu")
    del batch["labels"]
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        want = zoo.forward_logits(cut, model, batch)
        got = zoo.forward_logits(cut, card_model, {
            k: v.to(DEVICE) for k, v in batch.items()}).cpu()
        floor = None
        if with_floor:
            with torch.no_grad():
                for sign in (1.0, -1.0):
                    for p in model.parameters():
                        p.copy_(torch.nextafter(
                            p, torch.tensor(sign * float("inf"))))
                    if sign > 0:
                        floor = (zoo.forward_logits(cut, model, batch)
                                 - want).abs().max().item()
    finally:
        layers.COMPUTE_DTYPE = saved
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    res = {"batch": b, "seq": s, "max_abs_err": err,
           "scale": want.abs().max().item(), "argmax_agree": agree,
           "floor": floor}
    print(f"[lm zoo] {arch} float32 prefill, cut {cut.n_layers} layers, "
          f"{b} x {s} tokens with the stub inputs, card vs CPU: logits "
          f"within {err:.3e} (scale {res['scale']:.3f}, bound "
          f"{ZOO_PREFILL_ATOL}), argmax agrees at {100 * agree:.2f}%; "
          f"floor, the CPU with every weight one ulp up: {floor}")
    check(bool(torch.isfinite(got).all()) and err <= ZOO_PREFILL_ATOL,
          f"{arch} float32 prefill: card logits differ from the CPU's by "
          f"{err}, over {ZOO_PREFILL_ATOL}")
    return res


def zoo_cell(torch, arch):
    """One LM of the zoo at its published widths (``ZOO_DEPTH`` cuts the
    depth where one card forces it): prefill with the launch gates, the
    kernels at layer 0's own operands, the float32 card-vs-CPU prefill
    (the configs of this slice) and decode on a cut of the same weights,
    ``serve_lm`` decode, and the MoE dispatch's drops and collisions at
    prefill and decode."""
    from repro_torch.models import moe
    from repro_torch.models.layers import padded_vocab
    t0 = time.perf_counter()
    split = {}

    def lap(name, since=[t0]):
        now = time.perf_counter()
        split[name] = now - since[0]
        since[0] = now
    cfg = zoo_config(arch, ZOO_DEPTH[arch])
    expect = zoo_expect(cfg)
    label = f"lm zoo {arch}"
    model, batch, _, res = run_prefill(
        torch, cfg, ZOO_SEED, "flash_attention", label, expect=expect,
        shape=ZOO_PREFILL[arch], warm=ZOO_WARM)
    res.update(n_layers=cfg.n_layers, expect=expect,
               busy_share=(res["busy_ms"] / res["traced_ms"]
                           if res["busy_ms"] else None),
               weight_gb=sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 1e9)
    operands, res["prefill_dispatch"] = zoo_layer0(torch, cfg, model, batch)
    cut = zoo_config(arch, **ZOO_CUT[arch])
    cpu_model = zoo_cut(torch, model, cut)
    del model, batch
    torch.cuda.empty_cache()
    lap("prefill")
    res["kernels"] = zoo_kernels(torch, arch, cfg, operands)
    del operands
    torch.cuda.empty_cache()
    lap("kernels")
    # the cut's copy on the card, made after the kernels' timing (llama3's
    # flash twin at layer 0 holds ~50 GB of float32 scores)
    card_model = zoo_cut(torch, cpu_model, cut, DEVICE)
    if arch in ZOO_PREFILL_AGREE:
        if cut.family == "vlm":
            for m in (cpu_model, card_model):
                open_gates(torch, m, ZOO_SEED)
        res["prefill_agree"] = zoo_prefill_agree(torch, arch, cut, cpu_model,
                                                 card_model)
        lap("prefill_agree")
    res["agree"] = zoo_agree(torch, arch, cut, cpu_model, card_model)
    del cpu_model, card_model
    torch.cuda.empty_cache()
    lap("decode_agree")
    res["serve"] = serve_and_time(
        torch, lambda gen: zoo_serve_args(arch, gen, DEVICE,
                                          ZOO_SERVE_PROMPT),
        f"lm zoo serve {arch}", padded_vocab(cfg), cfg=cfg,
        wrap=moe.tally if cfg.family == "moe" else None, gen=ZOO_SERVE_GEN,
        prompt=ZOO_SERVE_PROMPT, profile=cfg.family == "moe")
    res["decode_dispatch"] = res["serve"].pop("instrumented")
    res["serve"].pop("tokens")
    torch.cuda.empty_cache()
    lap("serve")
    for stage in ("prefill", "decode"):
        d = res[f"{stage}_dispatch"]
        if d and d["calls"]:
            print(f"[lm zoo] {arch} {stage} MoE dispatch over {d['calls']} "
                  f"layer calls: {d['assignments']} assignments, "
                  f"{d['dropped']} dropped by capacity (drop rate "
                  f"{d['dropped'] / d['assignments']:.4f}, the reference's "
                  f"moe_drop_rate), {d['zeroed']} kept but zeroed by the "
                  f"slot cap - 1 collision")
    res["seconds"] = time.perf_counter() - t0
    res["split_s"] = split
    print(f"[lm zoo] {arch}: {cfg.n_layers} layers on the card "
          f"({res['weight_gb']:.2f} GB of float32 weights), prefill "
          f"{ZOO_PREFILL[arch]} at {res['prefill_tok_s']:,.0f} tokens/s, "
          f"busy {res['busy_share']}, peak {res['max_memory_gb']:.2f} GiB; "
          f"decode {res['serve']['tok_s']:,.1f} tok/s, median step "
          f"{res['serve'].get('median_step_ms')} ms, peak "
          f"{res['serve']['max_memory_gb']:.2f} GiB; {res['seconds']:.1f} s "
          f"({ {k: round(v, 1) for k, v in split.items()} })")
    return res


def phase_lm_zoo(torch):
    """The LM zoo beyond smollm and mamba2 (``zoo_cell`` each): zamba2-1.2b,
    qwen3-moe-30b-a3b, deepseek-v2-236b, whisper-small,
    llama-3.2-vision-11b, stablelm-12b and llama3-405b."""
    t0 = time.perf_counter()
    out = {arch: zoo_cell(torch, arch) for arch in ZOO_DEPTH}
    out["seconds"] = time.perf_counter() - t0
    print(f"[lm zoo] phase {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- lm mesh --
# the LM's model axis: qwen3-moe-30b-a3b at its published widths
# (d 2048, 32/4 heads of 128, 128 experts top-8 of width 768, vocab
# 151 936) over MESH_WORKERS gloo ranks on the one card, experts split
# and all-to-all dispatched (--moe ep_a2a) and heads split.  Cut in depth
# only: MESH_DEPTH of 48 layers.  Each rank holds its 64 experts (1.21 GB
# a layer), its 16/2 heads and the whole embedding and head (2.49 GB):
# ~7.3 GB of float32 weights at 4 layers; the single-process forward
# beside them holds all 12.5 GB.  Four layers (eight before) keep
# the two ranks, the rank-side decode and the single-process run inside
# the script's budget (the depth sets the per-forward time, not a card
# limit: both ranks and the single process would fit 16 layers).
MESH_ARCH, MESH_DEPTH, MESH_CUT = "qwen3-moe-30b-a3b", 4, 2
MESH_WORKERS = 2
MESH_PREFILL = (2, 2048)        # B x S, bf16: flash at (2, 16/2, 2048, 128)
# timed forwards after one warm forward (a rank's takes 3-5 s: gloo
# stages EP's all_to_alls through host memory)
MESH_REPS = 1
MESH_AGREE = (1, 256)           # float32 prefill on the cut
# float32 card, sharded against one process on the cut (the gather path,
# whose dispatch the split experts keep bit for bit), EP on the card
# against the same ranks' EP on the CPU, and EP with sequence parallelism
# against EP without: the sums of the split heads' outputs and gloo's
# reduction round differently from one process's, and the card's matmuls
# from the CPU's (~1e-6 to 1e-5 expected); a wrong slice, a dropped
# all_reduce or a misrouted token moves logits by tenths.  The bound is
# the zoo's float32 card-vs-CPU prefill bound.  EP against the gather
# path is printed, not held: their capacities drop different assignments.
MESH_ATOL = 1e-3
MESH_TIMEOUT_S = 900


def mesh_args(gen, device, *extra):
    """``serve_lm`` flags of the mesh phase's decode: batch 8, prompt 32,
    ``gen`` generated tokens, heads split (decode takes the MoE's gather
    path, experts split)."""
    from repro_torch.launch import serve
    return serve.parse_args([
        "--arch", MESH_ARCH, "--device", device, "--seed", str(ZOO_SEED),
        "--batch", str(LM_BATCH), "--prompt-len", str(ZOO_SERVE_PROMPT),
        "--gen-len", str(gen), "--shard-heads", *extra])


def mesh_batch(torch, cfg, shape, dev):
    """The seeded prefill tokens of ``shape`` (``train.lm_batch``, as
    ``run_prefill`` draws them)."""
    import numpy as np
    from repro_torch.launch import train
    batch = train.lm_batch(np.random.default_rng(ZOO_SEED), cfg, *shape, dev)
    del batch["labels"]
    return batch


def mesh_collectives(group, n):
    """The group's counters per forward (or step) over ``n`` of them:
    calls, bytes sent, transport and staging seconds, by collective."""
    return {kind: {k: v / n for k, v in st.items()}
            for kind, st in group.stats.items() if st["calls"]}


def lm_mesh_rank(group, out):
    """A rank of the lm mesh phase (``launch.mesh``'s target): the bf16
    prefill at ``MESH_DEPTH`` layers (a warm forward, then ``MESH_REPS``
    timed ones with zeroed launch and collective counters; rank 0 saves
    layer 0's flash operands), the bf16 ``serve_lm`` decode, then on the
    ``MESH_CUT`` float32 cut: the prefill on the gather path and on EP,
    each without and with ``--seq-parallel`` (rank 0 saves the logits),
    layer 0's EP call repeated on the CPU (the rank's experts copied
    over, the same gloo group's CPU view) with both runs' dispatch
    integers and outputs saved, the whole EP forward repeated on the CPU
    (the rank's weights moved there, the same CPU view; rank 0 saves the
    logits), and the float32 ``serve_lm`` decode with every step's
    logits; results to ``out/rank<r>.*``."""
    import copy
    import numpy as np
    import torch
    from repro_torch.core.collectives import ProcessWorkers
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import moe, zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, r = group.device, group.rank
    res = {"rank": r, "device": str(dev)}
    cfg = zoo_config(MESH_ARCH, MESH_DEPTH)
    with zoo.settings(group, moe_impl="ep_a2a", shard_heads=True):
        t0 = time.perf_counter()
        model = zoo.build(cfg, dev).init(ZOO_SEED)
        torch.cuda.synchronize(dev)
        res["init_s"] = time.perf_counter() - t0
        res["weight_gb"] = sum(p.numel() * p.element_size()
                               for p in model.parameters()) / 1e9
        batch = mesh_batch(torch, cfg, MESH_PREFILL, dev)
        real, seen = ops.flash_attention, []

        def spy(q, k, v, causal=True):
            if not seen and r == 0:
                torch.save({n: t.transpose(1, 2).cpu() for n, t in
                            (("q", q), ("k", k), ("v", v))},
                           os.path.join(out, "flash_ops.pt"))
            seen.append([list(t.shape) for t in (q, k, v)])
            return real(q, k, v, causal)
        ops.flash_attention = spy
        try:
            t0 = time.perf_counter()
            zoo.forward_logits(cfg, model, batch)
            torch.cuda.synchronize(dev)
            res["first_forward_s"] = time.perf_counter() - t0
        finally:
            ops.flash_attention = real
        res["flash_shapes"] = seen[0]
        ops.reset_launch_counts()
        group.reset_stats()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        with moe.tally() as drops:
            for _ in range(MESH_REPS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                logits = zoo.forward_logits(cfg, model, batch)
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                ok = bool(torch.isfinite(logits).all())
                del logits
        res.update(forward_ms=times, launches=ops.launch_counts(),
                   flash_routes=ops.flash_route_counts(), finite=ok,
                   collectives=mesh_collectives(group, MESH_REPS),
                   max_memory_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
                   dispatch=drops)
        del model
        torch.cuda.empty_cache()
    group.reset_stats()
    with launch_config(cfg):
        dec = serve.serve_lm(mesh_args(LM_PROFILE_GEN, "cuda", "--dist",
                                       "gloo", "--workers",
                                       str(group.world)), group=group)
    res["decode"] = {"tok_s": dec["tok_s"], "wall_s": dec["wall_s"],
                     "tokens": dec["tokens"].tolist(),
                     "collectives": mesh_collectives(
                         group, ZOO_SERVE_PROMPT + LM_PROFILE_GEN)}
    torch.cuda.empty_cache()
    # float32 on the cut (one model: the heads and experts split): the
    # gather path without and with sequence parallelism (rank 0's logits
    # for the single process's), then EP without and with it; layer 0's
    # EP run again on the CPU over a CPU view of the same gloo group
    cut = zoo_config(MESH_ARCH, MESH_CUT)
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    cpu_group = ProcessWorkers("gloo", group.world, group.rank, "cpu")
    try:
        fbatch = mesh_batch(torch, cut, MESH_AGREE, dev)
        with zoo.settings(group, shard_heads=True):
            model = zoo.build(cut, dev).init(ZOO_SEED)
        real_ep, first = moe.moe_forward_ep, []

        def ep_spy(p, x, cfg_):
            y = real_ep(p, x, cfg_)
            if not first:
                first.append((x.cpu(), y.cpu()))
            return y
        for moe_impl in ("gather", "ep_a2a"):
            for sp in (False, True):
                tag = f"{moe_impl}{'_sp' if sp else ''}"
                first.clear()
                moe.moe_forward_ep = ep_spy
                try:
                    with zoo.settings(group, moe_impl=moe_impl,
                                      shard_heads=True, seq_parallel=sp), \
                            moe.tally(plans=True) as t:
                        logits = zoo.forward_logits(cut, model, fbatch)
                finally:
                    moe.moe_forward_ep = real_ep
                if r == 0:
                    np.save(os.path.join(out, f"logits_{tag}.npy"),
                            logits.cpu().numpy())
                res[f"cut_{tag}_dispatch"] = {
                    k: v for k, v in t.items() if k != "plans"}
                if moe_impl == "ep_a2a" and not sp:
                    card = {n: np.asarray(v.cpu() if hasattr(v, "cpu")
                                          else v)
                            for n, v in t["plans"][0].items()}
                    layer0 = copy.deepcopy(model.layers[0].moe).to("cpu")
                    x0, y0 = first[0]
                    with zoo.settings(cpu_group, moe_impl="ep_a2a"), \
                            moe.tally(plans=True) as tc, torch.no_grad():
                        y_cpu = moe.moe_forward_ep(layer0, x0, cut)
                    cpu = {n: np.asarray(v) for n, v in
                           tc["plans"][0].items()}
                    np.savez(os.path.join(out, f"rank{r}_ep.npz"),
                             y_card=y0.numpy(), y_cpu=y_cpu.numpy(),
                             x0=x0.numpy(), router0=layer0.router.detach()
                             .numpy(),
                             **{f"card.{n}": v for n, v in card.items()},
                             **{f"cpu.{n}": v for n, v in cpu.items()})
                del logits
        # the whole EP forward again on the CPU, over the CPU view of the
        # same gloo group: the card's EP logits are held to it
        model.to("cpu")
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // group.world))
        try:
            with zoo.settings(cpu_group, moe_impl="ep_a2a",
                              shard_heads=True), moe.tally() as t:
                logits = zoo.forward_logits(cut, model, mesh_batch(
                    torch, cut, MESH_AGREE, "cpu"))
        finally:
            torch.set_num_threads(threads)
        if r == 0:
            np.save(os.path.join(out, "logits_ep_a2a_cpu.npy"),
                    logits.numpy())
        res["cut_ep_a2a_cpu_dispatch"] = dict(t)
        del logits, model
        group.reset_stats()
        toks, steps, _, _ = record_decode(
            torch, mesh_args(LM_PROFILE_GEN, "cuda", "--dist", "gloo",
                             "--workers", str(group.world)), cfg=cut,
            group=group)
        res["f32_decode_tokens"] = toks.tolist()
        if r == 0:
            np.save(os.path.join(out, "decode_logits.npy"), steps.numpy())
    finally:
        L.COMPUTE_DTYPE = saved
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def first_flip_gap(torch, a, b, prompt):
    """Two ``record_decode`` runs: the max abs logit gap of each row up
    to the step that produced its first differing token (all steps for a
    row that never differs), and the rows that never differ."""
    import numpy as np
    ta, tb = np.asarray(a[0]), np.asarray(b[0])
    gap, same = 0.0, 0
    for row in range(ta.shape[0]):
        diff = np.nonzero(ta[row] != tb[row])[0]
        last = a[1].shape[0] if not diff.size else prompt + int(diff[0])
        same += int(not diff.size)
        gap = max(gap, float((a[1][:last, row] - b[1][:last, row]).abs()
                             .max()))
    return gap, same


def ep_card_vs_cpu(torch, plans, m, e_loc, k):
    """Layer 0's EP dispatch on the card against the CPU's, per rank
    (``plans``: each rank's ``rank<r>_ep.npz``).  Each rank's top-k from
    the CPU's run of the same float32 input and router may differ from
    the card's only where the CPU's k-th and (k+1)-th probabilities lie
    within 1e-6 of each other; every other dispatch integer is
    recomputed on the CPU from the card's own top-k, the all_to_all
    simulated across the ranks' send blocks, and must equal the card's
    bit for bit; where no top-k differs, the CPU run's own integers equal
    the card's too.  Returns ``(top-k tokens that differ, near ties,
    integers compared, max |y_card - y_cpu| over ranks where no top-k
    differs, max |y|)``."""
    import numpy as np
    from repro_torch.models import moe
    flips = ties = compared = 0
    y_gap = y_max = 0.0
    level1 = []
    for z in plans:
        x = torch.from_numpy(z["x0"]).reshape(-1, z["x0"].shape[-1])
        router = torch.from_numpy(z["router0"])
        probs = torch.softmax((x @ router).float(), -1)
        srt = torch.sort(probs, -1, descending=True).values
        near = (srt[:, k - 1] - srt[:, k]) < 1e-6 * srt[:, k - 1]
        card = torch.from_numpy(z["card.topi"])
        differ = (torch.from_numpy(z["cpu.topi"]) != card).any(-1)
        flips += int(differ.sum())
        ties += int(near.sum())
        check(not bool((differ & ~near).any()), "lm mesh: the card's top-k "
              "experts differ from the CPU's away from a near tie")
        if not bool(differ.any()):
            for n in ("order", "dest", "slot", "ok", "recv_e", "recv_m",
                      "order2", "slot2", "ok2", "cap", "c2"):
                check(np.array_equal(z["card." + n], z["cpu." + n]),
                      f"lm mesh: EP {n} on the card differs from the "
                      f"CPU run's")
            y_gap = max(y_gap, float(np.abs(z["y_card"] - z["y_cpu"]).max()))
            y_max = max(y_max, float(np.abs(z["y_cpu"]).max()))
        fe = card.reshape(-1)
        cap = int(z["card.cap"])
        order, dest, slot = moe._sorted_slots(fe // e_loc, m)
        ok = slot < cap
        for n, a in (("order", order), ("dest", dest), ("slot", slot),
                     ("ok", ok)):
            check(np.array_equal(a.numpy(), z["card." + n]),
                  f"lm mesh: EP {n} on the card differs from the CPU's")
            compared += a.numel()
        send_e = torch.zeros((m, cap), dtype=torch.int64)
        send_m = torch.zeros((m, cap), dtype=torch.int64)
        sel = torch.nonzero(ok).squeeze(1)
        send_e[dest[sel], slot[sel]] = fe[order[sel]] % e_loc
        send_m[dest[sel], slot[sel]] = 1
        level1.append((send_e, send_m, cap))
    for r, z in enumerate(plans):
        cap = level1[r][2]
        re_ = torch.cat([level1[j][0][r] for j in range(m)])
        rm = torch.cat([level1[j][1][r] for j in range(m)])
        check(np.array_equal(re_.numpy(), z["card.recv_e"].astype(np.int64))
              and np.array_equal(rm.numpy(),
                                 z["card.recv_m"].astype(np.int64)),
              "lm mesh: EP's received expert ids or marks differ from the "
              "CPU's all_to_all")
        c2 = max(int(m * cap / e_loc * 2.0) + 8, 8)
        order2, sk2, slot2 = moe._sorted_slots(re_ + (1 - rm) * e_loc,
                                               e_loc + 1)
        ok2 = (slot2 < c2) & (sk2 < e_loc)
        for n, a in (("order2", order2), ("slot2", slot2), ("ok2", ok2)):
            check(np.array_equal(a.numpy(), z["card." + n]),
                  f"lm mesh: EP {n} on the card differs from the CPU's")
            compared += a.numel()
        check(int(z["card.c2"]) == c2, "lm mesh: EP's c2 differs")
    return flips, ties, compared, y_gap, y_max


def phase_lm_mesh(torch, smi):
    """The LM's model axis: ``lm_mesh_rank`` on ``MESH_WORKERS`` gloo ranks
    of the one card (``launch.mesh``), then, in this process after them,
    the single-process bf16 prefill and the float32 cut; the gates:
    every rank launched flash ``MESH_DEPTH`` times a forward on the
    tensor-core route at the per-rank shape, the kernel at rank 0's layer-
    0 operands against its twin (timed beside its bound and SDPA), finite
    logits; on the float32 cut the gather path's logits with and without
    sequence parallelism within ``MESH_ATOL`` of the single process's
    (the same dispatch, experts split), EP's within it of the ranks'
    whole EP forward repeated on the CPU, EP's with sequence parallelism
    within it of EP's without, and layer 0's EP dispatch and output on
    the card against the CPU's (``ep_card_vs_cpu``); the float32
    decode's tokens on every rank equal to the single process's (beside
    the one-ulp floor).  Returns the phase's record."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh")
    try:
        return lm_mesh_checks(torch, smi, tmp, t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def lm_mesh_checks(torch, smi, tmp, t0):
    """``phase_lm_mesh``'s runs and gates, the ranks' files in ``tmp``."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models.layers import padded_vocab
    cfg = zoo_config(MESH_ARCH, MESH_DEPTH)
    cut = zoo_config(MESH_ARCH, MESH_CUT)
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.path.join(ROOT, "src"), env.get("PYTHONPATH"))
        if p)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh", "--workers",
         str(MESH_WORKERS), "--dist", "gloo", "--device", DEVICE,
         "--timeout", str(MESH_TIMEOUT_S), "chip_smoke:lm_mesh_rank",
         json.dumps({"out": tmp})],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=MESH_TIMEOUT_S + 60)
    ranks_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"lm mesh: the ranks exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    ranks = [read_json(os.path.join(tmp, f"rank{r}.json"))
             for r in range(MESH_WORKERS)]
    m = MESH_WORKERS
    hq, hkv = cfg.n_heads // m, cfg.n_kv_heads // m
    b, s = MESH_PREFILL
    shape = [[b, hq, s, 128], [b, hkv, s, 128], [b, hkv, s, 128]]
    n_flash = MESH_REPS * MESH_DEPTH
    for rk in ranks:
        label = f"lm mesh rank {rk['rank']}"
        check(rk["launches"].get("flash_attention") == n_flash
              and sum(rk["launches"].values()) == n_flash
              and rk["flash_routes"] == {"tensor_core": n_flash,
                                         "float32": 0},
              f"{label}: launched {rk['launches']} (routes "
              f"{rk['flash_routes']}) over {MESH_REPS} forwards, expected "
              f"{MESH_DEPTH} tensor-core flash launches a forward")
        check(rk["flash_shapes"] == shape, f"{label}: flash at "
              f"{rk['flash_shapes']}, expected the per-rank {shape}")
        check(rk["finite"], f"{label}: prefill logits not finite")
        coll = rk["collectives"]
        check(coll.get("all_to_all", {}).get("calls") == 4 * MESH_DEPTH
              and coll.get("all_reduce", {}).get("calls") == MESH_DEPTH,
              f"{label}: collectives per forward {coll}: expected EP's 4 "
              f"all_to_alls and one all_reduce of the heads per layer")
        print(f"[lm mesh] rank {rk['rank']} ({rk['device']}): "
              f"{rk['weight_gb']:.2f} GB of float32 weights, init "
              f"{rk['init_s']:.2f} s, first forward "
              f"{rk['first_forward_s']:.3f} s; {b} x {s} bf16 forwards (ms) "
              f"{[round(t, 3) for t in rk['forward_ms']]}, peak "
              f"{rk['max_memory_gb']:.2f} GiB; launches {rk['launches']}; "
              f"flash at {rk['flash_shapes'][0]} / {rk['flash_shapes'][1]}; "
              f"MoE drops {rk['dispatch']}")
        for kind, st in coll.items():
            print(f"[lm mesh] rank {rk['rank']} {kind} per forward: "
                  f"{st['calls']:.0f} calls, {st['bytes'] / 1e6:.3f} MB sent, "
                  f"transport {st['seconds'] * 1e3:.3f} ms, staging "
                  f"{st['staging_s'] * 1e3:.3f} ms ({smi})")
    launches = {"flash_attention": sum(rk["launches"]["flash_attention"]
                                       for rk in ranks)}
    # the single process, after the ranks: the same forward
    model, _, _, single = run_prefill(
        torch, cfg, ZOO_SEED, "flash_attention", "lm mesh single process",
        shape=MESH_PREFILL, warm=MESH_REPS)
    launches["flash_attention"] += single["launches"]["flash_attention"]
    del model
    torch.cuda.empty_cache()
    # flash at rank 0's layer-0 operands: the per-rank shape as the
    # model's [B, L, H, Dh] views, against its twin, timed
    saved = torch.load(os.path.join(tmp, "flash_ops.pt"))
    qkv = [saved[n].to(DEVICE).transpose(1, 2) for n in ("q", "k", "v")]
    ops.reset_launch_counts()
    flash = time_kernel(torch, "flash_attention", qkv, {"causal": True})
    check(ops.flash_route_counts()["float32"] == 0, "lm mesh: flash at the "
          "per-rank shape left the tensor-core route")
    flash["shapes"] = [list(t.shape) for t in qkv]
    print(f"[lm mesh] flash at rank 0's layer-0 operands "
          f"{flash['shapes'][0]} / {flash['shapes'][1]} causal bf16: "
          f"{flash['ms']:.4f} ms (events) {flash['device_ms']:.4f} ms "
          f"(device), bound {flash['bound_ms']:.4f} ms "
          f"({flash['bound_by']}), SDPA {flash['library_ms']:.4f} / "
          f"{flash['library_device_ms']:.4f} ms, twin "
          f"{flash['plain_ms']:.4f} ms; max abs err {flash['max_abs_err']} "
          f"({smi})")
    del qkv, saved
    # the float32 cut: the single process against the sharded runs
    from repro_torch.models import layers as L, zoo
    saved_dt = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    agree = {}
    try:
        model = zoo.build(cut, DEVICE).init(ZOO_SEED)
        want = zoo.forward_logits(cut, model, mesh_batch(
            torch, cut, MESH_AGREE, DEVICE)).cpu().numpy()
        del model
        got = {tag: np.load(os.path.join(tmp, f"logits_{tag}.npy"))
               for tag in ("gather", "gather_sp", "ep_a2a", "ep_a2a_sp",
                           "ep_a2a_cpu")}
        for tag, ref_tag in (("gather", None), ("gather_sp", None),
                             ("ep_a2a", "ep_a2a_cpu"),
                             ("ep_a2a_sp", "ep_a2a")):
            other = want if ref_tag is None else got[ref_tag]
            err = float(np.abs(got[tag] - other).max())
            agree[tag] = err
            check(err <= MESH_ATOL, f"lm mesh: float32 {tag} logits {err} "
                  f"from {ref_tag or 'the single process'}'s, bound "
                  f"{MESH_ATOL}")
            print(f"[lm mesh] float32 {cut.n_layers}-layer cut, "
                  f"{MESH_AGREE[0]} x {MESH_AGREE[1]}, --moe "
                  f"{tag.replace('_sp', '')}"
                  f"{' --seq-parallel' if tag.endswith('_sp') else ''}: max "
                  f"|logits - {ref_tag or 'single process'}| {err:.3e} "
                  f"(bound {MESH_ATOL}); drops "
                  f"{ranks[0][f'cut_{tag}_dispatch']}"
                  + (f" (the CPU's {ranks[0]['cut_ep_a2a_cpu_dispatch']})"
                     if ref_tag == "ep_a2a_cpu" else ""))
        agree["ep_vs_gather"] = float(np.abs(got["ep_a2a"] - want).max())
        plans = [np.load(os.path.join(tmp, f"rank{r}_ep.npz"))
                 for r in range(m)]
        flips, ties, n, y_gap, y_max = ep_card_vs_cpu(
            torch, plans, m, cut.n_experts // m, cut.top_k)
        check(y_gap <= 1e-4 * y_max + 1e-7, f"lm mesh: layer 0's EP output "
              f"on the card {y_gap} from the CPU run's (max |y| {y_max})")
        agree.update(ep_ints=n, topk_flips=flips, near_ties=ties,
                     ep_y_max_abs_err=y_gap, ep_y_max=y_max)
        print(f"[lm mesh] EP at layer 0 of the float32 cut, card against the "
              f"CPU: {n} dispatch integers equal; top-k tokens that differ "
              f"{flips} (near ties {ties}); max |y_card - y_cpu| {y_gap:.3e} "
              f"of max |y| {y_max:.3e}; EP's logits "
              f"{agree['ep_vs_gather']:.3e} from the gather path's (their "
              f"capacities drop other assignments: drops "
              f"{ranks[0]['cut_ep_a2a_dispatch']} against "
              f"{ranks[0]['cut_gather_dispatch']})")
        # float32 decode: every rank's tokens against the single process's
        args = mesh_args(LM_PROFILE_GEN, DEVICE)
        base = record_decode(torch, args, cfg=cut)
        floor = record_decode(torch, args, cfg=cut, nudge=True)
    finally:
        L.COMPUTE_DTYPE = saved_dt
    mesh_logits = torch.from_numpy(np.load(os.path.join(tmp,
                                                        "decode_logits.npy")))
    gap = float((mesh_logits - base[1]).abs().max())
    floor_gap, floor_rows = first_flip_gap(torch, base, floor,
                                           ZOO_SERVE_PROMPT)
    for rk in ranks:
        check(np.array_equal(np.asarray(rk["f32_decode_tokens"]), base[0]),
              f"lm mesh: rank {rk['rank']}'s float32 decode tokens differ "
              f"from the single process's")
    agree.update(decode_max_abs_err=gap, decode_floor=floor_gap,
                 floor_rows_same=floor_rows)
    print(f"[lm mesh] float32 decode on the cut, batch {LM_BATCH}, prompt "
          f"{ZOO_SERVE_PROMPT}, gen {LM_PROFILE_GEN}: every rank's tokens "
          f"equal the single process's; max |logits - single| {gap:.3e}. "
          f"One-ulp floor (one process with every weight one float32 ulp "
          f"up): logits {floor_gap:.3e} up to each row's first differing "
          f"token, {floor_rows} of {LM_BATCH} rows generate the same "
          f"tokens")
    v_pad = padded_vocab(cfg)
    for rk in ranks:
        toks = np.asarray(rk["decode"]["tokens"])
        check(toks.shape == (LM_BATCH, LM_PROFILE_GEN) and toks.min() >= 0
              and toks.max() < v_pad, f"lm mesh: rank {rk['rank']}'s bf16 "
              f"decode tokens {toks.shape} outside [0, {v_pad})")
        check(np.array_equal(toks, np.asarray(ranks[0]["decode"]["tokens"])),
              "lm mesh: the ranks decoded different tokens")
    dec = ranks[0]["decode"]
    print(f"[lm mesh] bf16 serve_lm --dist gloo --workers {m} at "
          f"{MESH_DEPTH} layers, batch {LM_BATCH}, prompt {ZOO_SERVE_PROMPT}, "
          f"gen {LM_PROFILE_GEN}: {dec['tok_s']:,.1f} tok/s "
          f"({dec['wall_s']:.3f} s); collectives per step "
          f"{ {k: round(v['calls'], 1) for k, v in dec['collectives'].items()} } "
          f"({smi})")
    for rk in ranks:
        for key in ("flash_shapes",):
            rk.pop(key)
        rk["decode"].pop("tokens")
        rk.pop("f32_decode_tokens")
    res = {"ranks": ranks, "single": {k: single[k] for k in (
        "init_s", "first_forward_s", "warm_forward_ms", "forward_ms",
        "prefill_tok_s", "max_memory_gb", "busy_ms", "traced_ms",
        "launches")}, "flash": {k: flash[k] for k in (
            "shapes", "max_abs_err", "ms", "device_ms", "plain_ms",
            "plain_device_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")}, "agree": agree, "launches": launches,
        "ranks_s": ranks_s, "seconds": time.perf_counter() - t0}
    print(f"[lm mesh] single process: {b} x {s} forwards (ms) "
          f"{[round(t, 3) for t in single['forward_ms']]}, peak "
          f"{single['max_memory_gb']:.2f} GiB; the ranks' median "
          f"{[round(statistics.median(rk['forward_ms']), 3) for rk in ranks]} "
          f"ms, peaks {[round(rk['max_memory_gb'], 2) for rk in ranks]} GiB; "
          f"ranks {ranks_s:.1f} s, phase {res['seconds']:.1f} s ({smi})")
    return res


@contextlib.contextmanager
def twin_calls():
    """Count the calls of ``ssd_scan``'s plain twin inside the block (the
    main path on the card must make none)."""
    from repro_torch.kernels import ref
    real, calls = ref.ssd_scan_ref, {"ssd_scan_ref": 0}

    def counted(*a, **kw):
        calls["ssd_scan_ref"] += 1
        return real(*a, **kw)
    ref.ssd_scan_ref = counted
    try:
        yield calls
    finally:
        ref.ssd_scan_ref = real


def lm_shell(cfg, device="meta"):
    """An LM of ``cfg``'s family with no weights of its own (``meta``):
    the shell ``train_loop.module_loss`` swaps tensors into, and the
    source of ``convert.lm_leaves``' layout and the parameter counts."""
    from repro_torch.models import deepseek, hybrid, moe, ssm, transformer
    from repro_torch.models import vlm, whisper, zoo
    cls = {"dense": transformer.DenseLM, "moe_qwen": moe.Qwen3MoeLM,
           "moe_deepseek": deepseek.DeepSeekLM, "ssm": ssm.Mamba2LM,
           "hybrid": hybrid.Zamba2LM, "vlm": vlm.VisionLM,
           "audio": whisper.WhisperLM}[zoo._family_key(cfg)]
    return cls(cfg, device)


def lm_train_flops(cfg, b, s):
    """A FLOP lower bound of one train step (forward and backward) from
    the shapes: ``6 N_active B S`` (every weight matrix once per token:
    routed experts scaled by top_k / E, the hybrid's shared block once per
    site, the embedding table only where tied, as the read-out; the
    matrices that read the stub inputs, ``vproj``/``aproj``, Whisper's
    encoder and the cross sites' ``wk``/``wv``, once per vision token or
    frame ``T`` instead) plus the attention: ``6 B Hq S^2 Dh`` per causal
    layer or site, ``12 B Hq S T Dh`` per cross site and ``12 B Hq T^2
    Dh`` per encoder layer (the SSD's chunk products are left out).
    Returns ``(flops, n_active, n_total)``; ``n_active`` counts per
    token of its own stream."""
    from repro_torch.models import hybrid, vlm
    model = lm_shell(cfg)
    t = cfg.n_vision_tokens or cfg.n_audio_frames
    active = total = token_flops = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        if name == "tok" and not cfg.tie_embeddings:
            continue
        if ".moe.w" in name:
            n = n * cfg.top_k / cfg.n_experts
        if name.startswith("shared."):
            n *= hybrid.grouped(cfg)[0]
        active += n
        per_frame = (name in ("vproj", "aproj") or name.startswith("encoder.")
                     or name.endswith(("xattn.wk", "xattn.wv"))
                     or (name.startswith("cross.")
                         and name.endswith(("attn.wk", "attn.wv"))))
        token_flops += 6 * n * b * (t if per_frame else s)
    if cfg.family == "hybrid":
        attn_layers = hybrid.grouped(cfg)[0]
    elif cfg.family == "ssm":
        attn_layers = 0
    else:
        attn_layers = cfg.n_layers
    cross = {"vlm": vlm.n_sites(cfg) if cfg.family == "vlm" else 0,
             "audio": cfg.n_layers}.get(cfg.family, 0)
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    flops = (token_flops + 6 * b * cfg.n_heads * s * s * hd * attn_layers
             + 12 * b * cfg.n_heads * s * t * hd * cross
             + 12 * b * cfg.n_heads * t * t * hd * cfg.n_encoder_layers)
    return flops, active, total


def lm_train_costs(torch, cfg, b, s):
    """Two costs of a train step at the cell's shapes, on tensors made
    here: one ``adam_update`` over parameters of ``cfg``'s shapes (device
    ms by events behind a sleep, and host ms of one synchronized call),
    and for the SSM families one layer's ``SSDScan`` forward (the
    ``ssd_scan`` kernel) and backward (the vjp of ``ssd_chunked``), on
    bf16 operands laid out as the layer's (``ssd_inputs``) and first held
    against the twin under the bf16 gate (``check_ssd_bf16``)."""
    from repro_torch import convert
    from repro_torch.core.config import TrainConfig
    from repro_torch.models import ssm
    from repro_torch.train.optimizer import adam_update, init_adam
    shapes = [p.shape for p in convert.lm_leaves(lm_shell(cfg))[0]]
    params = [torch.zeros(sh, device=DEVICE) for sh in shapes]
    grads = [torch.full(sh, 1e-3, device=DEVICE) for sh in shapes]
    opt = init_adam(params)
    tcfg = TrainConfig()

    def adam():
        adam_update(tcfg, params, grads, opt)
    out = {"adamw_tensors": len(shapes),
           "adamw_device_ms": gpu_ms(torch, adam, reps=3)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    adam()
    torch.cuda.synchronize()
    out["adamw_host_ms"] = (time.perf_counter() - t) * 1e3
    del params, grads, opt
    if cfg.family in ("ssm", "hybrid"):
        _, h, p, n = ssm.dims(cfg)
        ins = ssd_inputs(torch, DEVICE, (b, s, h, p, n), "ref",
                         seed=LM_TRAIN_SEED, dtype=torch.bfloat16)
        err, share, _, _ = check_ssd_bf16(
            torch, ins, cfg.ssm_chunk, f"{cfg.name} training shape "
            f"{(b, s, h, p, n)} chunk {cfg.ssm_chunk}", tag="[lm train]")
        out.update(ssd_twin_max_abs_err=err, ssd_twin_gate_share=share)
        ins = [t.detach().requires_grad_() for t in ins]
        with torch.no_grad():
            out["ssd_fwd_ms"] = gpu_ms(
                torch, lambda: ssm.SSDScan.apply(*ins, cfg.ssm_chunk))
        y = ssm.SSDScan.apply(*ins, cfg.ssm_chunk)
        gy = torch.ones_like(y)
        out["ssd_bwd_ms"] = gpu_ms(torch, lambda: torch.autograd.grad(
            y, ins, gy, retain_graph=True), reps=5)
        del y, ins
    torch.cuda.empty_cache()
    return out


def lm_train_args(arch, b, s, steps, micro, ckpt_dir):
    """``train_lm`` flags: the card, ``LM_TRAIN_SEED``, the reference's lr,
    a log line every step, no checkpoint inside the run."""
    from repro_torch.launch import train
    return train.parse_args([
        "--arch", arch, "--device", DEVICE, "--seed", str(LM_TRAIN_SEED),
        "--steps", str(steps), "--lm-batch", str(b), "--lm-seq", str(s),
        "--microbatches", str(micro), "--log-every", "1",
        "--ckpt-every", str(steps + 1), "--ckpt-dir", ckpt_dir])


def lm_train_cell(torch, arch, smi, tmp):
    """``train_lm`` of ``arch`` at ``LM_TRAIN[arch]`` with zeroed launch
    counters, the twin's calls counted and the last step traced; the
    launch and finiteness gates; the per-arch numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    depth, b, s, steps, micro = LM_TRAIN[arch]
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    label = f"lm train {arch}"
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    clock = StepClock(torch, first=steps - 1, n=1, device_only=True)
    with launch_config(cfg, train), twin_calls() as twin:
        res = train.train_lm(lm_train_args(arch, b, s, steps, micro, tmp),
                             step_hook=clock)
    clock.close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    routes = ops.ssd_route_counts()
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    want = {name: 0 for name in counts}
    want["ssd_scan"] = mamba * steps * micro
    check(counts == want, f"{label}: launches {counts}, expected {want} "
          f"({mamba} ssd_scan per microbatch forward, no other kernel)")
    check(routes == {"tensor_core": want["ssd_scan"], "float32": 0},
          f"{label}: ssd_scan routes {routes}")
    check(twin["ssd_scan_ref"] == 0, f"{label}: the ssd_scan twin ran "
          f"{twin['ssd_scan_ref']} times on the card")
    check(len(res["losses"]) == steps
          and all(map(math.isfinite, res["losses"])),
          f"{label}: losses {res['losses']} (nan_guard would fire)")
    warm = clock.times[1:max(steps - 2, 2)]
    med = statistics.median(warm)
    flops, active, total = lm_train_flops(cfg, b, s)
    traced = clock.traced_ms()
    busy = summarize_profile(torch, clock.prof, 1, traced,
                             f"{label}, the traced last step")
    out = {"n_layers": cfg.n_layers, "batch": b, "seq": s, "steps": steps,
           "microbatches": micro, "losses": res["losses"],
           "wall_s": res["wall_s"], "step_times_ms": [1e3 * t for t in
                                                      clock.times],
           "median_step_ms": med * 1e3, "tokens_per_s": b * s / med,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "traced_ms": traced, "busy_ms": busy,
           "busy_share": None if busy is None else busy / traced,
           "device_kernels_per_step": sum(
               e.count for e in clock.prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith("ProfilerStep")),
           "launches": counts, "launches_per_step": {
               k: v / steps for k, v in counts.items() if v},
           "ssd_routes": routes, "twin_calls": twin["ssd_scan_ref"],
           "ssd_scan_device_ms_per_step": (
               kernel_device_ms(torch, clock.prof, "ssd_scan") if mamba
               else 0.0),
           "flops_per_step": flops, "params_active": active,
           "params_total": total,
           "flop_bound_ms": flops / BF16_FLOPS * 1e3, "device": smi}
    torch.cuda.empty_cache()
    out["costs"] = lm_train_costs(torch, cfg, b // micro, s)
    out["seconds"] = time.perf_counter() - t0
    print(f"[{label}] {cfg.n_layers} layers, {b} x {s} tokens, {steps} "
          f"steps, {micro} microbatch(es), {total / 1e9:.3f} G params "
          f"({active / 1e9:.3f} G active): median step "
          f"{out['median_step_ms']:.3f} ms of steps 1-{len(warm)} "
          f"({out['tokens_per_s']:,.0f} tokens/s); peak "
          f"{out['max_memory_gb']:.2f} GB; busy {out['busy_share']}; "
          f"our kernels per step {out['launches_per_step']}, CUDA kernels "
          f"per step {out['device_kernels_per_step']}; ssd_scan "
          f"{out['ssd_scan_device_ms_per_step']:.3f} device ms per step; "
          f"FLOP lower bound {flops / 1e12:.2f} TFLOP = "
          f"{out['flop_bound_ms']:.2f} ms at 989 TFLOP/s bf16 "
          f"({100 * out['flop_bound_ms'] / out['median_step_ms']:.1f}% of "
          f"the step); losses {[round(x, 4) for x in res['losses']]}; "
          f"{out['seconds']:.1f} s; card: {smi}")
    c = out["costs"]
    ssd = (f"; one layer's SSDScan at {b // micro} x {s}: forward (the "
           f"kernel) {c['ssd_fwd_ms']:.3f} ms, backward (the vjp of "
           f"ssd_chunked) {c['ssd_bwd_ms']:.3f} ms, x {mamba * micro} a "
           f"step = {c['ssd_bwd_ms'] * mamba * micro:.1f} ms"
           if mamba else "")
    print(f"[{label}] costs at the cell's shapes: adam_update over "
          f"{c['adamw_tensors']} tensors {c['adamw_device_ms']:.2f} device "
          f"ms, {c['adamw_host_ms']:.2f} ms host-clocked{ssd}; card: {smi}")
    return out


def _nudged(torch, flat):
    """Copies of ``flat`` with every weight one float32 ulp up (one
    ``nextafter``: no random draw over the ~0.4 G weights of a cut)."""
    inf = torch.tensor(float("inf"))
    return [torch.nextafter(p, inf) for p in flat]


def _leaf_gaps(torch, layout, a, b):
    """Per reference leaf of two flat gradient lists (``a`` on any device,
    ``b`` on the CPU or ``a``'s, moved to ``a``'s a tensor at a time): the
    largest |a - b| as a share of b's largest |entry|; returns ``(worst
    share, its path)``."""
    worst = (0.0, None)
    i = 0
    for path, n, st in zip(layout.paths, layout.counts, layout.stacked):
        err = scale = 0.0
        for x, y in zip(a[i:i + n], b[i:i + n]):
            y = y.to(x.device)
            err = max(err, (x - y).abs().max().item())
            scale = max(scale, y.abs().max().item())
        i += n
        share = err / max(scale, 1e-30)
        if share > worst[0]:
            worst = (share, "/".join(path))
    return worst


def lm_train_agree(torch, arch, smi):
    """Float32 card vs CPU: one ``make_train_step`` (its two halves,
    ``microbatch_grads`` and ``apply_grads``, to keep the gradients) of a
    ``LM_TRAIN_CUT[arch]`` cut of ``arch`` at full width (the VLM's gates
    set from the seed to non-zero values), from the same state (the card's
    seeded init carried to the host) and batch (``train.lm_batch``: the
    tokens, then the VLM's vision or Whisper's frame embeddings); the
    gates and floor of ``LM_TRAIN_*``."""
    import gc
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import layers, zoo
    from repro_torch.train import train_loop as TL
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **LM_TRAIN_CUT[arch])
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=LM_TRAIN[arch][3])
    api = zoo.build(cfg, DEVICE)
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    split = {}

    def lap(name, since=[t0]):
        now = time.perf_counter()
        split[name] = now - since[0]
        since[0] = now
    try:
        model = api.init(LM_TRAIN_SEED)
        if cfg.family == "vlm":
            open_gates(torch, model, LM_TRAIN_SEED)
        flat, layout = convert.lm_leaves(model)
        host = [t.cpu() for t in flat]
        lap("init_and_copy")
        batch = train.lm_batch(np.random.default_rng(LM_TRAIN_SEED), cfg, 1,
                               LM_TRAIN_CUT_S, "cpu")
        ops.reset_launch_counts()
        with twin_calls() as twin:
            card_fn = TL.module_loss(model, api.loss, layout.names)
            state = TL.init_state(flat, tcfg, layout)
            loss_c, grads_c = TL.microbatch_grads(
                card_fn, state.params, {k: v.to(DEVICE)
                                        for k, v in batch.items()}, 1)
            new_c, _ = TL.apply_grads(tcfg, state, loss_c, grads_c, layout)
            torch.cuda.synchronize()
        lap("card_step")
        counts = ops.launch_counts()
        mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
        check(counts["ssd_scan"] == mamba and twin["ssd_scan_ref"] == 0
              and ops.ssd_route_counts()["float32"] == mamba,
              f"{arch} float32 step: ssd_scan launches {counts}, routes "
              f"{ops.ssd_route_counts()}, twin calls {twin}")
        # the card's gradients, initial and new params stay there and the
        # comparisons run there, a tensor at a time: the host holds one
        # state (qwen3's cut: 7.5 GB of weights, ~60 GB at the update's
        # peak)
        del state, card_fn, model
        loss_c = loss_c.item()
        torch.cuda.empty_cache()
        cpu_fn = TL.module_loss(lm_shell(cfg), zoo.build(cfg, "cpu").loss,
                                layout.names)
        state = TL.init_state(host, tcfg, layout)
        loss_h, grads_h = TL.microbatch_grads(cpu_fn, state.params, batch, 1)
        lap("cpu_grads")
        grad_gap = _leaf_gaps(torch, layout, grads_c, grads_h)
        lap("grad_compare")
        floor = None
        if arch in LM_TRAIN_FLOOR:
            f_loss, f_grads = TL.microbatch_grads(
                cpu_fn, _nudged(torch, host), batch, 1)
            floor = {"loss": abs(f_loss.item() - loss_h.item()),
                     "grad": _leaf_gaps(torch, layout, f_grads, grads_h)}
            del f_grads
            lap("floor")
        del grads_c
        gc.collect()
        lr1 = tcfg.learning_rate / tcfg.warmup_steps
        param_bound = 2 * lr1 + 2.0 ** -22
        param_gap = moved = flips = n_weights = None
        if arch in LM_TRAIN_UPDATE:
            new_h, _ = TL.apply_grads(tcfg, state, loss_h, grads_h, layout)
            del grads_h, state
            lap("cpu_update")
            param_gap = flips = n_weights = 0
            for a, b in zip(new_c.params, new_h.params):
                d = (a - b.to(a.device)).abs()
                param_gap = max(param_gap, d.max().item())
                flips += int((d > lr1 / 100).sum())
                n_weights += d.numel()
            moved = max((a - b).abs().max().item()
                        for a, b in zip(new_c.params, flat))
            lap("param_compare")
        del new_c, flat
    finally:
        layers.COMPUTE_DTYPE = saved
    loss_gap = abs(loss_c - loss_h.item())
    res = {"layers": cfg.n_layers, "tokens": LM_TRAIN_CUT_S,
           "loss_card": loss_c, "loss_cpu": loss_h.item(),
           "loss_abs_err": loss_gap, "grad_max_share": grad_gap[0],
           "grad_worst_leaf": grad_gap[1], "param_max_abs_err": param_gap,
           "param_bound": param_bound, "param_moved": moved,
           "param_flips": flips,
           "param_flip_share": flips and flips / n_weights,
           "floor": floor,
           "launches": counts, "device": smi,
           "seconds": time.perf_counter() - t0, "split_s": split}
    update = ("the update not run on the CPU (LM_TRAIN_UPDATE)"
              if param_gap is None else
              f"params after the step within {param_gap:.3e} (bound 2 lr(1) "
              f"+ 2^-22 = {param_bound:.4e}; the step moved them up to "
              f"{moved:.3e}), {flips} of {n_weights} apart by over lr(1) / "
              f"100 (share {flips / n_weights:.2e}, bound "
              f"{LM_TRAIN_FLIP_SHARE})")
    print(f"[lm train agree] {arch} float32, {cfg.n_layers}-layer cut, 1 x "
          f"{LM_TRAIN_CUT_S} tokens, one step card vs CPU: loss "
          f"{loss_c:.6f} vs {loss_h.item():.6f} (|d| {loss_gap:.3e}); "
          f"gradients within {grad_gap[0]:.3e} of each leaf's largest |g| "
          f"(worst {grad_gap[1]}; bound {LM_TRAIN_GRAD_RTOL}); {update}; "
          f"floor, the CPU with "
          f"every weight one ulp up: "
          f"{'not run (host memory)' if floor is None else floor}; "
          f"{res['seconds']:.1f} s "
          f"({ {k: round(v, 1) for k, v in split.items()} }); card: {smi}")
    check(math.isfinite(loss_c) and loss_gap <= LM_TRAIN_LOSS_RTOL
          * abs(loss_h.item()), f"{arch} float32 step: loss card "
          f"{loss_c} vs CPU {loss_h.item()}")
    check(grad_gap[0] <= LM_TRAIN_GRAD_RTOL, f"{arch} float32 step: "
          f"gradient {grad_gap[1]} differs card vs CPU by {grad_gap[0]} of "
          f"its scale, over {LM_TRAIN_GRAD_RTOL}")
    if param_gap is not None:
        check(param_gap <= param_bound and moved > 0, f"{arch} float32 "
              f"step: params differ card vs CPU by {param_gap}, over "
              f"{param_bound}")
        check(flips <= LM_TRAIN_FLIP_SHARE * n_weights, f"{arch} float32 "
              f"step: {flips} of {n_weights} params apart by over lr(1) / "
              f"100")
    return res


def lm_train_micro_compress(torch, smi):
    """smollm-135m at full width on the card (bf16): ``--microbatches 2``
    against 1 on the first ``train_lm`` batch (the loss within
    ``LM_TRAIN_MICRO_RTOL``), then ``LM_TRAIN_COMPRESS_STEPS`` steps with
    ``compress_grads``, each reference leaf's residual checked against
    ``g + e - dequantize(quantize(g + e))`` bit for bit."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.train import compression
    from repro_torch.train import train_loop as TL
    arch = "smollm-135m"
    _, b, s, _, _ = LM_TRAIN[arch]
    cfg = get_config(arch)
    api = zoo.build(cfg, DEVICE)
    model = api.init(LM_TRAIN_SEED)
    flat, layout = convert.lm_leaves(model)
    fn = TL.module_loss(model, api.loss, layout.names)
    rng = np.random.default_rng(LM_TRAIN_SEED)
    batch = train.lm_batch(rng, cfg, b, s, DEVICE)
    one, g_one = TL.microbatch_grads(fn, flat, batch, 1)
    two, g_two = TL.microbatch_grads(fn, flat, batch, 2)
    rel = abs(one.item() - two.item()) / abs(one.item())
    grad_gap = _leaf_gaps(torch, layout, g_two, g_one)
    del g_one, g_two
    print(f"[lm train micro] {arch} bf16, {b} x {s} tokens: loss over 1 "
          f"microbatch {one.item():.6f}, over 2 {two.item():.6f} (rel "
          f"{rel:.3e}, bound {LM_TRAIN_MICRO_RTOL}); gradients within "
          f"{grad_gap[0]:.3e} of each leaf's largest |g| (worst "
          f"{grad_gap[1]}; bound {LM_TRAIN_MICRO_GRAD_RTOL}); card: {smi}")
    check(rel <= LM_TRAIN_MICRO_RTOL, f"{arch}: 2 microbatches' loss "
          f"{two.item()} vs 1's {one.item()}")
    check(grad_gap[0] <= LM_TRAIN_MICRO_GRAD_RTOL, f"{arch}: 2 "
          f"microbatches' gradient {grad_gap[1]} differs from 1's by "
          f"{grad_gap[0]} of its scale, over {LM_TRAIN_MICRO_GRAD_RTOL}")
    tcfg = TrainConfig(learning_rate=1e-3, compress_grads=True)
    state = TL.init_state(flat, tcfg, layout)
    shares = []
    for t in range(LM_TRAIN_COMPRESS_STEPS):
        batch = train.lm_batch(rng, cfg, b, s, DEVICE)
        loss, grads = TL.microbatch_grads(fn, state.params, batch, 1)
        prev = state.error
        state, metrics = TL.apply_grads(tcfg, state, loss, grads, layout)
        check(math.isfinite(metrics["loss"].item()),
              f"{arch} compressed step {t}: loss not finite")
        for path, g, e0, e in zip(layout.paths, layout.group(grads), prev,
                                  state.error):
            gf = g + e0
            q, scale = compression.quantize(gf)
            check(torch.equal(e, gf - compression.dequantize(q, scale)),
                  f"{arch} compressed step {t}: the residual of "
                  f"{'/'.join(path)} is not g - dequantize(q, s)")
            shares.append((e.abs().max() / scale).item())
        del grads
    print(f"[lm train compress] {arch}: {LM_TRAIN_COMPRESS_STEPS} steps "
          f"with compress_grads, {len(layout.paths)} reference leaves "
          f"each: every residual equals g - dequantize(q, s) bit for bit; "
          f"largest |residual| {max(shares):.3f} quantization steps; "
          f"card: {smi}")
    return {"loss_1": one.item(), "loss_2": two.item(), "micro_rel": rel,
            "micro_grad_max_share": grad_gap[0],
            "micro_grad_worst_leaf": grad_gap[1],
            "compress_steps": LM_TRAIN_COMPRESS_STEPS,
            "residual_max_steps": max(shares), "device": smi}


def phase_lm_train(torch, smi):
    """``train_lm`` at published widths (``lm_train_cell`` per arch of
    ``LM_TRAIN``), the float32 card-vs-CPU step per arch
    (``lm_train_agree``), and the microbatch and compression checks."""
    import tempfile
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch in LM_TRAIN:
            out[arch] = lm_train_cell(torch, arch, smi, tmp)
            torch.cuda.empty_cache()
    out["micro_compress"] = lm_train_micro_compress(torch, smi)
    torch.cuda.empty_cache()
    out["agree"] = {}
    for arch in LM_TRAIN:
        out["agree"][arch] = lm_train_agree(torch, arch, smi)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[lm train] phase {out['seconds']:.1f} s")
    return out


# LM training over a (data, model) process mesh (train_lm --dist): gloo
# ranks on the one card, through launch.mesh.  arch -> (layers on the
# card, None for all; workers W; model axis M; train_lm flags; batch;
# seq; steps).  qwen3-moe-30b-a3b at its published widths, 2 of 48
# layers (as LM_TRAIN), on a (2, 2) mesh with EP, heads split, sequence
# parallelism and remat full: each rank stores a quarter of the whole
# (FSDP over data, and over model where the model holds a leaf whole),
# gathers its model rank's half (~4.9 GB) before the loss and reduces
# as much gradient after it, all staged through host memory by gloo.
# zamba2-1.2b whole on (1, 2) with remat dots: every rank runs every
# Mamba layer's ssd_scan, again in the backward's recompute.  Two steps
# each (a first, which holds the ranks' one-time imports and CUDA
# warm-up, and one steady step): gloo's host-staged transport makes a
# step 8-14 s on the card's host, and a third step of both cells (~22 s)
# does not fit the whole script's 1200 s limit on a slow host.
TRAIN_MESH = {
    "zamba2-1.2b": (None, 2, 2, ("--shard-heads", "--seq-parallel",
                                 "--remat", "dots"), 4, 512, 2),
    "qwen3-moe-30b-a3b": (2, 4, 2, ("--moe", "ep_a2a", "--shard-heads",
                                    "--seq-parallel", "--remat", "full"),
                          4, 512, 2)}
# the float32 cut (LM_TRAIN_CUT's layers, full width): 2 x LM_TRAIN_CUT_S
# tokens, so the batch splits over qwen3's data axis of 2; one step over
# the mesh with the gather path (experts split), heads split, sequence
# parallelism, FSDP and remat full, against one process's
# make_train_step on the card (the same seeded init and batch): the loss
# within LM_TRAIN_LOSS_RTOL, every leaf's gradient within
# LM_TRAIN_GRAD_RTOL of its largest |g|, the new params within 2 lr(1) +
# 2^-22 with at most LM_TRAIN_FLIP_SHARE of them over lr(1) / 100 (PR
# 25's bounds: the mesh's sums run in other orders, ~1e-6 expected).
# EP drops other assignments than the gather path, so its cut step is
# held to the same ranks' EP step on the CPU: each rank's loss and
# gradient shares before the sync with the same bounds (the sync and
# the update are the gather path's arithmetic, held above; the update
# of qwen3's cut on the CPU is left out, as LM_TRAIN_UPDATE leaves it
# out: four ranks' host states would crowd the host's memory).  remat none and dots against full on the cut: every leaf's
# gradient share within TRAIN_MESH_REMAT_RTOL of its largest (the card's
# scatter-adds round in the order their atomics land).
TRAIN_MESH_CUT_B = 2
TRAIN_MESH_REMAT_RTOL = 1e-6
TRAIN_MESH_TIMEOUT_S = 900
#: the ranks' ``launch.mesh`` target
TRAIN_MESH_TARGET = "chip_smoke:train_mesh_rank"


def train_mesh_args(arch, flags, b, s, steps, tmp, *extra):
    """``train_lm`` flags of a mesh cell on the card."""
    from repro_torch.launch import train
    _, w, m, _, _, _, _ = TRAIN_MESH[arch]
    return train.parse_args([
        "--arch", arch, "--device", DEVICE, "--seed", str(LM_TRAIN_SEED),
        "--steps", str(steps), "--lm-batch", str(b), "--lm-seq", str(s),
        "--dist", "gloo", "--workers", str(w), "--model-axis", str(m),
        "--log-every", "1", "--ckpt-every", str(steps + 1), "--ckpt-dir",
        tmp, *flags, *extra])


def _flag(flags, name, value):
    """``flags`` with ``name``'s value replaced by ``value``."""
    flags = list(flags)
    if name in flags:
        flags[flags.index(name) + 1] = value
        return flags
    return flags + [name, value]


def _loss_of(model, batch):
    return model.loss(batch)


def _mesh_collectives(mesh, n):
    """Each axis's collective counters per step over ``n`` steps."""
    return {axis: mesh_collectives(g, n)
            for axis, g in mesh.groups().items()}


def train_mesh_single(torch, arch, ref):
    """One process's float32 ``make_train_step`` of the cut on the card
    (the gather path, no mesh) up to its gradients: each leaf's to
    ``ref/<i>.g.npy``; the loss, the grad norm ``apply_grads`` would
    clip by, the leaves' largest |g| and the step's learning rate to
    ``ref/single.json`` (its update is elementwise: a rank recomputes it
    on its slice from these, bit for bit the step's)."""
    import numpy as np
    from repro_torch.convert import lm_leaves
    from repro_torch.core.config import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import layers, zoo
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import global_norm
    cut = dataclasses.replace(get_lm_config(arch), **LM_TRAIN_CUT[arch])
    steps = TRAIN_MESH[arch][6]
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps)
    saved, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, torch.float32
    try:
        api = zoo.build(cut, DEVICE)
        model = api.init(LM_TRAIN_SEED)
        flat, layout = lm_leaves(model)
        batch = train.lm_batch(np.random.default_rng(LM_TRAIN_SEED), cut,
                               TRAIN_MESH_CUT_B, LM_TRAIN_CUT_S, DEVICE)
        loss, grads = TL.microbatch_grads(
            TL.module_loss(model, api.loss, layout.names),
            [p.detach() for p in flat], batch, 1)
        del flat
        gnorm = global_norm(grads)
        scales = []
        for i, g in enumerate(layout.group(grads)):
            scales.append(g.abs().max().item())
            np.save(os.path.join(ref, f"{i}.g.npy"), g.cpu().numpy())
            del g
        out = {"loss": loss.item(), "grad_norm": gnorm.item(),
               "scales": scales,
               "lr1": tcfg.learning_rate / tcfg.warmup_steps}
        with open(os.path.join(ref, "single.json"), "w") as f:
            json.dump(out, f)
    finally:
        layers.COMPUTE_DTYPE = saved
    del model, grads
    torch.cuda.empty_cache()
    return out


def get_lm_config(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def _owned(lf, coords):
    """True where a rank counts a leaf's slice once for the mesh (a leaf
    whole on an axis counts on that axis's rank 0)."""
    dr, mr = coords
    return ((lf.data_dim is not None or dr == 0)
            and (lf.model_cut is not None or mr == 0))


def _chunks(a, b, n=1 << 24):
    """Aligned chunks of ``n`` elements of two tensors of one shape, each
    pair on ``a``'s device (a comparison's temporaries stay a chunk's
    size on the crowded card, and the host's cores do no arithmetic)."""
    return ((x, y.to(x.device)) for x, y in zip(a.reshape(-1).split(n),
                                                 b.reshape(-1).split(n)))


def _gaps_vs(torch, plan, got, want_of, scales=None):
    """Per leaf, ``max |got - want|`` (``want_of(i, lf)`` the rank's slice
    of the reference's leaf ``i``) as a share of ``scales[i]`` (default
    the largest |want| over the mesh), compared a chunk at a time on
    ``got``'s device; returns ``(worst share, path)``."""
    errs, maxima = [], []
    for i, (lf, g) in enumerate(zip(plan.leaves, got)):
        e = mx = 0.0
        for x, y in _chunks(g, want_of(i, lf)):
            e = max(e, (x - y).abs().max().item())
            mx = max(mx, y.abs().max().item())
        errs.append(e)
        maxima.append(mx)
    world = plan.mesh.world
    errs = world.all_reduce(torch.tensor([errs], device=world.device),
                            "max")[0]
    if scales is None:
        scales = world.all_reduce(torch.tensor([maxima],
                                               device=world.device),
                                  "max")[0].tolist()
    worst = (0.0, None)
    for lf, e, sc in zip(plan.leaves, errs.tolist(), scales):
        share = e / max(sc, 1e-30)
        if share > worst[0]:
            worst = (share, "/".join(lf.path))
    return worst


def _param_gaps(torch, plan, got, want_of, lr1):
    """The new params' largest gap, and the weights apart by over
    ``lr1 / 100`` and all weights (each counted once over the mesh)."""
    gap = 0.0
    flips = n = 0
    for i, (lf, p) in enumerate(zip(plan.leaves, got)):
        for x, y in _chunks(p, want_of(i, lf)):
            d = (x - y).abs()
            gap = max(gap, d.max().item())
            if _owned(lf, plan.mesh.coords):
                flips += int((d > lr1 / 100).sum())
                n += d.numel()
    world = plan.mesh.world
    gap = world.all_reduce(torch.tensor([[gap]], device=world.device), "max")
    counts = world.all_reduce(torch.tensor([[flips, n]], dtype=torch.int64,
                                           device=world.device))
    return gap.item(), int(counts[0, 0]), int(counts[0, 1])


@contextlib.contextmanager
def _timed_calls(owner, names, into):
    """Inside the block, each function ``owner.<name>`` (a method where
    ``owner`` is a class) appends each call's seconds to ``into[name]``."""
    real = {n: getattr(owner, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            got = fn(*a, **kw)
            into.setdefault(name, []).append(time.perf_counter() - t0)
            return got
        return timed
    try:
        for n, fn in real.items():
            setattr(owner, n, wrap(n, fn))
        yield
    finally:
        for n, fn in real.items():
            setattr(owner, n, fn)


def train_mesh_rank(group, arch, out, ref, t_launch):
    """A rank of the lm train mesh phase (``launch.mesh``'s target): the
    bf16 cell through ``train_lm`` (step times and their parts,
    launches, collectives by axis, peak), one forward and
    backward of its last params (gathered once, the moments dropped)
    under each remat setting (peaks), then the float32 cut
    (``train_mesh_cut``); results to ``out/rank<r>.json``, with the
    seconds since ``t_launch`` (the phase's ``time.time()`` at the
    launch) at the rank's start and end."""
    started = time.time() - t_launch
    import numpy as np
    import torch
    from repro_torch.core.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train import train_loop as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    depth, w, m, flags, b, s, steps = TRAIN_MESH[arch]
    cfg = get_lm_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    dev, r = group.device, group.rank
    res = {"rank": r, "device": str(dev), "started_s": started}
    # each step's seconds in the step's parts (gather, differentiate,
    # reduce, update), its collectives and the growth of the staging
    # buffers: the calls' lists cut at each step's end
    calls, marks, seen, coll_s = {}, [], set(), []
    args = train_mesh_args(arch, flags, b, s, steps, out)
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times, t_last = [], [time.perf_counter()]

    def clock(t):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        times.append((now - t_last[0]) * 1e3)
        print(f"[{arch} rank {r}] step {t}: {times[-1]:.1f} ms; allocated "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}, "
              f"reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f}",
              flush=True)
        t_last[0] = now
        marks.append({k: len(v) for k, v in calls.items()})
        coll_s.append(sum(st["seconds"] + st["staging_s"] for g in seen
                          for st in g.stats.values()))
    from repro_torch.core import collectives
    from repro_torch.train import fsdp
    real_run = collectives.ProcessWorkers._run

    def spy_run(self, *a):
        seen.add(self)
        return real_run(self, *a)
    collectives.ProcessWorkers._run = spy_run
    with launch_config(cfg, train), twin_calls() as twin, _timed_calls(
            TL, ("mesh_grads", "apply_grads"), calls), _timed_calls(
            fsdp.ShardPlan, ("gather", "reduce"), calls), _timed_calls(
            collectives, ("_pinned",), calls):
        try:
            run = train.train_lm(args, group=group, step_hook=clock)
        finally:
            collectives.ProcessWorkers._run = real_run
    res["step_split_s"] = [
        {**{k: sum(v[(marks[t - 1].get(k, 0) if t else 0):
                     marks[t].get(k, 0)]) for k, v in calls.items()},
         "collectives": coll_s[t] - (coll_s[t - 1] if t else 0.0)}
        for t in range(len(marks))]
    plan, state, layout = run["plan"], run["state"], run["layout"]
    lm = plan.mesh
    res["steps_wall_s"] = run["wall_s"]
    res.update(step_ms=times, losses=run["losses"],
               grad_norms=run["grad_norms"], launches=ops.launch_counts(),
               ssd_routes=ops.ssd_route_counts(), twin_calls=twin,
               collectives=_mesh_collectives(lm, steps),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
               coords=list(lm.coords),
               state_gb=sum(t.numel() * 4 for t in state.params) / 2**30)
    # one forward and backward of the last state under each remat setting
    batch = train.data_rows(train.lm_batch(np.random.default_rng(
        LM_TRAIN_SEED), cfg, b, s, dev), cfg, lm)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=steps)
    res["remat_peak_gb"] = {}
    t0 = time.perf_counter()

    def remat_peak(remat):
        fn = TL.module_loss(lm_shell(dataclasses.replace(cfg, remat=remat)),
                            _loss_of, layout.names)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        loss, grads = TL.mesh_grads(fn, tcfg, layout, plan, whole, batch)
        torch.cuda.synchronize(dev)
        res["remat_peak_gb"][remat] = (torch.cuda.max_memory_allocated(dev)
                                       / 2**30)
        del loss, grads
        torch.cuda.empty_cache()
    with train.lm_settings(args, lm, cfg):
        whole = plan.gather(state.params)
        del state, run
        torch.cuda.empty_cache()
        for remat in ("full", "dots"):
            remat_peak(remat)
        # remat none keeps every activation: the ranks of one data
        # coordinate at a time (four ranks' passes do not fit the card)
        for turn in range(lm.data.world):
            if lm.coords[0] == turn:
                remat_peak("none")
            lm.world.all_reduce(torch.zeros((1, 1), device=dev))
    del whole, batch
    res["remat_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    res.update(train_mesh_cut(torch, arch, flags, lm, ref, out))
    res["done_s"] = time.time() - t_launch
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def train_mesh_cut(torch, arch, flags, lm, ref, out):
    """The float32 cut's gates on this rank (``train_mesh_rank``), the
    leaves gathered once: (EP cells) EP's gradient shares on the card and
    on the CPU (over CPU views of the same gloo groups, from the card's
    gathered leaves); the gather path's (remat full), remat none's and
    dots' held to them; then the gather path's sync and update held to
    one process's (``ref``).  The zero moments are made again for the
    update: four ranks' cut states, leaves and two sets of gradients
    would not fit the card beside them."""
    import numpy as np
    from repro_torch.convert import lm_leaves
    from repro_torch.core.config import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import layers, zoo
    from repro_torch.train import train_loop as TL
    from repro_torch.train.fsdp import ShardPlan
    from repro_torch.train.optimizer import adam_update, init_adam
    dev = lm.world.device
    steps = TRAIN_MESH[arch][6]
    res = {"split_s": {}}
    t_lap = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        res["split_s"][name] = now - t_lap[0]
        t_lap[0] = now
    cut = dataclasses.replace(get_lm_config(arch), **LM_TRAIN_CUT[arch],
                              remat="full")
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps)
    single = read_json(os.path.join(ref, "single.json"))

    def cut_args(moe_impl):
        fl = _flag(_flag(flags, "--moe", moe_impl), "--remat", "full")
        return train_mesh_args(arch, fl, TRAIN_MESH_CUT_B, LM_TRAIN_CUT_S,
                               1, out)
    gargs = cut_args("gather")
    saved, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, torch.float32
    try:
        with train.lm_settings(gargs, lm, cut):
            model = zoo.build(cut, dev).init(LM_TRAIN_SEED)
            params, layout = lm_leaves(model)
            plan = ShardPlan(layout, lm, cut.fsdp_params)
            p0 = TL.init_state(params, tcfg, layout, plan).params
            del params
            model.to_empty(device="meta")
            batch = train.data_rows(train.lm_batch(
                np.random.default_rng(LM_TRAIN_SEED), cut, TRAIN_MESH_CUT_B,
                LM_TRAIN_CUT_S, dev), cut, lm)
        lap("cut_init")
        whole = plan.gather(p0)
        lap("cut_gather")
        if "ep_a2a" in flags:
            res["ep"] = train_mesh_ep(torch, cut_args("ep_a2a"), lm, cut,
                                      tcfg, layout, plan, whole, batch,
                                      model)
            lap("cut_ep")
        with train.lm_settings(gargs, lm, cut):
            loss, full = TL.mesh_grads(
                TL.module_loss(model, _loss_of, layout.names), tcfg, layout,
                plan, whole, batch)
            # remat none and dots against full: each rank's shares
            res["remat_gap"] = {}
            for remat in ("none", "dots"):
                shell = lm_shell(dataclasses.replace(cut, remat=remat))
                _, g = TL.mesh_grads(TL.module_loss(shell, _loss_of,
                                                    layout.names),
                                     tcfg, layout, plan, whole, batch)
                res["remat_gap"][remat] = _gaps_vs(
                    torch, plan, g, lambda i, lf: full[i])
                del g
        del whole
        lap("cut_grads")
        loss = plan.mean_loss(loss)
        grads = plan.reduce(full)
        lap("cut_reduce")
        state = TL.TrainState(params=p0, opt=init_adam(p0), error=None)
        new, metrics = TL.apply_grads(tcfg, state, loss, grads, layout, plan)
        res["gather"] = {"loss": loss.item(), "loss_single": single["loss"],
                         "grad_norm": metrics["grad_norm"].item(),
                         "grad_norm_single": single["grad_norm"]}
        new = new.params

        def ref_g(i, lf):
            a = np.load(os.path.join(ref, f"{i}.g.npy"), mmap_mode="r")
            return torch.from_numpy(np.ascontiguousarray(plan.take(lf, a)))
        g_ref = [ref_g(i, lf) for i, lf in enumerate(plan.leaves)]
        res["gather"]["grad_gap"] = _gaps_vs(
            torch, plan, grads, lambda i, lf: g_ref[i], single["scales"])
        del grads
        # one process's update of the rank's slice, from its gradient and
        # norm: AdamW is elementwise, so these are its step's own values
        norm = torch.tensor(single["grad_norm"], device=dev)
        p_ref, _, _ = adam_update(tcfg, state.params,
                                  [g.to(dev) for g in g_ref], state.opt,
                                  lambda _: norm)
        del state, g_ref
        res["gather"]["params"] = _param_gaps(
            torch, plan, new, lambda i, lf: p_ref[i], single["lr1"])
        del new, p_ref
        lap("cut_compare")
    finally:
        layers.COMPUTE_DTYPE = saved
    return res


def train_mesh_ep(torch, eargs, lm, cut, tcfg, layout, plan, whole, batch,
                  model):
    """EP's float32 cut step on the card, then on the CPU over CPU views
    of the same gloo groups from the card's gathered leaves: each rank's
    loss and gradient shares before the sync (the sync's sums are the
    same arithmetic on both), card against CPU."""
    from repro_torch.core.collectives import ProcessWorkers
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.train import train_loop as TL
    from repro_torch.train.fsdp import ShardPlan
    t0 = time.perf_counter()
    with train.lm_settings(eargs, lm, cut), moe.tally() as t_card:
        loss, grads = TL.mesh_grads(
            TL.module_loss(model, _loss_of, layout.names), tcfg, layout,
            plan, whole, batch)
        loss = loss.item()
    card_s = time.perf_counter() - t0
    cpu = lmesh.Mesh(*(ProcessWorkers("gloo", g.world, g.rank, "cpu", g.pg)
                       for g in (lm.world, lm.data, lm.model)))
    cplan = ShardPlan(layout, cpu, cut.fsdp_params)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // lm.world.world))
    t0 = time.perf_counter()
    try:
        with train.lm_settings(eargs, cpu, cut), moe.tally() as t_cpu:
            closs, cgrads = TL.mesh_grads(
                TL.module_loss(lm_shell(cut), _loss_of, layout.names), tcfg,
                layout, cplan, [x.cpu() for x in whole],
                {k: v.cpu() for k, v in batch.items()})
            closs = closs.item()
    finally:
        torch.set_num_threads(threads)
    cpu_s = time.perf_counter() - t0
    rel = abs(loss - closs) / max(abs(closs), 1e-30)
    rel = lm.world.all_reduce(torch.tensor([[rel]], device=lm.world.device),
                              "max").item()
    return {"loss": loss, "loss_cpu": closs, "loss_rel_max": rel,
            "card_s": card_s, "cpu_s": cpu_s,
            "grad_gap": _gaps_vs(torch, plan, grads,
                                 lambda i, lf: cgrads[i]),
            "dispatch_card": dict(t_card), "dispatch_cpu": dict(t_cpu)}


def phase_lm_train_mesh(torch, smi):
    """LM training over the mesh (``TRAIN_MESH``): per cell, one process's
    float32 step on the cut first (``train_mesh_single``), then the ranks
    (``train_mesh_rank``); the gates: every rank exits 0 with finite
    losses and grad norms, zamba2's ranks launch ``ssd_scan`` at every
    Mamba layer's forward and again in its recompute on every step (no
    twin call, qwen3's ranks no kernel: training takes the plain
    attention), the float32 cut's gather-path step within the one
    process's bounds, remat none and dots within TRAIN_MESH_REMAT_RTOL of
    full, EP's card step within the CPU's.  Prints each rank's step
    times, collectives by axis and kind, and peaks beside ``smi``."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    out = {}
    for arch in TRAIN_MESH:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mesh")
        try:
            out[arch] = train_mesh_cell(torch, arch, smi, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[lm train mesh] phase {out['seconds']:.1f} s")
    return out


def train_mesh_cell(torch, arch, smi, tmp):
    """One ``TRAIN_MESH`` cell's runs and gates (``phase_lm_train_mesh``);
    the ranks' files in ``tmp``."""
    t0 = time.perf_counter()
    depth, w, m, flags, b, s, steps = TRAIN_MESH[arch]
    cfg = get_lm_config(arch)
    n_layers = cfg.n_layers if depth is None else depth
    label = f"lm train mesh {arch} ({w // m}, {m})"
    ref = os.path.join(tmp, "single")
    os.makedirs(ref)
    single = train_mesh_single(torch, arch, ref)
    single_s = time.perf_counter() - t0
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.path.join(ROOT, "src"), env.get("PYTHONPATH"))
        if p)
    # the ranks share the card: growable segments keep the allocator's
    # fragments from adding up over four processes
    env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[{label}] before the ranks: {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB free on the card, this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    t_launch = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh", "--workers",
         str(w), "--dist", "gloo", "--device", DEVICE, "--timeout",
         str(TRAIN_MESH_TIMEOUT_S), TRAIN_MESH_TARGET,
         json.dumps({"arch": arch, "out": tmp, "ref": ref,
                     "t_launch": t_launch})],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=TRAIN_MESH_TIMEOUT_S + 60)
    launcher_s = time.time() - t_launch
    print(proc.stdout, end="", flush=True)
    errors = [ln for ln in proc.stderr.splitlines()
              if "Error" in ln or "error" in ln][:12]
    check(proc.returncode == 0, f"{label}: the ranks exited "
          f"{proc.returncode}; first errors:\n" + "\n".join(errors)
          + f"\n{proc.stderr[-2000:]}")
    ranks = [read_json(os.path.join(tmp, f"rank{r}.json"))
             for r in range(w)]
    mamba = n_layers if cfg.family in ("ssm", "hybrid") else 0
    for rk in ranks:
        rl = f"{label} rank {rk['rank']} {tuple(rk['coords'])}"
        check(all(map(math.isfinite, rk["losses"] + rk["grad_norms"]))
              and len(rk["losses"]) == steps,
              f"{rl}: losses {rk['losses']}, grad norms {rk['grad_norms']}")
        want = {k: 0 for k in rk["launches"]}
        want["ssd_scan"] = mamba * 2 * steps
        check(rk["launches"] == want and rk["twin_calls"]["ssd_scan_ref"] == 0,
              f"{rl}: launches {rk['launches']} (twin "
              f"{rk['twin_calls']}), expected {want}: {mamba} ssd_scan a "
              f"forward and as many in the remat recompute, {steps} steps")
        print(f"[{label}] rank {rk['rank']} at {tuple(rk['coords'])} "
              f"({rk['device']}): {n_layers} layers, {b} x {s} bf16 tokens, "
              f"{' '.join(flags)}; step ms "
              f"{[round(t, 1) for t in rk['step_ms']]}; losses "
              f"{[round(x, 5) for x in rk['losses']]}, grad norms "
              f"{[round(x, 5) for x in rk['grad_norms']]}; stored state "
              f"{rk['state_gb']:.2f} GiB, peak {rk['peak_gb']:.2f} GiB; "
              f"one forward + backward's peak by remat "
              f"{ {k: round(v, 2) for k, v in rk['remat_peak_gb'].items()} } "
              f"GiB; launches {rk['launches']}; card: {smi}")
        for axis, kinds in rk["collectives"].items():
            for kind, st in kinds.items():
                print(f"[{label}] rank {rk['rank']} {axis} {kind} per step: "
                      f"{st['calls']:.0f} calls, {st['bytes'] / 1e6:.1f} MB "
                      f"sent, transport {st['seconds'] * 1e3:.1f} ms, "
                      f"staging {st['staging_s'] * 1e3:.1f} ms ({smi})")
    # the float32 cut: every rank reports the mesh-wide maxima
    rk = ranks[0]
    g = rk["gather"]
    lr1 = single["lr1"]
    bound = 2 * lr1 + 2.0 ** -22
    pgap, flips, n_w = g["params"]
    print(f"[{label}] float32 cut ({dict(LM_TRAIN_CUT[arch])}, "
          f"{TRAIN_MESH_CUT_B} x {LM_TRAIN_CUT_S} tokens), the gather path "
          f"over the mesh vs one process on the card: loss {g['loss']:.7f} "
          f"vs {g['loss_single']:.7f}, grad norm {g['grad_norm']:.6f} vs "
          f"{g['grad_norm_single']:.6f}; gradients within "
          f"{g['grad_gap'][0]:.3e} of each leaf's largest |g| (worst "
          f"{g['grad_gap'][1]}; bound {LM_TRAIN_GRAD_RTOL}); params after "
          f"the step within {pgap:.3e} (bound {bound:.4e}), {flips} of {n_w} "
          f"over lr(1) / 100; remat none / dots vs full "
          f"{ {k: v for k, v in rk['remat_gap'].items()} }; one process's "
          f"step {single_s:.1f} s; rank 0's seconds: steps "
          f"{rk['steps_wall_s']:.1f}, remat passes {rk['remat_s']:.1f}, the "
          f"cut { {k: round(v, 1) for k, v in rk['split_s'].items()} }; "
          f"each step's parts "
          f"{[{k: round(v, 2) for k, v in st.items()} for st in rk['step_split_s']]} "
          f"(collectives: their transport and staging; _pinned: the "
          f"staging buffers' growth); the ranks started {max(x['started_s'] for x in ranks):.1f} s "
          f"after the launch and ended after "
          f"{max(x['done_s'] for x in ranks):.1f} s, the launcher returned "
          f"after {launcher_s:.1f} s; card: {smi}")
    check(abs(g["loss"] - g["loss_single"]) <= LM_TRAIN_LOSS_RTOL
          * abs(g["loss_single"]), f"{label}: float32 loss {g['loss']} vs "
          f"one process's {g['loss_single']}")
    check(g["grad_gap"][0] <= LM_TRAIN_GRAD_RTOL, f"{label}: gradient "
          f"{g['grad_gap'][1]} {g['grad_gap'][0]} of its scale from one "
          f"process's")
    check(pgap <= bound and flips <= LM_TRAIN_FLIP_SHARE * n_w,
          f"{label}: params {pgap} apart (bound {bound}), {flips} of {n_w} "
          f"over lr(1) / 100")
    for k, (gap, path) in rk["remat_gap"].items():
        check(gap <= TRAIN_MESH_REMAT_RTOL, f"{label}: remat {k}'s gradient "
              f"{path} {gap} of its scale from full's")
    res = {"workers": w, "model_axis": m, "flags": list(flags),
           "n_layers": n_layers, "batch": b, "seq": s, "steps": steps,
           "ranks": ranks, "single": {k: v for k, v in single.items()
                                      if k != "scales"},
           "launches": {"ssd_scan": sum(x["launches"].get("ssd_scan", 0)
                                        for x in ranks)},
           "device": smi}
    if "ep" in rk:
        e = rk["ep"]
        print(f"[{label}] float32 cut, EP over the mesh: card vs the same "
              f"ranks on the CPU, each rank's loss and gradient shares "
              f"before the sync: rank 0's loss {e['loss']:.7f} vs "
              f"{e['loss_cpu']:.7f} (over the ranks within "
              f"{e['loss_rel_max']:.3e} relative); gradients within "
              f"{e['grad_gap'][0]:.3e} of each leaf's largest |g| (worst "
              f"{e['grad_gap'][1]}); dispatch card {e['dispatch_card']} / "
              f"CPU {e['dispatch_cpu']}; card {e['card_s']:.1f} s, CPU "
              f"{e['cpu_s']:.1f} s; card: {smi}")
        check(e["loss_rel_max"] <= LM_TRAIN_LOSS_RTOL, f"{label}: EP loss "
              f"card vs CPU {e['loss_rel_max']} apart")
        check(e["grad_gap"][0] <= LM_TRAIN_GRAD_RTOL, f"{label}: EP "
              f"gradient {e['grad_gap'][1]} card vs CPU {e['grad_gap'][0]}")
    res["seconds"] = time.perf_counter() - t0
    print(f"[{label}] {res['seconds']:.1f} s")
    return res


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


# ------------------------------------------------ dry-run and examples --
#: the dry-run's memory prediction (arguments + temp) against the card's
#: max_memory_allocated above the baseline: within this share
DRYRUN_MEM_RTOL = 0.10
#: production cells traced on the host: (arch, dryrun.lower_cell keywords)
DRYRUN_CELLS = (("graphgen-gcn", {}),
                ("qwen3-moe-30b-a3b", {"moe_impl": "ep_a2a"}))


def dryrun_prefill(torch, cfg, kernel, per_forward):
    """Trace ``cfg``'s prefill at the LM phase's shape with the dry-run
    at mesh 1 x 1, then run the same forward on the card and hold the
    prediction to it: ``kernel``'s calls (``per_forward``) against the
    real launches, the aten FLOPs against ``FlopCounterMode`` of the real
    forward, the argument bytes against the parameters' and inputs' real
    bytes (exactly) and arguments + temp against the peak the caching
    allocator saw above the baseline (within ``DRYRUN_MEM_RTOL``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.config import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, trace_analysis
    from repro_torch.models import zoo
    shape = ShapeConfig(f"prefill_{PREFILL_B}x{PREFILL_S}", "prefill",
                        PREFILL_S, PREFILL_B)
    rec = dryrun.lower_cell(cfg.name, shape.name, mesh=(1, 1), shape=shape,
                            cfg=cfg)
    check(rec["status"] == "ok", f"dry-run of {cfg.name}: {rec}")
    model = zoo.build(cfg, DEVICE).init(0)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (PREFILL_B,
                                                         PREFILL_S),
                                     generator=gen, dtype=torch.int32,
                                     device=DEVICE)}
    # a warm forward first: cuBLAS's workspace and the first call's
    # allocations belong to the baseline, not to the step
    warm = zoo.forward_logits(cfg, model, batch)
    del warm
    torch.cuda.synchronize()
    real_args = trace_analysis.storage_bytes(
        (list(model.parameters()) + list(model.buffers()), batch))
    base = torch.cuda.memory_allocated() - real_args
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits = zoo.forward_logits(cfg, model, batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    del logits
    with FlopCounterMode(display=False) as fc:
        zoo.forward_logits(cfg, model, batch)
    real_flops = fc.get_total_flops()
    mem = rec["memory"]
    pred = mem["argument_bytes"] + mem["temp_bytes"]
    calls = rec["kernels"].get(kernel, {}).get("calls", 0)
    print(f"[dryrun {cfg.name} prefill {PREFILL_B}x{PREFILL_S}] traced in "
          f"{rec['t_lower_s']:.2f} s: {kernel} {calls} calls predicted, "
          f"{launches[kernel]} launched; aten FLOPs {rec['aten_flops']} "
          f"predicted, {real_flops} counted on the card; argument bytes "
          f"{mem['argument_bytes']} predicted, {real_args} real; arguments "
          f"+ temp {pred} B predicted, peak above baseline {peak} B "
          f"(ratio {pred / peak:.4f}); kernels {rec['kernels']}")
    check(calls == launches[kernel] == per_forward,
          f"dry-run {cfg.name}: {calls} {kernel} calls predicted, "
          f"{launches[kernel]} launched, {per_forward} expected")
    check(rec["aten_flops"] == real_flops,
          f"dry-run {cfg.name}: aten FLOPs {rec['aten_flops']} predicted, "
          f"{real_flops} counted")
    check(mem["argument_bytes"] == real_args,
          f"dry-run {cfg.name}: argument bytes {mem['argument_bytes']} "
          f"predicted, {real_args} real")
    check(abs(pred / peak - 1) <= DRYRUN_MEM_RTOL,
          f"dry-run {cfg.name}: arguments + temp {pred} B against a peak of "
          f"{peak} B")
    del model, batch
    torch.cuda.empty_cache()
    return {"t_lower_s": rec["t_lower_s"], "calls": calls,
            "launches": launches, "aten_flops": rec["aten_flops"],
            "real_flops": real_flops, "argument_bytes": real_args,
            "predicted_bytes": pred, "peak_bytes": peak,
            "memory_ratio": pred / peak, "kernels": rec["kernels"]}


def dryrun_gcn_step(torch):
    """One pipelined step of graphgen-gcn-deep at W = 1 at the train
    phase's sizes, traced by the dry-run at mesh 1 x 1 and run on the
    card: the predicted calls of every kernel against the real launches."""
    from repro_torch.core.pipeline import make_pipelined_step
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, train
    from repro_torch.train.optimizer import init_adam
    arch = "graphgen-gcn-deep"
    run = train.build_gcn_run(train_args(arch, 1))
    cfg, b = run["cfg"], run["b"]
    gen_fn, dev_args, cache = run["gen_fn"], run["device_args"], run["cache"]
    with torch.no_grad():
        batch0, cache = gen_fn(dev_args, run["seeds_for"](0),
                               run["draws"](0, 1, b), cache)
    model = run["model"]
    carry = (model, init_adam(model.leaves()), batch0, cache)
    step = make_pipelined_step(gen_fn, run["train_fn"], cached=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    carry, loss = step(carry, dev_args, run["seeds_for"](1),
                       run["draws"](1, 1, b))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    rec = dryrun.lower_gcn_cell(
        {"arch": arch}, arch, False, mesh=(1, 1),
        n_nodes=dev_args[0].shape[1] - 1, n_edges=dev_args[1].shape[1],
        seeds=b, dims={k: getattr(cfg, k) for k in dryrun.GCN_DIMS},
        capacity_slack=run["slack"])
    calls = {k: r["calls"] for k, r in rec["kernels"].items()}
    print(f"[dryrun {arch} W=1 pipelined step] traced in "
          f"{rec['t_lower_s']:.2f} s: predicted calls {calls}, launched "
          f"{ {k: v for k, v in launches.items() if v} }; loss "
          f"{float(loss):.4f}")
    for name in set(calls) | {k for k, v in launches.items() if v}:
        check(calls.get(name, 0) == launches[name],
              f"dry-run {arch}: {calls.get(name, 0)} {name} calls "
              f"predicted, {launches[name]} launched")
    for name in ("fanout_mean", "fanout_mean_bwd", "cache_probe_tiered"):
        check(launches[name] > 0, f"dry-run {arch}: {name} never launched")
    return {"t_lower_s": rec["t_lower_s"], "calls": calls,
            "launches": launches}


def phase_dryrun(torch):
    """The dry-run (``launch/dryrun.py``) against the card: the smollm and
    mamba2 prefills and one GCN pipelined step, each traced and then run
    (``dryrun_prefill``, ``dryrun_gcn_step``); then two production cells
    traced on the host with their roofline rows (gate: status ok).
    Returns each check's figures (with its launches)."""
    from repro_torch.launch import dryrun, roofline
    t0 = time.perf_counter()
    out = {"smollm_prefill": dryrun_prefill(torch, lm_config(),
                                            "flash_attention", 30),
           "mamba2_prefill": dryrun_prefill(torch, ssm_config(), "ssd_scan",
                                            48),
           "gcn_step": dryrun_gcn_step(torch)}
    for arch, kw in DRYRUN_CELLS:
        rec = dryrun.lower_cell(arch, "train_4k", **kw)
        check(rec["status"] == "ok", f"dry-run {arch} train_4k: {rec}")
        row = roofline.analyse(rec)
        print(f"[dryrun {arch} train_4k 16x16 {kw}] traced in "
              f"{rec['t_lower_s']:.2f} s on {rec['trace_device']}; "
              f"collective bytes {rec['collective_bytes_per_device']}; "
              f"kernels {rec['kernels']}")
        print(roofline.markdown_table([row], rec["mesh"]))
        out[f"{arch} train_4k"] = {k: rec[k] for k in (
            "t_lower_s", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "memory", "kernels")}
        out[f"{arch} train_4k"]["step_bound_s"] = row["step_bound_s"]
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: sum(out[c]["launches"][k] for c in (
        "smollm_prefill", "mamba2_prefill", "gcn_step"))
        for k in KERNEL_META if k != "ssd_scan_f32"}
    return out


#: the examples' arch for the LM training example on the card: the SSD
#: kernel takes head dim 64 only, so the default zamba2 smoke config (16)
#: is refused there (no fallback); the dense smoke arch runs as it is
EXAMPLE_TRAIN_ARCH = "smollm-135m"


def phase_examples(torch):
    """Each example's ``main(device="cuda")`` in this process, gated on
    its own claims: the GCN losses fall, the recovery resumes at the
    failure's checkpoint on 4 workers and ends at step 40, every served
    sequence has its tokens, the LM trains its steps on its tokens.
    Returns per example its figures and launches."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import distributed_pipeline_torch
    import quickstart_torch
    import serve_lm_torch
    import train_lm_smoke_torch
    from repro_torch.kernels import ops
    out = {}

    def run(name, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        res["launches"] = ops.launch_counts()
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        print(f"[examples {name}] {res['seconds']:.1f} s, launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }")
        return res

    qs = run("quickstart", lambda: quickstart_torch.main(device=DEVICE))
    losses = qs["losses"]
    check(all(map(math.isfinite, losses)), "quickstart: a loss is not finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"quickstart: the loss did not fall: {losses}")
    check(qs["launches"]["fanout_mean"] == 3 * len(losses),
          f"quickstart: {qs['launches']['fanout_mean']} fanout_mean launches")
    dp = run("distributed_pipeline",
             lambda: distributed_pipeline_torch.main(device=DEVICE))
    check(dp["resumed_at"] == distributed_pipeline_torch.FAIL_AT
          and dp["final_workers"] == 4
          and dp["steps"] == distributed_pipeline_torch.TOTAL,
          f"distributed_pipeline: resumed at {dp['resumed_at']} on "
          f"{dp['final_workers']} workers, ended at step {dp['steps']}")
    dl = dp["losses"]
    check(sorted(dl) == [10, 20, 30, 40] and dl[40] < dl[10],
          f"distributed_pipeline: losses {dl}")
    check(dp["launches"]["cache_probe_compact"] > 0,
          "distributed_pipeline: the compact probe never launched")
    sv = run("serve_lm", lambda: serve_lm_torch.main(device=DEVICE))
    for arch in serve_lm_torch.ARCHS:
        toks = sv[arch]["tokens"]
        check(toks.shape == (serve_lm_torch.BATCH, serve_lm_torch.GEN),
              f"serve_lm {arch}: tokens of shape {toks.shape}")
    sv = {a: {"tok_s": sv[a]["tok_s"],
              "sample": sv[a]["tokens"][0][:10].tolist()}
          for a in serve_lm_torch.ARCHS} | {
        k: sv[k] for k in ("launches", "seconds")}
    out["serve_lm"] = sv
    tl = run("train_lm_smoke", lambda: train_lm_smoke_torch.main(
        device=DEVICE, arch=EXAMPLE_TRAIN_ARCH))
    steps = train_lm_smoke_torch.STEPS
    check(tl["steps"] == steps and tl["tokens"] == steps
          * train_lm_smoke_torch.B * train_lm_smoke_torch.S
          and all(map(math.isfinite, tl["losses"])),
          f"train_lm_smoke: {tl['steps']} steps, {tl['tokens']} tokens, "
          f"losses {tl['losses']}")
    out["launches"] = {k: sum(out[e]["launches"][k] for e in (
        "quickstart", "distributed_pipeline", "serve_lm", "train_lm_smoke"))
        for k in KERNEL_META if k != "ssd_scan_f32"}
    return out


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


def time_kernel(torch, name, inputs, kw, plain_reps=20):
    """Times, error and bound of one kernel at ``inputs`` (``ssd_scan_f32``:
    ``ssd_scan`` at float32 inputs).  The bound is the kernel's own
    ``<kernel>_work`` (the dry-run's count): each input byte read once and
    each output byte written once, at the operands' element sizes and the
    peak rate of their type; for the probes only the rows the hits need
    (data-dependent, counted here from the outputs)."""
    from repro_torch.kernels import (cache_gather, flash_attention,
                                     gather_reduce, ops, ref, ssd_scan)
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
        n_ops, n_bytes = gather_reduce.fanout_mean_work(m, k, d,
                                                        x.element_size())
    elif name == "cache_probe_gather":
        keys, rows, ids = inputs
        for a, b in zip(got, want):
            check(torch.equal(a, b), "gather probe differs from its twin at "
                  "the serve inputs")
        err = (got[1] - want[1]).abs().max().item()
        r, d = ids.shape[0], rows.shape[1]
        n_hit_rows = int(torch.unique(ids[got[0]]).numel())
        n_ops, n_bytes = cache_gather.cache_probe_gather_work(
            r, keys.numel(), d, kw["assoc"], rows.element_size(),
            hit_rows=n_hit_rows)
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
        n_ops, n_bytes = gather_reduce.fanout_mean_bwd_work(
            m, k, d, g.element_size())
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
        n_ops, n_bytes = cache_gather.cache_probe_tiered_work(
            r, k1.numel(), k2.numel(), d, kw["l1_assoc"], kw["l2_assoc"],
            r2.element_size(), hit_rows=n_hit_rows)
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
        n_ops, n_bytes = flash_attention.flash_attention_work(
            b, hq, lq, lk, dh, hkv, kw["causal"], q.element_size())
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
        # what the function needs (ssd_scan_work): C B^T over the causal
        # pairs once per (batch, chunk), shared by the heads; per head the
        # decay and scores x over the pairs; the inter-chunk read-out and
        # the state update after the first chunk only
        n_ops, n_bytes = ssd_scan.ssd_scan_work(b, l, h, p, n, kw["chunk"],
                                                x.element_size())
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
        n_ops, n_bytes = gather_reduce.gather_reduce_work(
            m, k, d, n_rows, item, kept=kept.numel(), distinct=n_distinct)
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
        kept = sum(bin(v & 0xFFFFFFFF).count("1")
                   for v in got[0].reshape(-1).tolist())
        n_ops, n_bytes = cache_gather.cache_probe_compact_work(
            h, w, r, keys.shape[1], d, kw["assoc"], kw["hit_cap"],
            rows.element_size(), kept=kept)
    ms, dev_ms = both_ms(torch, kern)
    plain_ms, plain_dev_ms = both_ms(torch, plain, reps=plain_reps)
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
    ap.add_argument("--zoo-only", action="store_true",
                    help="stop after the build and the lm zoo phase (a "
                         "first bring-up of the hybrid and MoE LMs)")
    ap.add_argument("--train-only", action="store_true",
                    help="stop after the build and the lm train phase (a "
                         "first bring-up of LM training)")
    ap.add_argument("--train-mesh-only", action="store_true",
                    help="stop after the build and the lm train mesh "
                         "phase (a first bring-up of training over the "
                         "LM's mesh)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="stop after the build and the lm mesh phase (a "
                         "first bring-up of the LM's model axis)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="stop after the build, the dryrun and the "
                         "examples phases (a first bring-up of the "
                         "dry-run on the card)")
    opts = ap.parse_args()
    # host tensors of 2 MB and more on transparent huge pages (torch's
    # CPU allocator madvises them): a fresh allocation's page faults cost
    # as much as the pass that fills it, and the float32 CPU references
    # (qwen3's AdamW over 1.87 G weights in the lm train phase, the CPU
    # decodes) allocate fresh memory at every op
    os.environ.setdefault("THP_MEM_ALLOC_ENABLE", "1")

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
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            thp = f.read().strip()
    except OSError:
        thp = "unknown"
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; transparent huge "
          f"pages {thp}, THP_MEM_ALLOC_ENABLE="
          f"{os.environ.get('THP_MEM_ALLOC_ENABLE')}")

    t0 = time.perf_counter()

    def stamp(name):
        print(f"[time] {name} phase done {time.perf_counter() - t0:.1f} s "
              f"after the build began")
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    phase_build_report(lib_path)

    if opts.zoo_only:
        print(json.dumps({"lm_zoo": phase_lm_zoo(torch)}))
        print("[zoo-only] stopping after the lm zoo phase")
        return
    if opts.train_only:
        print(json.dumps({"lm_train": phase_lm_train(torch, smi)}))
        print("[train-only] stopping after the lm train phase")
        return
    if opts.train_mesh_only:
        print(json.dumps({"lm_train_mesh": phase_lm_train_mesh(torch, smi)}))
        print("[train-mesh-only] stopping after the lm train mesh phase")
        return
    if opts.mesh_only:
        print(json.dumps({"lm_mesh": phase_lm_mesh(torch, smi)}))
        print("[mesh-only] stopping after the lm mesh phase")
        return
    if opts.dryrun_only:
        dry = phase_dryrun(torch)
        stamp("dryrun")
        ex = phase_examples(torch)
        stamp("examples")
        print(json.dumps({"dryrun": dry, "examples": ex}, default=str))
        print("[dryrun-only] stopping after the dryrun and examples phases")
        return
    phase_kernels(torch, dev)
    if opts.dist_only:
        phase_dist(torch)
        phase_dist_paths(torch)
        phase_nccl(torch)
        print("[dist-only] stopping after the process backend's phases")
        return
    if opts.kernels_only:
        print(json.dumps({"flash_dh160": phase_flash(torch, dev)}))
        phase_ssd_kernels(torch, dev)
        print("[kernels-only] stopping after the kernel checks")
        return
    serve_res = phase_serve(torch)
    stamp("serve")
    train_res = phase_train(torch)
    stamp("train")
    phase_train_kernels(torch, train_res)
    stamp("train_kernels")
    host_res = phase_host(torch)
    stamp("host")
    phase_host_kernels(torch, host_res)
    stamp("host_kernels")
    merge_res = phase_merge(torch)
    stamp("merge")
    offline_res = phase_offline(torch, host_res)
    stamp("offline")
    ckpt_res = phase_ckpt(torch)
    stamp("ckpt")
    autotune_res = phase_autotune(torch)
    stamp("autotune")
    agree_at = phase_autotune_agree(torch)
    stamp("autotune_agree")
    baselines = phase_baselines(torch)
    stamp("baselines")
    recovery = phase_recovery(torch)
    stamp("recovery")
    dist_res = phase_dist(torch)
    stamp("dist")
    paths_res = phase_dist_paths(torch)
    stamp("dist_paths")
    nccl_res = phase_nccl(torch)
    stamp("nccl")
    flash_dh160 = phase_flash(torch, dev)
    stamp("flash")
    phase_ssd_kernels(torch, dev)
    stamp("ssd_kernels")
    prefill = phase_lm_prefill(torch)
    stamp("lm_prefill")
    lm_serve = phase_lm_serve(torch)
    stamp("lm_serve")
    ssm_prefill = phase_ssm_prefill(torch)
    stamp("ssm_prefill")
    ssm_serve = phase_ssm_serve(torch)
    stamp("ssm_serve")
    zoo_res = phase_lm_zoo(torch)
    stamp("lm_zoo")
    mesh_res = phase_lm_mesh(torch, smi)
    stamp("lm_mesh")
    lm_train = phase_lm_train(torch, smi)
    stamp("lm_train")
    train_mesh = phase_lm_train_mesh(torch, smi)
    stamp("lm_train_mesh")
    gather = phase_gather_reduce(torch, serve_res)
    stamp("gather_reduce")
    dry = phase_dryrun(torch)
    stamp("dryrun")
    examples = phase_examples(torch)
    stamp("examples")
    runs = (list(serve_res.values()) + list(train_res.values())
            + list(host_res.values()) + [merge_res]
            + list(offline_res.values()) + [ckpt_res]
            + list(autotune_res.values())
            + [agree_at, recovery, dist_res, paths_res, nccl_res]
            + [prefill, lm_serve, ssm_prefill, ssm_serve, gather]
            + [r for arch in ZOO_DEPTH for r in (zoo_res[arch],
                                                 zoo_res[arch]["serve"])]
            + [lm_train[arch] for arch in LM_TRAIN] + [mesh_res]
            + [train_mesh[arch] for arch in TRAIN_MESH]
            + [dry, examples])
    launches = {name: sum(r["launches"].get(name, 0) for r in runs)
                for name in KERNEL_META}
    # the float32 route of ssd_scan: its launches on the main path (0 in a
    # bf16 forward, which run_prefill requires)
    launches["ssd_scan_f32"] = sum(r.get("ssd_routes", {}).get("float32", 0)
                                   for r in runs)
    phase_agree(torch, dev)
    stamp("agree")
    phase_agree_train(torch, dev)
    stamp("agree_train")
    kernels, floor = phase_timing(torch, serve_res, train_res, launches,
                           prefill["qkv"], ssm_prefill["ssd_inputs"],
                           gather["inputs"])
    stamp("timing")
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
        for label, r in autotune_res.items()},
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
    print(json.dumps({"flash_dh160": flash_dh160}))
    print(json.dumps({"lm_zoo": zoo_res}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"lm_mesh": mesh_res}))
    print(json.dumps({"lm_train_mesh": train_mesh}))
    print(json.dumps({"dryrun": dry, "examples": examples}, default=str))
    # the kernels at the zoo's own layer-0 operands, beside their rows
    for entry in kernels:
        rows = {arch: {k: zoo_res[arch]["kernels"][entry["name"]][k] for k in (
            "shapes", "strides", "max_abs_err", "ms", "device_ms",
            "plain_ms", "plain_device_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")}
            for arch in ZOO_DEPTH
            if entry["name"] in zoo_res[arch]["kernels"]}
        if rows:
            entry["zoo"] = rows
        if entry["name"] == "flash_attention":
            entry["mesh"] = mesh_res["flash"]
    print(json.dumps({"timing_floor": {"null_launch": "a 4-byte zero_()",
                                       **floor}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
