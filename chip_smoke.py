#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LAQ (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to a plain version while a CUDA tensor is at hand):

1. Build the hand-written CUDA wire kernels with ``nvcc`` (sm_90a) from
   ``src/repro_torch/kernels/csrc`` and print the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card.
   ``absmax`` and ``quantize_pack_fused``: at the 12 leaf shapes of
   stablelm-1.6b, the 5 leaf shapes of phase 13's two models
   (``TABLE_LEAVES``) at b = 2, 4 and 8, a length that is not a multiple of
   8 or 4096, an unaligned operand, R == 0 and b in {1, 2, 4, 8}.
   Phase 15's shapes: the regression's w (50,) at b = 2, 4 and 8, the
   logistic w also at b = 1.  Phase 17's leaf (8, 4) at b = 2, 4 and 8,
   and at that leaf and at 1,000,003 elements, b = 4, the fault
   frontier's non-finite gradients: one NaN, one +inf and one -inf, all
   +inf and all NaN, NaN compared as NaN (moments too).
   ``quantize_pack_adaptive``: at those 18 leaf shapes for each width of
   the grid (2, 4, 8), the grid (2, 4) (4-bit lanes), a ragged length,
   R == 0 and a NaN input; a pinned width must equal
   ``quantize_pack_fused``.
   ``sparse_quantize_pack``: at k = 41,105,920 survivors (5% of
   stablelm-1.6b at the EF path's 8 layers, the k that path gives it),
   k = 82,213,376 (5% at 24 layers) and a ragged k, b in {1, 2, 4, 8},
   ef_frontier's top 196 of 7,840 at b = 1 and 2,
   lo == hi and lo far below the grid step.  R, codes, packed bytes, delta/deq and q_new must
   be bitwise equal; the moments agree to rtol 1e-5 (the kernel sums in
   float64 per thread, the plain version in float32).  Time each kernel,
   its plain version and a one-call PyTorch yardstick where there is one
   with CUDA events, at the largest leaf (276,824,064 elements) or at
   the EF path's k = 41,105,920, b=4.
3. Check the slice on a small input: smoke stablelm in float32, 12
   deterministic rounds each of LAQ, A-LAQ, A-LAQ with the tighter
   relative thresholds (0.5, 0.9) and EF-top-k on the card against the
   same runs on the CPU (plain versions): identical uploads, bits and
   widths, loss to rtol 1e-4.  The tighter A-LAQ run must launch
   quantize_pack_adaptive at widths 2 and 4 from inside the engine.
   ``repro_torch.random`` (the ``jax.random`` draws) must give the same
   bits on the card as on the CPU, in both threefry layouts, and
   ``run_stochastic`` (slaq, slaq_ps, qsgd, ssgd; 30 rounds of a small
   Table 3 regression) the same uploads, bits and mean bits.  The
   participation and robustness layer, card vs CPU: smoke stablelm (4
   rounds) under phase 9's three paths and a bernoulli run with
   undefended NaN corruption, crashes without reconciliation and the
   median; the 10-worker quadratic (30 rounds) under fixed_k, bernoulli,
   markov and delay participation with inf, sign-flip, bit-flip and
   scaling faults, crashes, validation, gate, clip and the trimmed mean.
   Uploads, bits and every worker's rejections equal.
   ``run_with_watchdog`` with escalation (a temporary directory) gives
   the same log on both; a checkpoint resume on the card equals the
   unbroken run, and so do the resumes of lasg_ps, delay and lasg_wk2 with
   SVRG and bernoulli sampling (their carries hold shared iterates), each
   holding no more ``torch.cuda.memory_allocated()`` after the load than
   the unbroken carry (both printed).  A NaN innovation under top-k: the
   support of 2^20 planted values (ties, NaN of both signs, +-inf), kernel 7 on its NaN
   and infinite grids, and the 10-worker quadratic under EF-top-k with
   NaN corruption (6 rounds, with validation and without), card vs CPU;
   the rejects must be the reference's.
4. The paths, each through ``RoundEngine.round`` with the kernels' launch
   counters zeroed just before it and read just after, on stablelm-1.6b at
   its published widths (d_model 2048, vocab 100352), float32 params and
   bfloat16 compute, W=4 workers with 2 x 512 tokens each,
   ``AccumulatingSource(deterministic, accum=2)``, lm_frontier's criterion
   and 1/t stepsize, alpha=0.5, on the fused wire:

   a. LAQ b=8, per-leaf radii, 24 layers, 4 rounds: absmax and
      quantize_pack_fused launch rounds x W x 12 times.
   b. A-LAQ (lm_frontier's ``alaq``: radius schedule on the grid (2, 4, 8),
      relative thresholds (0.05, 0.5)), 24 layers, 3 rounds: absmax and
      quantize_pack_adaptive launch rounds x W x 12 times, quantize_pack_fused
      never; round 1 uploads from every worker at width 8.  Kernel 4's
      launches are also reported by the width each worker selected (a
      worker that then skips has still quantized at that width).
   c. EF-top-k (lm_frontier's ``ef_topk``: b=4, top-k of 5% of the
      coordinates, error feedback), depth cut to 8 layers (the W residuals
      are 4 more model copies; 24 layers do not fit in 80 GB), 3 rounds:
      sparse_quantize_pack launches rounds x W times, the dense kernels
      never.

   Every loss must be finite, round 1 must upload from every worker, and
   each path's peak allocation must stay below 76 GB.
5. The sharded step (``launch/train.py`` ``make_train_step``) at full
   width: stablelm-1.6b at its published widths and depth, bfloat16
   params and compute, one worker on NCCL (world size 1), 2 x 512 tokens
   in 2 microbatches, sgd, the packed wire: 3 steps at b=4 and 3 with the
   adaptive schedule on the grid (2, 4, 8).  Per step over the 12 leaves:
   absmax 24 (12 in worker_update, 12 in the streamed wire), and
   quantize_pack_fused 12 + quantize_codes_fused 12 (fixed width) or
   quantize_pack_adaptive 12 + quantize_codes_adaptive 12 (adaptive).
   Then 3 steps each, at the same 24 layers, of the lazy rule lasg_wk2 with SVRG's streaming anchor (refreshed in
   steps 1 and 3) on the packed wire at b=4: the anchor's and the stale
   iterate's backprops at float32 iterates under bfloat16 compute, the
   same 24 + 12 + 12 launches a step; and of phase 4's EF-top-k (b=4, 5%)
   on the float wire: sparse_quantize_pack once a step, the dense kernels
   never.  Then b=4 with ``qhat`` and ``server_agg`` in bfloat16
   (``state_bf16``), 3 steps on each wire: the packed wire's launches as
   b=4's, the float wire's absmax 12 and quantize_pack_fused 12 a step;
   the two wires' parameters, losses, uploads and bits equal, the state
   bf16 after every step, each peak printed beside b=4's.  Losses
   finite, step 1 uploads, peak allocation below 76 GB.  First, the
   strategies of ``SHARDED_SMALL`` at smoke size, card vs CPU.
6. The exchange on the card: W=4 gloo ranks on the one card (payloads
   staged through pinned host memory; each rank is this script run as
   ``chip_smoke.py --exchange-rank RANK PORT OUT``, which writes its
   result to the JSON file OUT, and every rank is reaped before the
   phase ends), stablelm-1.6b at full width and 2
   layers, 3 steps each of the float wire and the packed wire at b=4 from
   the same parameters and batch, then 3 of each with bernoulli
   participation (p=0.5) and validation with the norm gate, then 2 of
   each under lasg_wk2 + SVRG (phase 5's) at 1 layer (four ranks' states
   at 2 layers do not fit in the card's memory), and 2 of each under
   lasg_wk2 + SVRG with bfloat16 state at 2 layers: the parameters must be
   bitwise equal between the two wires, and the uploads and bits equal
   step by step and on every rank.
7. The kernel rows of ``benchmarks_torch/bits_sweep.py``
   (``run_kernels``): kernels 3 and 8 at n = 2^20, b in {4, 8}, its rows
   printed.
8. Stochastic rounds at stablelm-1.6b's published widths, as phase 4 but
   with W=4 workers of 4 x 512 tokens and ``AccumulatingSource(batch=2,
   accum=2, seed=0)``, 3 rounds each: SLAQ (rule 7a, b=8) at 24 layers,
   lm_frontier's stochastic ``slaq`` (rule lasg_wk, b=4) at 8 layers (the
   W gradient EMAs), and the same-sample rule lasg_wk2 with SVRG anchors
   refreshed every 2 rounds (b=8) at 6 layers (the W stale iterates and W
   anchor gradients).  absmax and quantize_pack_fused launch rounds x W x
   12 times on each; the round-1 sampled indices are printed.  Losses
   finite, round 1 uploads from every worker, peak below 76 GB.
9. Participation and the robustness layer at stablelm-1.6b's widths, as
   phase 4 (W=4 of 2 x 512 tokens, b per path, 3 rounds): ``robust_full``
   (24 layers, b=8: fixed_k 3 of 4, -40x gradient scaling and
   crash-restart at p=0.25, validation, norm gate 4, clip 4, crash
   reconciliation), ``robust_sort`` (8 layers, b=4: Markov churn p=0.75
   with sojourn 8, MSB flips of 5% of the codes at p=0.5, validation,
   trimmed mean with t=1) and ``delay`` (8 layers, b=8, max_delay 2).
   The seeds (``ROBUST_SEEDS``) are checked against the deterministic
   masks first: an absent worker, crashes of reachable workers and a
   corrupted upload of a warm worker, which must be rejected.  absmax
   and quantize_pack_fused launch rounds x W x 12 times on each path,
   whoever was absent; losses finite; peak below 76 GB.
10. Serving at stablelm-1.6b's published widths.
   a. Serve: 24 layers, bfloat16 params and compute, random weights from
      seed 0; prompts of 8 x 512 tokens, ``max_len`` 576, 64 greedy tokens
      through ``launch/serve.py``'s ``jit_serve`` after a warm-up session.
      Prefill ms, decode ms per token (median), tokens/s, peak and the
      cache's shape and dtype, beside their bounds.  The first decode
      step's logits must equal ``stack.forward`` over prompt + token at
      the last position within ``SERVE_ATOL`` (bfloat16; measured 0.1016
      on the H100).
   b. Publish: phase 4's LAQ trainer (b=8) at 8 layers, 4 rounds, through
      ``launch/publish.py``'s ``trainer_rounds``, feeds ``core/replica.py``'s
      publisher (fused wire, b=4, threshold 0.25, max_staleness 1) and a
      ``ReplicaFleet`` of two replicas with ``max_delay=1``.  After each
      round replica 0 serves 8 x 512 prompts and 32 greedy tokens from its
      float32 weights at bfloat16 compute (a setting the JAX package cannot
      run).  Replica 0 equals ``theta_pub`` bitwise every round and replica
      1 the previous round's; absmax launches 12 per publish round and
      quantize_pack_fused 12 per push, counted as the ``publish`` path
      beside the trainer's ``publish_trainer``.  Peak below 76 GB.

11. The MoE family at qwen3-moe-30b-a3b's published widths (d_model 2048,
   128 experts of width 768, top-8, 32 heads over 4 kv heads of 128,
   qk-norm, vocab 151936), random weights from seed 0.
   a. Train: phase 4's LAQ (b=8; W=4 of 2 x 512 tokens, ``accum=2``,
      float32 params, bfloat16 compute, fused wire), depth cut to 1 layer
      (P = 1,245,452,544, 15 leaves; LAQ's copies of 2 layers would not
      fit in 80 GB), 3 rounds, counted as the ``moe`` path: absmax and
      quantize_pack_fused launch 3 x 4 x 15 = 180 times each.  Losses
      finite, round 1 uploads from every worker, peak below 76 GB, and
      each worker's round-1 gradient evaluated twice is bitwise equal (the
      gather's backward and the combines' scatter-adds must not make the
      upload decisions depend on the run).
   b. Serve the whole model: 48 layers, bfloat16 params and compute (P =
      30,532,122,624, 61.06 GB), phase 10a's 8 x 512 prompts, ``max_len``
      576 and 64 greedy tokens after a warm-up session.  Prefill's logits
      must equal ``forward`` over the prompt at the last position within
      ``SERVE_ATOL``; peak below 76 GB.  Decode step 1 is held against
      ``forward`` over prompt + token at full width but 2 layers, float32
      params and compute (7.5 GB), within ``MOE_DECODE_ATOL``, the prefill
      and that forward run with ``capacity_factor`` E/K so that no token
      drops (decode's dense path drops none; at 48 layers in bfloat16 the
      two paths may pick another top-8 at some layer).  Prefill ms,
      decode ms per token and tokens/s beside their bounds.

12. The Mamba2 families, random weights from seed 0, phase 4's LAQ
   settings (b=8; W=4 of 2 x 512 tokens, ``accum=2``, float32 params,
   bfloat16 compute, fused wire).
   a. Train zamba2-2.7b (hybrid: d_model 2560, d_inner 5120, 80 SSM heads
      of 64, state 64, conv 4; one shared block of 32 heads of 80 and
      d_ff 10240; vocab 32000) cut to 24 Mamba layers, so the shared
      block is applied 4 times (P = 1,226,023,040 in 29 leaves), 3
      rounds, counted as the ``hybrid`` path: absmax and
      quantize_pack_fused launch 3 x 4 x 29 = 348 times each.  Losses
      finite, round 1 uploads from every worker, peak below 76 GB, and
      each worker's round-1 gradient evaluated twice is bitwise equal (the
      cumsum, the shared block's accumulated gradient, the embedding's
      scatter).
   b. Serve zamba2-2.7b whole: 54 layers in bfloat16, phase 10a's session
      (8 x 512 prompts, ``max_len`` 576, 64 greedy tokens after a warm-up),
      the cache of 9 KV rows and 54 SSM states; prefill vs ``forward``
      within ``SERVE_ATOL``; decode step 1 vs ``forward`` over prompt +
      token at full width and 6 layers (one shared application), float32,
      prompts of 8 x 127 tokens (one SSD chunk on both sides), within
      ``MAMBA_DECODE_ATOL``.  Prefill ms, decode ms a token and tokens/s
      beside their bounds.
   c. mamba2-130m (ssm) whole, 24 layers (P = 167,610,816, 20 leaves): 3
      LAQ rounds as 12a, the ``ssm`` path, 240 launches each of absmax and
      quantize_pack_fused, the gradient twice; then served as 12b, its
      decode check at all 24 layers.

13. The paper's Tables 2 and 3 (``benchmarks_torch/table2_gradient.py``,
    ``table3_stochastic.py``) at full size on the card with the fused
    wire: the synthetic MNIST-like mixture (600 x 784, M = 10 workers)
    drawn on the card and held bitwise to the CPU draw, as are the NN's
    initial weights; then both tables, the logistic model (1 leaf) and the
    784 -> 200 -> 10 ReLU network (4 leaves).  Every row's rounds and bits
    must equal ``JAX_TABLES``, the JAX modules' rows on the CPU; the
    logistic rows of Table 2 are read at the JAX run's iteration index
    (the card's own index, which a 1e-6 loss residual decides, is
    logged beside it).  Every row's final loss must be within
    ``LOSS_RTOL`` of the JAX run's (the CPU tests' tolerance: torch's and
    XLA's matmuls reduce in other orders), so a wrong code or ``q_new``
    from kernel 1 or 2 fails QGD's rows too, whose rounds and bits are
    fixed.  SSGD's support is a knife edge on the gradients (ROADMAP
    queue 3): its bits and loss are held to ``SSGD_RTOL``.  All nine
    claim checks must hold.  Each model's rows of each table run in a process
    of their own (``chip_smoke.py --paper-run MODULE FUNCTION OUT``), and
    the processes of phases 13 to 17, twelve, all at once: each is
    host-bound eager rounds on one card with little memory.  Kernels 1
    and 2 are launched once per worker, leaf and round of QGD, LAQ and
    the NN's SLAQ: in Table 2 16,000 times each on the
    logistic model and 40,000 on the NN, in Table 3 12,000 on the NN (the
    logistic SLAQ's b=3 is off the fused wire's grid and runs on the
    reference wire, as in the reference).

14. The paper's convergence study (``benchmarks_torch/convergence.py``:
    GD / QGD / LAG / LAQ at b = 4, 600 rounds, and LAQ on non-i.i.d.
    shards, 400) and the LAQ half of ``benchmarks_torch/bits_sweep.py``
    (``run_sweep``: LAQ at b = 2, 4 and 8, 400 rounds each) at full size
    on the card with the fused wire, each in a process of its own, as in
    phase 13.  Every run's final uploads and bits must
    equal ``JAX_STUDIES``, the JAX modules' on the CPU, and its final loss
    be within ``LOSS_RTOL``; the four fitted slopes and LAQ's
    quantization-error decay ratio within ``SLOPE_RTOL`` and
    ``DECAY_RTOL`` of ``JAX_FIT``; all five claim checks must hold.
    Kernels 1 and 2 are launched once per worker and round of QGD and
    every LAQ run: 16,000 times each in the convergence study and 12,000
    in the sweep.

15. The A-LAQ width sweep (``benchmarks_torch/adaptive_sweep.py``: LAQ at
    b = 2, 4 and 8, the radius schedule and the budgeted controller on
    the grid (2, 4, 8), ridge regression at p = 50 over 10 workers, 400
    rounds each) and the error-feedback frontier
    (``benchmarks_torch/ef_frontier.py``: LAQ at b = 4, 2 and 1 and
    EF-top-k at b = 2 and 1 with k = 196 of the logistic model's 7,840,
    400 rounds each) at full size on the card with the fused wire, each in
    a process of its own, as in phase 13.  Every run's final uploads and
    bits must equal ``JAX_FRONTIERS``, the JAX modules' on the CPU (the
    regression's data drawn on the card first, bitwise equal to the CPU
    draw), its
    final loss be within ``LOSS_RTOL`` and its rows' entries that count
    bits or rounds equal ``JAX_FRONTIER_ROWS``; the EF-top-k runs, which
    part from JAX's on a skip decision that the gradient's reduction
    order moves (ROADMAP queue 3), within ``EF_RTOL`` and
    ``EF_LOSS_RTOL``.  The nine claims must be the reference's (two A-LAQ
    claims fail in the reference too).  Launches, one per worker and
    round: absmax 20,000 and 12,000, quantize_pack_fused 12,000 and
    12,000, quantize_pack_adaptive 8,000 (its width mix printed), and
    sparse_quantize_pack 8,000.

16. The stochastic lazy-aggregation frontier
    (``benchmarks_torch/lasg_frontier.py``: the deterministic-LAQ floor,
    then SGD, QSGD and SLAQ under rules 7a, WK, WK2, PS and with SVRG,
    batch 10 of 60, b = 3, 500 rounds each) and the participation
    frontier (``benchmarks_torch/participation_frontier.py``: LAQ and QGD
    under Bernoulli sampling at p = 1.0, 0.5 and 0.2, a communication-rich
    LAQ at p = 1.0 and 0.5, LAQ at delay D = 4 and under Markov churn, b =
    4, 400 rounds each) at full size on the card with the fused wire, the
    LASG runs split over ``LASG_PROCS`` processes, the participation runs
    in one, at once with phases 13-15.  Every run's final uploads and
    bits must equal ``JAX_STOCH_FRONTIERS``, the JAX modules' on the CPU,
    its final loss be within ``LOSS_RTOL`` and its rows' entries that
    count uploads, rounds or bits equal ``JAX_STOCH_FRONTIER_ROWS``; the
    runs of ``STOCH_BANDS``, whose skip decisions the gradient's
    reduction order moves (ROADMAP queue 3), within their bands, and
    SLAQ-WK's and SLAQ-PS's uploads and bits equal the reference's in
    every round of ``JAX_STOCH_PREFIX``.  The
    targets must be within ``LOSS_RTOL`` of ``JAX_STOCH_FRONTIER_TARGETS``
    and the eighteen claims the reference's.  Launches: absmax and
    quantize_pack_fused 44,000 times each in the participation frontier,
    once per worker and round of its 11 runs, the sampled-out workers too;
    none in the LASG frontier, whose b = 3 is off the fused wire's widths.

17. The fault frontier (``benchmarks_torch/fault_frontier.py``: LAQ and
    dense QGD at b = 4 on a 4-class softmax regression over W = 6 workers,
    one leaf of 8 x 4, 120 rounds each, under inf and NaN corruption,
    crash-restart and -40x scaling, with and without validation, the norm
    gate, crash reconciliation and the trimmed mean, and the undefended inf
    run under ``run_with_watchdog``, which rolls back from its checkpoint
    and escalates) at full size on the card with the fused wire, in a
    process of its own at once with phases 13-16.  Every row's final
    uploads and bits, ``finite`` and ``bits_to_target`` must equal
    ``JAX_FAULT_FRONTIER``, the JAX module's on the CPU, its final loss be
    within ``LOSS_RTOL`` (NaN where NaN), the target within ``LOSS_RTOL``,
    the watchdog's log equal and the eleven claims the reference's (two
    fail in the reference too).  Launches: absmax and quantize_pack_fused
    once per worker and round of the eleven cells and of the watchdog's
    healthy and wasted chunks, 8,760 each (printed beside the prediction):
    a corrupted, crashed or rejected worker still runs its wire.

Phase 3 also draws ``random.normal`` and ``random.permutation`` (at a
size that takes two shuffle rounds) on the card and on the CPU, in both
threefry layouts, bitwise equal.

Phase 3 also runs 12 LAQ rounds each of smoke qwen3-moe, mamba2-130m and
zamba2-2.7b (float32, alpha ``MODEL_SMALL_ALPHA``) on the card and on the
CPU (equal uploads, bits and widths, loss to rtol 1e-4), and serves each
as it serves smoke stablelm.

Phase 3 also serves smoke stablelm in float32 on the card and on the CPU
(prefill and 8 greedy tokens: equal ids, logits within
``SERVE_SMALL_ATOL``), and replays 10 CPU rounds of the micro LM of
``benchmarks_torch/serve_frontier.py`` through the fused-wire publisher
and two replicas on both, at b=4 and with the adaptive schedule: equal
kinds, widths and bits, ``theta_pub`` and replica 0 bitwise equal.

Phase 2 also holds kernels 5 and 6 (``quantize_codes_fused``,
``quantize_codes_adaptive``) and kernel 3 (``quantize_pack``) at the 12
leaf shapes for b in {1, 2, 4, 8} (each grid width for kernel 6) and at a
ragged length, an odd last dim, R == 0 and a NaN input; kernel 8
(``dequant_acc``) at the 12 leaf shapes with W=4, keep (1, 0, 1, 1) and
one zero radius, with and without acc, and at W in {1, 2}, an unpadded
payload and a NaN radius.  All bitwise.

The last lines are the card (``nvidia-smi``), one JSON object of per-kernel
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
W, N_LOCAL, SEQ, ACCUM, ALPHA = 4, 2, 512, 2, 0.5
PATH_ROUNDS = {"laq": 4, "alaq": 3, "ef_topk": 3}
EF_LAYERS = 8                 # EF-top-k depth cut (memory, see the docstring)
PEAK_LIMIT = 76e9
SPARSE_K = 82_213_376         # static_k(0.05, 1,644,267,520), 24 layers
SMALL_ROUNDS, SMALL_ALPHA = 12, 0.05
TIMED_LAUNCHES = 20
SHARDED_STEPS, SHARDED_ROWS, SHARDED_MICROBATCH, SHARDED_LR = 3, 2, 2, 1e-2
# phase 5's paths on the float wire (the others run on the packed wire)
SHARDED_FLOAT = ("sharded_ef_topk", "sharded_float_bf16")
EXCHANGE_W, EXCHANGE_LAYERS, EXCHANGE_ROWS = 4, 2, 1
# phase 6's lasg_wk2 + SVRG: 2 steps on each wire at 1 layer (four ranks'
# states at 2 layers, about 17.5 GiB each, ran out of the card's memory
# beside the five CUDA contexts)
EXCHANGE_LAZY_STEPS, EXCHANGE_LAZY_LAYERS = 2, 1
# the same with qhat and server_agg in bfloat16 (state_bf16), at the depth
# where one rank's peak stays at 19.0 GB (PERF.md section 2's 76 GB over
# four ranks), measured with scripts/profile_torch_round.py --method
# sharded_wk2_svrg --state-bf16 --layers 2 --memory: 18.36 GB on an H100
# 80GB HBM3 at 700 W (20.42 GB with float32 state)
EXCHANGE_BF16_LAYERS = 2
CHILD_TIMEOUT = 600           # seconds for the processes of phases 6, 13-16
EXCHANGE_DEFENDED = dict(participation="bernoulli", participation_p=0.5,
                         participation_seed=1)   # phase 6, with the defense
STOCH_LAYERS = {"slaq": 24, "slaq_wk": 8, "slaq_wk2_svrg": 6}  # phase 8
STOCH_N_LOCAL, STOCH_BATCH, STOCH_ROUNDS = 4, 2, 3
ROBUST_LAYERS = {"robust_full": 24, "robust_sort": 8, "delay": 8}  # phase 9
ROBUST_ROUNDS = 3
# seeds read off the deterministic masks on the CPU (robust_events): in 3
# rounds robust_full has an absent worker every round, crashes of
# reachable workers in round 2 and a corrupted upload of a warm (already
# accepted) worker in round 3; robust_sort has absent workers and bit
# flips on uploading workers in round 1
ROBUST_SEEDS = {"robust_full": dict(participation_seed=0, fault_seed=25),
                "robust_sort": dict(participation_seed=7, fault_seed=0)}
SMALL_ROBUST_ROUNDS = 4
BF16_OPS_PER_S = 989e12       # H100 SXM bfloat16 tensor cores, dense
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_MAX_LEN = 8, 512, 64, 576
SERVE_ATOL = 0.25             # bf16 decode vs forward (phase 10a)
SERVE_SMALL_ATOL = 1e-4       # float32 card vs CPU logits (phase 3)
PUBLISH_LAYERS, PUBLISH_ROUNDS, PUBLISH_TOKENS = 8, 4, 32   # phase 10b
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_TRAIN_LAYERS, MOE_TRAIN_ROUNDS = 1, 3       # phase 11a
MOE_CHECK_LAYERS = 2          # phase 11b's float32 decode check
MOE_DECODE_ATOL = 1e-3        # float32 decode vs undropped forward (11b)
MODEL_SMALL_ALPHA = 0.02      # phase 3's smoke MoE and Mamba2 rounds
HYBRID_ARCH, SSM_ARCH = "zamba2-2.7b", "mamba2-130m"
HYBRID_TRAIN_LAYERS, MAMBA_TRAIN_ROUNDS = 24, 3  # phase 12a (and 12c's rounds)
MAMBA_LEAVES = {HYBRID_ARCH: 29, SSM_ARCH: 20}
HYBRID_CHECK_LAYERS = 6       # phase 12b's float32 decode check
MAMBA_CHECK_PROMPT = 127      # one SSD chunk in the prefill and the forward
MAMBA_DECODE_ATOL = 1e-4      # float32 decode vs forward (12b, 12c)
# the leaves of phase 13's models (phase 2): the logistic weights, the
# NN's w1, b1, w2, b2
TABLE_LEAVES = (("logistic w", (10, 784)), ("nn w1", (784, 200)),
                ("nn b1", (200,)), ("nn w2", (200, 10)), ("nn b2", (10,)))
TABLE_MODULES = {"table2": "table2_gradient", "table3": "table3_stochastic"}
# phase 13: (iterations, rounds, bits, final loss) of each row of the JAX
# modules benchmarks/table2_gradient.py and table3_stochastic.py, run on
# the CPU (jax 0.9.0, JAX_PLATFORMS=cpu)
JAX_TABLES = {
    "table2/logistic/gd": (800, 8000, 2007040000, 0.014796958),
    "table2/logistic/qgd": (800, 8000, 251136000, 0.014797318),
    "table2/logistic/lag": (762, 100, 25088000, 0.014782393),
    "table2/logistic/laq": (800, 104, 3264768, 0.0149133345),
    "table2/nn/gd": (500, 5000, 25441544192, 0.020052833),
    "table2/nn/qgd": (500, 5000, 6360574464, 0.020053316),
    "table2/nn/lag": (500, 101, 513920320, 0.0200241),
    "table2/nn/laq": (500, 90, 114490080, 0.020120237),
    "table3/logistic/sgd": (400, 4000, 1003520000, 0.021039935),
    "table3/logistic/qsgd": (400, 4000, 125568000, 0.021142755),
    "table3/logistic/ssgd": (400, 4000, 141202576, 0.021091487),
    "table3/logistic/slaq": (400, 40, 942080, 0.08780606),
    "table3/nn/sgd": (300, 3000, 15264994304, 0.025112148),
    "table3/nn/qsgd": (300, 3000, 4293355008, 0.025116017),
    "table3/nn/ssgd": (300, 3000, 2327410688, 0.025148112),
    "table3/nn/slaq": (300, 563, 716199232, 0.024632217),
}
# phase 14: (final cum_uploads, cum_bits, loss) of each run of the JAX
# modules benchmarks/convergence.py and bits_sweep.py (the LAQ sweep at its
# settings), and the four slopes and the decay ratio of the first, run on
# the CPU (jax 0.9.0, JAX_PLATFORMS=cpu; tests/paper_studies_probe.py)
JAX_STUDIES = {
    "convergence/gd": (6000, 1505280000, 0.014848352409899235),
    "convergence/qgd": (6000, 188352000, 0.01484876498579979),
    "convergence/lag": (90, 22579200, 0.014791985973715782),
    "convergence/laq": (85, 2668320, 0.014944987371563911),
    "convergence/heterogeneous_laq": (69, 2166048, 0.01649072766304016),
    "bits_sweep/b2": (40, 628480, 2.4846103191375732),
    "bits_sweep/b4": (65, 2040480, 0.015023739077150822),
    "bits_sweep/b8": (70, 4392640, 0.014831856824457645),
}
JAX_FIT = {"gd": -0.011920970470387416, "qgd": -0.011917001488059051,
           "lag": -0.012673458821750373, "laq": -0.009838528788480136,
           "decay_ratio": 0.001417334794173362}
# the port's CPU runs of both wires against these: slopes within 4.3e-6,
# the decay ratio within 2.9e-5 (it averages LAQ's radii, which a code on
# a rounding boundary moves by a grid step: LAQ's within 5.2e-4 per round)
SLOPE_RTOL = 1e-4
DECAY_RTOL = 1e-3
LOSS_RTOL = 1e-5              # final loss, card vs JAX (phases 13-15)
SSGD_RTOL = 1e-4              # SSGD's bits and loss (phase 13; ROADMAP queue 3)
# phase 15's leaves in phase 2: the regression's w at the fixed widths
# (kernels 1 and 2) and at each width of the grid (kernel 4); with the
# logistic w of TABLE_LEAVES at b=1 (plain_b1) and ef_frontier's survivors
# (kernel 7 at k = 196, b = 1 and 2)
REGRESSION_LEAF = ("regression w", (50,))
FRONTIER_MODULES = ("adaptive_sweep", "ef_frontier")
# phase 15: (final cum_uploads, cum_bits, loss) of each run of the JAX
# modules benchmarks/adaptive_sweep.py and ef_frontier.py, their rows'
# entries that count bits or rounds and their claims in order, run on the
# CPU (jax 0.9.0, JAX_PLATFORMS=cpu; tests/frontiers_probe.py).  The
# reference's own first two A-LAQ claims fail (ROADMAP, reference-side
# discrepancies): the port is held to the reference's verdicts.
JAX_FRONTIERS = {
    "adaptive_sweep/fixed_b2": (40, 5280, 0.010269160382449627),
    "adaptive_sweep/fixed_b4": (52, 12064, 0.0061525385826826096),
    "adaptive_sweep/fixed_b8": (52, 22464, 0.00621040677651763),
    "adaptive_sweep/adaptive_radius": (50, 8900, 0.006735560949891806),
    "adaptive_sweep/adaptive_budget": (50, 8900, 0.006735560949891806),
    "ef_frontier/plain_b4": (65, 2040480, 0.015023739077150822),
    "ef_frontier/plain_b2": (40, 628480, 2.4846103191375732),
    "ef_frontier/plain_b1": (40, 314880, 24.196758270263672),
    "ef_frontier/ef_topk_b2": (467, 1402868, 0.019921084865927696),
    "ef_frontier/ef_topk_b1": (451, 1266408, 0.020013269037008286),
}
JAX_FRONTIER_ROWS = {
    "adaptive_sweep/fixed_b2": dict(bits_to_fixed4_loss=None,
                                    mean_width_late=0.0),
    "adaptive_sweep/fixed_b4": dict(bits_to_fixed4_loss=12064.0,
                                    mean_width_late=0.6399999856948853),
    "adaptive_sweep/fixed_b8": dict(bits_to_fixed4_loss=None,
                                    mean_width_late=1.600000023841858),
    "adaptive_sweep/adaptive_radius": dict(
        bits_to_fixed4_loss=None, mean_width_late=0.36000001430511475),
    "adaptive_sweep/adaptive_budget": dict(
        bits_to_fixed4_loss=None, mean_width_late=0.36000001430511475),
    "ef_frontier/plain_b4": dict(rounds_to_target=30,
                                 bits_to_target=941760.0),
    "ef_frontier/plain_b2": dict(rounds_to_target=None, bits_to_target=None),
    "ef_frontier/plain_b1": dict(rounds_to_target=None, bits_to_target=None),
    "ef_frontier/ef_topk_b2": dict(rounds_to_target=291,
                                   bits_to_target=874164.0),
    "ef_frontier/ef_topk_b1": dict(rounds_to_target=363,
                                   bits_to_target=1019304.0),
}
JAX_FRONTIER_TARGET = 0.026291543385013938   # ef_frontier's target loss
JAX_FRONTIER_CLAIMS = {"adaptive_sweep": (False, False, True, True),
                       "ef_frontier": (True, True, True, True, True)}
# the EF-top-k runs part from JAX's on a skip decision that the gradient's
# float32 reduction order moves (ROADMAP queue 3): their uploads, bits and
# rows to EF_RTOL, their loss to EF_LOSS_RTOL.  Four orders of the same
# gradient on the CPU (JAX's, the port's, float64, the examples reversed)
# spread them by up to 4.5% (uploads and bits) and 0.4% (loss, bits to
# the target)
EF_RTOL = 0.1
EF_LOSS_RTOL = 1e-2
# phase 16's LASG runs go to LASG_PROCS processes, every LASG_PROCS-th
# run of lasg_frontier.RUNS to each: in one, its 4,500 rounds were the
# pool's longest process (347.2 s of ten at once on the card's 8 host
# cores, the others 81.7-211.2 s)
LASG_PROCS = 2
# phase 16: (final cum_uploads, cum_bits, loss) of each run of the JAX
# modules benchmarks/lasg_frontier.py (det_laq is its deterministic-LAQ
# floor) and participation_frontier.py, their rows' uploads, rounds and
# bits to the targets, their targets and their claims in order, run on
# the CPU (jax 0.9.0, JAX_PLATFORMS=cpu; tests/stochastic_frontiers_probe.py)
JAX_STOCH_FRONTIERS = {
    "lasg_frontier/det_laq": (60, 1413120, 0.015967274084687233),
    "lasg_frontier/sgd": (5000, 1254400000, 0.024750133976340294),
    "lasg_frontier/qsgd": (5000, 156960000, 0.024840377271175385),
    "lasg_frontier/slaq_7a": (55, 1295360, 0.07588044553995132),
    "lasg_frontier/slaq_wk": (3015, 71009280, 0.023876236751675606),
    "lasg_frontier/slaq_wk2": (54, 1271808, 0.058909256011247635),
    "lasg_frontier/slaq_ps": (689, 16227328, 0.024595040827989578),
    "lasg_frontier/slaq_vr": (60, 1413120, 0.0171027984470129),
    "participation_frontier/laq_p1.0": (65, 2040480, 0.015023739077150822),
    "participation_frontier/qgd_p1.0": (4000, 125568000,
                                        0.015069367364048958),
    "participation_frontier/laq_p0.5": (62, 1946304, 0.014931919053196907),
    "participation_frontier/qgd_p0.5": (2033, 63819936, 0.015058739110827446),
    "participation_frontier/laq_p0.2": (56, 1757952, 0.014897521585226059),
    "participation_frontier/qgd_p0.2": (813, 25521696, 0.0150006003677845),
    "participation_frontier/laq_rich_p1.0": (153, 4802976,
                                             0.014950219541788101),
    "participation_frontier/laq_rich_p0.5": (99, 3107808,
                                             0.014897621236741543),
    "participation_frontier/laq_d4": (60, 1883520, 0.015007507055997849),
    "participation_frontier/laq_mkv_burst": (56, 1757952,
                                             0.015192138962447643),
    "participation_frontier/laq_mkv_iid": (60, 1883520, 0.01504396740347147),
}
JAX_STOCH_FRONTIER_ROWS = {
    "lasg_frontier/sgd": dict(
        rounds_to_target=3010, bits_to_target=755148800.0,
        bits_to_det_floor=None),
    "lasg_frontier/qsgd": dict(
        rounds_to_target=3030, bits_to_target=95117760.0,
        bits_to_det_floor=None),
    "lasg_frontier/slaq_7a": dict(
        rounds_to_target=None, bits_to_target=None,
        bits_to_det_floor=None),
    "lasg_frontier/slaq_wk": dict(
        rounds_to_target=1966, bits_to_target=46303232.0,
        bits_to_det_floor=None),
    "lasg_frontier/slaq_wk2": dict(
        rounds_to_target=None, bits_to_target=None,
        bits_to_det_floor=None),
    "lasg_frontier/slaq_ps": dict(
        rounds_to_target=529, bits_to_target=12459008.0,
        bits_to_det_floor=None),
    "lasg_frontier/slaq_vr": dict(
        rounds_to_target=30, bits_to_target=706560.0,
        bits_to_det_floor=1177600.0),
    "participation_frontier/laq_p1.0": dict(
        uploads_to_target=41, bits_to_target=1287072.0),
    "participation_frontier/qgd_p1.0": dict(
        uploads_to_target=2470, bits_to_target=77538240.0),
    "participation_frontier/laq_p0.5": dict(
        uploads_to_target=42, bits_to_target=1318464.0),
    "participation_frontier/qgd_p0.5": dict(
        uploads_to_target=1212, bits_to_target=38047104.0),
    "participation_frontier/laq_p0.2": dict(
        uploads_to_target=20, bits_to_target=627840.0),
    "participation_frontier/qgd_p0.2": dict(
        uploads_to_target=415, bits_to_target=13027680.0),
    "participation_frontier/laq_rich_p1.0": dict(
        uploads_to_target=121, bits_to_target=3798432.0),
    "participation_frontier/laq_rich_p0.5": dict(
        uploads_to_target=65, bits_to_target=2040480.0),
    "participation_frontier/laq_d4": dict(
        uploads_to_target=30, bits_to_target=941760.0),
    "participation_frontier/laq_mkv_burst": dict(
        uploads_to_target=26, bits_to_target=816192.0),
    "participation_frontier/laq_mkv_iid": dict(
        uploads_to_target=30, bits_to_target=941760.0),
}
JAX_STOCH_FRONTIER_TARGETS = {
    "lasg_frontier": dict(target_loss=0.02970016077160835,
                          det_floor=0.015967274084687233,
                          det_target=0.018362365197390318),
    "participation_frontier": dict(target_loss=0.015822835732251406),
}
JAX_STOCH_FRONTIER_CLAIMS = {"lasg_frontier": (True,) * 8,
                             "participation_frontier": (True,) * 10}
# the reference's uploads in each of the first rounds of SLAQ-WK and
# SLAQ-PS, one hexadecimal digit a round: the rounds before the first in
# which the reference, fed the minibatch rows in any of 32 other orders,
# parts from its own run (98 for WK, 182 for PS;
# tests/stochastic_frontiers_probe.py section 7)
JAX_STOCH_PREFIX = {
    "lasg_frontier/slaq_wk": "a" * 67 + "9" * 14 + "a" * 16,
    "lasg_frontier/slaq_ps": ("aa0a182816351633333423334224240351251243322442"
                              "0343123410621125112430242123303142113411312314"
                              "0222220240302133110520204113102320221400232101"
                              "1421011322102220132021141013230103132021300"),
}
# (uploads, bits and rows, final loss) relative bands of the runs whose
# skip decisions or codes follow the gradient's float32 rounding (ROADMAP
# queue 3); every other run is held exactly and its loss to LOSS_RTOL.
# Each band lies between two readings taken apart from the card's own:
# below it, how far the rounding alone moves the run; above it, how far a
# planted fault of the run's rule moves it (on the CPU,
# tests/stochastic_frontiers_probe.py sections 7 and 8; on an H100,
# tests/lasg_order_witness.py).
# - SLAQ-WK: the reference fed each minibatch's rows in 32 other orders
#   ends at -22.1% to +26.8% uploads and bits, -26.2% to +13.6% rows to
#   the target, loss -2.25% to +2.11%.  Its variance estimate left
#   undebiased: -93.7% uploads, loss +3.15%; sigma_hat^2 never refreshed:
#   -95.9%, +54%.
# - SLAQ-PS: 32 orders +-1.02% uploads, -0.57% to +0.38% rows, loss
#   -0.21% to +0.46%.  Lhat^2 left undebiased: -26.1% uploads (its loss,
#   -0.30%, lies inside the orders' spread: its counts catch it).
# - SLAQ-VR: its counts equal the reference's in every order; its loss
#   follows the gradient's accuracy: 32 orders move it by 3.4e-6 at most,
#   the port's gradients computed in float64 by -6.29e-5.  Its anchor
#   refreshed only once: +247% uploads, loss +4.4.
# SLAQ-WK and SLAQ-PS are also held in every round of JAX_STOCH_PREFIX,
# which each planted fault leaves by round 4.
STOCH_BANDS = {"lasg_frontier/slaq_wk": (0.3, 0.025),
               "lasg_frontier/slaq_ps": (0.02, 5e-3),
               "lasg_frontier/slaq_vr": (0.0, 1e-4)}
# phase 17: (final cum_uploads, cum_bits, loss, finite, bits_to_target) of
# each row of the JAX module benchmarks/fault_frontier.py, its target, the
# watchdog's log and its claims in order, run on the CPU (jax 0.9.0,
# JAX_PLATFORMS=cpu, its BENCH_faults.json written elsewhere;
# tests/fault_frontier_probe.py).  Two claims fail in the reference too
# (ROADMAP, reference-side discrepancies): the port is held to them.
NAN = float("nan")
JAX_FAULT_FRONTIER = {
    "rows": {
        "clean": (209, 33440.0, 2.0513916015625, True, 24000.0),
        "clean_defended": (209, 33440.0, 2.0513916015625, True, 24000.0),
        "inf_undefended": (720, 115200.0, NAN, False, None),
        "inf_defended": (262, 41920.0, 2.0513052940368652, True, 28480.0),
        "nan_undefended": (275, 44000.0, 2.0513968467712402, True, 29440.0),
        "nan_defended": (262, 41920.0, 2.0513052940368652, True, 28480.0),
        "crash_naive": (176, 28160.0, 3.232029438018799, True, 13280.0),
        "crash_reconciled": (205, 32800.0, 2.051255464553833, True, 23040.0),
        "scale_qgd_sum": (720, 115200.0, 5444.8134765625, True, None),
        "scale_qgd_trimmed": (720, 115200.0, 1312.948486328125, True, None),
        "scale_laq_gated": (282, 45120.0, 2.221200466156006, True, None),
        "watchdog_inf": (262, 41920.0, 2.0513052940368652, True, 28480.0),
    },
    "target_loss": 2.09241943359375,
    "watchdog_log": {"rollbacks": 1, "wasted_rounds": 20,
                     "wasted_bits": 19200.0, "gave_up": False},
    "claims": (True,) * 8 + (False, False, True),
}
# the fault frontier's one leaf (phase 2), and the length of phase 2's
# non-finite cases of kernels 1 and 2
FAULT_LEAF = ("fault w", (8, 4))
NONFINITE_N = 1_000_003


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=TIMED_LAUNCHES, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def named_leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        out += named_leaves(v, name + ".") if isinstance(v, dict) else [(name, v)]
    return out


def _bitwise(torch, label, names, got, want):
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            bad = (a != b).sum().item() if a.shape == b.shape else "shape"
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"version ({bad} elements)")


def _moments_close(label, got, want, nan_ok=False) -> float:
    """Largest absolute difference of the two moments (rtol 1e-5; with
    ``nan_ok`` NaN equals NaN and an infinite moment must be equal)."""
    e = 0.0
    for name, a, b in zip(("err_sq", "innovation_sq"), got, want):
        a, b = a.item(), b.item()
        if nan_ok and ((math.isnan(a) and math.isnan(b)) or
                       (math.isinf(b) and a == b)):
            continue
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"{label}: {name} {a!r} vs plain {b!r}")
        e = max(e, abs(a - b))
    return e


def check_kernels(leaf_shapes, torch, ops, ref):
    """Phase 2, kernels 1 and 2: bitwise checks at every main-path shape
    (``leaf_shapes`` at b=8, ``TABLE_LEAVES`` and ``REGRESSION_LEAF`` at
    b=2, 4 and 8, the logistic w also at b=1) and the edge cases; returns
    the largest absolute error of each kernel's outputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    err = {"absmax": 0.0, "quantize_pack_fused": 0.0}

    def one(label, g, qh, bits, nonfinite=False):
        R = ops.absmax(g, qh)
        R_ref = ref.absmax_ref(g, qh)
        torch.cuda.synchronize()
        if nonfinite:
            # NaN compared as NaN, moments with equal_nan
            _nan_equal(torch, label, ("absmax",), (R,), (R_ref,))
        elif not torch.equal(R, R_ref):
            raise AssertionError(f"{label}: absmax {R.item()!r} != plain "
                                 f"{R_ref.item()!r}")
        else:
            err["absmax"] = max(err["absmax"], (R - R_ref).abs().item())
        got = ops.quantize_pack_fused(g, qh, R, bits)
        want = ref.quantize_pack_fused_ref(g, qh, R, bits)
        torch.cuda.synchronize()
        names = ("packed", "delta", "q_new")
        if nonfinite:
            _nan_equal(torch, label, names, got[:3], want[:3])
        else:
            _bitwise(torch, label, names, got[:3], want[:3])
        e = _moments_close(label, got[3:], want[3:], nan_ok=nonfinite)
        if not nonfinite:
            err["quantize_pack_fused"] = max(err["quantize_pack_fused"], e)
        log(f"  ok {label}: n={g.numel()} b={bits} R={R.item():.6e} "
            f"{'bitwise, NaN as NaN' if nonfinite else 'bitwise'}; moments "
            f"{got[3].item():.6e} {got[4].item():.6e}")

    for name, shape in leaf_shapes:
        n = math.prod(shape)
        g, qh = _pair(torch, gen, n)
        one(f"{name} {tuple(shape)}", g.view(shape), qh.view(shape), 8)
        del g, qh
    for name, shape in TABLE_LEAVES + (REGRESSION_LEAF, FAULT_LEAF):
        g, qh = _pair(torch, gen, math.prod(shape))
        # ef_frontier's plain_b1 runs the logistic w at b=1
        for bits in (1, 2, 4, 8) if name == "logistic w" else (2, 4, 8):
            one(f"{name} {tuple(shape)}", g.view(shape), qh.view(shape), bits)
    # the fault frontier's corrupted gradients, at its leaf and at a long
    # ragged length, b=4: one NaN (R is NaN, the R > 0 guard drops the
    # payload), one +inf and one -inf, all +inf (R = inf, delta from
    # fma(2 tau R, q, -R)) and all NaN
    for name, shape in (FAULT_LEAF, ("ragged", (NONFINITE_N,))):
        n = math.prod(shape)
        g, qh = _pair(torch, gen, n)
        nan_one, infs = g.clone(), g.clone()
        nan_one[n // 3] = math.nan
        infs[1], infs[n - 2] = math.inf, -math.inf
        for case, bad in (("one NaN", nan_one), ("+inf and -inf", infs),
                          ("all +inf", torch.full_like(g, math.inf)),
                          ("all NaN", torch.full_like(g, math.nan))):
            one(f"{name} {tuple(shape)} {case}", bad.view(shape),
                qh.view(shape), 4, nonfinite=True)
    g, qh = _pair(torch, gen, 3 * 4096 + 1239)
    one("ragged length", g, qh, 8)
    g, qh = _pair(torch, gen, 1_000_003, shift=1)
    one("unaligned operands", g, qh, 8)
    g, qh = _pair(torch, gen, 1_000_003)
    one("R == 0", g, g.clone(), 8)
    for bits in (1, 2, 4, 8):
        one(f"b={bits}", g, qh, bits)
    return err


def _pair(torch, gen, n, shift=0):
    g = torch.randn(n + shift, generator=gen, device="cuda") * 1e-3
    qh = g + torch.randn(n + shift, generator=gen, device="cuda") * 1e-4
    return g[shift:], qh[shift:]


def check_adaptive_kernel(leaf_shapes, torch, ops, ref):
    """Phase 2, kernel 4: every width of the grids (2, 4, 8) and (2, 4) at
    the leaf shapes and the edge cases; a pinned width must be kernel 2
    bit for bit.  Returns the largest absolute error of the moments."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = 0.0

    def one(label, g, qh, grid, sel, nan_ok=False):
        nonlocal worst
        R = ops.absmax(g, qh)
        onehot = torch.eye(len(grid))[sel]
        got = ops.quantize_pack_adaptive(g, qh, R, onehot, grid)
        want = ref.quantize_pack_adaptive_ref(g.reshape(-1), qh.reshape(-1),
                                              R, grid, sel)
        fixed = ops.quantize_pack_fused(g, qh, R, grid[sel])
        torch.cuda.synchronize()
        _bitwise(torch, label, ("packed", "delta", "q_new"), got[:3], want[:3])
        _bitwise(torch, label + " vs kernel 2", ("delta", "q_new"), got[1:3],
                 fixed[1:3])
        if grid[sel] == max(grid):
            _bitwise(torch, label + " vs kernel 2", ("packed",), got[:1],
                     fixed[:1])
        for a, b in zip(got[3:], fixed[3:]):
            if not (torch.equal(a, b) or (nan_ok and a.isnan() and b.isnan())):
                raise AssertionError(f"{label}: moments differ from kernel 2")
        worst = max(worst, _moments_close(label, got[3:], want[3:], nan_ok))
        log(f"  ok {label}: n={g.numel()} grid={grid} b={grid[sel]} bitwise, "
            "= kernel 2")

    for name, shape in leaf_shapes:
        g, qh = _pair(torch, gen, math.prod(shape))
        for sel in range(3):
            one(f"{name} {tuple(shape)}", g.view(shape), qh.view(shape),
                (2, 4, 8), sel)
        del g, qh
    g, qh = _pair(torch, gen, 3 * 4096 + 1239)
    for grid in ((2, 4, 8), (2, 4)):
        for sel in range(len(grid)):
            one("ragged length", g, qh, grid, sel)
    one("R == 0", g, g.clone(), (2, 4), 0)
    g[1234] = float("nan")
    one("NaN input", g, qh, (2, 4, 8), 1, nan_ok=True)
    return worst


def check_sparse_kernel(ef_k, torch, ops, ref):
    """Phase 2, kernel 7: survivors at the EF path's k, at SPARSE_K and at a
    ragged k for each width, ef_frontier's top-k survivors at b = 1 and 2,
    lo == hi, and lo far below the grid step; all bitwise.  Returns the
    largest absolute difference of deq (0 when bitwise)."""
    from repro_torch.core.compressors import sparse_grid
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    worst = 0.0

    def one(label, v, bits, lo=None, hi=None):
        nonlocal worst
        if lo is None:
            lo, hi = sparse_grid(v, bits)
        got = ops.sparse_quantize_pack(v, lo, hi, bits)
        want = ref.sparse_quantize_pack_ref(v, lo, hi, bits)
        torch.cuda.synchronize()
        _bitwise(torch, label, ("packed", "codes", "deq"), got, want)
        if v.numel():
            worst = max(worst, (got[2] - want[2]).abs().max().item())
        log(f"  ok {label}: k={v.numel()} b={bits} lo={lo.item():.6e} "
            f"hi={hi.item():.6e} bitwise")

    for k in (ef_k, SPARSE_K, 3 * 4096 + 1239):
        v = torch.randn(k, generator=gen, device="cuda") * 1e-3
        for bits in (1, 2, 4, 8):
            one(f"survivors k={k}", v, bits)
        del v
    # ef_frontier's EF-top-k: the top k of a logistic-w innovation
    from benchmarks_torch import ef_frontier
    from repro_torch.core.compressors import select_support, static_k
    p = math.prod(dict(TABLE_LEAVES)["logistic w"])
    d = torch.randn(p, generator=gen, device="cuda") * 1e-3
    sel = select_support("topk", d, static_k(ef_frontier.EF_K, p))
    for bits in (1, 2):
        one(f"ef_frontier survivors of p={p}", sel.vals, bits)
    v = torch.randn(1_000_003, generator=gen, device="cuda")
    same = torch.where(v < 0, -1.0, 1.0) * 2e-3
    lo = torch.tensor(2e-3, device="cuda")
    for bits in (1, 4):
        one("lo == hi", same, bits, lo, lo)
    v[17] = 1e-30
    for bits in (2, 8):
        a = v.abs()
        one("lo far below step", v, bits, a.amin(), a.amax())
    return worst


def _bound(r):
    by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = r["ops"] / F32_OPS_PER_S * 1e3
    r["bound_ms"] = max(by_bytes, by_ops)
    r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return r


def time_kernels(n, ef_k, torch, ops, ref):
    """Kernel, plain version and one-call yardstick at the largest leaf
    (kernels 1, 2 and 4, each width of kernel 4) and at the EF path's k
    survivors (kernel 7, b=4)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    g = torch.randn(n, generator=gen, device="cuda") * 1e-3
    qh = g + torch.randn(n, generator=gen, device="cuda") * 1e-4
    R = ops.absmax(g, qh)
    dist = torch.dist(g, qh, p=float("inf"))
    if not torch.equal(dist, R):
        raise AssertionError("torch.dist(p=inf) does not compute R")
    bits = 8
    rows = {
        "absmax": dict(
            ms=time_ms(lambda: ops.absmax(g, qh)),
            plain_ms=time_ms(lambda: ref.absmax_ref(g, qh)),
            library_ms=time_ms(lambda: torch.dist(g, qh, p=float("inf"))),
            bytes=8 * n + 4, ops=3 * n),
        "quantize_pack_fused": dict(
            ms=time_ms(lambda: ops.quantize_pack_fused(g, qh, R, bits)),
            plain_ms=time_ms(lambda: ref.quantize_pack_fused_ref(g, qh, R,
                                                                 bits)),
            library_ms=None,
            bytes=8 * n + 8 * n + n * bits // 8 + 8, ops=14 * n),
    }
    grid = (2, 4, 8)
    by_width = {}
    for sel, b in enumerate(grid):
        onehot = torch.eye(3)[sel]
        by_width[b] = dict(
            ms=time_ms(lambda: ops.quantize_pack_adaptive(g, qh, R, onehot,
                                                          grid)),
            plain_ms=time_ms(lambda: ref.quantize_pack_adaptive_ref(
                g, qh, R, grid, sel)))
    # the payload is provisioned at max(grid) = 8 bits: the same bytes at
    # every width
    rows["quantize_pack_adaptive"] = dict(
        ms=by_width[8]["ms"], plain_ms=by_width[8]["plain_ms"],
        library_ms=None, bytes=8 * n + 8 * n + n + 8, ops=14 * n,
        by_width={str(b): r for b, r in by_width.items()})
    del g, qh
    v = torch.randn(ef_k, generator=gen, device="cuda") * 1e-3
    lo, hi = v.abs().amin(), v.abs().amax()
    k, b = ef_k, 4
    rows["sparse_quantize_pack"] = dict(
        ms=time_ms(lambda: ops.sparse_quantize_pack(v, lo, hi, b)),
        plain_ms=time_ms(lambda: ref.sparse_quantize_pack_ref(v, lo, hi, b)),
        library_ms=None, bytes=4 * k + 8 + k + 4 * k + k * b // 8,
        ops=10 * k)
    return {name: _bound(r) for name, r in rows.items()}


def strategies():
    """lm_frontier's deterministic methods (benchmarks/lm_frontier.py:84-96)
    on the fused wire, and ``alaq_tight``: A-LAQ with the relative
    thresholds (0.5, 0.9), whose widths move on the small input."""
    from repro_torch.core.adaptive import BitSchedule, EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.strategy import StrategyConfig
    base = dict(kind="laq", per_leaf_radius=True, wire_backend="fused",
                criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
                eta_schedule=EtaSchedule("inv_t", t0=30.0))
    def alaq(thresholds):
        return StrategyConfig(bits=8, **base, bit_schedule=BitSchedule(
            kind="radius", grid=(2, 4, 8), threshold_mode="rel",
            thresholds=thresholds))
    return {
        "laq": StrategyConfig(bits=8, **base),
        "alaq": alaq((0.05, 0.5)),
        "alaq_tight": alaq((0.5, 0.9)),
        "ef_topk": StrategyConfig(bits=4, **base, compressor="topk",
                                  compressor_k=0.05, error_feedback=True),
    }


def stochastic_strategies():
    """Phase 8's stochastic methods on the fused wire, with lm_frontier's
    criterion and 1/t stepsize: SLAQ under rule 7a at b=8, lm_frontier's
    own stochastic "slaq" (benchmarks/lm_frontier.py:99-104: rule lasg_wk,
    b=4), and the same-sample rule with SVRG anchors refreshed every 2
    rounds at b=8."""
    from repro_torch.core.adaptive import EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.strategy import StrategyConfig
    base = dict(kind="laq", per_leaf_radius=True, wire_backend="fused",
                criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
                eta_schedule=EtaSchedule("inv_t", t0=30.0))
    return {
        "slaq": StrategyConfig(bits=8, **base),
        "slaq_wk": StrategyConfig(bits=4, lazy_rule="lasg_wk", **base),
        "slaq_wk2_svrg": StrategyConfig(bits=8, lazy_rule="lasg_wk2",
                                        grad_mode="svrg", svrg_period=2,
                                        **base),
    }


def robust_strategies():
    """Phase 9's paths (and phase 3's small runs of them): lm_frontier's
    criterion and 1/t stepsize on the fused wire with per-leaf radii, plus
    participation, faults and defenses."""
    from repro_torch.core.adaptive import EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.defense import DefenseConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.strategy import StrategyConfig
    base = dict(kind="laq", per_leaf_radius=True, wire_backend="fused",
                criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
                eta_schedule=EtaSchedule("inv_t", t0=30.0))
    full, sort = ROBUST_SEEDS["robust_full"], ROBUST_SEEDS["robust_sort"]
    return {
        "robust_full": StrategyConfig(
            bits=8, **base, participation="fixed_k", participation_p=0.75,
            participation_seed=full["participation_seed"],
            faults=FaultConfig(corrupt_p=0.25, corrupt_kind="scale",
                               corrupt_scale=-40.0, crash_p=0.25,
                               fault_seed=full["fault_seed"]),
            defense=DefenseConfig(validate=True, gate_mult=4.0,
                                  clip_mult=4.0, reconcile_crashes=True)),
        "robust_sort": StrategyConfig(
            bits=4, **base, participation="markov", participation_p=0.75,
            markov_sojourn=8.0, participation_seed=sort["participation_seed"],
            faults=FaultConfig(corrupt_p=0.5, corrupt_kind="bitflip",
                               bitflip_frac=0.05,
                               fault_seed=sort["fault_seed"]),
            defense=DefenseConfig(validate=True), aggregator="trimmed_mean",
            trim_frac=0.34),
        "delay": StrategyConfig(bits=8, **base, participation="delay",
                                max_delay=2),
    }


def robust_events(method, strategy, rounds):
    """The deterministic availability and fault masks of a phase-9 path's
    rounds, read on the CPU: ``(avail, crashed, corrupted)`` lists of [W]
    bool lists (None where the path has no such stream)."""
    from repro_torch.core.engine import make_participation
    from repro_torch.core.faults import corruption_mask, crash_mask
    part = make_participation(strategy, W)
    state, avail = part.init(None), []
    for k in range(rounds):
        a, _, state = part.begin_round(state, k, None)
        avail.append([True] * W if a is None else a.tolist())
    flt = strategy.faults
    crashed = ([crash_mask(flt, k, W).tolist() for k in range(rounds)]
               if flt.crashy else None)
    corrupted = ([corruption_mask(flt, k, W).tolist() for k in range(rounds)]
                 if flt.corrupt_p > 0 else None)
    return avail, crashed, corrupted


def check_robust_events(method, events):
    """Phase 9: the seeds put the path's events in its rounds."""
    avail, crashed, corrupted = events
    if method == "robust_full":
        warm = set(m for m in range(W) if avail[0][m])
        ok = (all(not all(a) for a in avail)
              and any(a and c for k in range(1, len(avail))
                      for a, c in zip(avail[k], crashed[k]))
              and any(avail[k][m] and corrupted[k][m] and m in warm
                      for k in range(1, len(avail)) for m in range(W))
              and not any(corrupted[0]) and not any(crashed[0]))
    elif method == "robust_sort":
        ok = (any(not all(a) for a in avail)
              and any(a and c for a, c in zip(avail[0], corrupted[0])))
    else:
        ok = True
    if not ok:
        raise AssertionError(f"{method}: the seeds do not put the path's "
                             f"events in its rounds: {events}")


def robust_small_check(torch, tmpdir):
    """Phase 3: the participation and robustness layer on small inputs, on
    the card vs the CPU.  Smoke stablelm (float32, W=4, 4 rounds) under
    phase 9's three paths and a bernoulli run with undefended NaN
    corruption, crashes without reconciliation and the median; the 10-worker
    quadratic of test_engine_parity.py (30 rounds) under each remaining
    participation mode and corruption kind; ``run_with_watchdog`` with
    escalation into ``tmpdir``; and a checkpoint resume on the card equal to
    the unbroken run.  Uploads, bits, rejections and watchdog logs must be
    equal; losses agree to rtol 1e-4 (NaN where NaN)."""
    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.defense import (DefenseConfig, WatchdogConfig,
                                          run_with_watchdog)
    from repro_torch.core.engine import (AccumulatingSource, FullBatchSource,
                                         RoundEngine)
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.model import init_params, lm_worker_loss

    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = init_params(0, cfg, device="cpu")
    corpus = lm_worker_corpus(0, W, 2, 32, cfg.vocab, device="cpu")
    lm_runs = dict(robust_strategies())
    lm_runs["bernoulli_nan_median"] = lm_runs["delay"]._replace(
        participation="bernoulli", participation_p=0.5, participation_seed=2,
        max_delay=0, faults=FaultConfig(corrupt_p=0.25, corrupt_kind="nan",
                                        crash_p=0.25, fault_seed=3),
        defense=DefenseConfig(reconcile_crashes=False), aggregator="median")

    def lm_engine(dev, strategy):
        src = AccumulatingSource(lm_worker_loss(cfg, W),
                                 {k: v.to(dev) for k, v in corpus.items()},
                                 deterministic=True, accum=ACCUM, scale=1.0)
        return RoundEngine(src, strategy, alpha=SMALL_ALPHA)

    gen = torch.Generator().manual_seed(0)
    qc = torch.randn(10, 20, generator=gen)
    qa = 0.5 + torch.rand(10, 20, generator=gen)

    def q_loss(p, data):
        c, a = data
        return 0.5 * torch.sum(a * torch.square(p["x"] - c)) / 10

    q_base = dict(kind="laq", bits=4, wire_backend="fused",
                  criterion=CriterionConfig(D=10, xi=0.08, t_bar=20))
    q_runs = {
        "fixed_k_inf_validate": dict(
            participation="fixed_k", participation_p=0.3,
            faults=FaultConfig(corrupt_p=0.3, corrupt_kind="inf",
                               fault_seed=2),
            defense=DefenseConfig(validate=True)),
        "bernoulli_sign_flip_gate": dict(
            participation="bernoulli", participation_p=0.5,
            faults=FaultConfig(corrupt_p=0.2, corrupt_kind="sign_flip",
                               fault_seed=2),
            defense=DefenseConfig(validate=True, gate_mult=4.0)),
        "markov_bitflip_gate": dict(
            participation="markov", participation_p=0.7, markov_sojourn=3.0,
            faults=FaultConfig(corrupt_p=0.3, corrupt_kind="bitflip",
                               bitflip_frac=0.5, fault_seed=4),
            defense=DefenseConfig(validate=True, gate_mult=1.5)),
        "delay_scale_clip_crash": dict(
            participation="delay", max_delay=2,
            faults=FaultConfig(corrupt_p=0.25, corrupt_kind="scale",
                               corrupt_scale=-40.0, crash_p=0.1,
                               fault_seed=7),
            defense=DefenseConfig(clip_mult=4.0)),
        "trimmed_mean_crash_no_reconcile": dict(
            faults=FaultConfig(corrupt_p=0.15, corrupt_kind="scale",
                               corrupt_scale=-40.0, crash_p=0.1),
            defense=DefenseConfig(reconcile_crashes=False),
            aggregator="trimmed_mean", trim_frac=0.2),
    }

    def q_engine(dev, kw):
        return RoundEngine(FullBatchSource(q_loss, (qc.to(dev), qa.to(dev))),
                           StrategyConfig(**q_base, **kw), alpha=0.3)

    def compare(name, runs):
        (ca, a), (cb, b) = runs["cuda"], runs["cpu"]
        ra, rb = ca[1].defense.rejects, cb[1].defense.rejects
        if not (torch.equal(a.cum_uploads, b.cum_uploads)
                and torch.equal(a.cum_bits, b.cum_bits)
                and ((ra is None and rb is None) or torch.equal(ra, rb))):
            raise AssertionError(
                f"{name}: uploads/bits/rejections differ card vs CPU: "
                f"{a.cum_uploads.tolist()} {ra} vs {b.cum_uploads.tolist()} "
                f"{rb}")
        if not torch.equal(a.loss.isnan(), b.loss.isnan()):
            raise AssertionError(f"{name}: NaN losses differ card vs CPU")
        live = ~b.loss.isnan()
        rel = (((a.loss - b.loss).abs() / b.loss.abs())[live].max().item()
               if live.any() else 0.0)
        if not rel <= 1e-4:
            raise AssertionError(f"{name}: loss differs card vs CPU by "
                                 f"{rel:.3e}")
        log(f"  ok {name}: uploads {a.cum_uploads.tolist()} rejections "
            f"{None if ra is None else ra.tolist()} equal on card and CPU; "
            f"loss max rel diff {rel:.3e}")

    for name, strategy in lm_runs.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = lm_engine(dev, strategy)
            runs[dev] = eng.run_from(eng.init_carry(params, device=dev),
                                     SMALL_ROBUST_ROUNDS)
        compare(f"smoke stablelm {name}", runs)
    for name, kw in q_runs.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = q_engine(dev, kw)
            runs[dev] = eng.run_from(eng.init_carry(
                {"x": torch.zeros(20)}, device=dev), 30)
        compare(f"quadratic {name}", runs)

    logs = {}
    for dev in ("cpu", "cuda"):
        def escalate(engine):
            return RoundEngine(engine.source, engine.cfg._replace(
                defense=DefenseConfig(validate=True)), alpha=engine.alpha)

        res, wlog, carry = run_with_watchdog(
            q_engine(dev, dict(faults=FaultConfig(corrupt_p=0.1,
                                                  corrupt_kind="inf"))),
            {"x": torch.zeros(20)}, 40,
            ckpt_path=os.path.join(tmpdir, f"watchdog_{dev}.npz"),
            wd=WatchdogConfig(chunk=10), escalate=escalate, device=dev)
        logs[dev] = (wlog, res.cum_bits, carry[1].defense.rejects)
    (la, ba, ra), (lb, bb, rb) = logs["cuda"], logs["cpu"]
    if la != lb or not la["rollbacks"] or not torch.equal(ba, bb) \
            or not torch.equal(ra, rb):
        raise AssertionError(f"watchdog: card {la} vs CPU {lb}")
    log(f"  ok run_with_watchdog with escalation: log {la} equal on card "
        f"and CPU")

    eng = lm_engine("cuda", lm_runs["robust_full"])
    _, whole = eng.run_from(eng.init_carry(params, device="cuda"),
                            SMALL_ROBUST_ROUNDS)
    carry, first = eng.run_from(eng.init_carry(params, device="cuda"), 2)
    path = os.path.join(tmpdir, "resume.npz")
    save_checkpoint(path, carry, 2)
    del carry
    carry, step = load_checkpoint(path, eng.init_carry(params,
                                                       device="cuda"))
    _, second = eng.run_from(carry, SMALL_ROBUST_ROUNDS - 2)
    for f in ("cum_uploads", "cum_bits", "loss", "quant_err"):
        if step != 2 or not torch.equal(
                torch.cat([getattr(first, f), getattr(second, f)]),
                getattr(whole, f)):
            raise AssertionError(f"checkpoint resume on the card: {f} "
                                 f"differs from the unbroken run")
    log(f"  ok checkpoint resume on the card at round 2 equals the "
        f"unbroken {SMALL_ROBUST_ROUNDS} rounds")

    # the runs whose carry holds shared iterates: a resumed carry holds one
    # tensor per distinct iterate, no more memory than the unbroken one
    del carry, whole, first, second, _
    stoch_corpus = lm_worker_corpus(1, W, STOCH_N_LOCAL, 32, cfg.vocab,
                                    device="cuda")
    shared = {
        "lasg_ps": (False, lm_runs["delay"]._replace(
            participation="full", max_delay=0, lazy_rule="lasg_ps")),
        "delay": (False, lm_runs["delay"]),
        "wk2_svrg_bernoulli": (True, lm_runs["delay"]._replace(
            participation="bernoulli", participation_p=0.6, max_delay=0,
            lazy_rule="lasg_wk2", grad_mode="svrg", svrg_period=2)),
    }
    for name, (stochastic, strategy) in shared.items():
        if stochastic:
            eng = RoundEngine(AccumulatingSource(
                lm_worker_loss(cfg, W), stoch_corpus, batch=STOCH_BATCH,
                seed=0, accum=ACCUM, scale=1.0), strategy, alpha=SMALL_ALPHA)
        else:
            eng = lm_engine("cuda", strategy)
        shared_resume_check(torch, name, eng, params, path)


def shared_resume_check(torch, name, eng, params, path):
    """Phase 3: ``eng`` 2 rounds from ``params`` on the card, saved to
    ``path`` and resumed into a fresh carry; the resumed run's next 2
    rounds must equal the unbroken run's bit for bit (counts, losses,
    radii and parameters), and ``torch.cuda.memory_allocated()`` of the
    resumed carry, taken after the load, must be no more than the unbroken
    carry's (both printed)."""
    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.tree import tree_leaves

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    a0 = allocated()
    carry, rec = eng.run_from(eng.init_carry(params, device="cuda"), 2)
    del rec
    unbroken = allocated() - a0
    save_checkpoint(path, carry, 2)
    _, whole = eng.run_from(carry, 2)
    del carry, _
    a1 = allocated()
    carry, step = load_checkpoint(path, eng.init_carry(params, device="cuda"))
    resumed = allocated() - a1
    _, second = eng.run_from(carry, 2)
    del carry, _
    same = step == 2 and all(
        torch.equal(getattr(second, f), getattr(whole, f))
        for f in ("cum_uploads", "cum_bits", "loss", "quant_err")) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(second.params),
                                          tree_leaves(whole.params)))
    if not same:
        raise AssertionError(f"checkpoint resume of {name} on the card "
                             "differs from the unbroken run")
    if resumed > unbroken:
        raise AssertionError(
            f"checkpoint resume of {name} on the card: the resumed carry "
            f"holds {resumed} B, the unbroken one {unbroken} B")
    log(f"  ok checkpoint resume of {name} on the card at round 2 equals "
        f"the unbroken run; torch.cuda.memory_allocated() of the carry: "
        f"unbroken {unbroken} B, resumed {resumed} B")


def random_card_check(torch):
    """Phase 3: ``repro_torch.random`` on the card bitwise equal to the CPU,
    in both threefry layouts, from keys to every draw the port makes."""
    from repro_torch import random
    n = 0
    for flag in (True, False):
        with random.threefry_partitionable(flag):
            for seed in (0, 7, 2**32 - 1):
                draws = {}
                for dev in ("cpu", "cuda"):
                    k = random.fold_in(random.PRNGKey(seed, device=dev), 3)
                    draws[dev] = (
                        random.split(k, 5), random.random_bits(k, ((1 << 20) + 3,)),
                        random.uniform(k, (1000, 7)),
                        random.randint(k, (4097,), 0, 12),
                        random.randint(k, (33,), -5, 2**31 - 1),
                        random.bernoulli(k, 0.5, (512, 3)),
                        random.normal(k, (1000, 7)),
                        random.normal(k, (200_001,)),
                        random.uniform(k, (4097,), minval=-3.0, maxval=7.0),
                        random.permutation(k, 4001))
                for a, b in zip(draws["cuda"], draws["cpu"]):
                    same = (_same_bits(torch, a, b) if b.is_floating_point()
                            else torch.equal(a.cpu(), b))
                    if a.device.type != "cuda" or not same:
                        raise AssertionError(
                            f"random draw differs card vs CPU (partitionable="
                            f"{flag}, seed {seed}, shape {tuple(b.shape)})")
                    n += b.numel()
    log(f"  ok random.py: {n} drawn values bitwise equal on card and CPU "
        f"in both layouts")


def stochastic_small_check(torch):
    """Phase 3: ``run_stochastic`` on a small Table 3 regression (6 workers
    of 12 examples, p=8, batch 4, b=4, 30 rounds) on the card vs the CPU:
    identical uploads, bits and mean bits, loss to rtol 1e-4."""
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.simulated import run_stochastic
    from repro_torch.core.strategy import StrategyConfig
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(6, 12, 8, generator=gen)
    Y = X @ torch.linspace(-1.0, 1.0, 8) + 0.3 * torch.randn(6, 12,
                                                             generator=gen)

    def loss(params, data):
        x, y = data
        return 0.5 * torch.sum(torch.square(x @ params["w"] - y)) / 72

    cfg = StrategyConfig(kind="laq", bits=4, wire_backend="fused",
                         criterion=CriterionConfig(D=10, xi=0.08, t_bar=20))
    for kind in ("slaq", "slaq_ps", "qsgd", "ssgd"):
        runs = {dev: run_stochastic(loss, {"w": torch.zeros(8)}, (X, Y), kind,
                                    steps=30, alpha=0.3, batch=4, bits=4,
                                    seed=2, laq_cfg=cfg, device=dev)
                for dev in ("cpu", "cuda")}
        a, b = runs["cuda"], runs["cpu"]
        for f in ("cum_uploads", "cum_bits", "mean_bits"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"run_stochastic {kind}: {f} differs "
                                     f"card vs CPU")
        rel = ((a.loss - b.loss).abs() / b.loss.abs()).max().item()
        if not rel <= 1e-4:
            raise AssertionError(f"run_stochastic {kind}: loss differs card "
                                 f"vs CPU by {rel:.3e}")
        log(f"  ok run_stochastic {kind}, 30 rounds: uploads "
            f"{int(a.cum_uploads[-1])} bits {a.cum_bits[-1].item():.0f} equal "
            f"on card and CPU; loss max rel diff {rel:.3e}")


def small_slice_check(torch, ops, arch="stablelm-1.6b", methods=None,
                      alpha=SMALL_ALPHA):
    """Phase 3: the slice on a small input (the smoke variant of ``arch``),
    on the card vs on the CPU, for each of ``methods`` (default: all of
    ``strategies()``).  The card runs count kernel 4's launches by width:
    the tighter A-LAQ must drive its 2- and 4-bit arms through the
    engine.  Smoke qwen3-moe runs LAQ at MODEL_SMALL_ALPHA: at 0.05 its loss
    oscillates, and ulp differences in the gradient grow past rtol 1e-4 by
    round 12, as between the port and the JAX package."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.model import init_params, lm_worker_loss

    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = init_params(0, cfg, device="cpu")
    corpus = lm_worker_corpus(0, W, 2, 32, cfg.vocab, device="cpu")
    for method, strategy in strategies().items():
        if methods is not None and method not in methods:
            continue
        runs = {}
        ops.quantize_pack_adaptive.launches_by_width = {}
        for dev in ("cpu", "cuda"):
            src = AccumulatingSource(
                lm_worker_loss(cfg, W),
                {k: v.to(dev) for k, v in corpus.items()},
                deterministic=True, accum=ACCUM, scale=1.0)
            runs[dev] = RoundEngine(src, strategy, alpha=alpha).run(
                params, SMALL_ROUNDS, device=dev)
        a, b = runs["cuda"], runs["cpu"]
        if not (torch.equal(a.cum_uploads, b.cum_uploads)
                and torch.equal(a.cum_bits, b.cum_bits)
                and torch.equal(a.mean_bits, b.mean_bits)):
            raise AssertionError(
                f"{method}: uploads/bits/widths differ: cuda "
                f"{a.cum_uploads.tolist()} {a.mean_bits.tolist()} cpu "
                f"{b.cum_uploads.tolist()} {b.mean_bits.tolist()}")
        rel = ((a.loss - b.loss).abs() / b.loss.abs()).max().item()
        if not rel <= 1e-4:
            raise AssertionError(f"{method}: loss differs from the CPU run by "
                                 f"{rel:.3e}")
        by_width = dict(ops.quantize_pack_adaptive.launches_by_width)
        if method == "alaq_tight" and not {2, 4} <= set(by_width):
            raise AssertionError(f"{method}: the engine launched kernel 4 "
                                 f"only at widths {by_width}, not at 2 and 4")
        log(f"  ok {method} on {cfg.name}, {SMALL_ROUNDS} rounds: uploads "
            f"{a.cum_uploads.tolist()} mean width of the uploads "
            f"{a.mean_bits.tolist()} equal on card and CPU; loss max rel diff "
            f"{rel:.3e}; quantize_pack_adaptive launches by width {by_width}")



def _nan_equal(torch, label, names, got, want):
    """:func:`_bitwise` where NaN is compared as NaN (its payload and sign
    are the producer's): equal NaN masks, bitwise equal elsewhere."""
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{label}: {name} shapes {tuple(a.shape)} "
                                 f"vs {tuple(b.shape)}")
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            na, nb = a.isnan(), b.isnan()
            if not torch.equal(na, nb):
                raise AssertionError(f"{label}: {name} is NaN elsewhere")
            a, b = a[~na], b[~nb]
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs "
                                 f"({(a != b).sum().item()} elements)")


# the reference's rejects after 6 rounds of the NaN top-k case below, from
# the JAX engine on the CPU (tests/test_torch_faults.py, "topk_validate")
NAN_TOPK_REJECTS = [3, 2, 3, 2, 3, 2, 2, 1, 2, 0]


def nan_topk_check(torch, ops, ref):
    """Phase 3: a NaN innovation under top-k, card vs CPU.  The support of
    a vector of 2^20 planted values (ties, NaN of both signs, +-inf) at
    several k: ``jax.lax.top_k``'s order, NaN first, which CUDA's
    ``torch.topk`` must not change; kernel 7 on its NaN (and, without NaN,
    infinite) grid against its plain version on the card and the CPU; and
    the 10-worker quadratic of tests/torch_engine_cases.py under top-k
    with error feedback and NaN corruption, 6 rounds on the fused wire,
    with validation (rejects equal to the reference's) and without (a NaN
    loss): uploads, bits, rejects and NaN-ness equal on both devices."""
    import numpy as np
    from repro_torch.core.compressors import select_support, sparse_grid
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.defense import DefenseConfig
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.strategy import StrategyConfig

    rng = np.random.default_rng(5)
    n = 1 << 20
    flat = (rng.choice(np.array([0.5, 1.0, 1.5, 3.0], np.float32), n)
            * np.where(rng.random(n) < 0.5, -1.0, 1.0)).astype(np.float32)
    at = rng.choice(n, 400, replace=False)
    flat[at[:150]] = np.nan
    flat[at[150:300]] = -np.float32(np.nan)
    flat[at[300:]] = np.where(np.arange(100) % 2, np.inf, -np.inf)
    no_nan = np.where(np.isnan(flat), np.float32(0.25), flat)
    for label, x, ks in (("NaN", flat, (100, 300, 1000, n // 20, n // 2)),
                         ("inf", no_nan, (50, 1000, n // 20))):
        for k in ks:
            sel = {dev: select_support("topk", torch.from_numpy(x).to(dev), k)
                   for dev in ("cpu", "cuda")}
            _nan_equal(torch, f"top-k {label} k={k}", ("idx", "vals"),
                       sel["cuda"], sel["cpu"])
            for bits in (1, 4, 8):
                out = {}
                for dev, s in sel.items():
                    lo, hi = sparse_grid(s.vals, bits)
                    out[dev] = (lo.reshape(1), hi.reshape(1)) + tuple(
                        ops.sparse_quantize_pack(s.vals, lo, hi, bits))
                    if dev == "cuda":
                        _nan_equal(torch, f"kernel 7 {label} k={k} b={bits}",
                                   ("packed", "codes", "deq"), out[dev][2:],
                                   ref.sparse_quantize_pack_ref(s.vals, lo, hi,
                                                                bits))
                _nan_equal(torch, f"sparse grid {label} k={k} b={bits}",
                           ("lo", "hi", "packed", "codes", "deq"),
                           out["cuda"], out["cpu"])
        log(f"  ok top-k with {label} planted, k in {ks}: support and "
            f"kernel 7's grid equal on card and CPU")

    qrng = np.random.default_rng(0)
    qc = torch.from_numpy(qrng.standard_normal((10, 20)).astype(np.float32))
    qa = torch.from_numpy((0.5 + qrng.uniform(size=(10, 20)))
                          .astype(np.float32))

    def q_loss(p, data):
        c, a = data
        return 0.5 * torch.sum(a * torch.square(p["x"] - c)) / 10

    base = dict(kind="laq", bits=4, wire_backend="fused", compressor="topk",
                compressor_k=0.25, error_feedback=True,
                criterion=CriterionConfig(D=10, xi=0.08, t_bar=20),
                faults=FaultConfig(corrupt_p=0.3, corrupt_kind="nan",
                                   fault_seed=1))
    for name, kw in (("validate", dict(defense=DefenseConfig(validate=True))),
                     ("undefended", {})):
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = RoundEngine(FullBatchSource(q_loss, (qc.to(dev),
                                                       qa.to(dev))),
                              StrategyConfig(**base, **kw), alpha=0.3)
            runs[dev] = eng.run_from(eng.init_carry({"x": torch.zeros(20)},
                                                    device=dev), 6)
        (ca, a), (cb, b) = runs["cuda"], runs["cpu"]
        ra, rb = ca[1].defense.rejects, cb[1].defense.rejects
        if not (torch.equal(a.cum_uploads, b.cum_uploads)
                and torch.equal(a.cum_bits, b.cum_bits)
                and torch.equal(a.loss.isnan(), b.loss.isnan())):
            raise AssertionError(f"NaN top-k {name}: card vs CPU: "
                                 f"{a.cum_uploads.tolist()} {a.loss.tolist()}"
                                 f" vs {b.cum_uploads.tolist()} "
                                 f"{b.loss.tolist()}")
        if name == "validate" and not (ra.tolist() == rb.tolist()
                                       == NAN_TOPK_REJECTS):
            raise AssertionError(f"NaN top-k: rejects {ra.tolist()} (card), "
                                 f"{rb.tolist()} (CPU), reference "
                                 f"{NAN_TOPK_REJECTS}")
        if name == "undefended" and not a.loss[-1].isnan():
            raise AssertionError("NaN top-k undefended: the loss is finite")
        log(f"  ok NaN top-k {name}: uploads {a.cum_uploads.tolist()}, "
            f"rejects {None if ra is None else ra.tolist()}, last loss "
            f"{a.loss[-1].item()} on card and CPU")


def serve_small_check(torch, arch="stablelm-1.6b"):
    """Phase 3: the smoke variant of ``arch`` in float32 serves on the card
    as on the CPU: prefill of 4 x 24 tokens and 8 decode steps fed the
    CPU's greedy tokens, logits to SERVE_SMALL_ATOL, the greedy ids of each
    step equal; then the greedy pair of ``jit_serve`` free-running, the
    same ids."""
    from repro_torch import random
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import jit_serve
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = {"cpu": init_params(0, cfg, device="cpu")}
    params["cuda"] = tree_map(lambda l: l.to("cuda"), params["cpu"])
    prompts = random.randint(random.PRNGKey(1, device="cpu"), (4, 24), 0,
                             cfg.vocab).long()
    logits, caches = {}, {}
    for dev in ("cpu", "cuda"):
        logits[dev], caches[dev] = prefill(params[dev], prompts.to(dev), cfg,
                                           32)
    worst = 0.0
    for step in range(9):
        a, b = logits["cuda"].cpu(), logits["cpu"]
        worst = max(worst, (a - b).abs().max().item())
        ids = {d: torch.argmax(x[:, -1:], -1) % cfg.vocab
               for d, x in (("cuda", a), ("cpu", b))}
        if not (worst <= SERVE_SMALL_ATOL
                and torch.equal(ids["cuda"], ids["cpu"])):
            raise AssertionError(f"serve: step {step} logits differ card vs "
                                 f"CPU by {worst:.3e} or ids differ")
        if step < 8:
            for dev in ("cpu", "cuda"):
                logits[dev], caches[dev] = decode_step(
                    params[dev], caches[dev], ids["cpu"].to(dev), cfg)
    seqs = {}
    for dev in ("cpu", "cuda"):
        pre, dec = jit_serve(cfg, 32)
        tok, cache = pre(params[dev], prompts.to(dev))
        seq = [tok]
        for _ in range(8):
            tok, cache = dec(params[dev], cache, tok)
            seq.append(tok)
        seqs[dev] = torch.cat(seq, 1).cpu()
    if not torch.equal(seqs["cuda"], seqs["cpu"]):
        raise AssertionError("serve: greedy ids differ card vs CPU")
    log(f"  ok serve on {cfg.name} (float32): prefill + 8 decode steps, "
        f"logits max abs diff card vs CPU {worst:.3e} (limit "
        f"{SERVE_SMALL_ATOL}), greedy ids equal: {seqs['cuda'][0].tolist()}")


def publish_small_check(torch, ops):
    """Phase 3: the micro LM's trainer (``benchmarks_torch/serve_frontier``)
    runs 10 rounds on the CPU; the fused-wire publisher and a fleet of two
    replicas (``max_delay=1``) replay that trajectory on the card and on the
    CPU, at b=4 and with the adaptive schedule.  Kinds, widths and bits
    equal; ``theta_pub`` and replica 0 bitwise equal card vs CPU."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks_torch.serve_frontier import _train_trajectory
    from repro_torch.core.adaptive import BitSchedule
    from repro_torch.core.replica import (PublishConfig, init_publisher,
                                          publish)
    from repro_torch.launch.publish import ReplicaFleet
    from repro_torch.tree import tree_leaves, tree_map

    params0, traj = _train_trajectory(10, torch.device("cpu"))
    policies = {
        "b4": PublishConfig(bits=4, threshold=0.35, max_staleness=1,
                            wire_backend="fused"),
        "adaptive": PublishConfig(threshold=0.0, wire_backend="fused",
                                  bit_schedule=BitSchedule(
                                      kind="radius", grid=(2, 4, 8),
                                      threshold_mode="rel",
                                      thresholds=(0.05, 0.5))),
    }
    for name, pcfg in policies.items():
        runs = {}
        before = (ops.absmax.launches, ops.quantize_pack_fused.launches)
        for dev in ("cpu", "cuda"):
            p0 = tree_map(lambda l: l.to(dev), params0)
            st = init_publisher(p0, pcfg)
            fleet = ReplicaFleet(p0, 2, pcfg, max_delay=1)
            rows = []
            for params in traj:
                msg, st = publish(pcfg, st,
                                  tree_map(lambda l: l.to(dev), params))
                fleet.deliver(msg)
                rows.append((type(msg).__name__, getattr(msg, "width", None),
                             st.bits_sent))
            runs[dev] = (rows, st.theta_pub, fleet.replicas[0].params)
        launched = (ops.absmax.launches - before[0],
                    ops.quantize_pack_fused.launches - before[1])
        (ra, ta, pa), (rb, tb, pb) = runs["cuda"], runs["cpu"]
        if ra != rb:
            raise AssertionError(f"publish {name}: kinds/widths/bits differ "
                                 f"card vs CPU: {ra} vs {rb}")
        for label, x, y in (("theta_pub", ta, tb), ("replica 0", pa, pb)):
            if not all(torch.equal(u.cpu(), v) for u, v in
                       zip(tree_leaves(x), tree_leaves(y))):
                raise AssertionError(f"publish {name}: {label} differs card "
                                     "vs CPU")
        if not all(launched):
            raise AssertionError(f"publish {name}: kernels 1, 2 launched "
                                 f"{launched} times on the card")
        log(f"  ok publish {name} over 10 micro-LM rounds: kinds/widths "
            f"{[r[:2] for r in ra]}, bits {ra[-1][2]:.0f} equal; theta_pub "
            f"and replica 0 bitwise card vs CPU; card launches (absmax, "
            f"quantize_pack_fused) {launched}")


def check_codes_kernels(leaf_shapes, torch, ops, ref):
    """Phase 2, kernels 5, 6 and 3: bitwise against their plain versions at
    every main-path shape and the edge cases; kernel 6 pinned at a width is
    kernel 5.  Returns the largest absolute error of each (0 when
    bitwise)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    grid = (2, 4, 8)
    err = {"quantize_codes_fused": 0.0, "quantize_codes_adaptive": 0.0,
           "quantize_pack": 0.0}

    def one(label, g, qh, bits_list):
        R = ops.absmax(g, qh)
        for bits in bits_list:
            got = ops.quantize_codes_fused(g, qh, R, bits)
            _bitwise(torch, f"{label} b={bits} codes", ("codes", "delta"),
                     got, ref.quantize_codes_ref(g, qh, R, bits))
            pk = ops.quantize_pack(g, qh, R, bits)
            _bitwise(torch, f"{label} b={bits} payload", ("packed", "delta"),
                     pk, ref.quantize_pack_payload_ref(g, qh, R, bits))
            if not torch.equal(pk[1], got[1]):
                raise AssertionError(f"{label}: kernels 3 and 5 disagree")
            if bits in grid:
                sel = grid.index(bits)
                ad = ops.quantize_codes_adaptive(g, qh, R, torch.eye(3)[sel],
                                                 grid)
                _bitwise(torch, f"{label} b={bits} adaptive",
                         ("codes", "delta"), ad,
                         ref.quantize_codes_adaptive_ref(g, qh, R, grid, sel))
                _bitwise(torch, f"{label} b={bits} adaptive vs kernel 5",
                         ("codes", "delta"), ad, got)
        torch.cuda.synchronize()
        log(f"  ok {label}: n={g.numel()} b={bits_list} kernels 5, 6, 3 "
            "bitwise")

    for name, shape in leaf_shapes:
        g, qh = _pair(torch, gen, math.prod(shape))
        one(f"{name} {tuple(shape)}", g.view(shape), qh.view(shape),
            (1, 2, 4, 8))
        del g, qh
    g, qh = _pair(torch, gen, 3 * 4096 + 1239)
    one("ragged length", g, qh, (1, 2, 4, 8))
    g, qh = _pair(torch, gen, 4097 * 3)
    one("odd last dim (4097, 3)", g.view(4097, 3), qh.view(4097, 3), (2, 4, 8))
    g, qh = _pair(torch, gen, 1_000_003, shift=1)
    one("unaligned operands", g, qh, (2, 4, 8))
    g, qh = _pair(torch, gen, 1_000_003)
    one("R == 0", g, g.clone(), (1, 2, 4, 8))
    g[1234] = float("nan")
    one("NaN input", g, qh, (2, 4, 8))
    return err


def check_dequant_kernel(leaf_shapes, torch, ops, ref):
    """Phase 2, kernel 8: bitwise against its plain version (acc first, then
    worker by worker) at every leaf shape with W=4, keep (1, 0, 1, 1) and
    one zero radius, with and without acc, each b; at W in {1, 2}, an
    unpadded payload and a NaN radius.  Returns the largest absolute
    error."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)

    def one(label, n, W, bits, nbytes=None, nan_radius=False):
        nbytes = nbytes or -(-n // 4096) * 4096 * bits // 8
        packed = torch.randint(0, 256, (W, nbytes), generator=gen,
                               device="cuda", dtype=torch.uint8)
        R = torch.rand(W, generator=gen, device="cuda") * 1e-2
        R[min(1, W - 1)] = float("nan") if nan_radius else 0.0
        keep = torch.tensor((1.0, 0.0, 1.0, 1.0)[:W], device="cuda")
        acc = torch.randn(n, generator=gen, device="cuda")
        for a in (None, acc):
            got = ops.dequant_acc(packed, R, keep, bits, n, a)
            want = ref.dequant_acc_ref(packed, R, keep, bits, n, a)
            _bitwise(torch, f"{label} W={W} b={bits} acc={a is not None}",
                     ("out",), (got,), (want,))
        torch.cuda.synchronize()

    for name, shape in leaf_shapes:
        n = math.prod(shape)
        for bits in (1, 2, 4, 8):
            one(f"{name} {tuple(shape)}", n, 4, bits)
        log(f"  ok {name} {tuple(shape)}: kernel 8 W=4 b=1,2,4,8 with and "
            "without acc bitwise")
    for W in (1, 2, 4):
        for bits in (1, 2, 4, 8):
            n = 3 * 4096 + 1239
            one("ragged", n, W, bits)
            one("unpadded payload", n, W, bits, nbytes=-(-n * bits // 8))
            one("NaN radius", n, W, bits, nan_radius=True)
    log("  ok kernel 8 at W=1, 2, 4: ragged, unpadded payload, NaN radius")
    return 0.0


def time_new_kernels(n, torch, ops, ref):
    """Kernels 5, 6, 3 and 8 and their plain versions at the largest leaf:
    kernels 5 and 6 at each width of the grid (2, 4, 8), kernel 3 at b in
    {4, 8}, kernel 8 at W=4, b=4 with and without acc."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    g = torch.randn(n, generator=gen, device="cuda") * 1e-3
    qh = g + torch.randn(n, generator=gen, device="cuda") * 1e-4
    R = ops.absmax(g, qh)
    grid = (2, 4, 8)
    codes, adaptive = {}, {}
    for sel, b in enumerate(grid):
        onehot = torch.eye(3)[sel]
        codes[b] = dict(
            ms=time_ms(lambda: ops.quantize_codes_fused(g, qh, R, b)),
            plain_ms=time_ms(lambda: ref.quantize_codes_ref(g, qh, R, b)))
        adaptive[b] = dict(
            ms=time_ms(lambda: ops.quantize_codes_adaptive(g, qh, R, onehot,
                                                           grid)),
            plain_ms=time_ms(lambda: ref.quantize_codes_adaptive_ref(
                g, qh, R, grid, sel)))
    payload = {b: dict(
        ms=time_ms(lambda: ops.quantize_pack(g, qh, R, b)),
        plain_ms=time_ms(lambda: ref.quantize_pack_payload_ref(g, qh, R, b)),
        bytes=8 * n + 4 * n + n * b // 8 + 4) for b in (4, 8)}
    rows = {
        "quantize_codes_fused": dict(
            **codes[4], library_ms=None, bytes=8 * n + n + 4 * n + 4,
            ops=10 * n, by_width={str(b): r for b, r in codes.items()}),
        "quantize_codes_adaptive": dict(
            **adaptive[4], library_ms=None, bytes=8 * n + n + 4 * n + 4,
            ops=10 * n, by_width={str(b): r for b, r in adaptive.items()}),
        "quantize_pack": dict(
            ms=payload[4]["ms"], plain_ms=payload[4]["plain_ms"],
            library_ms=None, bytes=payload[4]["bytes"], ops=10 * n,
            by_width={str(b): dict(ms=r["ms"], plain_ms=r["plain_ms"])
                      for b, r in payload.items()}),
    }
    del g, qh
    W, b = 4, 4
    packed = torch.randint(0, 256, (W, n * b // 8), generator=gen,
                           device="cuda", dtype=torch.uint8)
    Rw = torch.rand(W, generator=gen, device="cuda") * 1e-2
    keep = torch.tensor((1.0, 0.0, 1.0, 1.0), device="cuda")
    acc = torch.randn(n, generator=gen, device="cuda")
    with_acc = dict(
        ms=time_ms(lambda: ops.dequant_acc(packed, Rw, keep, b, n, acc)),
        plain_ms=time_ms(lambda: ref.dequant_acc_ref(packed, Rw, keep, b, n,
                                                     acc)))
    wb = with_acc["bytes"] = W * n * b // 8 + 4 * n + 4 * n + 8 * W
    with_acc["bound_ms"] = wb / HBM_BYTES_PER_S * 1e3
    rows["dequant_acc"] = dict(
        ms=time_ms(lambda: ops.dequant_acc(packed, Rw, keep, b, n)),
        plain_ms=time_ms(lambda: ref.dequant_acc_ref(packed, Rw, keep, b, n)),
        library_ms=None, bytes=W * n * b // 8 + 4 * n + 8 * W,
        ops=4 * W * n, with_acc=with_acc)
    del packed, acc
    return {name: _bound(r) for name, r in rows.items()}


def sharded_strategies():
    """The sharded step's configurations (phase 5): b=4 and the adaptive
    schedule on the packed wire, lasg_wk2 + SVRG (anchor refreshed every 2
    steps) on the packed wire at b=4, phase 4's EF-top-k (b=4, 5%) on
    the float wire, and b=4 with ``qhat`` and ``server_agg`` in bfloat16
    (``state_bf16``) on the packed and on the float wire."""
    from repro_torch.core.adaptive import BitSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.strategy import StrategyConfig
    base = dict(kind="laq", bits=4, per_leaf_radius=True,
                wire_backend="fused",
                criterion=CriterionConfig(D=10, xi=0.08, t_bar=100))
    return {
        "sharded_b4": StrategyConfig(**base),
        "sharded_adaptive": StrategyConfig(**base, bit_schedule=BitSchedule(
            kind="radius", grid=(2, 4, 8), threshold_mode="rel",
            thresholds=(0.05, 0.5))),
        "sharded_wk2_svrg": StrategyConfig(**base, lazy_rule="lasg_wk2",
                                           grad_mode="svrg", svrg_period=2),
        "sharded_ef_topk": StrategyConfig(**base, compressor="topk",
                                          compressor_k=0.05,
                                          error_feedback=True),
        "sharded_b4_bf16": StrategyConfig(**base, state_bf16=True),
        "sharded_float_bf16": StrategyConfig(**base, state_bf16=True),
    }


# phase 5's smoke-size runs of the sharded step, card vs CPU: the lazy rules
# and SVRG (anchor refreshed every 2 steps) and the compressors, each as
# StrategyConfig fields, its wire and its xi (tests/torch_dist_cases.py's
# settings: a criterion that splits skips and uploads)
SHARDED_SMALL = {
    "lasg_wk": (dict(lazy_rule="lasg_wk"), "packed", 0.3),
    "lasg_wk2": (dict(lazy_rule="lasg_wk2"), "packed", 0.003),
    "lasg_ps": (dict(lazy_rule="lasg_ps"), "packed", 0.3),
    "svrg": (dict(grad_mode="svrg", svrg_period=2), "packed", 0.3),
    "wk2_svrg": (dict(lazy_rule="lasg_wk2", grad_mode="svrg",
                      svrg_period=2), "float", 0.003),
    "ef_topk": (dict(compressor="topk", compressor_k=0.1,
                     error_feedback=True), "float", 0.3),
    "randk": (dict(compressor="randk", compressor_k=0.1), "float", 0.5),
    "ef_randk": (dict(compressor="randk", compressor_k=0.1,
                      error_feedback=True), "float", 1.0),
    "bf16_b4": (dict(state_bf16=True), "packed", 0.3),
    "bf16_float": (dict(state_bf16=True), "float", 0.3),
    "bf16_wk2_svrg": (dict(lazy_rule="lasg_wk2", grad_mode="svrg",
                           svrg_period=2, state_bf16=True), "packed", 0.003),
}
SHARDED_SMALL_STEPS = 4


def sharded_small_check(torch, card_workers, cpu_workers):
    """Phase 5, first: each of ``SHARDED_SMALL`` through the sharded step
    on smoke stablelm in float32, one worker of 2 x 32 tokens, on the card
    (NCCL) and on the CPU (gloo): uploads and bits equal step by step, the
    loss to rtol 1e-4 (the CPU runs are held to the JAX package's step by
    ``tests/test_torch_train.py``)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.adaptive import EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = init_params(0, cfg, device="cpu")
    corpus = lm_worker_corpus(0, 1, 2, 32, cfg.vocab, device="cpu")
    for name, (fields, wire, xi) in SHARDED_SMALL.items():
        strat = StrategyConfig(
            kind="laq", bits=4, per_leaf_radius=True, wire_backend="fused",
            criterion=CriterionConfig(D=10, xi=xi, t_bar=100,
                                      include_quant_error=False),
            eta_schedule=EtaSchedule("inv_t", t0=30.0), **fields)
        runs = {}
        for dev, workers in (("cuda", card_workers), ("cpu", cpu_workers)):
            batch = {k: v[0].to(dev) for k, v in corpus.items()}
            state = init_train_state(
                tree_map(lambda l: l.to(dev, copy=True), params), workers,
                strat, sgd())
            step = make_train_step(cfg, workers, strat, sgd(),
                                   lr=SHARDED_LR, wire=wire,
                                   microbatch=SHARDED_MICROBATCH)
            rec = []
            for _ in range(SHARDED_SMALL_STEPS):
                state, met = step(state, batch)
                rec.append((met.loss.item(), met.uploads, met.bits.item()))
            runs[dev] = (rec, [l.cpu() for l in tree_leaves(state.params)])
        (a, pa), (b, pb) = runs["cuda"], runs["cpu"]
        if [r[1:] for r in a] != [r[1:] for r in b]:
            raise AssertionError(f"phase 5 small {name}: uploads/bits differ: "
                                 f"cuda {a} cpu {b}")
        rel = max(abs(x[0] - y[0]) / abs(y[0]) for x, y in zip(a, b))
        if not rel <= 1e-4:
            raise AssertionError(f"phase 5 small {name}: loss differs from "
                                 f"the CPU run by {rel:.3e}")
        dp = max((x - y).abs().max().item() for x, y in zip(pa, pb))
        log(f"  ok {name} ({wire} wire): uploads/bits {[r[1:] for r in a]} "
            f"equal on card and CPU; loss max rel diff {rel:.3e}; params "
            f"max abs diff {dp:.3e}")


SHARDED_KERNELS = ("absmax", "quantize_pack_fused", "quantize_pack_adaptive",
                   "quantize_codes_fused", "quantize_codes_adaptive",
                   "sparse_quantize_pack")


def run_sharded_path(torch, ops, workers, method, cfg, steps):
    """Phase 5: one configuration of the sharded step at full width on one
    worker (its wire: ``SHARDED_FLOAT`` or packed), fresh params, the
    launch counters zeroed just before the steps and read just after.
    Under ``state_bf16`` the stored ``qhat`` and ``server_agg`` must be
    bfloat16 after every step, and the final parameters are returned on
    the host (else None)."""
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import tree_leaves

    corpus = lm_worker_corpus(0, 1, SHARDED_ROWS, SEQ, cfg.vocab,
                              device="cuda")
    batch = {k: v[0] for k, v in corpus.items()}
    strat = sharded_strategies()[method]
    state = init_train_state(init_params(0, cfg, device="cuda"), workers,
                             strat, sgd())
    step = make_train_step(cfg, workers, strat, sgd(), lr=SHARDED_LR,
                           wire=("float" if method in SHARDED_FLOAT
                                 else "packed"),
                           microbatch=SHARDED_MICROBATCH)
    torch.cuda.synchronize()
    for name in SHARDED_KERNELS:
        getattr(ops, name).launches = 0
    ops.quantize_codes_adaptive.launches_by_width = {}
    recs, step_ms, peaks = [], [], []
    for k in range(steps):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        recs.append(met)
        log(f"  step {k + 1}: loss {met.loss.item():.6f} uploads "
            f"{met.uploads} bits {met.bits.item():.6e} ms {step_ms[-1]:.1f} "
            f"peak_alloc {peaks[-1] / 1e9:.2f} GB")
        if strat.state_bf16:
            dtypes = {l.dtype for l in tree_leaves(state.comm.qhat)
                      + tree_leaves(state.comm.server_agg)}
            if dtypes != {torch.bfloat16}:
                raise AssertionError(f"{method}: state dtypes {dtypes} after "
                                     f"step {k + 1}")
    launches = {name: getattr(ops, name).launches for name in SHARDED_KERNELS}
    launches["codes_adaptive_by_width"] = dict(
        ops.quantize_codes_adaptive.launches_by_width)
    final = ([l.cpu() for l in tree_leaves(state.params)]
             if strat.state_bf16 else None)
    del state, step, corpus, batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if not all(math.isfinite(m.loss.item()) for m in recs):
        raise AssertionError(f"{method}: non-finite loss")
    if recs[0].uploads != 1:
        raise AssertionError(f"{method}: step 1 uploaded {recs[0].uploads}")
    if max(peaks) >= PEAK_LIMIT:
        raise AssertionError(f"{method}: peak allocation {max(peaks)} B >= "
                             f"{PEAK_LIMIT:.0f} B")
    return launches, recs, step_ms, peaks, final


def _exchange_rank(rank, port, path):
    """Phase 6, one of the EXCHANGE_W gloo ranks on the card: 3 steps of
    the float wire, then 3 of the packed wire at b=4, from the same
    parameters and batch; writes its result, or its error, to the JSON
    file ``path``.  Returns the process's exit code."""
    try:
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "src"))
        import torch
        import torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.core.defense import DefenseConfig
        from repro_torch.data.synthetic import lm_worker_corpus
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import init_workers, worker_batch
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.models.model import init_params
        from repro_torch.optim.optimizers import sgd
        from repro_torch.tree import tree_leaves

        torch.backends.cuda.matmul.allow_tf32 = False
        store = dist.TCPStore("127.0.0.1", port, EXCHANGE_W, False)
        workers = init_workers("gloo", EXCHANGE_W, rank, store)
        cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                                  n_layers=EXCHANGE_LAYERS)
        corpus = lm_worker_corpus(1, EXCHANGE_W, EXCHANGE_ROWS, SEQ,
                                  cfg.vocab, device="cuda")
        batch = worker_batch({k: v.reshape((-1,) + tuple(v.shape[2:]))
                              for k, v in corpus.items()}, workers)
        strat = sharded_strategies()["sharded_b4"]
        defended = strat._replace(**EXCHANGE_DEFENDED,
                                  defense=DefenseConfig(validate=True,
                                                        gate_mult=4.0))
        lazy = sharded_strategies()["sharded_wk2_svrg"]
        lazy_bf16 = lazy._replace(state_bf16=True)
        out = {"transport": workers.transport("cuda")}
        final = {}
        for label, st, wire in (("float", strat, "float"),
                                ("packed", strat, "packed"),
                                ("defended_float", defended, "float"),
                                ("defended_packed", defended, "packed"),
                                ("lazy_float", lazy, "float"),
                                ("lazy_packed", lazy, "packed"),
                                ("bf16_lazy_float", lazy_bf16, "float"),
                                ("bf16_lazy_packed", lazy_bf16, "packed")):
            for name in SHARDED_KERNELS:
                getattr(ops, name).launches = 0
            lcfg = cfg
            if label.startswith("lazy"):
                lcfg = dataclasses.replace(cfg, n_layers=EXCHANGE_LAZY_LAYERS)
            elif label.startswith("bf16"):
                lcfg = dataclasses.replace(cfg, n_layers=EXCHANGE_BF16_LAYERS)
            state = init_train_state(init_params(0, lcfg, device="cuda"),
                                     workers, st, sgd())
            step = make_train_step(lcfg, workers, st, sgd(),
                                   lr=SHARDED_LR, wire=wire)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = []
            for _ in range(EXCHANGE_LAZY_STEPS if "lazy" in label
                           else SHARDED_STEPS):
                t0 = time.perf_counter()
                state, met = step(state, batch)
                torch.cuda.synchronize()
                rec.append((met.loss.item(), met.uploads, met.bits.item(),
                            (time.perf_counter() - t0) * 1e3))
            out[label] = rec
            out[f"{label}_launches"] = {name: getattr(ops, name).launches
                                        for name in SHARDED_KERNELS}
            out[f"{label}_peak"] = torch.cuda.max_memory_allocated()
            rej = state.comm.defense.rejects
            out[f"{label}_rejects"] = None if rej is None else int(rej[0])
            final[label] = [l.cpu() for l in tree_leaves(state.params)]
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        out["params_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(final["float"], final["packed"]))
        for pre in ("defended_", "lazy_", "bf16_lazy_"):
            out[f"{pre}params_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(final[f"{pre}float"],
                                                  final[f"{pre}packed"]))
        out["n_params"] = sum(t.numel() for t in final["float"])
        out["lazy_n_params"] = sum(t.numel() for t in final["lazy_float"])
        out["bf16_lazy_n_params"] = sum(t.numel()
                                        for t in final["bf16_lazy_float"])
        dist.destroy_process_group()
        _report(path, out)
        return 0
    except BaseException as e:                   # reported, then exit 1
        import traceback
        _report(path, {"error": f"{e!r}\n{traceback.format_exc()}"})
        return 1


def _report(path, obj):
    """Write a child process's result ``obj`` to the JSON file ``path`` in
    one step (written aside, then renamed)."""
    with open(path + ".part", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".part", path)


def _run_children(argvs, label):
    """Run this script once per argument list of ``argvs``, all at once,
    each with the path of its JSON result appended; return the results in
    order.  Stops at the first child that fails and raises its error, or
    when ``CHILD_TIMEOUT`` has passed; every child has exited, or been
    killed and reaped, when this returns."""
    results = [None] * len(argvs)
    with tempfile.TemporaryDirectory() as tmpdir:
        paths = [os.path.join(tmpdir, f"child{i}.json")
                 for i in range(len(argvs))]
        procs = []
        try:
            for argv, path in zip(argvs, paths):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), *argv, path]))
            deadline = time.monotonic() + CHILD_TIMEOUT
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break               # a child failed: its error is read below
                if time.monotonic() > deadline:
                    raise AssertionError(f"{label}: not every process of "
                                         f"{len(procs)} ended in "
                                         f"{CHILD_TIMEOUT} s")
                time.sleep(1)
            for i, path in enumerate(paths):
                if os.path.exists(path):
                    with open(path) as f:
                        results[i] = json.load(f)
                    if "error" in results[i]:
                        raise AssertionError(f"{label} {' '.join(argvs[i])}:"
                                             f"\n{results[i]['error']}")
            for i, p in enumerate(procs):
                if results[i] is None or p.poll() != 0:
                    raise AssertionError(
                        f"{label} {' '.join(argvs[i])}: exited with "
                        f"{p.poll()}, result file "
                        f"{'missing' if results[i] is None else 'written'}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
    return results


def exchange_on_card(torch):
    """Phase 6: EXCHANGE_W gloo ranks on the one card; every rank's float
    and packed parameters must be bitwise equal, and the uploads and bits
    equal step by step.  Each rank is this script in a process of its own;
    all of them have exited, or been killed and reaped, when this returns.
    Returns rank 0's record."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, EXCHANGE_W + 1, True,
                          wait_for_workers=False)
    results = dict(enumerate(_run_children(
        [["--exchange-rank", str(r), str(store.port)]
         for r in range(EXCHANGE_W)], "phase 6")))
    del store
    for rank, out in sorted(results.items()):
        for pre in ("", "defended_", "lazy_", "bf16_lazy_"):
            if not out[f"{pre}params_bitwise"]:
                raise AssertionError(f"phase 6 rank {rank}: {pre}float and "
                                     f"{pre}packed wires gave different "
                                     "parameters")
            for a, b in zip(out[f"{pre}float"], out[f"{pre}packed"]):
                if a[1:3] != b[1:3]:
                    raise AssertionError(
                        f"phase 6 rank {rank}: uploads/bits differ between "
                        f"the {pre}wires: {a} vs {b}")
        log(f"  rank {rank}: transport {out['transport']}; float steps "
            f"(loss, uploads, bits, ms) {out['float']}; packed "
            f"{out['packed']}; defended float {out['defended_float']}; "
            f"defended packed {out['defended_packed']} (rejections "
            f"{out['defended_packed_rejects']}); lasg_wk2 + SVRG float "
            f"{out['lazy_float']}, packed {out['lazy_packed']} "
            f"({out['lazy_n_params']} params, peak "
            f"{out['lazy_float_peak'] / 1e9:.2f} GB float, "
            f"{out['lazy_packed_peak'] / 1e9:.2f} GB packed); the same "
            f"with bf16 state, float {out['bf16_lazy_float']}, packed "
            f"{out['bf16_lazy_packed']} ({out['bf16_lazy_n_params']} params, "
            f"peak {out['bf16_lazy_float_peak'] / 1e9:.2f} GB float, "
            f"{out['bf16_lazy_packed_peak'] / 1e9:.2f} GB packed); peak "
            f"{out['packed_peak'] / 1e9:.2f} GB; params bitwise equal "
            f"between the wires ({out['n_params']} params)")
    first = results[0]
    for rank, out in results.items():       # global sums: one value on all
        for wire in ("float", "packed", "defended_float", "defended_packed",
                     "lazy_float", "lazy_packed", "bf16_lazy_float",
                     "bf16_lazy_packed"):
            if [r[1:3] for r in out[wire]] != [r[1:3] for r in first[wire]]:
                raise AssertionError(f"phase 6: rank {rank}'s uploads/bits "
                                     f"differ from rank 0's ({wire} wire)")
    for rank, out in results.items():
        for label in ("packed", "defended_packed", "lazy_packed",
                      "bf16_lazy_packed"):
            n = EXCHANGE_LAZY_STEPS if "lazy" in label else SHARDED_STEPS
            want = {"absmax": 2 * 12 * n, "quantize_pack_fused": 12 * n,
                    "quantize_codes_fused": 12 * n}
            got = out[f"{label}_launches"]
            if any(got[k] != v for k, v in want.items()):
                raise AssertionError(f"phase 6 rank {rank}: {label} wire "
                                     f"launches {got}, expected {want}")
    return first


def run_bits_sweep(torch, ops):
    """Phase 7: the port's bits_sweep benchmark, its launch counters of
    kernels 3 and 8 zeroed just before and read just after."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks_torch import bits_sweep
    for name in ("quantize_pack", "dequant_acc"):
        getattr(ops, name).launches = 0
    rows = bits_sweep.run_kernels()
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches
                for name in ("quantize_pack", "dequant_acc")}
    for row in rows:
        log("  " + json.dumps(row))
    want = 2 * (1 + bits_sweep.WARMUP + bits_sweep.TIMED)
    if launches != {"quantize_pack": want, "dequant_acc": want}:
        raise AssertionError(f"phase 7 launches {launches}, expected {want} "
                             "each")
    return launches, rows


KERNELS = ("absmax", "quantize_pack_fused", "quantize_pack_adaptive",
           "sparse_quantize_pack", "quantize_pack", "quantize_codes_fused",
           "quantize_codes_adaptive", "dequant_acc")


def run_path(torch, ops, method, cfg, rounds, *, stochastic=False,
             strategy=None, uploads1=W, phase=None):
    """One path at full width: fresh params and engine, the launch counters
    zeroed just before the rounds and read just after.  Returns the
    counters, the per-round records, round ms, peak bytes and the final
    reject ledger (None without a defense).  A stochastic path (phase 8)
    draws ``STOCH_BATCH`` of its workers' ``STOCH_N_LOCAL`` sequences each
    round.  ``strategy`` overrides the method's own (phase 9), and
    ``uploads1`` is the number of workers that must upload in round 1."""
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.config import n_params
    from repro_torch.models.model import init_params, lm_worker_loss

    n_local = STOCH_N_LOCAL if stochastic else N_LOCAL
    phase = phase or (8 if stochastic else 4)
    log(f"phase {phase}: {method}, {cfg.name} at "
        f"{cfg.n_layers} layers (P={n_params(cfg)}), W={W}, {n_local}x{SEQ} "
        f"tokens per worker, accum={ACCUM}, alpha={ALPHA}, fused wire")
    corpus = lm_worker_corpus(0, W, n_local, SEQ, cfg.vocab, device="cuda")
    if stochastic:
        source = AccumulatingSource(lm_worker_loss(cfg, W), corpus,
                                    batch=STOCH_BATCH, seed=0, accum=ACCUM,
                                    scale=1.0)
        strategy = strategy or stochastic_strategies()[method]
        log(f"  round-1 sampled indices per worker: "
            f"{source.indices(0).tolist()}")
    else:
        source = AccumulatingSource(lm_worker_loss(cfg, W), corpus,
                                    deterministic=True, accum=ACCUM,
                                    scale=1.0)
        strategy = strategy or strategies()[method]
    engine = RoundEngine(source, strategy, alpha=ALPHA)
    carry = engine.init_carry(init_params(0, cfg, device="cuda"),
                              device="cuda")
    torch.cuda.synchronize()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    ops.quantize_pack_adaptive.launches_by_width = {}
    recs, round_ms, peaks = [], [], []
    for k in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        carry, rec = engine.round(carry)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        recs.append(rec)
        loss, gn, ups, bits, qe, width = rec
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        log(f"  round {k + 1}: loss {loss.item():.6f} uploads {ups} "
            f"cum_bits {bits.item():.6e} mean upload width {width.item():g} "
            f"R_max {qe.item():.4e} ms {round_ms[-1]:.1f} peak_alloc "
            f"{peaks[-1] / 1e9:.2f} GB alloc_retries {retries}")
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    launches["adaptive_by_width"] = dict(
        ops.quantize_pack_adaptive.launches_by_width)
    rejects = carry[1].defense.rejects
    rejects = None if rejects is None else rejects.tolist()
    del carry, engine, corpus, source
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    if not all(math.isfinite(r[0].item()) for r in recs):
        raise AssertionError(f"{method}: non-finite loss")
    if recs[0][2] != uploads1:
        raise AssertionError(f"{method}: round 1 uploads {recs[0][2]} != "
                             f"{uploads1}")
    if max(peaks) >= PEAK_LIMIT:
        raise AssertionError(f"{method}: peak allocation {max(peaks)} B >= "
                             f"{PEAK_LIMIT:.0f} B")
    return launches, recs, round_ms, peaks, rejects


def _greedy_session(torch, prefill_fn, decode_fn, params, prompts, tokens):
    """One serve session: prefill, then ``tokens`` greedy decode steps, the
    card synchronized after each.  Returns the prefill ms, the per-step
    ms, the ids and the cache."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = prefill_fn(params, prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms, ids = [], [tok]
    for _ in range(tokens):
        t0 = time.perf_counter()
        tok, cache = decode_fn(params, cache, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        ids.append(tok)
    return prefill_ms, step_ms, torch.cat(ids, 1), cache


def serve_full(torch, cfg):
    """Phase 10a: stablelm-1.6b at its published widths, depth and dtypes
    (bfloat16 params and compute), random weights from seed 0: prompts of
    SERVE_BATCH x SERVE_PROMPT tokens, greedy decode of SERVE_TOKENS after a
    warm-up session of the same shape.  The first decode step's logits
    must equal the training forward over prompt + token at the last
    position within SERVE_ATOL."""
    from repro_torch import random
    from repro_torch.launch.serve import jit_serve
    from repro_torch.models.config import n_params
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)

    B, S, T, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_MAX_LEN
    log(f"phase 10a: serve, stablelm-1.6b at {cfg.n_layers} layers "
        f"(P={n_params(cfg)}), {cfg.param_dtype} params and compute, "
        f"{B} x {S} prompt tokens, max_len {max_len}, {T} greedy tokens")
    params = init_params(0, cfg, device="cuda")
    prompts = random.randint(random.PRNGKey(1, device="cuda"), (B, S), 0,
                             cfg.vocab).long()
    pre, dec = jit_serve(cfg, max_len)
    _greedy_session(torch, pre, dec, params, prompts, T)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prefill_ms, step_ms, ids, cache = _greedy_session(torch, pre, dec, params,
                                                      prompts, T)
    peak = torch.cuda.max_memory_allocated()
    k = cache["attn"]["k"]
    cache_shape, cache_dtype = tuple(k.shape), str(k.dtype)
    cache_gb = 2 * k.numel() * k.element_size() / 1e9
    del cache
    decode_ms = sorted(step_ms)[len(step_ms) // 2]
    tok_s = B * T / (sum(step_ms) / 1e3)
    if not (0 <= int(ids.min()) and int(ids.max()) < cfg.vocab):
        raise AssertionError("phase 10a: greedy ids out of the vocabulary")

    # the check: decode step 1 against the forward over prompt + token
    logits0, cache = prefill(params, prompts, cfg, max_len)
    tok0 = torch.argmax(logits0[:, -1:], -1) % cfg.vocab
    logits1, cache = decode_step(params, cache, tok0, cfg)
    del cache
    seq = torch.cat([prompts, tok0], 1)
    # one key block over the S + 1 positions: the chunking of the forward
    # would otherwise take gcd(kv_chunk, S + 1) = 1-position blocks
    fwd_cfg = dataclasses.replace(cfg, kv_chunk=S + 1)
    with torch.no_grad():
        want = forward(params, seq, fwd_cfg)[:, -1:]
    err = (logits1 - want).abs().max().item()
    same = (torch.argmax(logits1, -1) == torch.argmax(want, -1)).float()
    log(f"  decode step 1 vs forward over {S + 1} tokens: max abs diff "
        f"{err:.4e} (limit {SERVE_ATOL}), |logits| <= "
        f"{want.abs().max().item():.3f}, argmax agreement "
        f"{same.mean().item():.3f}")
    if not err <= SERVE_ATOL:
        raise AssertionError(f"phase 10a: decode differs from the forward by "
                             f"{err}")
    del want, logits0, logits1, seq

    block = n_params(cfg) - 2 * cfg.padded_vocab() * cfg.d_model - cfg.d_model
    head = cfg.d_model * cfg.padded_vocab()
    attn_flops = (2 * 2 * B * cfg.n_heads * cfg.hd * S * (S + 1) // 2
                  * cfg.n_layers)
    prefill_bound = (2 * block * B * S + attn_flops) / BF16_OPS_PER_S * 1e3
    decode_bytes = 2 * (block + head) + cache_gb * 1e9
    decode_bound = decode_bytes / HBM_BYTES_PER_S * 1e3
    row = dict(prefill_ms=prefill_ms, prefill_bound_ms=prefill_bound,
               decode_ms_per_token_median=decode_ms,
               decode_bound_ms=decode_bound, tokens_per_s=tok_s,
               peak_gb=peak / 1e9, base_gb=base / 1e9,
               cache_shape=cache_shape, cache_dtype=cache_dtype,
               cache_gb=cache_gb, decode_vs_forward_max_abs=err)
    log(f"  ok serve: prefill {prefill_ms:.2f} ms (bound {prefill_bound:.2f} "
        f"ms: {2 * block * B * S:.4e} block flops + {attn_flops:.4e} "
        f"attention flops over {BF16_OPS_PER_S:.3e}/s), decode "
        f"{decode_ms:.3f} ms per token, median of {T} (bound "
        f"{decode_bound:.3f} ms: {decode_bytes / 1e9:.3f} GB over "
        f"{HBM_BYTES_PER_S:.3e} B/s), {tok_s:.1f} tokens/s; peak "
        f"{peak / 1e9:.2f} GB (weights {base / 1e9:.2f} GB); cache "
        f"{cache_shape} {cache_dtype} {cache_gb:.3f} GB; step ms min "
        f"{min(step_ms):.3f} max {max(step_ms):.3f}")
    if peak >= PEAK_LIMIT:
        raise AssertionError(f"phase 10a: peak {peak} B >= {PEAK_LIMIT:.0f}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def publish_full(torch, ops, cfg):
    """Phase 10b: phase 4's LAQ trainer at PUBLISH_LAYERS layers feeds the
    publisher (fused wire, b=4, threshold 0.25, max_staleness 1) and a
    fleet of two replicas with ``max_delay=1``; after each round replica 0
    serves SERVE_BATCH x SERVE_PROMPT prompts and PUBLISH_TOKENS greedy
    tokens from its float32 weights at bfloat16 compute.  Replica 0 must
    equal ``theta_pub`` bitwise every round and replica 1 the previous
    round's; absmax launches 12 per publish round and quantize_pack_fused
    12 per push.  The trainer's and the publisher's launches are counted
    as two paths, each zeroed just before it runs and read just after."""
    from repro_torch import random
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.core.replica import (PublishConfig, init_publisher,
                                          publish, staleness_drift)
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.launch.publish import ReplicaFleet, trainer_rounds
    from repro_torch.launch.serve import jit_serve
    from repro_torch.models.config import n_params
    from repro_torch.models.model import init_params, lm_worker_loss
    from repro_torch.tree import tree_leaves, tree_map

    pcfg = PublishConfig(bits=4, threshold=0.25, max_staleness=1,
                         wire_backend="fused")
    log(f"phase 10b: publish, phase 4's LAQ (b=8) at {cfg.n_layers} layers "
        f"(P={n_params(cfg)}), W={W} of {N_LOCAL}x{SEQ} tokens, "
        f"{PUBLISH_ROUNDS} rounds; {pcfg}; 2 replicas, max_delay 1; "
        f"replica 0 serves {SERVE_BATCH}x{SERVE_PROMPT} prompts and "
        f"{PUBLISH_TOKENS} greedy tokens from float32 weights at bfloat16 "
        "compute (a setting the JAX package cannot run: its layer scan "
        "changes the carry's dtype)")
    corpus = lm_worker_corpus(0, W, N_LOCAL, SEQ, cfg.vocab, device="cuda")
    engine = RoundEngine(AccumulatingSource(lm_worker_loss(cfg, W), corpus,
                                            deterministic=True, accum=ACCUM,
                                            scale=1.0),
                         strategies()["laq"], alpha=ALPHA)
    params0 = init_params(0, cfg, device="cuda")
    st = init_publisher(params0, pcfg)
    fleet = ReplicaFleet(params0, 2, pcfg, max_delay=1)
    prev_view = tree_map(torch.clone, st.theta_pub)
    trainer = trainer_rounds(engine, params0, PUBLISH_ROUNDS, device="cuda")
    del params0
    prompts = random.randint(random.PRNGKey(2, device="cuda"),
                             (SERVE_BATCH, SERVE_PROMPT), 0,
                             cfg.vocab).long()
    pre, dec = jit_serve(cfg, SERVE_PROMPT + PUBLISH_TOKENS)
    paths = {"publish_trainer": dict.fromkeys(KERNELS, 0),
             "publish": dict.fromkeys(KERNELS, 0)}

    def counted(path, fn):
        torch.cuda.synchronize()
        for name in KERNELS:
            getattr(ops, name).launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {name: getattr(ops, name).launches for name in KERNELS}
        for name in KERNELS:
            paths[path][name] += got[name]
        return out, ms, got

    rows = []
    for k in range(PUBLISH_ROUNDS):
        torch.cuda.reset_peak_memory_stats()
        params, train_ms, _ = counted("publish_trainer",
                                      lambda: next(trainer))
        (msg, st), pub_ms, got = counted("publish",
                                         lambda: publish(pcfg, st, params))
        kind = type(msg).__name__
        want = {"absmax": 12,
                "quantize_pack_fused": 12 if kind == "DeltaMsg" else 0}
        if {n: got[n] for n in KERNELS if got[n]} != {
                n: v for n, v in want.items() if v}:
            raise AssertionError(f"phase 10b round {k + 1}: publish launched "
                                 f"{got}, expected {want}")
        _, apply_ms, got = counted("publish", lambda: fleet.deliver(msg))
        if any(got.values()):
            raise AssertionError(f"phase 10b: the replicas launched {got}")
        r0, r1 = fleet.replicas
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(r0.params), tree_leaves(st.theta_pub))):
            raise AssertionError(f"phase 10b round {k + 1}: replica 0 is not "
                                 "theta_pub bitwise")
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(r1.params), tree_leaves(prev_view))):
            raise AssertionError(f"phase 10b round {k + 1}: replica 1 is not "
                                 "the previous round's theta_pub")
        del prev_view
        prev_view = tree_map(torch.clone, st.theta_pub)
        drift = staleness_drift(params, r0)
        width = getattr(msg, "width", None)
        del msg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_ms, step_ms, ids, cache = _greedy_session(
            torch, pre, dec, r0.params, prompts, PUBLISH_TOKENS)
        serve_ms = (time.perf_counter() - t0) * 1e3
        del cache
        if not (0 <= int(ids.min()) and int(ids.max()) < cfg.vocab):
            raise AssertionError("phase 10b: greedy ids out of the vocabulary")
        peak = torch.cuda.max_memory_allocated()
        rows.append(dict(round=k + 1, kind=kind, width=width,
                         train_ms=train_ms, publish_ms=pub_ms,
                         apply_ms=apply_ms, serve_ms=serve_ms,
                         prefill_ms=prefill_ms,
                         decode_ms_median=sorted(step_ms)[len(step_ms) // 2],
                         drift=drift, bits_sent=st.bits_sent,
                         peak_gb=peak / 1e9, rounds_behind=fleet.freshness()))
        log(f"  round {k + 1}: {kind} width {width} "
            f"bits_sent {st.bits_sent:.6e}; train {train_ms:.1f} ms, "
            f"publish {pub_ms:.1f} ms, apply (2 replicas) {apply_ms:.1f} ms, "
            f"serve {serve_ms:.1f} ms (prefill {prefill_ms:.1f}, decode "
            f"median {rows[-1]['decode_ms_median']:.2f} ms/token); drift "
            f"||theta - replica 0||_inf {drift:.4e}; replicas behind "
            f"{fleet.freshness()}; peak {peak / 1e9:.2f} GB; replica 0 == "
            "theta_pub bitwise, replica 1 == the previous round's")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"phase 10b: peak {peak} B >= "
                                 f"{PEAK_LIMIT:.0f}")
        del params
    if st.n_pushes == 0:
        raise AssertionError("phase 10b: the publisher never pushed")
    want_trainer = PUBLISH_ROUNDS * W * 12
    if (paths["publish_trainer"]["absmax"] != want_trainer
            or paths["publish_trainer"]["quantize_pack_fused"] != want_trainer
            or paths["publish"]["absmax"] != PUBLISH_ROUNDS * 12
            or paths["publish"]["quantize_pack_fused"] != st.n_pushes * 12):
        raise AssertionError(f"phase 10b launches {paths}")
    log(f"  ok publish: {st.n_pushes} pushes, {st.n_resyncs} resyncs; "
        f"launches {paths}")
    del trainer, engine, corpus, st, fleet, prev_view
    gc.collect()
    torch.cuda.empty_cache()
    return paths, rows


def grad_is_deterministic(torch, cfg, phase):
    """Phases 11a, 12a and 12c: each worker's round-1 gradient (phase 4's
    source at the initial parameters) evaluated twice must be bitwise
    equal."""
    from repro_torch.core.engine import AccumulatingSource
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.model import init_params, lm_worker_loss
    from repro_torch.tree import tree_leaves

    params = init_params(0, cfg, device="cuda")
    corpus = lm_worker_corpus(0, W, N_LOCAL, SEQ, cfg.vocab, device="cuda")
    source = AccumulatingSource(lm_worker_loss(cfg, W), corpus,
                                deterministic=True, accum=ACCUM, scale=1.0)
    batches = source.sample(0)
    for m in range(W):
        first = source.grad_at(params, batches, m)
        second = source.grad_at(params, batches, m)
        diff = [i for i, (a, b) in enumerate(zip(tree_leaves(first),
                                                 tree_leaves(second)))
                if not torch.equal(a, b)]
        if diff:
            raise AssertionError(f"phase {phase}: worker {m}'s round-1 "
                                 f"gradient differs between two "
                                 f"evaluations in leaves {diff}")
        del first, second
    del params, corpus, source, batches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  ok: each of the {W} workers' round-1 gradients is bitwise equal "
        f"across two evaluations")


def moe_decode_check(torch, cfg):
    """Phase 11b: decode step 1 against the forward over prompt + token, at
    full width, MOE_CHECK_LAYERS layers, float32 params and compute.  The
    prefill and the forward run with ``capacity_factor`` E/K, so that C = S
    and no token drops: decode's dense path drops none, and a token dropped
    in the prefill would change the cache that the decode step reads."""
    from repro_torch import random
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)

    B, S, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN
    cfg = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    params = init_params(0, cfg, device="cuda")
    prompts = random.randint(random.PRNGKey(1, device="cuda"), (B, S), 0,
                             cfg.vocab).long()
    logits0, cache = prefill(params, prompts, cfg, max_len)
    tok0 = torch.argmax(logits0[:, -1:], -1) % cfg.vocab
    logits1, cache = decode_step(params, cache, tok0, cfg)
    del cache
    fwd_cfg = dataclasses.replace(cfg, kv_chunk=S + 1)
    with torch.no_grad():
        want = forward(params, torch.cat([prompts, tok0], 1), fwd_cfg)[:, -1:]
    err = (logits1 - want).abs().max().item()
    same = (torch.argmax(logits1, -1) == torch.argmax(want, -1)).float()
    log(f"  decode step 1 vs the undropped forward over {S + 1} tokens "
        f"({MOE_CHECK_LAYERS} layers, float32): max abs diff {err:.4e} "
        f"(limit {MOE_DECODE_ATOL}), |logits| <= "
        f"{want.abs().max().item():.3f}, argmax agreement "
        f"{same.mean().item():.3f}")
    if not err <= MOE_DECODE_ATOL:
        raise AssertionError(f"phase 11b: decode differs from the forward by "
                             f"{err}")
    del params, want, logits0, logits1
    gc.collect()
    torch.cuda.empty_cache()
    return err


def _serve_whole(torch, cfg, phase):
    """Phase 10a's session on ``cfg`` at its depth and dtypes, random
    weights from seed 0, after a warm-up session of the same shape; then
    prefill's logits against ``forward`` over the prompt at the last
    position, within SERVE_ATOL, and the peak below PEAK_LIMIT.  Returns
    the timings, the peak, the weights' and the cache's bytes."""
    from repro_torch import random
    from repro_torch.launch.serve import jit_serve
    from repro_torch.models.model import forward, init_params, prefill

    B, S, T, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_MAX_LEN
    t0 = time.perf_counter()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated()
    log(f"  init {init_s:.1f} s, weights {weights / 1e9:.2f} GB")
    prompts = random.randint(random.PRNGKey(1, device="cuda"), (B, S), 0,
                             cfg.vocab).long()
    pre, dec = jit_serve(cfg, max_len)
    _greedy_session(torch, pre, dec, params, prompts, T)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, step_ms, ids, cache = _greedy_session(torch, pre, dec, params,
                                                      prompts, T)
    peak = torch.cuda.max_memory_allocated()
    leaves = {f"{g}.{k}": v for g in ("attn", "mamba")
              for k, v in cache.get(g, {}).items()}
    cache_spec = {k: [list(v.shape), str(v.dtype)] for k, v in leaves.items()}
    cache_bytes = {k: v.numel() * v.element_size() for k, v in leaves.items()}
    del cache, leaves
    if not (0 <= int(ids.min()) and int(ids.max()) < cfg.vocab):
        raise AssertionError(f"phase {phase}: greedy ids out of the "
                             f"vocabulary")

    logits0, cache = prefill(params, prompts, cfg, max_len)
    del cache
    with torch.no_grad():
        want = forward(params, prompts, cfg)[:, -1:]
    err = (logits0 - want).abs().max().item()
    log(f"  prefill vs forward over the {S} prompt tokens: max abs diff "
        f"{err:.4e} (limit {SERVE_ATOL})")
    if not err <= SERVE_ATOL:
        raise AssertionError(f"phase {phase}: prefill differs from the "
                             f"forward by {err}")
    peak = max(peak, torch.cuda.max_memory_allocated())
    del want, logits0, params
    gc.collect()
    torch.cuda.empty_cache()
    if peak >= PEAK_LIMIT:
        raise AssertionError(f"phase {phase}: peak {peak} B >= "
                             f"{PEAK_LIMIT:.0f}")
    return dict(prefill_ms=prefill_ms, step_ms=step_ms,
                decode_ms=sorted(step_ms)[len(step_ms) // 2],
                tok_s=B * T / (sum(step_ms) / 1e3), peak=peak,
                weights=weights, cache_spec=cache_spec,
                cache_bytes=cache_bytes, err=err, init_s=init_s)


def serve_moe(torch, cfg):
    """Phase 11b: the whole qwen3-moe at its published widths, depth and
    dtypes (bfloat16), random weights from seed 0: phase 10a's session,
    prefill's logits against the forward over the prompt, and the bounds.
    Decode reads every expert's weights each step (the dense path), so its
    bound is the whole model's bytes; prefill's is the capacity-active
    parameters' flops (E x C expert slots a row)."""
    from repro_torch.models.config import n_params
    from repro_torch.models.moe import capacity

    B, S, T, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_MAX_LEN
    log(f"phase 11b: serve, {cfg.name} at {cfg.n_layers} layers "
        f"(P={n_params(cfg)}), {cfg.param_dtype} params and compute, "
        f"{B} x {S} prompt tokens, max_len {max_len}, {T} greedy tokens")
    check_err = moe_decode_check(torch, cfg)
    r = _serve_whole(torch, cfg, "11b")
    cache_gb = sum(r["cache_bytes"].values()) / 1e9

    D, E, Fd, L = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.n_layers
    C = capacity(S, cfg)
    head = D * cfg.padded_vocab()
    block = n_params(cfg) - 2 * head - D
    per_attn = (block // L - D * E - 3 * E * D * Fd - 2 * D)
    active = L * (per_attn + D * E + (E * C / S) * 3 * D * Fd)
    attn_flops = (2 * 2 * B * cfg.n_heads * cfg.hd * S * (S + 1) // 2 * L)
    prefill_bound = (2 * active * B * S + attn_flops) / BF16_OPS_PER_S * 1e3
    decode_bytes = 2 * (block + head) + cache_gb * 1e9
    decode_bound = decode_bytes / HBM_BYTES_PER_S * 1e3
    row = dict(prefill_ms=r["prefill_ms"], prefill_bound_ms=prefill_bound,
               decode_ms_per_token_median=r["decode_ms"],
               decode_bound_ms=decode_bound, tokens_per_s=r["tok_s"],
               tokens_per_s_bound=B * 1e3 / decode_bound,
               peak_gb=r["peak"] / 1e9, weights_gb=r["weights"] / 1e9,
               cache=r["cache_spec"], cache_gb=cache_gb,
               prefill_vs_forward_max_abs=r["err"],
               decode_vs_forward_max_abs_f32_2_layers=check_err,
               capacity=C, init_s=r["init_s"])
    log(f"  ok serve: prefill {r['prefill_ms']:.2f} ms (bound "
        f"{prefill_bound:.2f} ms: {2 * active * B * S:.4e} flops of "
        f"{active:.4e} capacity-active params (C={C}) + {attn_flops:.4e} "
        f"attention flops over {BF16_OPS_PER_S:.3e}/s), decode "
        f"{r['decode_ms']:.3f} ms per token, median of {T} (bound "
        f"{decode_bound:.3f} ms: {decode_bytes / 1e9:.3f} GB over "
        f"{HBM_BYTES_PER_S:.3e} B/s), {r['tok_s']:.1f} tokens/s (bound "
        f"{B * 1e3 / decode_bound:.1f}); peak {r['peak'] / 1e9:.2f} GB "
        f"(weights {r['weights'] / 1e9:.2f} GB); cache {r['cache_spec']} "
        f"{cache_gb:.3f} GB; step ms min {min(r['step_ms']):.3f} max "
        f"{max(r['step_ms']):.3f}")
    return row


def recurrent_decode_check(torch, cfg, layers, phase):
    """Phases 12b and 12c: decode step 1 against the forward over prompt +
    token, at full width, ``layers`` layers, float32 params and compute,
    with prompts of SERVE_BATCH x MAMBA_CHECK_PROMPT tokens: the prefill
    and the forward then each run one SSD chunk (Q = S), and a prompt of
    more than ``ssm_chunk`` tokens would have to be a multiple of it."""
    from repro_torch import random
    from repro_torch.models.config import n_params
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)

    B, S = SERVE_BATCH, MAMBA_CHECK_PROMPT
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = init_params(0, cfg, device="cuda")
    prompts = random.randint(random.PRNGKey(1, device="cuda"), (B, S), 0,
                             cfg.vocab).long()
    logits0, cache = prefill(params, prompts, cfg, SERVE_MAX_LEN)
    tok0 = torch.argmax(logits0[:, -1:], -1) % cfg.vocab
    logits1, cache = decode_step(params, cache, tok0, cfg)
    del cache
    with torch.no_grad():
        want = forward(params, torch.cat([prompts, tok0], 1), cfg)[:, -1:]
    err = (logits1 - want).abs().max().item()
    same = (torch.argmax(logits1, -1) == torch.argmax(want, -1)).float()
    log(f"  decode step 1 vs forward over {S + 1} tokens ({layers} layers, "
        f"P={n_params(cfg)}, float32): max abs diff {err:.4e} (limit "
        f"{MAMBA_DECODE_ATOL}), |logits| <= {want.abs().max().item():.3f}, "
        f"argmax agreement {same.mean().item():.3f}")
    if not err <= MAMBA_DECODE_ATOL:
        raise AssertionError(f"phase {phase}: decode differs from the forward "
                             f"by {err}")
    del params, want, logits0, logits1
    gc.collect()
    torch.cuda.empty_cache()
    return err


def time_ssd(torch, cfg):
    """One ``ssd_chunked`` call at the prefill's shapes (SERVE_BATCH x
    SERVE_PROMPT tokens; x, B and C in the compute dtype, dt float32), CUDA
    events over 5 calls: its ms and its bound, the larger of its matmul
    flops over the bf16 rate and the bytes of its inputs and outputs
    over the HBM rate."""
    from repro_torch.models.mamba2 import ssd_chunked

    B, S = SERVE_BATCH, SERVE_PROMPT
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q, cdt = min(cfg.ssm_chunk, S), cfg.compute_dtype
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(cdt)
    dt = 0.1 * torch.rand((B, S, H), generator=gen, device="cuda")
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda").to(cdt)
              for _ in range(2))
    with torch.no_grad():
        ms = time_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk),
                     iters=5, warmup=1)
    flops = 2 * B * S * (Q * N + Q * H * P + 2 * H * N * P)
    esz = x.element_size()
    nbytes = (2 * B * S * H * P * esz + 4 * B * S * H + 2 * B * S * N * esz
              + 4 * B * H * P * N)
    bound = max(flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    del x, dt, Bm, Cm
    torch.cuda.empty_cache()
    return ms, bound


def serve_recurrent(torch, cfg, phase, check_layers):
    """Phases 12b and 12c: a Mamba2 model whole, at its published widths,
    depth and dtypes (bfloat16), random weights from seed 0: the decode
    check at ``check_layers`` layers in float32, then phase 10a's session,
    prefill's logits against the forward over the prompt, and the bounds.
    Prefill's bound is the larger of its matmul and SSD flops (the shared
    block's once per application) over the bf16 rate and the weights'
    bytes over the HBM rate; decode's is the weights, the cache and the
    SSM state written back, over the HBM rate."""
    from repro_torch.models.config import n_params
    from repro_torch.models.stack import n_shared_applications

    B, S, T, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_MAX_LEN
    log(f"phase {phase}: serve, {cfg.name} at {cfg.n_layers} layers "
        f"(P={n_params(cfg)}), {cfg.param_dtype} params and compute, "
        f"{B} x {S} prompt tokens, max_len {max_len}, {T} greedy tokens")
    check_err = recurrent_decode_check(torch, cfg, check_layers, phase)
    r = _serve_whole(torch, cfg, phase)
    cache_bytes = sum(r["cache_bytes"].values())

    D, L = cfg.d_model, cfg.n_layers
    di, H, P, GN = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim,
                    cfg.ssm_n_groups * cfg.ssm_state)
    Q, n_sh = min(cfg.ssm_chunk, S), n_shared_applications(cfg)
    mamba_mm = D * (2 * di + 2 * GN + H) + di * D        # a layer, a token
    shared_mm = (2 * D * cfg.n_heads * cfg.hd + 2 * D * cfg.n_kv_heads
                 * cfg.hd + 3 * D * cfg.d_ff)
    ssd = 2 * (Q * GN + Q * H * P + 2 * H * GN * P)       # a layer, a token
    attn_flops = 2 * 2 * B * cfg.n_heads * cfg.hd * S * (S + 1) // 2 * n_sh
    prefill_flops = (2 * B * S * (L * mamba_mm + n_sh * shared_mm)
                     + B * S * L * ssd + attn_flops
                     + 2 * B * D * cfg.padded_vocab())
    prefill_bound = max(prefill_flops / BF16_OPS_PER_S,
                        r["weights"] / HBM_BYTES_PER_S) * 1e3
    decode_bytes = r["weights"] + cache_bytes + r["cache_bytes"]["mamba.ssm"]
    decode_bound = decode_bytes / HBM_BYTES_PER_S * 1e3
    ssd_ms, ssd_bound = time_ssd(torch, cfg)
    row = dict(prefill_ms=r["prefill_ms"], prefill_bound_ms=prefill_bound,
               prefill_flops=prefill_flops,
               decode_ms_per_token_median=r["decode_ms"],
               decode_bound_ms=decode_bound, tokens_per_s=r["tok_s"],
               tokens_per_s_bound=B * 1e3 / decode_bound,
               peak_gb=r["peak"] / 1e9, weights_gb=r["weights"] / 1e9,
               cache=r["cache_spec"], cache_gb=cache_bytes / 1e9,
               prefill_vs_forward_max_abs=r["err"],
               decode_vs_forward_max_abs_f32=check_err,
               decode_check_layers=check_layers, init_s=r["init_s"],
               ssd_ms_per_layer=ssd_ms, ssd_bound_ms_per_layer=ssd_bound)
    log(f"  the SSD scan alone at the prefill's shapes: {ssd_ms:.3f} ms a "
        f"layer (bound {ssd_bound:.4f} ms), {L * ssd_ms:.2f} ms over the "
        f"{L} layers")
    log(f"  ok serve: prefill {r['prefill_ms']:.2f} ms (bound "
        f"{prefill_bound:.2f} ms: {prefill_flops:.4e} flops, of them "
        f"{B * S * L * ssd:.4e} SSD and {attn_flops:.4e} attention in "
        f"{n_sh} shared applications, over {BF16_OPS_PER_S:.3e}/s, or "
        f"{r['weights'] / 1e9:.3f} GB of weights over {HBM_BYTES_PER_S:.3e} "
        f"B/s), decode {r['decode_ms']:.3f} ms per token, median of {T} "
        f"(bound {decode_bound:.3f} ms: {decode_bytes / 1e9:.3f} GB), "
        f"{r['tok_s']:.1f} tokens/s (bound {B * 1e3 / decode_bound:.1f}); "
        f"peak {r['peak'] / 1e9:.2f} GB (weights {r['weights'] / 1e9:.2f} "
        f"GB); cache {r['cache_spec']} {cache_bytes / 1e9:.3f} GB; step ms "
        f"min {min(r['step_ms']):.3f} max {max(r['step_ms']):.3f}")
    return row


def _same_bits(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)))


def _paper_run(module, function, path, names=()):
    """One run of phases 13 to 16 in a process of its own:
    ``benchmarks_torch.<module>.<function>`` at full size on the card with
    the fused wire, the launch counters zeroed just before and read just
    after; writes its rows, what it returns (the claim checks, or None),
    each run's per-round uploads and bits and its final loss, the launches
    (kernel 4's also by width) and the seconds, or the error, to the JSON
    file ``path``.  With ``names``, ``function`` runs those runs alone, a
    part of a frontier's runs (``lasg_frontier.run_methods``): no rows and
    no checks then, and each run's per-round loss too, from which the
    parent makes the rows.  Returns the process's exit code."""
    try:
        root = os.path.dirname(os.path.abspath(__file__))
        sys.path[:0] = [os.path.join(root, "src"), root]
        import importlib

        import torch
        from repro_torch.kernels import ops
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run = getattr(importlib.import_module(f"benchmarks_torch.{module}"),
                      function)
        for name in KERNELS:
            getattr(ops, name).launches = 0
        ops.quantize_pack_adaptive.launches_by_width = {}
        results, traces, checks = {}, {}, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if names:
            traces = {f"{module}/{k}": r for k, r in run(
                list(names), device="cuda", wire="fused").items()}
        else:
            checks = run([], results, device="cuda", wire="fused",
                         traces=traces)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: getattr(ops, k).launches for k in KERNELS}
        launches["adaptive_by_width"] = {
            str(b): n for b, n in sorted(
                ops.quantize_pack_adaptive.launches_by_width.items())}
        runs = {k: dict(cum_uploads=r.cum_uploads.tolist(),
                        cum_bits=r.cum_bits.tolist(),
                        final_loss=float(r.loss[-1]),
                        **({"loss": r.loss.tolist()} if names else {}))
                for k, r in traces.items()}
        _report(path, dict(launches=launches, seconds=seconds,
                           results=results, checks=checks, runs=runs))
        return 0
    except BaseException:
        import traceback
        _report(path, {"error": traceback.format_exc()})
        return 1


def _table_module(table):
    import importlib
    return importlib.import_module(f"benchmarks_torch.{TABLE_MODULES[table]}")


def paper_data_check(torch):
    """Phases 13 and 15, first: the data, the NN's weights and the
    regression's data and true weights drawn on the card, bitwise equal
    to the CPU draw."""
    from benchmarks_torch import adaptive_sweep, common

    (cw, cf), (pw, pf) = (common.make_dataset(device=d)
                          for d in ("cuda", "cpu"))
    for a, b, name in zip(cw + cf, pw + pf, ("Xw", "Yw", "X", "Y")):
        if a.device.type != "cuda" or not _same_bits(torch, a, b):
            raise AssertionError(f"phase 13: dataset {name} differs card vs "
                                 "CPU")
    ci, pi = common.nn_init(device="cuda"), common.nn_init(device="cpu")
    for k in pi:
        if not _same_bits(torch, ci[k], pi[k]):
            raise AssertionError(f"phase 13: nn_init {k} differs card vs CPU")
    log(f"  ok dataset {tuple(cw[0].shape)} and nn_init bitwise equal on "
        f"card and CPU")
    (_, _, cd, cws), (_, _, pd, pws) = (adaptive_sweep.regression_setup(
        device=d) for d in ("cuda", "cpu"))
    for a, b, name in zip(cd + (cws,), pd + (pws,), ("X", "y", "w_star")):
        if a.device.type != "cuda" or not _same_bits(torch, a, b):
            raise AssertionError(f"phase 15: regression {name} differs card "
                                 "vs CPU")
    log(f"  ok regression X {tuple(cd[0].shape)}, y and w_star bitwise equal "
        f"on card and CPU")


def paper_children() -> dict:
    """The processes of phases 13 to 17: ``{phase: {run: argv}}``.
    Each is this script's ``--paper-run`` on one of the paper's
    experiments; all of them run at once (each is host-bound: one card,
    little memory)."""
    from benchmarks_torch import lasg_frontier
    return {
        13: {(table, model): ["--paper-run", TABLE_MODULES[table],
                              f"run_{model}"]
             for table in TABLE_MODULES for model in ("logistic", "nn")},
        14: {"convergence": ["--paper-run", "convergence", "run"],
             "bits_sweep_laq": ["--paper-run", "bits_sweep", "run_sweep"]},
        15: {m: ["--paper-run", m, "run"] for m in FRONTIER_MODULES},
        16: {**{f"lasg_frontier/{i}": ["--paper-run", "lasg_frontier",
                                       "run_methods",
                                       *lasg_frontier.RUNS[i::LASG_PROCS]]
                for i in range(LASG_PROCS)},
             "participation_frontier": ["--paper-run",
                                        "participation_frontier", "run"]},
        17: {"fault_frontier": ["--paper-run", "fault_frontier", "run"]},
    }


def paper_tables(out):
    """Phase 13: the paper's Tables 2 and 3 at full size on the card with
    the fused wire, each model's rows of each table in a process of its
    own; ``out`` holds their results by ``(table, model)``.  Returns
    ``(launches by table and model, rows)``."""
    from benchmarks_torch import common
    W = common.M_WORKERS
    t2, t3 = _table_module("table2"), _table_module("table3")
    # one absmax and one quantize_pack_fused per worker, leaf and round of
    # QGD and LAQ (1 leaf logistic, 4 NN) and of the NN's SLAQ; the
    # logistic SLAQ's b=3 runs on the reference wire
    want_launches = {
        ("table2", "logistic"): 2 * W * t2.STEPS_LOGREG * 1,
        ("table2", "nn"): 2 * W * t2.STEPS_NN * 4,
        ("table3", "logistic"): 0,
        ("table3", "nn"): W * t3.STEPS_NN * 4,
    }
    launches, rows, results = {}, {}, {}
    for (table, model), res in out.items():
        n = want_launches[table, model]
        expect_launches(f"{table} {model}", res["launches"],
                        {"absmax": n, "quantize_pack_fused": n})
        if n:
            launches[f"{table}_{model}"] = res["launches"]
        results.update(res["results"])
        for row, run in res["runs"].items():
            got = dict(res["results"][row], final_loss=run["final_loss"])
            it, rounds, bits, loss = JAX_TABLES[row]
            if row.startswith("table2/logistic/"):
                # at the JAX iteration index: the card's own index is set
                # by a 1e-6 loss residual, which float ulps can move
                got_rounds, got_bits = (run["cum_uploads"][it - 1],
                                        run["cum_bits"][it - 1])
            else:
                got_rounds, got_bits = got["rounds"], got["bits"]
            if got_rounds != rounds:
                raise AssertionError(f"phase 13 {row}: rounds {got_rounds}, "
                                     f"JAX {rounds}")
            if row.endswith("/ssgd"):
                ok = abs(got_bits - bits) <= SSGD_RTOL * bits
            else:
                ok = got_bits == bits
            if not ok:
                raise AssertionError(f"phase 13 {row}: bits {got_bits:.0f}, "
                                     f"JAX {bits}")
            rtol = SSGD_RTOL if row.endswith("/ssgd") else LOSS_RTOL
            if not abs(got["final_loss"] - loss) <= rtol * loss:
                raise AssertionError(f"phase 13 {row}: final loss "
                                     f"{got['final_loss']!r}, JAX {loss!r} "
                                     f"(rtol {rtol})")
            rows[row] = dict(iterations=got["iterations"], jax_iterations=it,
                             rounds=got_rounds, bits=got_bits,
                             jax_bits=bits, accuracy=got["accuracy"],
                             final_loss=got["final_loss"],
                             jax_final_loss=loss)
            log(f"  ok {row}: rounds {got_rounds} bits {got_bits:.0f} "
                f"(JAX {bits}) at iteration {it}; the card's own "
                f"iteration {got['iterations']}, accuracy "
                f"{got['accuracy']:.4f}, final loss {got['final_loss']!r} "
                f"(JAX {loss!r})")
        log(f"  ok {table} {model}: {res['seconds']:.1f} s on the card, "
            f"launches { {k: v for k, v in res['launches'].items() if v} }")
    for table, mod in (("table2", t2), ("table3", t3)):
        checks = mod.claims(results)
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"phase 13 {table}: claims failed {failed}")
        log(f"  ok {table}: the {len(checks)} claims hold")
    return launches, rows


def paper_studies(out):
    """Phase 14: the convergence study and the bits sweep's LAQ half at
    full size on the card with the fused wire, each in a process of its
    own; ``out`` holds their results.  Every run's final uploads and bits
    must equal ``JAX_STUDIES``, its final loss within ``LOSS_RTOL``; the
    slopes and the decay ratio within ``SLOPE_RTOL`` and ``DECAY_RTOL`` of
    ``JAX_FIT``; every claim must hold.  Returns ``(launches by study,
    rows)``."""
    from benchmarks_torch import bits_sweep, common, convergence
    W = common.M_WORKERS
    # one absmax and one quantize_pack_fused per worker and round of QGD
    # and LAQ (1 leaf), of the heterogeneous LAQ and of each width's LAQ
    want_launches = {
        "convergence": W * (2 * convergence.STEPS + convergence.STEPS_HET),
        "bits_sweep_laq": W * len(bits_sweep.SWEEP_BITS)
        * bits_sweep.SWEEP_STEPS,
    }
    launches, rows = {}, {}
    for path, res in out.items():
        n = want_launches[path]
        expect_launches(path, res["launches"],
                        {"absmax": n, "quantize_pack_fused": n})
        launches[path] = res["launches"]
        for run, got in res["runs"].items():
            uploads, bits, loss = (got["cum_uploads"][-1], got["cum_bits"][-1],
                                   got["final_loss"])
            want = JAX_STUDIES[run]
            if (uploads, bits) != want[:2]:
                raise AssertionError(f"phase 14 {run}: uploads, bits "
                                     f"{uploads}, {bits:.0f}; JAX {want[:2]}")
            if not abs(loss - want[2]) <= LOSS_RTOL * want[2]:
                raise AssertionError(f"phase 14 {run}: final loss {loss!r}, "
                                     f"JAX {want[2]!r} (rtol {LOSS_RTOL})")
            rows[run] = dict(uploads=uploads, bits=bits, final_loss=loss,
                             jax_final_loss=want[2])
            log(f"  ok {run}: uploads {uploads} bits {bits:.0f} (JAX's), "
                f"final loss {loss!r} (JAX {want[2]!r})")
        failed = [c for c, ok in res["checks"].items() if not ok]
        if failed:
            raise AssertionError(f"phase 14 {path}: claims failed {failed}")
        log(f"  ok {path}: {res['seconds']:.1f} s on the card, launches "
            f"{ {k: v for k, v in res['launches'].items() if v} }; claims "
            f"hold: {sorted(res['checks'])}")
    results = out["convergence"]["results"]
    fit = {k: results[f"convergence/{k}"]["rate_log_slope"]
           for k in convergence.KINDS}
    fit["decay_ratio"] = results["convergence/quant_error_decay"]["ratio"]
    for k, got in fit.items():
        want = JAX_FIT[k]
        rtol = DECAY_RTOL if k == "decay_ratio" else SLOPE_RTOL
        if not abs(got - want) <= rtol * abs(want):
            raise AssertionError(f"phase 14 {k}: {got!r}, JAX {want!r} "
                                 f"(rtol {rtol})")
        rows[k] = dict(value=got, jax_value=want)
    log(f"  ok slopes and decay ratio {fit} (JAX {JAX_FIT})")
    return launches, rows


def _close(got, want, rtol) -> bool:
    """``got`` within ``rtol`` of ``want``, None only as None."""
    if got is None or want is None:
        return got is want
    return abs(got - want) <= rtol * abs(want)


def paper_frontiers(out):
    """Phase 15: the A-LAQ width sweep and the error-feedback frontier at
    full size on the card with the fused wire, each in a process of its
    own; ``out`` holds their results by module.  Every run's final uploads
    and bits must equal ``JAX_FRONTIERS`` and its rows' ``bits_to_*``,
    ``rounds_to_target`` and ``mean_width_late`` entries
    ``JAX_FRONTIER_ROWS``, its final loss within ``LOSS_RTOL``; the
    EF-top-k runs' within ``EF_RTOL`` and ``EF_LOSS_RTOL`` (ROADMAP queue
    3).  The claims must be the reference's.  Returns ``(launches by
    module, rows)``."""
    from benchmarks_torch import adaptive_sweep, common, ef_frontier
    W = common.M_WORKERS
    a, e = W * adaptive_sweep.STEPS, W * ef_frontier.STEPS
    # one launch per worker, leaf (one) and round: absmax and kernel 2 on
    # each fixed width, absmax and kernel 4 under each schedule, kernel 7
    # alone on each EF-top-k run
    want_launches = {
        "adaptive_sweep": {"absmax": 5 * a, "quantize_pack_fused": 3 * a,
                           "quantize_pack_adaptive": 2 * a},
        "ef_frontier": {"absmax": 3 * e, "quantize_pack_fused": 3 * e,
                        "sparse_quantize_pack": 2 * e},
    }
    launches, rows = {}, {}
    for module, res in out.items():
        expect_launches(module, res["launches"], want_launches[module])
        launches[module] = res["launches"]
        for run, got in res["runs"].items():
            ef = "/ef_topk_" in run
            uploads, bits, loss = (got["cum_uploads"][-1], got["cum_bits"][-1],
                                   got["final_loss"])
            want = JAX_FRONTIERS[run]
            count_rtol = EF_RTOL if ef else 0.0
            loss_rtol = EF_LOSS_RTOL if ef else LOSS_RTOL
            if not (_close(uploads, want[0], count_rtol)
                    and _close(bits, want[1], count_rtol)):
                raise AssertionError(f"phase 15 {run}: uploads, bits "
                                     f"{uploads}, {bits:.0f}; JAX {want[:2]} "
                                     f"(rtol {count_rtol})")
            if not _close(loss, want[2], loss_rtol):
                raise AssertionError(f"phase 15 {run}: final loss {loss!r}, "
                                     f"JAX {want[2]!r} (rtol {loss_rtol})")
            row = {k: res["results"][run][k] for k in JAX_FRONTIER_ROWS[run]}
            for k, v in JAX_FRONTIER_ROWS[run].items():
                if not _close(row[k], v, count_rtol):
                    raise AssertionError(f"phase 15 {run}: {k} {row[k]}, "
                                         f"JAX {v} (rtol {count_rtol})")
            rows[run] = dict(uploads=uploads, bits=bits, final_loss=loss,
                             jax=want, **row)
            log(f"  ok {run}: uploads {uploads} bits {bits:.0f} (JAX "
                f"{want[0]}, {want[1]}), final loss {loss!r} (JAX "
                f"{want[2]!r}), {row}")
        claims = tuple(res["checks"].values())
        if claims != JAX_FRONTIER_CLAIMS[module]:
            raise AssertionError(f"phase 15 {module}: claims {res['checks']}"
                                 f", JAX {JAX_FRONTIER_CLAIMS[module]}")
        log(f"  ok {module}: {res['seconds']:.1f} s on the card, launches "
            f"{ {k: v for k, v in res['launches'].items() if v} }; the "
            f"claims are the reference's: {res['checks']}")
    target = out["ef_frontier"]["results"]["ef_frontier/target"]["target_loss"]
    if not _close(target, JAX_FRONTIER_TARGET, LOSS_RTOL):
        raise AssertionError(f"phase 15: target loss {target!r}, JAX "
                             f"{JAX_FRONTIER_TARGET!r}")
    by_width = launches["adaptive_sweep"]["adaptive_by_width"]
    if (sum(by_width.values()) != 2 * a
            or not set(by_width) <= {"2", "4", "8"}):
        raise AssertionError(f"phase 15: kernel 4's widths {by_width}")
    log(f"  ok kernel 4's width mix over the two A-LAQ runs: {by_width}")
    return launches, rows


def _prefix_part(got, digits, bits_per_upload):
    """The first round (from 1) of the prefix ``digits`` (uploads in each
    round, one hexadecimal digit a round) in which the run ``got``'s
    uploads or bits part from them, or None."""
    want = 0
    for k, (digit, uploads, bits) in enumerate(zip(
            digits, got["cum_uploads"], got["cum_bits"])):
        want += int(digit, 16)
        if uploads != want or bits != want * bits_per_upload:
            return k + 1
    return None


def paper_stoch_frontiers(out):
    """Phase 16: the LASG and the participation frontier at full size on
    the card with the fused wire, the LASG runs in the processes of
    ``LASG_PROCS`` (their rows and claims made here by
    ``lasg_frontier.frontier``), the participation runs in one; ``out``
    holds the processes' results.  Every run's final uploads and bits
    must equal ``JAX_STOCH_FRONTIERS`` and its rows' entries that count
    uploads, rounds or bits ``JAX_STOCH_FRONTIER_ROWS``, its final loss
    within ``LOSS_RTOL``; the runs of ``STOCH_BANDS``, which part from
    JAX's on skip decisions that the gradient's reduction order moves
    (ROADMAP queue 3), within their bands, after equal uploads and bits
    in every round of ``JAX_STOCH_PREFIX``.  The targets must be within
    ``LOSS_RTOL`` of ``JAX_STOCH_FRONTIER_TARGETS`` and the claims the
    reference's.  Returns ``(launches by module, rows)``."""
    from benchmarks_torch import (common, lasg_frontier,
                                  participation_frontier)
    parts = [res for run, res in out.items()
             if run.startswith("lasg_frontier/")]
    runs = {k: v for res in parts for k, v in res["runs"].items()}
    results = {}
    checks = lasg_frontier.frontier(
        {k.split("/")[1]: SimpleNamespace(**v) for k, v in runs.items()}, [],
        results)
    out = {"lasg_frontier": dict(
        runs=runs, results=results, checks=checks,
        seconds=max(res["seconds"] for res in parts),
        launches={k: sum(res["launches"][k] for res in parts)
                  for k in KERNELS}),
        "participation_frontier": out["participation_frontier"]}
    # one absmax and one quantize_pack_fused per worker and round of each
    # participation run, the sampled-out workers' too (the reference's
    # vmap runs every lane); the LASG frontier's b = 3 is off the fused
    # wire's widths and its baselines have no LAQ wire: no launch
    n = (len(participation_frontier._methods("fused"))
         * participation_frontier.STEPS * common.M_WORKERS)
    want_launches = {"lasg_frontier": {},
                     "participation_frontier": {"absmax": n,
                                                "quantize_pack_fused": n}}
    launches, rows = {}, {}
    for module, res in out.items():
        expect_launches(module, res["launches"], want_launches[module])
        launches[module] = res["launches"]
        for run, got in res["runs"].items():
            uploads, bits, loss = (got["cum_uploads"][-1], got["cum_bits"][-1],
                                   got["final_loss"])
            want = JAX_STOCH_FRONTIERS[run]
            count_rtol, loss_rtol = STOCH_BANDS.get(run, (0.0, LOSS_RTOL))
            part = _prefix_part(got, JAX_STOCH_PREFIX.get(run, ""),
                                want[1] / want[0])
            if part is not None:
                raise AssertionError(
                    f"phase 16 {run}: uploads or bits part from JAX's in "
                    f"round {part}, within the first "
                    f"{len(JAX_STOCH_PREFIX[run])}")
            if not (_close(uploads, want[0], count_rtol)
                    and _close(bits, want[1], count_rtol)):
                raise AssertionError(f"phase 16 {run}: uploads, bits "
                                     f"{uploads}, {bits:.0f}; JAX {want[:2]} "
                                     f"(rtol {count_rtol})")
            if not _close(loss, want[2], loss_rtol):
                raise AssertionError(f"phase 16 {run}: final loss {loss!r}, "
                                     f"JAX {want[2]!r} (rtol {loss_rtol})")
            want_row = JAX_STOCH_FRONTIER_ROWS.get(run, {})
            row = {k: res["results"][run][k] for k in want_row}
            for k, v in want_row.items():
                if not _close(row[k], v, count_rtol):
                    raise AssertionError(f"phase 16 {run}: {k} {row[k]}, "
                                         f"JAX {v} (rtol {count_rtol})")
            rows[run] = dict(uploads=uploads, bits=bits, final_loss=loss,
                             jax=want, **row)
            log(f"  ok {run}: uploads {uploads} bits {bits:.0f} (JAX "
                f"{want[0]}, {want[1]}), final loss {loss!r} (JAX "
                f"{want[2]!r}), {row}")
        target = res["results"][f"{module}/target"]
        for k, v in JAX_STOCH_FRONTIER_TARGETS[module].items():
            if not _close(target[k], v, LOSS_RTOL):
                raise AssertionError(f"phase 16 {module}: {k} {target[k]!r}, "
                                     f"JAX {v!r}")
        claims = tuple(res["checks"].values())
        if claims != JAX_STOCH_FRONTIER_CLAIMS[module]:
            raise AssertionError(f"phase 16 {module}: claims {res['checks']}"
                                 f", JAX {JAX_STOCH_FRONTIER_CLAIMS[module]}")
        log(f"  ok {module}: {res['seconds']:.1f} s on the card, launches "
            f"{ {k: v for k, v in res['launches'].items() if v} }; targets "
            f"{target}; the claims are the reference's: {res['checks']}")
    return launches, rows


def _same_loss(got, want) -> bool:
    """A final loss within ``LOSS_RTOL`` of JAX's, NaN where NaN."""
    if math.isnan(want) or math.isnan(got):
        return math.isnan(want) and math.isnan(got)
    return _close(got, want, LOSS_RTOL)


def paper_fault_frontier(res):
    """Phase 17: the fault frontier at full size on the card with the fused
    wire, in a process of its own; ``res`` holds its result.  Every row's
    final uploads and bits, ``finite`` and ``bits_to_target`` must equal
    ``JAX_FAULT_FRONTIER``'s and its final loss be within ``LOSS_RTOL`` (NaN
    where NaN); the target within ``LOSS_RTOL``, the watchdog's log equal
    and the claims the reference's (the first holds only if the clean and
    the defended losses are bitwise equal on the card).  Kernels 1 and 2
    launch once per worker and round of each of the eleven cells and of
    the watchdog's healthy and wasted chunks.  Returns ``(launches,
    rows)``."""
    from benchmarks_torch import fault_frontier as ff
    want = JAX_FAULT_FRONTIER
    wasted = want["watchdog_log"]["wasted_rounds"]
    cells = (len(want["rows"]) - 1) * ff.STEPS * ff.W
    n = cells + (ff.STEPS + wasted) * ff.W
    expect_launches("fault_frontier", res["launches"],
                    {"absmax": n, "quantize_pack_fused": n})
    rows = {}
    for name, (uploads, bits, loss, finite, to_target) in want["rows"].items():
        row = res["results"][f"fault_frontier/{name}"]
        got = (row["total_uploads"], row["total_bits"], row["finite"],
               row["bits_to_target"])
        if got != (uploads, bits, finite, to_target):
            raise AssertionError(
                f"phase 17 {name}: uploads, bits, finite, bits_to_target "
                f"{got}; JAX {(uploads, bits, finite, to_target)}")
        if not _same_loss(row["final_loss"], loss):
            raise AssertionError(f"phase 17 {name}: final loss "
                                 f"{row['final_loss']!r}, JAX {loss!r}")
        rows[name] = dict(row, jax_final_loss=loss)
        log(f"  ok {name}: uploads {row['total_uploads']} bits "
            f"{row['total_bits']:.0f} finite {row['finite']} bits_to_target "
            f"{row['bits_to_target']}, final loss {row['final_loss']!r} (JAX "
            f"{loss!r})")
    target = res["results"]["fault_frontier/target"]["target_loss"]
    if not _close(target, want["target_loss"], LOSS_RTOL):
        raise AssertionError(f"phase 17: target loss {target!r}, JAX "
                             f"{want['target_loss']!r}")
    wd = res["results"]["fault_frontier/watchdog_log"]
    if wd != want["watchdog_log"]:
        raise AssertionError(f"phase 17: watchdog log {wd}, JAX "
                             f"{want['watchdog_log']}")
    claims = tuple(res["checks"].values())
    if claims != want["claims"]:
        raise AssertionError(f"phase 17: claims {res['checks']}, JAX "
                             f"{want['claims']}")
    log(f"  ok fault_frontier: {res['seconds']:.1f} s on the card; launches "
        f"absmax {res['launches']['absmax']}, quantize_pack_fused "
        f"{res['launches']['quantize_pack_fused']} (predicted {n}: "
        f"{cells} in the eleven cells, {(ff.STEPS + wasted) * ff.W} in the "
        f"watchdog's {ff.STEPS} + {wasted} rounds); target {target!r}; "
        f"watchdog {wd}; the claims are the reference's: {res['checks']}")
    return {"fault_frontier": res["launches"]}, rows


def expect_launches(method, launches, want):
    for name in KERNELS:
        if launches[name] != want.get(name, 0):
            raise AssertionError(f"{method}: {name} launched {launches[name]} "
                                 f"times on the path, expected "
                                 f"{want.get(name, 0)}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(root, "src"), root]
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import static_k
    from repro_torch.kernels import ops, quant_pack, ref
    from repro_torch.models.config import n_params
    from repro_torch.models.model import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    log("phase 1: build")
    t0 = time.perf_counter()
    lib = quant_pack.library()
    log(f"  built {lib.path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "cached" in line:
            log("  " + line.strip())

    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              param_dtype=torch.float32)
    params = init_params(0, cfg, device="cuda")
    shapes = [(k, tuple(v.shape)) for k, v in named_leaves(params)]
    del params
    p = sum(math.prod(s) for _, s in shapes)
    if p != n_params(cfg) or len(shapes) != 12:
        raise AssertionError(f"{len(shapes)} leaves, {p} params")
    log(f"stablelm-1.6b: {p} params in {len(shapes)} leaves")

    ef_cfg = dataclasses.replace(cfg, n_layers=EF_LAYERS)
    ef_k = static_k(strategies()["ef_topk"].compressor_k, n_params(ef_cfg))
    log("phase 2: kernels against their plain versions")
    errs = check_kernels(shapes, torch, ops, ref)
    errs["quantize_pack_adaptive"] = check_adaptive_kernel(
        shapes + list(TABLE_LEAVES) + [REGRESSION_LEAF], torch, ops, ref)
    errs["sparse_quantize_pack"] = check_sparse_kernel(ef_k, torch, ops, ref)
    errs.update(check_codes_kernels(shapes, torch, ops, ref))
    errs["dequant_acc"] = check_dequant_kernel(shapes, torch, ops, ref)
    largest = max(math.prod(s) for _, s in shapes)
    timing = time_kernels(largest, ef_k, torch, ops, ref)
    timing.update(time_new_kernels(largest, torch, ops, ref))
    for name, r in timing.items():
        log(f"  {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}")
        for b, w in r.get("by_width", {}).items():
            log(f"    width {b}: {w['ms']:.4f} ms, plain {w['plain_ms']:.4f} ms")
        if "with_acc" in r:
            w = r["with_acc"]
            log(f"    with acc: {w['ms']:.4f} ms (bound {w['bound_ms']:.4f} "
                f"ms), plain {w['plain_ms']:.4f} ms")
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 3: the slice on a small input, card vs CPU")
    small_slice_check(torch, ops)
    nan_topk_check(torch, ops, ref)
    random_card_check(torch)
    stochastic_small_check(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        robust_small_check(torch, tmpdir)
    serve_small_check(torch)
    publish_small_check(torch, ops)
    for arch in (MOE_ARCH, SSM_ARCH, HYBRID_ARCH):
        small_slice_check(torch, ops, arch, ("laq",), MODEL_SMALL_ALPHA)
        serve_small_check(torch, arch)

    paths = {
        "laq": (cfg, {"absmax": 1, "quantize_pack_fused": 1}),
        "alaq": (cfg, {"absmax": 1, "quantize_pack_adaptive": 1}),
        "ef_topk": (ef_cfg, {"sparse_quantize_pack": 1}),
    }
    by_path = {}
    for method, (pcfg, per) in paths.items():
        rounds = PATH_ROUNDS[method]
        launches, recs, round_ms, peaks, _ = run_path(torch, ops, method,
                                                      pcfg, rounds)
        per_round = 1 if method == "ef_topk" else len(shapes)
        expect_launches(method, launches,
                        {k: rounds * W * per_round * v for k, v in per.items()})
        if method == "alaq" and recs[0][5].item() != 8.0:
            raise AssertionError(f"alaq: round 1 mean width "
                                 f"{recs[0][5].item()} != 8")
        by_path[method] = launches
        log(f"  ok {method}: launches {launches}, losses finite, round-1 "
            f"uploads {W}; mean round ms after the first "
            f"{sum(round_ms[1:]) / (rounds - 1):.1f}, max peak "
            f"{max(peaks) / 1e9:.2f} GB")

    log("phase 5: the sharded step at full width, one NCCL worker")
    import torch.distributed as dist
    from repro_torch.launch.mesh import WorkerGroup, init_workers
    store = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    workers = init_workers("nccl", 1, 0, store)
    sharded_small_check(torch, workers, WorkerGroup(
        dist.new_group([0], backend="gloo"), 1, 0, "gloo"))
    sharded_cfg = get_config("stablelm-1.6b")      # bf16 params and compute
    per_step = {
        "sharded_b4": {"absmax": 24, "quantize_pack_fused": 12,
                       "quantize_codes_fused": 12},
        "sharded_adaptive": {"absmax": 24, "quantize_pack_adaptive": 12,
                             "quantize_codes_adaptive": 12},
        "sharded_wk2_svrg": {"absmax": 24, "quantize_pack_fused": 12,
                             "quantize_codes_fused": 12},
        "sharded_ef_topk": {"sparse_quantize_pack": 1},
        "sharded_b4_bf16": {"absmax": 24, "quantize_pack_fused": 12,
                            "quantize_codes_fused": 12},
        "sharded_float_bf16": {"absmax": 12, "quantize_pack_fused": 12},
    }
    sharded = {}
    for method, want in per_step.items():
        log(f"  {method}: stablelm-1.6b at {sharded_cfg.n_layers} layers "
            f"(P={n_params(sharded_cfg)}), {SHARDED_ROWS}x{SEQ} tokens in "
            f"{SHARDED_MICROBATCH} microbatches, "
            f"{'float' if method in SHARDED_FLOAT else 'packed'} wire, "
            f"transport {workers.transport('cuda')}")
        launches, recs, step_ms, peaks, final = run_sharded_path(
            torch, ops, workers, method, sharded_cfg, SHARDED_STEPS)
        sharded[method] = (recs, max(peaks), final)
        for name in SHARDED_KERNELS:
            if launches[name] != SHARDED_STEPS * want.get(name, 0):
                raise AssertionError(
                    f"{method}: {name} launched {launches[name]} times, "
                    f"expected {SHARDED_STEPS * want.get(name, 0)}")
        by_path[method] = {k: launches.get(k, 0) for k in KERNELS}
        if method == "sharded_adaptive":
            codes_by_width = launches["codes_adaptive_by_width"]
        log(f"  ok {method}: launches {launches}; step ms "
            f"{[round(x, 1) for x in step_ms]}; max peak "
            f"{max(peaks) / 1e9:.2f} GB")
    (rp, peak_p, fp), (rf, peak_f, ff) = (sharded["sharded_b4_bf16"],
                                          sharded["sharded_float_bf16"])
    if not all(torch.equal(a, b) for a, b in zip(fp, ff)):
        raise AssertionError("state_bf16: the packed and float wires gave "
                             "different parameters")
    for a, b in zip(rp, rf):
        if (a.loss.item(), a.uploads, a.bits.item()) != (
                b.loss.item(), b.uploads, b.bits.item()):
            raise AssertionError(f"state_bf16: packed step {a} vs float {b}")
    del fp, ff
    peak_f32 = sharded["sharded_b4"][1]
    log(f"  ok state_bf16: packed and float wires give bitwise-equal "
        f"parameters, losses {[round(m.loss.item(), 6) for m in rp]}, "
        f"uploads {[m.uploads for m in rp]}; max peak packed "
        f"{peak_p / 1e9:.2f} GB, float {peak_f / 1e9:.2f} GB, beside "
        f"sharded_b4's {peak_f32 / 1e9:.2f} GB (float32 state): "
        f"{(peak_f32 - peak_p) / 1e9:.2f} GB less on the packed wire")
    dist.destroy_process_group()
    del store
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 6: the exchange on the card, W={EXCHANGE_W} gloo ranks, "
        f"stablelm-1.6b at full width and {EXCHANGE_LAYERS} layers")
    ex = exchange_on_card(torch)
    by_path["exchange_w4_packed"] = {k: ex["packed_launches"].get(k, 0)
                                     for k in KERNELS}
    by_path["exchange_w4_defended_packed"] = {
        k: ex["defended_packed_launches"].get(k, 0) for k in KERNELS}
    by_path["exchange_w4_wk2_svrg_packed"] = {
        k: ex["lazy_packed_launches"].get(k, 0) for k in KERNELS}
    by_path["exchange_w4_bf16_wk2_svrg_packed"] = {
        k: ex["bf16_lazy_packed_launches"].get(k, 0) for k in KERNELS}
    log(f"  ok: float and packed wires give bitwise-equal parameters on "
        f"every rank, without and with bernoulli participation and the "
        f"defense, and under lasg_wk2 + SVRG; uploads/bits per step "
        f"{[r[1:3] for r in ex['packed']]}, defended "
        f"{[r[1:3] for r in ex['defended_packed']]}, lasg_wk2 + SVRG "
        f"{[r[1:3] for r in ex['lazy_packed']]} ({EXCHANGE_LAZY_LAYERS} "
        f"layer), with bf16 state {[r[1:3] for r in ex['bf16_lazy_packed']]} "
        f"({EXCHANGE_BF16_LAYERS} layers)")

    log("phase 7: benchmarks_torch/bits_sweep.py")
    sweep_launches, _ = run_bits_sweep(torch, ops)
    by_path["bits_sweep"] = {k: sweep_launches.get(k, 0) for k in KERNELS}
    gc.collect()
    torch.cuda.empty_cache()

    for method, layers in STOCH_LAYERS.items():
        pcfg = dataclasses.replace(cfg, n_layers=layers)
        launches, recs, round_ms, peaks, _ = run_path(
            torch, ops, method, pcfg, STOCH_ROUNDS, stochastic=True)
        per_round = W * len(shapes)
        expect_launches(method, launches, {
            "absmax": STOCH_ROUNDS * per_round,
            "quantize_pack_fused": STOCH_ROUNDS * per_round})
        by_path[method] = launches
        log(f"  ok {method}: launches {launches}, losses finite, round-1 "
            f"uploads {W}, uploads by round "
            f"{[b[2] - a[2] for a, b in zip([(0, 0, 0)] + recs, recs)]}; "
            f"round ms {[round(x, 1) for x in round_ms]}, max peak "
            f"{max(peaks) / 1e9:.2f} GB")

    robust = robust_strategies()
    for method, layers in ROBUST_LAYERS.items():
        strategy = robust[method]
        events = robust_events(method, strategy, ROBUST_ROUNDS)
        check_robust_events(method, events)
        log(f"phase 9: {method}: seeds {ROBUST_SEEDS.get(method, {})}; per "
            f"round available {events[0]}, crashed {events[1]}, corrupted "
            f"{events[2]}")
        pcfg = dataclasses.replace(cfg, n_layers=layers)
        launches, recs, round_ms, peaks, rejects = run_path(
            torch, ops, method, pcfg, ROBUST_ROUNDS, strategy=strategy,
            uploads1=sum(events[0][0]), phase=9)
        per_round = W * len(shapes)
        expect_launches(method, launches, {
            "absmax": ROBUST_ROUNDS * per_round,
            "quantize_pack_fused": ROBUST_ROUNDS * per_round})
        if method == "robust_full" and not sum(rejects):
            raise AssertionError(f"{method}: the corrupted upload of round 3 "
                                 f"was not rejected: {rejects}")
        by_path[method] = launches
        log(f"  ok {method}: launches {launches}, losses finite, uploads "
            f"by round {[b[2] - a[2] for a, b in zip([(0, 0, 0)] + recs, recs)]}"
            f", rejections per worker {rejects}; round ms "
            f"{[round(x, 1) for x in round_ms]}, max peak "
            f"{max(peaks) / 1e9:.2f} GB")

    serve_row = serve_full(torch, get_config("stablelm-1.6b"))
    publish_paths, publish_rows = publish_full(
        torch, ops, dataclasses.replace(cfg, n_layers=PUBLISH_LAYERS))
    by_path.update(publish_paths)
    log("  " + json.dumps({"serve": serve_row, "publish": publish_rows}))

    moe_cfg = get_config(MOE_ARCH)
    train_cfg = dataclasses.replace(moe_cfg, n_layers=MOE_TRAIN_LAYERS,
                                    param_dtype=torch.float32)
    n_leaves = 15
    launches, recs, round_ms, peaks, _ = run_path(
        torch, ops, "laq", train_cfg, MOE_TRAIN_ROUNDS, phase="11a")
    expect_launches("moe", launches, {
        "absmax": MOE_TRAIN_ROUNDS * W * n_leaves,
        "quantize_pack_fused": MOE_TRAIN_ROUNDS * W * n_leaves})
    by_path["moe"] = launches
    moe_train_row = dict(round_ms=round_ms, peak_gb=max(peaks) / 1e9,
                         losses=[r[0].item() for r in recs],
                         cum_uploads=[int(r[2]) for r in recs])
    log(f"  ok moe: launches {launches}, losses finite, round-1 uploads {W}; "
        f"round ms {[round(x, 1) for x in round_ms]}, max peak "
        f"{max(peaks) / 1e9:.2f} GB")
    grad_is_deterministic(torch, train_cfg, "11a")
    moe_serve_row = serve_moe(torch, moe_cfg)
    log("  " + json.dumps({"moe_train": moe_train_row,
                           "moe_serve": moe_serve_row}))

    for path, arch, phases in (("hybrid", HYBRID_ARCH, ("12a", "12b")),
                               ("ssm", SSM_ARCH, ("12c", "12c"))):
        mcfg = get_config(arch)
        train_cfg = dataclasses.replace(
            mcfg, n_layers=HYBRID_TRAIN_LAYERS if path == "hybrid"
            else mcfg.n_layers, param_dtype=torch.float32)
        launches, recs, round_ms, peaks, _ = run_path(
            torch, ops, "laq", train_cfg, MAMBA_TRAIN_ROUNDS, phase=phases[0])
        per_run = MAMBA_TRAIN_ROUNDS * W * MAMBA_LEAVES[arch]
        expect_launches(path, launches, {"absmax": per_run,
                                         "quantize_pack_fused": per_run})
        by_path[path] = launches
        train_row = dict(round_ms=round_ms, peak_gb=max(peaks) / 1e9,
                         losses=[r[0].item() for r in recs],
                         cum_uploads=[int(r[2]) for r in recs])
        log(f"  ok {path}: launches {launches}, losses finite, round-1 "
            f"uploads {W}; round ms {[round(x, 1) for x in round_ms]}, max "
            f"peak {max(peaks) / 1e9:.2f} GB")
        grad_is_deterministic(torch, train_cfg, phases[0])
        serve_row = serve_recurrent(
            torch, mcfg, phases[1],
            HYBRID_CHECK_LAYERS if path == "hybrid" else mcfg.n_layers)
        log("  " + json.dumps({f"{path}_train": train_row,
                               f"{path}_serve": serve_row}))

    log("phases 13-17: the paper's experiments and the fault frontier at "
        "full size, fused wire, each run in a process of its own, all at "
        "once")
    gc.collect()
    torch.cuda.empty_cache()
    paper_data_check(torch)
    flat = [(phase, run, argv) for phase, runs in paper_children().items()
            for run, argv in runs.items()]
    t0 = time.perf_counter()
    res = _run_children([argv for _, _, argv in flat], "phases 13-17")
    wall = time.perf_counter() - t0
    out = {13: {}, 14: {}, 15: {}, 16: {}, 17: {}}
    for (phase, run, _), r in zip(flat, res):
        out[phase][run] = r
    log("phase 13: the paper's Tables 2 and 3")
    table_launches, table_rows = paper_tables(out[13])
    by_path.update(table_launches)
    log("  " + json.dumps({"paper_tables": table_rows}))
    log("phase 14: the convergence study and the bits sweep")
    study_launches, study_rows = paper_studies(out[14])
    by_path.update(study_launches)
    log("  " + json.dumps({"paper_studies": study_rows}))
    log("phase 15: the A-LAQ width sweep and the error-feedback frontier")
    frontier_launches, frontier_rows = paper_frontiers(out[15])
    by_path.update(frontier_launches)
    log("  " + json.dumps({"paper_frontiers": frontier_rows}))
    log("phase 16: the LASG and the participation frontier")
    stoch_launches, stoch_rows = paper_stoch_frontiers(out[16])
    by_path.update(stoch_launches)
    log("  " + json.dumps({"paper_stoch_frontiers": stoch_rows}))
    log("phase 17: the fault frontier")
    fault_launches, fault_rows = paper_fault_frontier(
        out[17]["fault_frontier"])
    by_path.update(fault_launches)
    log("  " + json.dumps({"fault_frontier": fault_rows}))
    log(f"  ok phases 13-17: the {len(flat)} processes in {wall:.1f} s, at "
        f"once; the longest "
        f"{max(r['seconds'] for p in out.values() for r in p.values()):.1f} s"
        f" on the card")

    src = "src/repro_torch/kernels/csrc/quant_pack.cu"
    replaces = {
        "absmax": "src/repro/kernels/quant_pack.py:82",
        "quantize_pack_fused": "src/repro/kernels/quant_pack.py:134",
        "quantize_pack": "src/repro/kernels/quant_pack.py:186",
        "quantize_pack_adaptive": "src/repro/kernels/quant_pack.py:264",
        "quantize_codes_fused": "src/repro/kernels/quant_pack.py:331",
        "quantize_codes_adaptive": "src/repro/kernels/quant_pack.py:377",
        "sparse_quantize_pack": "src/repro/kernels/quant_pack.py:436",
        "dequant_acc": "src/repro/kernels/quant_pack.py:502",
    }
    for name in KERNELS:
        if not any(by_path[m].get(name, 0) for m in by_path):
            raise AssertionError(f"{name} was launched on no path")
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces[name],
        "launches": sum(by_path[m].get(name, 0) for m in by_path),
        "launches_by_path": {m: by_path[m].get(name, 0) for m in by_path
                             if by_path[m].get(name, 0)},
        "max_abs_err": errs[name], "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in KERNELS]
    by_width = sorted(by_path["alaq"]["adaptive_by_width"].items())
    kernels[KERNELS.index("quantize_pack_adaptive")]["launches_by_width"] = {
        str(b): n for b, n in by_width}
    kernels[KERNELS.index("quantize_pack_adaptive")][
        "launches_by_width_adaptive_sweep"] = frontier_launches[
            "adaptive_sweep"]["adaptive_by_width"]
    kernels[KERNELS.index("quantize_codes_adaptive")]["launches_by_width"] = {
        str(b): n for b, n in sorted(codes_by_width.items())}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--exchange-rank"]:
        rank, port, path = sys.argv[2:5]
        sys.exit(_exchange_rank(int(rank), int(port), path))
    if sys.argv[1:2] == ["--paper-run"]:
        sys.exit(_paper_run(*sys.argv[2:4], sys.argv[-1], sys.argv[4:-1]))
    sys.exit(main())
