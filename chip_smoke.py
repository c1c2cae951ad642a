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
   stablelm-1.6b, a length that is not a multiple of 8 or 4096, an
   unaligned operand, R == 0 and b in {1, 2, 4, 8}.
   ``quantize_pack_adaptive``: at the 12 leaf shapes for each width of the
   grid (2, 4, 8), the grid (2, 4) (4-bit lanes), a ragged length, R == 0
   and a NaN input; a pinned width must equal ``quantize_pack_fused``.
   ``sparse_quantize_pack``: at k = 41,105,920 survivors (5% of
   stablelm-1.6b at the EF path's 8 layers, the k that path gives it),
   k = 82,213,376 (5% at 24 layers) and a ragged k, b in {1, 2, 4, 8},
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
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
W, N_LOCAL, SEQ, ACCUM, ALPHA = 4, 2, 512, 2, 0.5
PATH_ROUNDS = {"laq": 4, "alaq": 3, "ef_topk": 3}
EF_LAYERS = 8                 # EF-top-k depth cut (memory, see the docstring)
PEAK_LIMIT = 76e9
SPARSE_K = 82_213_376         # static_k(0.05, 1,644,267,520), 24 layers
SMALL_ROUNDS, SMALL_ALPHA = 12, 0.05
TIMED_LAUNCHES = 20


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
    """Largest absolute difference of the two moments (rtol 1e-5)."""
    e = 0.0
    for name, a, b in zip(("err_sq", "innovation_sq"), got, want):
        a, b = a.item(), b.item()
        if nan_ok and math.isnan(a) and math.isnan(b):
            continue
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"{label}: {name} {a!r} vs plain {b!r}")
        e = max(e, abs(a - b))
    return e


def check_kernels(leaf_shapes, torch, ops, ref):
    """Phase 2, kernels 1 and 2: bitwise checks at every main-path shape and
    the edge cases; returns the largest absolute error of each kernel's
    outputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    err = {"absmax": 0.0, "quantize_pack_fused": 0.0}

    def one(label, g, qh, bits):
        R = ops.absmax(g, qh)
        R_ref = ref.absmax_ref(g, qh)
        torch.cuda.synchronize()
        if not torch.equal(R, R_ref):
            raise AssertionError(f"{label}: absmax {R.item()!r} != plain "
                                 f"{R_ref.item()!r}")
        err["absmax"] = max(err["absmax"], (R - R_ref).abs().item())
        got = ops.quantize_pack_fused(g, qh, R, bits)
        want = ref.quantize_pack_fused_ref(g, qh, R, bits)
        torch.cuda.synchronize()
        _bitwise(torch, label, ("packed", "delta", "q_new"), got[:3], want[:3])
        e = _moments_close(label, got[3:], want[3:])
        err["quantize_pack_fused"] = max(err["quantize_pack_fused"], e)
        log(f"  ok {label}: n={g.numel()} b={bits} R={R.item():.6e} "
            f"bitwise; moments {got[3].item():.6e} {got[4].item():.6e}")

    for name, shape in leaf_shapes:
        n = math.prod(shape)
        g, qh = _pair(torch, gen, n)
        one(f"{name} {tuple(shape)}", g.view(shape), qh.view(shape), 8)
        del g, qh
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
    the 12 leaf shapes and the edge cases; a pinned width must be kernel 2
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
    ragged k for each width, lo == hi, and lo far below the grid step; all
    bitwise.  Returns the largest absolute difference of deq (0 when
    bitwise)."""
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


def small_slice_check(torch, ops):
    """Phase 3: the slice on a small input, on the card vs on the CPU, for
    each method.  The card runs count kernel 4's launches by width: the
    tighter A-LAQ must drive its 2- and 4-bit arms through the engine."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.model import init_params, lm_worker_loss

    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = init_params(0, cfg, device="cpu")
    corpus = lm_worker_corpus(0, W, 2, 32, cfg.vocab, device="cpu")
    for method, strategy in strategies().items():
        runs = {}
        ops.quantize_pack_adaptive.launches_by_width = {}
        for dev in ("cpu", "cuda"):
            src = AccumulatingSource(
                lm_worker_loss(cfg, W),
                {k: v.to(dev) for k, v in corpus.items()},
                deterministic=True, accum=ACCUM, scale=1.0)
            runs[dev] = RoundEngine(src, strategy, alpha=SMALL_ALPHA).run(
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
        log(f"  ok {method} on smoke stablelm, {SMALL_ROUNDS} rounds: uploads "
            f"{a.cum_uploads.tolist()} mean width of the uploads "
            f"{a.mean_bits.tolist()} equal on card and CPU; loss max rel diff "
            f"{rel:.3e}; quantize_pack_adaptive launches by width {by_width}")


KERNELS = ("absmax", "quantize_pack_fused", "quantize_pack_adaptive",
           "sparse_quantize_pack")


def run_path(torch, ops, method, cfg, rounds):
    """One path at full width: fresh params and engine, the launch counters
    zeroed just before the rounds and read just after.  Returns the
    counters, the per-round records, round ms and peak bytes."""
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.config import n_params
    from repro_torch.models.model import init_params, lm_worker_loss

    log(f"phase 4: {method}, stablelm-1.6b at {cfg.n_layers} layers "
        f"(P={n_params(cfg)}), W={W}, {N_LOCAL}x{SEQ} tokens per worker, "
        f"accum={ACCUM}, alpha={ALPHA}, fused wire")
    corpus = lm_worker_corpus(0, W, N_LOCAL, SEQ, cfg.vocab, device="cuda")
    engine = RoundEngine(AccumulatingSource(lm_worker_loss(cfg, W), corpus,
                                            deterministic=True, accum=ACCUM,
                                            scale=1.0),
                         strategies()[method], alpha=ALPHA)
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
    del carry, engine, corpus
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    if not all(math.isfinite(r[0].item()) for r in recs):
        raise AssertionError(f"{method}: non-finite loss")
    if recs[0][2] != W:
        raise AssertionError(f"{method}: round 1 uploads {recs[0][2]} != W={W}")
    if max(peaks) >= PEAK_LIMIT:
        raise AssertionError(f"{method}: peak allocation {max(peaks)} B >= "
                             f"{PEAK_LIMIT:.0f} B")
    return launches, recs, round_ms, peaks


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
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
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
    errs["quantize_pack_adaptive"] = check_adaptive_kernel(shapes, torch, ops,
                                                           ref)
    errs["sparse_quantize_pack"] = check_sparse_kernel(ef_k, torch, ops, ref)
    largest = max(math.prod(s) for _, s in shapes)
    timing = time_kernels(largest, ef_k, torch, ops, ref)
    for name, r in timing.items():
        log(f"  {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}")
        for b, w in r.get("by_width", {}).items():
            log(f"    width {b}: {w['ms']:.4f} ms, plain {w['plain_ms']:.4f} ms")
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 3: the slice on a small input, card vs CPU")
    small_slice_check(torch, ops)

    paths = {
        "laq": (cfg, {"absmax": 1, "quantize_pack_fused": 1}),
        "alaq": (cfg, {"absmax": 1, "quantize_pack_adaptive": 1}),
        "ef_topk": (ef_cfg, {"sparse_quantize_pack": 1}),
    }
    by_path = {}
    for method, (pcfg, per) in paths.items():
        rounds = PATH_ROUNDS[method]
        launches, recs, round_ms, peaks = run_path(torch, ops, method, pcfg,
                                                   rounds)
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

    src = "src/repro_torch/kernels/csrc/quant_pack.cu"
    replaces = {
        "absmax": "src/repro/kernels/quant_pack.py:82",
        "quantize_pack_fused": "src/repro/kernels/quant_pack.py:134",
        "quantize_pack_adaptive": "src/repro/kernels/quant_pack.py:264",
        "sparse_quantize_pack": "src/repro/kernels/quant_pack.py:436",
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces[name],
        "launches": sum(by_path[m][name] for m in by_path),
        "launches_by_path": {m: by_path[m][name] for m in by_path},
        "max_abs_err": errs[name], "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in KERNELS]
    by_width = sorted(by_path["alaq"]["adaptive_by_width"].items())
    kernels[KERNELS.index("quantize_pack_adaptive")]["launches_by_width"] = {
        str(b): n for b, n in by_width}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
