#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LAQ (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to a plain version while a CUDA tensor is at hand):

1. Build the hand-written CUDA wire kernels with ``nvcc`` (sm_90a) from
   ``src/repro_torch/kernels/csrc`` and print the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card: at the
   12 leaf shapes of stablelm-1.6b, a length that is not a multiple of 8
   or 4096, an unaligned operand, R == 0 and b in {1, 2, 4, 8}.  R, codes,
   packed bytes, delta and q_new must be bitwise equal; the two moments
   agree to rtol 1e-5 (the kernel sums in float64 per thread, the plain
   version in float32).  Time both and a one-call PyTorch yardstick at the
   largest leaf (276,824,064 elements) with CUDA events.
3. Check the whole slice on a small input: smoke stablelm in float32,
   12 deterministic LAQ rounds on the card against the same run on the
   CPU (plain versions): identical uploads and bits, loss to rtol 1e-4.
4. The main path: stablelm-1.6b at its published widths (24 layers,
   d_model 2048, vocab 100352), float32 params and bfloat16 compute, W=4
   workers with 2 x 512 tokens each, ``AccumulatingSource(deterministic,
   accum=2)``, LAQ b=8 with per-leaf radii on the fused wire, lm_frontier's
   criterion and 1/t stepsize, alpha=0.5, through ``RoundEngine.round``.
   The kernels' launch counters are zeroed just before and must read
   rounds x W x 12 just after; every loss must be finite and round 1 must
   upload from every worker.

The last lines are the card (``nvidia-smi``), one JSON object of per-kernel
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ROUNDS, W, N_LOCAL, SEQ, ACCUM, ALPHA = 4, 4, 2, 512, 2, 0.5
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


def check_kernels(leaf_shapes, torch, ops, ref):
    """Phase 2: bitwise checks at every main-path shape and the edge cases;
    returns the largest absolute error of each kernel's outputs."""
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
        got = ops.quantize_pack_fused(g, qh, R, bits)
        want = ref.quantize_pack_fused_ref(g, qh, R, bits)
        torch.cuda.synchronize()
        for name, a, b in zip(("packed", "delta", "q_new"), got[:3], want[:3]):
            if a.shape != b.shape or not torch.equal(a, b):
                bad = (a != b).sum().item() if a.shape == b.shape else "shape"
                raise AssertionError(f"{label}: {name} differs from the plain "
                                     f"version ({bad} elements)")
        e = 0.0
        for name, a, b in zip(("err_sq", "innovation_sq"), got[3:], want[3:]):
            a, b = a.item(), b.item()
            if not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"{label}: {name} {a!r} vs plain {b!r}")
            e = max(e, abs(a - b))
        err["quantize_pack_fused"] = max(err["quantize_pack_fused"], e)
        log(f"  ok {label}: n={g.numel()} b={bits} R={R.item():.6e} "
            f"bitwise; moments {got[3].item():.6e} {got[4].item():.6e}")

    def pair(n, shift=0):
        g = torch.randn(n + shift, generator=gen, device="cuda") * 1e-3
        qh = g + torch.randn(n + shift, generator=gen, device="cuda") * 1e-4
        return g[shift:], qh[shift:]

    for name, shape in leaf_shapes:
        n = math.prod(shape)
        g, qh = pair(n)
        one(f"{name} {tuple(shape)}", g.view(shape), qh.view(shape), 8)
        del g, qh
    g, qh = pair(3 * 4096 + 1239)
    one("ragged length", g, qh, 8)
    g, qh = pair(1_000_003, shift=1)
    one("unaligned operands", g, qh, 8)
    g, qh = pair(1_000_003)
    one("R == 0", g, g.clone(), 8)
    for bits in (1, 2, 4, 8):
        one(f"b={bits}", g, qh, bits)
    return err


def time_kernels(n, torch, ops, ref):
    """Kernel, plain version and one-call yardstick at the largest leaf."""
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
    for r in rows.values():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["ops"] / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return rows


def strategy():
    from repro_torch.core.adaptive import EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.strategy import StrategyConfig
    return StrategyConfig(
        kind="laq", bits=8, per_leaf_radius=True, wire_backend="fused",
        criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
        eta_schedule=EtaSchedule("inv_t", t0=30.0))


def small_slice_check(torch):
    """Phase 3: the slice on a small input, on the card vs on the CPU."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.model import init_params, lm_worker_loss

    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = init_params(0, cfg, device="cpu")
    corpus = lm_worker_corpus(0, W, 2, 32, cfg.vocab, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        src = AccumulatingSource(
            lm_worker_loss(cfg, W), {k: v.to(dev) for k, v in corpus.items()},
            deterministic=True, accum=ACCUM, scale=1.0)
        runs[dev] = RoundEngine(src, strategy(), alpha=SMALL_ALPHA).run(
            params, SMALL_ROUNDS, device=dev)
    a, b = runs["cuda"], runs["cpu"]
    if not (torch.equal(a.cum_uploads, b.cum_uploads)
            and torch.equal(a.cum_bits, b.cum_bits)):
        raise AssertionError(f"uploads/bits differ: cuda {a.cum_uploads.tolist()}"
                             f" cpu {b.cum_uploads.tolist()}")
    rel = ((a.loss - b.loss).abs() / b.loss.abs()).max().item()
    if not rel <= 1e-4:
        raise AssertionError(f"loss differs from the CPU run by {rel:.3e}")
    log(f"  ok smoke stablelm, {SMALL_ROUNDS} rounds: uploads "
        f"{a.cum_uploads.tolist()} equal on card and CPU; loss max rel diff "
        f"{rel:.3e}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.kernels import ops, quant_pack, ref
    from repro_torch.models.config import n_params
    from repro_torch.models.model import init_params, lm_worker_loss

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
    p = sum(math.prod(s) for _, s in shapes)
    if p != n_params(cfg) or len(shapes) != 12:
        raise AssertionError(f"{len(shapes)} leaves, {p} params")
    log(f"stablelm-1.6b: {p} params in {len(shapes)} leaves")

    log("phase 2: kernels against their plain versions")
    errs = check_kernels(shapes, torch, ops, ref)
    largest = max(math.prod(s) for _, s in shapes)
    timing = time_kernels(largest, torch, ops, ref)
    for name, r in timing.items():
        log(f"  {name} at n={largest}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    torch.cuda.empty_cache()

    log("phase 3: the slice on a small input, card vs CPU")
    small_slice_check(torch)

    log(f"phase 4: stablelm-1.6b, W={W}, {N_LOCAL}x{SEQ} tokens per worker, "
        f"accum={ACCUM}, LAQ b=8 per-leaf fused, alpha={ALPHA}")
    corpus = lm_worker_corpus(0, W, N_LOCAL, SEQ, cfg.vocab, device="cuda")
    engine = RoundEngine(AccumulatingSource(lm_worker_loss(cfg, W), corpus,
                                            deterministic=True, accum=ACCUM,
                                            scale=1.0),
                         strategy(), alpha=ALPHA)
    carry = engine.init_carry(params, device="cuda")
    del params
    torch.cuda.synchronize()
    ops.absmax.launches = 0
    ops.quantize_pack_fused.launches = 0
    recs, round_ms, peaks = [], [], []
    for k in range(ROUNDS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        carry, rec = engine.round(carry)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        recs.append(rec)
        loss, gn, ups, bits, qe, _ = rec
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        log(f"  round {k + 1}: loss {loss.item():.6f} uploads {ups} "
            f"cum_bits {bits.item():.6e} R_max {qe.item():.4e} "
            f"ms {round_ms[-1]:.1f} peak_alloc {peaks[-1] / 1e9:.2f} GB "
            f"alloc_retries {retries}")
    launches = {"absmax": ops.absmax.launches,
                "quantize_pack_fused": ops.quantize_pack_fused.launches}

    want = ROUNDS * W * len(shapes)
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the main "
                                 f"path, expected {want}")
    if not all(math.isfinite(r[0].item()) for r in recs):
        raise AssertionError("non-finite loss")
    if recs[0][2] != W:
        raise AssertionError(f"round 1 uploads {recs[0][2]} != W={W}")
    log(f"  ok: launches {launches}, losses finite, round-1 uploads {W}; "
        f"mean round ms after the first {sum(round_ms[1:]) / (ROUNDS - 1):.1f}"
        f", max peak {max(peaks) / 1e9:.2f} GB")

    src = "src/repro_torch/kernels/csrc/quant_pack.cu"
    replaces = {"absmax": "src/repro/kernels/quant_pack.py:82",
                "quantize_pack_fused": "src/repro/kernels/quant_pack.py:134"}
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in ("absmax", "quantize_pack_fused")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
