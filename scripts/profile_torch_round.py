"""Where one round of the PyTorch port spends its time on the GPU.

    python3 scripts/profile_torch_round.py
        [--method laq|alaq|ef_topk|sharded_b4|sharded_adaptive|
                  sharded_wk2_svrg|sharded_ef_topk]
        [--arch stablelm-1.6b] [--layers N] [--rounds 2] [--top 20]
        [--memory] [--state-bf16]

Runs one of ``chip_smoke.py``'s paths (stablelm-1.6b at its published
widths, float32 params, bfloat16 compute, W=4, 2x512 tokens per worker,
accum 2, on the fused wire) with one of ``benchmarks/lm_frontier.py``'s
deterministic methods: ``laq`` (b=8, per-leaf radii, 24 layers), ``alaq``
(the radius schedule on the grid (2, 4, 8), 24 layers) or ``ef_topk``
(b=4, top-k of 5%, error feedback, 8 layers), for ``--rounds`` warm-up
rounds, then three more rounds.  ``--arch`` and ``--layers`` take another
config of the registry at another depth: ``--arch zamba2-2.7b --layers
24`` is phase 12a's hybrid, ``--arch mamba2-130m`` phase 12c's model.
The rounds:

* plain, timed on the host clock and closed by a synchronize;
* with host timers around the round's stages (each stage ends in
  ``torch.cuda.synchronize()``): the loss forward, each worker's gradient,
  each worker's wire roundtrip and skip decision, and the rest
  (server recursion, update, history push);
* under ``torch.profiler`` (CPU + CUDA activities): device time by kernel,
  and the device's busy share of the round's wall time.

The ``sharded_*`` methods profile one step of ``chip_smoke.py``'s phase 5
instead: the sharded step (``launch/train.py``) at full width and depth,
bfloat16 params and compute, one NCCL worker, 2x512 tokens in 2
microbatches, sgd, the packed wire at b=4, with the adaptive schedule on
the grid (2, 4, 8), or under lasg_wk2 with SVRG's streaming anchor
(refreshed every 2 steps), or EF-top-k (b=4, 5%) on the float wire.  Its
stages: the gradients (every backprop: the primal one, and SVRG's anchor
and WK2's stale iterate where they run), ``worker_update`` (the
roundtrip, width and skip decision), the wire (the streamed packed wire,
``_packed_aggregate``: codes, pack, exchange, decode and sum; or the
float wire's gather and sum) and the optimizer update; the rest is the
SVRG refresh and correction, the server recursion and bookkeeping.
``--layers`` cuts their depth too.  With ``--memory`` a sharded method
runs ``--rounds`` + 1 steps and prints no times: for every call of the
step, of those stages but ``worker_update`` and of the calls inside it
(the EF sum, the sparse roundtrip's flat copies, support, top-k,
``nonzero`` and scatter), the bytes allocated at entry and at exit and the peak inside
the call, nested in call order.  ``--state-bf16`` stores a sharded
method's ``qhat`` and ``server_agg`` in bfloat16 (``state_bf16``).

Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import strategy as strategy_mod  # noqa: E402
from repro_torch.core.adaptive import BitSchedule, EtaSchedule  # noqa: E402
from repro_torch.core.criterion import CriterionConfig  # noqa: E402
from repro_torch.core.engine import AccumulatingSource, RoundEngine  # noqa: E402
from repro_torch.core.strategy import StrategyConfig  # noqa: E402
from repro_torch.data.synthetic import lm_worker_corpus  # noqa: E402
from repro_torch.models.model import init_params, lm_worker_loss  # noqa: E402
from repro_torch.optim.optimizers import Optimizer, sgd  # noqa: E402

W, N_LOCAL, SEQ, ACCUM, ALPHA = 4, 2, 512, 2, 0.5
METHODS = {   # benchmarks/lm_frontier.py:84-96, fused wire: (strategy, layers)
    "laq": (dict(bits=8), 24),
    "alaq": (dict(bits=8, bit_schedule=BitSchedule(
        kind="radius", grid=(2, 4, 8), threshold_mode="rel",
        thresholds=(0.05, 0.5))), 24),
    "ef_topk": (dict(bits=4, compressor="topk", compressor_k=0.05,
                     error_feedback=True), 8),
}
SHARDED = {   # chip_smoke.py phase 5: (strategy, wire)
    "sharded_b4": (dict(bits=4), "packed"),
    "sharded_adaptive": (dict(bits=4, bit_schedule=BitSchedule(
        kind="radius", grid=(2, 4, 8), threshold_mode="rel",
        thresholds=(0.05, 0.5))), "packed"),
    "sharded_wk2_svrg": (dict(bits=4, lazy_rule="lasg_wk2", grad_mode="svrg",
                              svrg_period=2), "packed"),
    "sharded_ef_topk": (dict(bits=4, compressor="topk", compressor_k=0.05,
                             error_feedback=True), "float"),
}


class StageTimer:
    """Wall time of named stages, each closed by a device synchronize."""

    def __init__(self):
        self.ms = defaultdict(float)

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return timed


class MemoryTracker:
    """Device memory of named calls: the bytes allocated at entry and at
    exit, and the peak allocation inside the call (nested tracked calls
    included), one record per call in the order the calls began."""

    def __init__(self):
        self.records = []       # [depth, name, entry, peak, exit]
        self.open = [0]         # the running peak of each open call

    def wrap(self, name, fn):
        cuda = torch.cuda

        def tracked(*args, **kwargs):
            self.open[-1] = max(self.open[-1], cuda.max_memory_allocated())
            entry = cuda.memory_allocated()
            rec = [len(self.open) - 1, name, entry, None, None]
            self.records.append(rec)
            cuda.reset_peak_memory_stats()
            self.open.append(entry)
            out = fn(*args, **kwargs)
            rec[3] = max(self.open.pop(), cuda.max_memory_allocated())
            rec[4] = cuda.memory_allocated()
            self.open[-1] = max(self.open[-1], rec[3])
            cuda.reset_peak_memory_stats()
            return out
        return tracked

    def report(self):
        print(f"  {'call':44s} {'entry GB':>9s} {'peak GB':>9s} "
              f"{'exit GB':>9s}")
        for depth, name, entry, peak, exit_ in self.records:
            print(f"  {'  ' * depth + name:44s} {entry / 1e9:9.3f} "
                  f"{peak / 1e9:9.3f} {exit_ / 1e9:9.3f}")
        self.records.clear()


def track_memory(step, steps):
    """Run ``steps`` calls of ``step()`` with the sharded step's stages
    and the sparse path's calls tracked; print each step's records."""
    from repro_torch.core import compressors as compressors_mod
    from repro_torch.core import wire as wire_mod
    from repro_torch.launch import train as train_mod

    tracker = MemoryTracker()
    # a wrapper holds its arguments until the call returns, so
    # worker_update (which frees the gradients handed to it) is not wrapped
    targets = [(train_mod, k) for k in (
        "accumulate_loss_grads", "apply_svrg_streaming", "stale_side_grads",
        "_packed_aggregate", "_float_aggregate", "_server_update")]
    targets += [(strategy_mod, "fma_f32"), (strategy_mod, "sparse_roundtrip"),
                (wire_mod, "_flat"), (wire_mod, "select_support"),
                (wire_mod, "scatter_selection"),
                (compressors_mod, "_topk_support"), (torch, "topk"),
                (torch, "nonzero")]
    saved = [(mod, k, getattr(mod, k)) for mod, k in targets]
    for mod, k, fn in saved:
        setattr(mod, k, tracker.wrap(k, fn))
    tracked_step = tracker.wrap("step", step)
    for i in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tracker.open = [0]
        met = tracked_step()
        torch.cuda.synchronize()
        print(f"step {i + 1}: uploads {met.uploads}, peak "
              f"{tracker.open[0] / 1e9:.3f} GB")
        tracker.report()
    for mod, k, fn in saved:
        setattr(mod, k, fn)


def report(timer, total, plain, run_once, top):
    """Print the stage table of the timed run, then profile one more run
    (``run_once`` returns its record) and print the device's busy share
    and the top kernels."""
    for name, ms in timer.ms.items():
        print(f"  {name:32s} {ms:9.1f} ms  {100 * ms / total:5.1f}%")
    rest = total - sum(timer.ms.values())
    print(f"  {'rest (recursion, update)':32s} {rest:9.1f} ms  "
          f"{100 * rest / total:5.1f}%")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled run: {wall:.1f} ms wall, device busy "
          f"{device_us / 1e3:.1f} ms ({100 * device_us / 1e3 / wall:.1f}%); "
          f"against the plain run's wall: "
          f"{100 * device_us / 1e3 / plain:.1f}% busy")
    print(events.table(sort_by="self_device_time_total", row_limit=top,
                       max_name_column_width=60))


def profile_sharded(args):
    """One step of the sharded step at full width on one NCCL worker."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import init_workers

    cfg = get_config("stablelm-1.6b")       # bfloat16 params and compute
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    print(f"{args.method}, {cfg.n_layers} layers, one NCCL worker"
          + (", bfloat16 state" if args.state_bf16 else ""))
    store = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    workers = init_workers("nccl", 1, 0, store)
    corpus = lm_worker_corpus(0, 1, N_LOCAL, SEQ, cfg.vocab, device="cuda")
    batch = {k: v[0] for k, v in corpus.items()}
    fields, wire = SHARDED[args.method]
    scfg = StrategyConfig(kind="laq", **fields,
                          per_leaf_radius=True, wire_backend="fused",
                          criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
                          state_bf16=args.state_bf16)
    timer = StageTimer()
    opt = sgd()
    opt = Optimizer(opt.init, timer.wrap("optimizer update", opt.update))
    step = train_mod.make_train_step(cfg, workers, scfg, opt, lr=1e-2,
                                     wire=wire, microbatch=ACCUM)
    state = [train_mod.init_train_state(init_params(0, cfg, device="cuda"),
                                        workers, scfg, opt)]

    def run_once():
        state[0], met = step(state[0], batch)
        return met

    if args.memory:
        track_memory(run_once, args.rounds + 1)
        dist.destroy_process_group()
        return
    for _ in range(args.rounds):
        run_once()
    timer.ms.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    met = run_once()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    print(f"plain step: {plain:.1f} ms, uploads {met.uploads}")
    timer.ms.clear()
    wrapped = {"accumulate_loss_grads": "gradients (fwd+bwd, 2 micro)",
               "worker_update": "worker_update (roundtrip, skip)",
               "_packed_aggregate": "packed wire (codes..sum)",
               "_float_aggregate": "float wire (gather, sum)"}
    saved = {k: getattr(train_mod, k) for k in wrapped}
    for k, name in wrapped.items():
        setattr(train_mod, k, timer.wrap(name, saved[k]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    met = run_once()
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    for k, fn in saved.items():
        setattr(train_mod, k, fn)
    print(f"timed step: {total:.1f} ms, uploads {met.uploads}")
    report(timer, total, plain, run_once, args.top)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=sorted(METHODS) + sorted(SHARDED),
                    default="laq")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the method's, or the config's "
                    "for another --arch)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--memory", action="store_true",
                    help="sharded methods: the memory of each call, no "
                    "times")
    ap.add_argument("--state-bf16", action="store_true",
                    help="sharded methods: qhat and server_agg in bfloat16")
    args = ap.parse_args()
    if args.state_bf16 and args.method not in SHARDED:
        raise SystemExit("--state-bf16 runs in the sharded step only: "
                         "RoundEngine refuses it")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.method in SHARDED:
        return profile_sharded(args)

    method, layers = METHODS[args.method]
    cfg = get_config(args.arch)
    if args.arch != "stablelm-1.6b":
        layers = cfg.n_layers
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              n_layers=args.layers or layers)
    print(f"{args.method}, {cfg.name}, {cfg.n_layers} layers")
    source = AccumulatingSource(
        lm_worker_loss(cfg, W),
        lm_worker_corpus(0, W, N_LOCAL, SEQ, cfg.vocab, device="cuda"),
        deterministic=True, accum=ACCUM, scale=1.0)
    scfg = StrategyConfig(kind="laq", **method, per_leaf_radius=True,
                          wire_backend="fused",
                          criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
                          eta_schedule=EtaSchedule("inv_t", t0=30.0))
    engine = RoundEngine(source, scfg, alpha=ALPHA)
    carry = engine.init_carry(init_params(0, cfg, device="cuda"))
    for _ in range(args.rounds):
        carry, _ = engine.round(carry)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, rec = engine.round(carry)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    print(f"plain round: {plain:.1f} ms, uploads {rec[2]}")

    timer = StageTimer()
    source.global_loss = timer.wrap("loss forward (W workers)",
                                    source.global_loss)
    source.grad_at = timer.wrap("gradients (fwd+bwd, accum)", source.grad_at)
    worker_update = strategy_mod.worker_update
    strategy_mod.worker_update = timer.wrap("wire + skip decision",
                                            worker_update)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, rec = engine.round(carry)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    strategy_mod.worker_update = worker_update
    del source.global_loss, source.grad_at
    print(f"timed round: {total:.1f} ms, uploads {rec[2]}")
    state = [carry]

    def run_once():
        state[0], out = engine.round(state[0])
        return out

    report(timer, total, plain, run_once, args.top)


if __name__ == "__main__":
    main()
