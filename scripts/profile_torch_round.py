"""Where one round of the PyTorch port spends its time on the GPU.

    python3 scripts/profile_torch_round.py
        [--method laq|alaq|ef_topk|sharded_b4|sharded_adaptive]
        [--arch stablelm-1.6b] [--layers N] [--rounds 2] [--top 20]

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
microbatches, sgd, the packed wire at b=4 or with the adaptive schedule on
the grid (2, 4, 8).  Its stages: the gradients, ``worker_update`` (the
roundtrip, width and skip decision), the streamed packed wire
(``_packed_aggregate``: codes, pack, exchange, decode and sum) and the
optimizer update; the rest is the server recursion and bookkeeping.

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
SHARDED = {   # chip_smoke.py phase 5
    "sharded_b4": dict(bits=4),
    "sharded_adaptive": dict(bits=4, bit_schedule=BitSchedule(
        kind="radius", grid=(2, 4, 8), threshold_mode="rel",
        thresholds=(0.05, 0.5))),
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
    print(f"{args.method}, {cfg.n_layers} layers, one NCCL worker")
    store = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    workers = init_workers("nccl", 1, 0, store)
    corpus = lm_worker_corpus(0, 1, N_LOCAL, SEQ, cfg.vocab, device="cuda")
    batch = {k: v[0] for k, v in corpus.items()}
    scfg = StrategyConfig(kind="laq", **SHARDED[args.method],
                          per_leaf_radius=True, wire_backend="fused",
                          criterion=CriterionConfig(D=10, xi=0.08, t_bar=100))
    timer = StageTimer()
    opt = sgd()
    opt = Optimizer(opt.init, timer.wrap("optimizer update", opt.update))
    step = train_mod.make_train_step(cfg, workers, scfg, opt, lr=1e-2,
                                     wire="packed", microbatch=ACCUM)
    state = [train_mod.init_train_state(init_params(0, cfg, device="cuda"),
                                        workers, scfg, opt)]

    def run_once():
        state[0], met = step(state[0], batch)
        return met

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
               "_packed_aggregate": "packed wire (codes..sum)"}
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
    args = ap.parse_args()
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
