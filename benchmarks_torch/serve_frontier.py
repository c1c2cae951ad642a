"""Serving-freshness frontier of the port, the counterpart of
``benchmarks/serve_frontier.py``: eval quality against delta-push
bandwidth.

One LAQ trainer (the micro LM: b=8 dense grid, 1/t stepsize,
``AccumulatingSource`` fold, ``RoundEngine`` of the port) runs once; its
parameter trajectory is replayed through five publishing policies
(``core/replica.py``) feeding a replica fleet, and each policy is scored
on the served replica's held-out eval loss, its pushed wire bits (the
initial snapshot included) and the worst ``rounds_behind`` any replica
serves at.  Policies: always-push float32 (a resync every round),
always-push quantized (b=4), lazy quantized (push only when the
innovation beats the relative threshold, resync after 16 skipped rounds),
lazy adaptive width (a rel-mode ``BitSchedule``), and lazy quantized
behind a 3-replica fleet with transport delay (``max_delay=2``).

Checks (the reference's): lazy quantized serves within 1.05x (1.10x with
``--tiny``) of always-push float32's eval loss at <= 0.25x its bytes, and
below always-push quantized's bytes; the replica equals the published
view bitwise on both wire backends, with identical push schedules and
bits; every resync restores bitwise equality with the trainer; freshness
stays within the staleness budget (+ the transport delay); adaptive width
serves within the same band.  A greedy-decode tokens/s row rides along
(no check).

    PYTHONPATH=src python -m benchmarks_torch.serve_frontier [--tiny] \\
        [--device cpu] [--out rows.json]

It prints its rows and checks and exits 1 if a check fails.  JSON is
written only to ``--out``.  The weights are the port's own random init
from seed 0 (the same distribution as the reference's, not its bits), so
the numbers are not the reference's ``BENCH_serve.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch import random
from repro_torch.core.adaptive import BitSchedule, EtaSchedule
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.engine import AccumulatingSource, RoundEngine
from repro_torch.core.replica import (PublishConfig, apply_message,
                                      init_publisher, init_replica, publish)
from repro_torch.core.strategy import StrategyConfig
from repro_torch.data.synthetic import lm_worker_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.publish import ReplicaFleet, trainer_rounds
from repro_torch.launch.serve import jit_serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, lm_loss, lm_worker_loss
from repro_torch.tree import tree_leaves, tree_map

STEPS = 150
TINY_STEPS = 40
LOSS_MULT = 1.05
TINY_LOSS_MULT = 1.10
BYTES_MULT = 0.25
ALPHA = 0.5
W = 4
ACCUM = 2
TRAIN_BITS = 8            # the gradient wire's dense grid
PUSH_BITS = 4             # the parameter-delta wire is a separate dial
LAZY_TH = 0.35
MAX_STALENESS = 16

CFG = ModelConfig(name="lm-micro", arch_type="dense", n_layers=2, d_model=32,
                  vocab=64, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                  q_chunk=16, kv_chunk=8,
                  param_dtype=torch.float32, compute_dtype=torch.float32)
CRIT = CriterionConfig(D=10, xi=0.08, t_bar=100)
ETA = EtaSchedule(kind="inv_t", t0=30.0)


def _policies():
    return {
        # a resync every round: threshold >= 1 never pushes lazily, and
        # max_staleness=0 tolerates no skip
        "float32_push": PublishConfig(threshold=1.5, max_staleness=0),
        "quant_push": PublishConfig(bits=PUSH_BITS, threshold=0.0),
        "lazy_quant": PublishConfig(bits=PUSH_BITS, threshold=LAZY_TH,
                                    max_staleness=MAX_STALENESS),
        "lazy_adaptive": PublishConfig(
            threshold=LAZY_TH, max_staleness=MAX_STALENESS,
            bit_schedule=BitSchedule(kind="radius", grid=(2, 4, 8),
                                     threshold_mode="rel",
                                     thresholds=(0.05, 0.5))),
    }


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _train_trajectory(steps: int, dev):
    """The one trainer run every policy replays: a clone of each iterate."""
    engine = RoundEngine(
        AccumulatingSource(lm_worker_loss(CFG, W),
                           lm_worker_corpus(0, W, 16, 16, CFG.vocab,
                                            device=dev),
                           deterministic=True, accum=ACCUM, scale=1.0),
        StrategyConfig(kind="laq", bits=TRAIN_BITS, per_leaf_radius=True,
                       criterion=CRIT, eta_schedule=ETA),
        alpha=ALPHA)
    params0 = init_params(0, CFG, device=dev)
    traj = [tree_map(torch.clone, p)
            for p in trainer_rounds(engine, params0, steps, device=dev)]
    return params0, traj


def _replay(name, pcfg, params0, traj, eval_loss, *, n_replicas=1,
            max_delay=0):
    """One policy over the trajectory; scores replica 0."""
    st = init_publisher(params0, pcfg)
    fleet = ReplicaFleet(params0, n_replicas, pcfg, max_delay=max_delay)
    max_behind, resync_exact = 0, None
    for params in traj:
        msg, st = publish(pcfg, st, params)
        fleet.deliver(msg)
        max_behind = max(max_behind, max(fleet.freshness()))
        if msg is not None and not hasattr(msg, "payloads") and max_delay == 0:
            # a resync on a synchronous fleet must equal the trainer
            exact = _tree_equal(fleet.replicas[0].params, params)
            resync_exact = exact if resync_exact is None \
                else (resync_exact and exact)
    loss = float(eval_loss(fleet.replicas[0].params))
    return dict(policy=name, bits=st.bits_sent, n_pushes=st.n_pushes,
                n_resyncs=st.n_resyncs, max_rounds_behind=max_behind,
                eval_loss=loss, eval_ppl=math.exp(min(loss, 30.0)),
                resync_exact=resync_exact, n_replicas=n_replicas,
                max_delay=max_delay)


def _bitwise_both_backends(params0, traj):
    """Both backends cut the same push schedule and bits, and a replica
    equals the published view bitwise on each."""
    outcomes = {}
    for backend in ("reference", "fused"):
        pcfg = PublishConfig(bits=PUSH_BITS, threshold=LAZY_TH,
                             max_staleness=MAX_STALENESS,
                             wire_backend=backend)
        st = init_publisher(params0, pcfg)
        rep = init_replica(params0)
        sched, ok = [], True
        for params in traj:
            msg, st = publish(pcfg, st, params)
            rep = apply_message(rep, msg, pcfg)
            sched.append(None if msg is None
                         else "p" if hasattr(msg, "payloads") else "r")
            ok &= _tree_equal(rep.params, st.theta_pub)
        outcomes[backend] = (sched, ok, st.bits_sent)
    ref, fused = outcomes["reference"], outcomes["fused"]
    return ref[0] == fused[0] and ref[2] == fused[2], ref[1] and fused[1]


def _decode_tokens_per_s(params, dev, tokens=16, batch=4, prompt_len=16):
    """Steady-state greedy decode rate on the served weights, after a
    warm-up session."""
    prefill_fn, decode_fn = jit_serve(CFG, prompt_len + tokens)
    prompts = random.randint(random.PRNGKey(1, device=dev),
                             (batch, prompt_len), 0, CFG.vocab)
    tok, cache = prefill_fn(params, prompts)
    decode_fn(params, cache, tok)
    tok, cache = prefill_fn(params, prompts)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(tokens):
        tok, cache = decode_fn(params, cache, tok)
    tok.cpu()
    return batch * tokens / (time.perf_counter() - t0)


def run(tiny: bool = False, device="cuda"):
    """``(rows, checks)``: one row per policy and the decode rate; each
    check True, False, or None where it does not apply."""
    dev = resolve_device(device)
    steps = TINY_STEPS if tiny else STEPS
    params0, traj = _train_trajectory(steps, dev)

    held_out = lm_worker_corpus(1, 1, 32, 16, CFG.vocab, device=dev)
    eval_batch = {k: v[0] for k, v in held_out.items()}

    def eval_loss(p):
        with torch.no_grad():
            return lm_loss(p, eval_batch, CFG)

    rows = [_replay(name, pcfg, params0, traj, eval_loss)
            for name, pcfg in _policies().items()]
    rows.append(_replay("lazy_quant_fleet",
                        PublishConfig(bits=PUSH_BITS, threshold=LAZY_TH,
                                      max_staleness=MAX_STALENESS),
                        params0, traj, eval_loss, n_replicas=3, max_delay=2))
    by = {r["policy"]: r for r in rows}
    rows.append(dict(policy="decode_rate", tokens_per_s=_decode_tokens_per_s(
        init_replica(traj[-1]).params, dev)))

    f32, lazy, quant = by["float32_push"], by["lazy_quant"], by["quant_push"]
    mult = TINY_LOSS_MULT if tiny else LOSS_MULT
    sched_ok, bitwise_ok = _bitwise_both_backends(params0, traj)
    checks = {
        "lazy quantized publishing serves within "
        f"{mult}x of always-push-float32 eval loss":
            lazy["eval_loss"] <= mult * f32["eval_loss"],
        "lazy quantized pushes <= 0.25x the float32 bytes":
            lazy["bits"] <= BYTES_MULT * f32["bits"],
        "laziness pays on top of quantization: lazy < always-push bytes":
            lazy["bits"] < quant["bits"],
        "replica == published view bitwise on both wire backends":
            bitwise_ok,
        "both wire backends cut identical push schedules and bits":
            sched_ok,
        "every max_staleness resync restored bitwise trainer equality":
            None if lazy["n_resyncs"] == 0 and f32["n_resyncs"] == 0
            else bool((lazy["resync_exact"] in (None, True))
                      and (f32["resync_exact"] in (None, True))
                      and (lazy["n_resyncs"] + f32["n_resyncs"]) > 0),
        "freshness stays within the staleness budget (+ transport delay)":
            lazy["max_rounds_behind"] <= MAX_STALENESS
            and by["lazy_quant_fleet"]["max_rounds_behind"]
            <= MAX_STALENESS + 2,
        "adaptive width serves the same quality band as fixed b=4":
            by["lazy_adaptive"]["eval_loss"] <= mult * f32["eval_loss"],
    }
    return rows, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="fewer trainer rounds, looser loss band")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", help="write the rows and checks as JSON here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("serve_frontier: torch.cuda.is_available() is False; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 1
    rows, checks = run(tiny=args.tiny, device=args.device)
    by = {r["policy"]: r for r in rows}
    print(f"{'policy':17s} {'eval ppl':>9s} {'Mbits':>8s} {'pushes':>7s} "
          f"{'resyncs':>8s} {'behind':>7s}")
    for name in ("float32_push", "quant_push", "lazy_quant", "lazy_adaptive",
                 "lazy_quant_fleet"):
        r = by[name]
        print(f"{name:17s} {r['eval_ppl']:9.3f} {r['bits'] / 1e6:8.3f} "
              f"{r['n_pushes']:7d} {r['n_resyncs']:8d} "
              f"{r['max_rounds_behind']:7d}")
    print(f"decode: {by['decode_rate']['tokens_per_s']:,.0f} tok/s on "
          f"{args.device} (steady-state greedy, no check)")
    ok = True
    for k, v in checks.items():
        print(f"[{'SKIP' if v is None else 'PASS' if v else 'FAIL'}] {k}")
        ok &= v is None or bool(v)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"tiny": args.tiny, "device": args.device,
                       "rows": rows, "checks": checks}, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
