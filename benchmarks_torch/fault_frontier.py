"""Fault frontier on the port: LAQ under corrupt, crashed and Byzantine
workers, port of ``benchmarks/fault_frontier.py``.

    PYTHONPATH=src python -m benchmarks_torch.fault_frontier \\
        [--device cuda|cpu] [--wire reference|fused] [--tiny]

One small multinomial-logistic problem (W = 6 workers, 8 features, 4
classes: one leaf of 32 parameters, with an L2 term so that the optimum is
interior), one loss target, ``TARGET_MULT`` times the fault-free final
loss, and eleven cells of fault and defense, each ``STEPS`` rounds of LAQ
(or dense QGD) at b = ``BITS``:

* ``clean`` and ``clean_defended``: validation and the norm gate at fault
  rate 0 must give the bitwise-equal loss trace and the same bits;
* ``inf_*`` and ``nan_*``: 10% of the uploads corrupted to +inf or NaN,
  without and with validation (a NaN gradient makes R NaN, so the R > 0
  guard drops the payload while ``err_sq`` NaN forces dense uploads);
* ``crash_naive`` and ``crash_reconciled``: crash-restart at 2% a round,
  the server's stale ``qhat`` kept or subtracted;
* ``scale_qgd_sum``, ``scale_qgd_trimmed`` and ``scale_laq_gated``: 8% of
  the uploads scaled by -40, against the plain sum, the trimmed mean and
  the norm gate;

and a twelfth row, ``watchdog_inf``: the undefended inf corruption under
:func:`repro_torch.core.defense.run_with_watchdog`, which rolls back from
its checkpoint and escalates to a validating engine.  Each row has the
final loss, whether every loss was finite, the total uploads and bits and
the bits at the first round whose loss is at most the target (not
``common.first_reach``'s sustained crossing); eleven claim checks follow.
With ``--tiny`` (``TINY_STEPS`` rounds) the two margin claims print SKIP.
Two claims fail in the reference too (the trimmed mean's gain is about 4x,
not 10x; the gated lazy run never reaches the target): the port keeps the
reference's verdicts, so this exits 1 as the reference's ``main`` does.

``--wire fused`` sends every cell through ``absmax`` and
``quantize_pack_fused`` on the card, once per worker and round: a
corrupted, crashed or rejected worker still runs its wire.  The card is
the default device: without one, and without ``--device cpu``, this exits
non-zero.  Unlike the reference, it writes no ``BENCH_faults.json``.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.defense import (DefenseConfig, WatchdogConfig,
                                      run_with_watchdog)
from repro_torch.core.engine import FullBatchSource, RoundEngine
from repro_torch.core.faults import FaultConfig
from repro_torch.core.quantize import fma_f32
from repro_torch.core.strategy import StrategyConfig
from repro_torch.data.synthetic import classification_dataset, split_workers
from repro_torch.device import resolve_device
from repro_torch.random import xla_exp, xla_log

from .tables import table_main

STEPS = 120
TINY_STEPS = 60           # the margin claims need the full horizon: SKIP
W = 6
ALPHA = 0.05
BITS = 4
L2 = 1e-2                 # interior optimum (see the reference's docstring)
CRIT = CriterionConfig(D=10, xi=0.001, t_bar=6)
TARGET_MULT = 1.02        # target = MULT x fault-free final loss
BITS_RATIO_MAX = 1.5      # defended bits-to-target vs clean
CRASH_DRIFT_MIN = 1.3     # naive-crash final vs clean final
TRIM_GAIN_MIN = 10.0      # sum final vs trimmed final
F32 = torch.float32

INF = FaultConfig(corrupt_p=0.1, corrupt_kind="inf")
NAN = FaultConfig(corrupt_p=0.1, corrupt_kind="nan")
CRASH = FaultConfig(crash_p=0.02)
SCALE = FaultConfig(corrupt_p=0.08, corrupt_kind="scale", corrupt_scale=-40.0)
VALIDATE = DefenseConfig(validate=True)


def _fma(a, b, c):
    """``a * b + c`` rounded once, on operands broadcast to one shape."""
    return fma_f32(*(x.contiguous() for x in torch.broadcast_tensors(a, b, c)))


def _const(x, v):
    return torch.tensor(v, dtype=F32, device=x.device)


class SoftmaxSource(FullBatchSource):
    """The problem's gradient source: every worker's gradient and loss
    computed at once, at the round's iterate, in the order of XLA's CPU
    program for the reference's jitted ``vmap`` of ``jax.grad`` and of the
    loss (jax 0.9, read off its optimized HLO and IR), one float32
    operation at a time, so that the CPU and the card give the reference's
    bits.  The loss of worker m is the mean softmax cross-entropy of its
    shard plus ``L2 * sum(p^2)``.

    * ``X @ p`` (``[W * n, 8] @ [8, 4]``): four FMA chains, over the
      features ``k`` and ``k + 4``, summed pairwise.
    * ``exp`` and ``log`` are XLA's (:func:`repro_torch.random.xla_exp`,
      :func:`~repro_torch.random.xla_log`); the class sums run in class
      order.
    * The gradient: the log-softmax cotangent ``t e - Y / n``, ``t = (Y / n
      summed over the classes) / s``, as one FMA; ``X^T`` times it as one
      FMA chain over the rows from row 0; plus ``2 (L2 p)``.  ``Y`` is
      one-hot, so ``Y / n`` (the product with ``f32(1/n)``) and its sums
      are exact.
    * The loss: ``S = sum(Y (d - log s))`` in four lanes of the rows ``r
      mod 4``, the classes in order within a row, the lanes summed as ``(0
      + 2) + (1 + 3)``; ``sum(p^2)`` in eight lanes, one a row of ``p``,
      each an FMA chain over its columns, summed as a tree over ``(l, l +
      4)``, ``(l, l + 2)``, ``(l, l + 1)``; then ``L2 sum(p^2) - S / n``
      with the product by ``f32(1/n)`` contracted into the difference.  The
      global loss sums the workers' in order from 0.

    The engine asks for the loss, then for one worker's gradient at a
    time: the first ask at an iterate computes all W and keeps them, and
    the softmax they share, until the engine moves to another iterate."""

    def __init__(self, worker_data):
        super().__init__(None, worker_data)
        self.inv = float(torch.tensor(1.0 / worker_data[0].shape[1],
                                      dtype=F32))
        self._at, self._cache = None, {}

    def _logits(self, p):
        X = self.worker_data[0]
        half = X.shape[-1] // 2
        acc = _fma(X[..., half:, None], p[half:],
                   X[..., :half, None] * p[:half])
        return (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :]
                                                     + acc[..., 3, :])

    def _cached(self, p, what, make):
        """``make(p)``, kept while the engine stays at the iterate ``p``
        (the round's loss, then its W gradients)."""
        if self._at is None or self._at[0] is not p or \
                self._at[1] != p._version:
            self._at, self._cache = (p, p._version), {}
        if what not in self._cache:
            self._cache[what] = make(p)
        return self._cache[what]

    def _shift(self, p):
        def make(p):
            z = self._logits(p)
            d = z - torch.amax(z, -1, keepdim=True)
            e = xla_exp(d)
            s = e[..., 0]
            for c in range(1, e.shape[-1]):
                s = s + e[..., c]
            return d, e, s
        return self._cached(p, "shift", make)

    def grads(self, p) -> torch.Tensor:
        """``[W, 8, 4]``: every worker's gradient at ``p``."""
        X, Y = self.worker_data
        _, e, s = self._shift(p)
        yc = Y * _const(p, self.inv)
        u = -yc[..., 0]
        for c in range(1, Y.shape[-1]):
            u = u - yc[..., c]
        gz = _fma((-u / s)[..., None], e, -yc)
        g = torch.zeros((X.shape[0],) + tuple(p.shape), dtype=F32,
                        device=p.device)
        for i in range(X.shape[1]):
            g = _fma(X[:, i, :, None], gz[:, i, None, :], g)
        reg = p * _const(p, L2)
        return g + (reg + reg)

    def worker_losses(self, p) -> torch.Tensor:
        """``[W]``: every worker's loss at ``p``."""
        Y = self.worker_data[1]
        d, _, s = self._shift(p)
        term = Y * (d - xla_log(s)[..., None])
        lanes = torch.tensor([0.0, -0.0, -0.0, -0.0], dtype=F32,
                             device=p.device).expand(Y.shape[0], 4)
        for r in range(0, Y.shape[1], 4):
            for c in range(Y.shape[-1]):
                lanes = lanes + term[:, r:r + 4, c]
        S = (lanes[:, 0] + lanes[:, 2]) + (lanes[:, 1] + lanes[:, 3])
        sq = p[:, 0] * p[:, 0]
        for j in range(1, p.shape[1]):
            sq = _fma(p[:, j], p[:, j], sq)
        sq = sq[:4] + sq[4:]
        sq = sq[:2] + sq[2:]
        reg = (sq[0] + sq[1]) * _const(p, L2)
        return _fma(-S, _const(p, self.inv), reg)

    def grad_at(self, params, batches, m: int):
        return self._cached(params, "grads", self.grads)[m].clone()

    @torch.no_grad()
    def global_loss(self, params):
        losses = self.worker_losses(params)
        total = losses[0]
        for w in range(1, losses.shape[0]):
            total = total + losses[w]
        return total


def problem(device="cuda"):
    """``(source, p0)``: the mixture of ``PRNGKey(0)`` (30 rows a class) on
    ``device``, split over ``W`` workers of 20 rows, as a
    :class:`SoftmaxSource`, and the zero ``[8, 4]`` start."""
    dev = resolve_device(device)
    X, Y = classification_dataset(random.PRNGKey(0, device=dev),
                                  n_per_class=30, n_classes=4, n_features=8,
                                  separation=2.0, noise=1.0)
    return (SoftmaxSource(split_workers(X, Y, W)),
            torch.zeros((8, 4), dtype=F32, device=dev))


def bits_to(result, target):
    """The cumulative bits at the first round whose loss is at most
    ``target`` (the reference's ``_bits_to``), or None."""
    hit = np.nonzero(result.loss.numpy() <= target)[0]
    return None if hit.size == 0 else float(result.cum_bits[hit[0]])


def _cells(wire):
    """The eleven cells by name, in the reference's order."""
    laq = StrategyConfig(kind="laq", bits=BITS, criterion=CRIT,
                         wire_backend=wire)
    qgd = laq._replace(kind="qgd")
    return {
        "clean": laq,
        "clean_defended": laq._replace(
            defense=DefenseConfig(validate=True, gate_mult=6.0)),
        "inf_undefended": laq._replace(faults=INF),
        "inf_defended": laq._replace(faults=INF, defense=VALIDATE),
        "nan_undefended": laq._replace(faults=NAN),
        "nan_defended": laq._replace(faults=NAN, defense=VALIDATE),
        "crash_naive": laq._replace(
            faults=CRASH, defense=DefenseConfig(reconcile_crashes=False)),
        "crash_reconciled": laq._replace(faults=CRASH),
        "scale_qgd_sum": qgd._replace(faults=SCALE),
        "scale_qgd_trimmed": qgd._replace(faults=SCALE,
                                          aggregator="trimmed_mean",
                                          trim_frac=0.34),
        "scale_laq_gated": laq._replace(
            faults=SCALE, defense=DefenseConfig(validate=True, gate_mult=4.0)),
    }


# the rows in the reference's order: the eleven cells, then the watchdog's
CELL_ORDER = (*_cells("reference"), "watchdog_inf")


def watchdog_row(src, p0, steps, wire, device):
    """The undefended inf corruption under the watchdog: chunks of 20
    rounds, a checkpoint in a temporary directory, rollback and escalation
    to a validating engine on the same source.  Returns ``(result,
    log)``."""
    cfg = StrategyConfig(kind="laq", bits=BITS, criterion=CRIT, faults=INF,
                         wire_backend=wire)

    def escalate(engine):
        return RoundEngine(src, engine.cfg._replace(defense=VALIDATE),
                           alpha=ALPHA)

    with tempfile.TemporaryDirectory() as td:
        res, log, _ = run_with_watchdog(
            RoundEngine(src, cfg, alpha=ALPHA), p0, steps,
            ckpt_path=os.path.join(td, "wd.npz"),
            wd=WatchdogConfig(chunk=20, explode_mult=25.0), escalate=escalate,
            device=device)
    return res, log


def run(out_rows, results, *, device="cuda", wire="reference", tiny=False,
        traces=None):
    """Fill ``results`` with one row per cell (``fault_frontier/<cell>``),
    the target's (``fault_frontier/target``) and the watchdog's log
    (``fault_frontier/watchdog_log``); return the claim checks.
    ``traces``, when given, receives each run's :class:`RunResult`."""
    dev = resolve_device(device)
    traces = {} if traces is None else traces
    src, p0 = problem(dev)
    steps = TINY_STEPS if tiny else STEPS

    runs = {}
    for name, cfg in _cells(wire).items():
        runs[name] = RoundEngine(src, cfg, alpha=ALPHA).run(p0, steps,
                                                            device=dev)
    runs["watchdog_inf"], wd_log = watchdog_row(src, p0, steps, wire, dev)
    for name, r in runs.items():
        traces[f"fault_frontier/{name}"] = r

    clean_final = float(runs["clean"].loss[-1])
    target = TARGET_MULT * clean_final

    frontier = {}
    for name, r in runs.items():
        bt = bits_to(r, target)
        frontier[name] = results[f"fault_frontier/{name}"] = dict(
            final_loss=float(r.loss[-1]),
            finite=bool(torch.isfinite(r.loss).all()),
            total_uploads=int(r.cum_uploads[-1]),
            total_bits=float(r.cum_bits[-1]),
            bits_to_target=bt)
        out_rows.append((f"fault_frontier_{name}", float(r.cum_bits[-1]),
                         f"loss={frontier[name]['final_loss']:.4f};"
                         f"to_target={bt}"))
    results["fault_frontier/target"] = dict(
        target_loss=target, clean_final=clean_final, steps=steps)
    results["fault_frontier/watchdog_log"] = dict(
        rollbacks=len(wd_log["rollbacks"]),
        wasted_rounds=int(wd_log["wasted_rounds"]),
        wasted_bits=float(wd_log["wasted_bits"]),
        gave_up=bool(wd_log["gave_up"]))

    def f(name, key="final_loss"):
        return frontier[name][key]

    def reaches(name):
        return frontier[name]["bits_to_target"] is not None

    def bits_to_target(name):
        v = frontier[name]["bits_to_target"]
        return np.inf if v is None else v

    full = None if tiny else True  # margin claims SKIP on the tiny horizon
    results["fault_frontier/claims"] = checks = {
        "defense at fault rate 0 is free: bitwise-identical loss, equal bits":
            torch.equal(runs["clean"].loss, runs["clean_defended"].loss)
            and f("clean", "total_bits") == f("clean_defended", "total_bits"),
        "inf corruption: undefended goes non-finite and never reaches target":
            not f("inf_undefended", "finite")
            and not reaches("inf_undefended"),
        "inf corruption: validation reaches target":
            reaches("inf_defended") and f("inf_defended", "finite"),
        f"inf corruption: defended bits-to-target <= {BITS_RATIO_MAX}x clean":
            full and bits_to_target("inf_defended")
            <= BITS_RATIO_MAX * bits_to_target("clean"),
        "nan corruption: undefended stays finite but pays >=10% upload tax":
            f("nan_undefended", "finite")
            and f("nan_undefended", "total_uploads")
            >= 1.10 * f("clean", "total_uploads"),
        "nan corruption: err_sq validation reaches target, uploads <= "
        "undefended":
            reaches("nan_defended")
            and f("nan_defended", "total_uploads")
            <= f("nan_undefended", "total_uploads"),
        f"crash: naive restart's ghost bias >= {CRASH_DRIFT_MIN}x clean "
        "final loss":
            full and f("crash_naive") >= CRASH_DRIFT_MIN * clean_final,
        "crash: reconciled restart lands on the clean floor (<=1.05x)":
            f("crash_reconciled") <= 1.05 * clean_final,
        f"byzantine scale: trimmed-mean final >= {TRIM_GAIN_MIN:.0f}x lower "
        "than sum":
            f("scale_qgd_sum") >= TRIM_GAIN_MIN * f("scale_qgd_trimmed"),
        "byzantine scale on the lazy path: norm-gate reaches target":
            reaches("scale_laq_gated"),
        "watchdog: rolls back (>=1), escalates, converges":
            len(wd_log["rollbacks"]) >= 1 and not wd_log["gave_up"]
            and reaches("watchdog_inf"),
    }
    return checks


def main(argv=None) -> int:
    return table_main("fault_frontier", run, argv, tiny=True)


if __name__ == "__main__":
    sys.exit(main())
