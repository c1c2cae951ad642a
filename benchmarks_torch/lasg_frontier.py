"""Stochastic lazy-aggregation frontier on the port: SGD, QSGD and the
LASG rules (SLAQ-7a, SLAQ-WK, SLAQ-WK2, SLAQ-PS, SLAQ-VR) in bits and
rounds to a loss on noisy minibatches, port of
``benchmarks/lasg_frontier.py``.

    PYTHONPATH=src python -m benchmarks_torch.lasg_frontier \\
        [--device cuda|cpu] [--wire reference|fused]

The paper's logistic regression with a small minibatch (``BATCH`` of each
worker's 60 examples) at b = ``BITS``, ``STEPS`` rounds, minibatch seed
``SEED``.  First the deterministic-LAQ floor: LAQ on full local gradients
with the same quantizer and criterion.  Then the seven ``METHODS`` through
``run_stochastic``; ``slaq_vr`` is SLAQ with SVRG-corrected gradients
(anchor refreshed every ``SVRG_PERIOD`` rounds) under the plain 7a rule.
Two targets: 1.2 times SGD's final loss, and ``DET_TOL`` times the
floor.  Each row (``lasg_frontier/<method>``, SLAQ as ``slaq_7a``) has
the final loss, the total uploads (``total_rounds``) and bits, and the
cumulative uploads and bits at the first sustained crossing of each target
(``common.first_reach``).  Eight claim checks follow.  ``run_methods``
runs any of the runs and ``frontier`` makes the rows and the claims of all
of them, so the runs can be split over processes.

b = 3 is off the fused wire's packed widths, so the LAQ-family runs stay
on the reference wire whatever ``--wire`` says
(``table3_stochastic.row_wire``), as the reference's do, and SGD and QSGD
have no LAQ wire: this frontier launches none of the CUDA kernels.  The
card is the default device: without one, and without ``--device cpu``,
this exits non-zero.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.simulated import run_gradient_based, run_stochastic
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import (PAPER_CRITERION, first_reach, logreg_init, logreg_loss,
                     make_dataset)
from .table3_stochastic import row_wire
from .tables import table_main

STEPS = 500
BATCH = 10            # of 60 local examples: high minibatch variance
BITS = 3              # paper's stochastic setting
ALPHA = 0.5
SEED = 1
SVRG_PERIOD = 10
DET_TOL = 1.15        # "reaches the deterministic floor": within 15%
METHODS = ("sgd", "qsgd", "slaq", "slaq_wk", "slaq_wk2", "slaq_ps",
           "slaq_vr")
LABELS = {"slaq": "slaq_7a"}    # 7a = LAQ criterion replayed on noise
RUNS = ("det_laq",) + tuple(LABELS.get(k, k) for k in METHODS)


def run_methods(names, *, device="cuda", wire="reference"):
    """The runs ``names`` by label, each a :class:`RunResult`: ``det_laq``
    (the deterministic-LAQ floor) or a method's label (``RUNS``)."""
    dev = resolve_device(device)
    workers, full = make_dataset(device=dev)
    loss_fn = logreg_loss(full[0].shape[0])
    laq_cfg = StrategyConfig(kind="laq", bits=BITS, criterion=PAPER_CRITERION,
                             wire_backend=row_wire(wire, BITS))
    vr_cfg = laq_cfg._replace(grad_mode="svrg", svrg_period=SVRG_PERIOD)
    kinds = {LABELS.get(k, k): k for k in METHODS}
    runs = {}
    for name in names:
        if name == "det_laq":
            # the deterministic-LAQ floor: full local gradients, same
            # quantizer and criterion -- the level every uncorrected
            # stochastic method plateaus above (the variance floor) and
            # SLAQ-VR is contracted to reach
            runs[name] = run_gradient_based(
                loss_fn, logreg_init(device=dev), workers, laq_cfg,
                steps=STEPS, alpha=ALPHA, device=dev)
            continue
        kind = kinds[name]
        runs[name] = run_stochastic(
            loss_fn, logreg_init(device=dev), workers,
            "slaq" if kind == "slaq_vr" else kind, steps=STEPS, alpha=ALPHA,
            batch=BATCH, bits=BITS, seed=SEED,
            laq_cfg=vr_cfg if kind == "slaq_vr" else laq_cfg, device=dev)
    return runs


def frontier(runs, out_rows, results):
    """Fill ``results`` with one row per method (``lasg_frontier/<label>``)
    and the targets' (``lasg_frontier/target``) from ``runs``, every run of
    ``RUNS`` by label (anything with ``loss``, ``cum_uploads`` and
    ``cum_bits`` per round); return the claim checks."""
    det_floor = float(runs["det_laq"].loss[-1])
    # within 20% of the dense-SGD floor (reachable by every method whose
    # skip decisions track innovation rather than noise)
    target = 1.2 * float(runs["sgd"].loss[-1])
    target_det = DET_TOL * det_floor

    rows = {}
    for name in RUNS[1:]:
        r = runs[name]
        at = first_reach(r, target)
        at_det = first_reach(r, target_det)
        rows[name] = results[f"lasg_frontier/{name}"] = dict(
            final_loss=float(r.loss[-1]),
            total_rounds=int(r.cum_uploads[-1]),
            total_bits=float(r.cum_bits[-1]),
            rounds_to_target=None if at is None else at[0],
            bits_to_target=None if at is None else at[1],
            bits_to_det_floor=None if at_det is None else at_det[1])
        out_rows.append((f"lasg_frontier_{name}", float(r.cum_bits[-1]),
                         f"loss={rows[name]['final_loss']:.4f};"
                         f"to_target={at}"))
    results["lasg_frontier/target"] = dict(
        target_loss=target, det_floor=det_floor, det_target=target_det)

    def to_target(name, field):
        v = rows[name][field]
        return np.inf if v is None else v

    results["lasg_frontier/claims"] = checks = {
        "bits-to-target: SLAQ-WK < QSGD":
            to_target("slaq_wk", "bits_to_target")
            < to_target("qsgd", "bits_to_target"),
        "rounds-to-target: SLAQ-WK < SLAQ-7a (7a skips on noise)":
            to_target("slaq_wk", "rounds_to_target")
            < to_target("slaq_7a", "rounds_to_target"),
        "bits-to-target: SLAQ-PS < SGD":
            to_target("slaq_ps", "bits_to_target")
            < to_target("sgd", "bits_to_target"),
        "SLAQ-PS skips most rounds":
            rows["slaq_ps"]["total_rounds"]
            < 0.5 * rows["sgd"]["total_rounds"],
        "SLAQ-WK final loss beats 7a-on-noise":
            rows["slaq_wk"]["final_loss"] < rows["slaq_7a"]["final_loss"],
        "SLAQ-WK2 skips at least as much as SLAQ-WK (noise-free rule)":
            rows["slaq_wk2"]["total_rounds"]
            <= rows["slaq_wk"]["total_rounds"],
        f"SLAQ-VR reaches the deterministic-LAQ floor (x{DET_TOL})":
            rows["slaq_vr"]["bits_to_det_floor"] is not None,
        "bits-to-det-floor: SLAQ-VR < SLAQ-WK (VR removes the floor)":
            to_target("slaq_vr", "bits_to_det_floor")
            < to_target("slaq_wk", "bits_to_det_floor"),
    }
    return checks


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """Fill ``results`` with one row per method (``lasg_frontier/<label>``)
    and the targets' (``lasg_frontier/target``); return the claim checks.
    ``traces``, when given, receives each run's :class:`RunResult`, the
    floor's as ``lasg_frontier/det_laq``."""
    runs = run_methods(RUNS, device=device, wire=wire)
    if traces is not None:
        traces.update({f"lasg_frontier/{k}": r for k, r in runs.items()})
    return frontier(runs, out_rows, results)


def main(argv=None) -> int:
    return table_main("lasg_frontier", run, argv)


if __name__ == "__main__":
    sys.exit(main())
