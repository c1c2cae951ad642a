"""Participation and staleness frontier on the port: bits and uploads to a
loss under client sampling (p in {1.0, 0.5, 0.2}), bounded delay (D = 4)
and Markov churn, on the paper's logistic regression with deterministic
full gradients, port of ``benchmarks/participation_frontier.py``.

    PYTHONPATH=src python -m benchmarks_torch.participation_frontier \\
        [--device cuda|cpu] [--wire reference|fused]

Eleven runs of ``STEPS`` rounds each at b = ``BITS``: LAQ and dense QGD at
every p of ``P_GRID`` (Bernoulli sampling below 1.0), a communication-rich
LAQ (``RICH_CRITERION``, ten times stricter than the paper's) at p = 1.0
and 0.5, LAQ with every worker m at the iterate ``m mod (DELAY + 1)``
rounds old, and LAQ under Markov churn at mean availability 0.5 with ON
streaks of 8 (bursty) and 2 rounds (memoryless).  The target loss is
``TARGET_TOL`` times QGD's final loss at p = 1.0; each row has the final
loss, the total uploads and bits, and the cumulative uploads and bits at
the first sustained crossing of the target (``common.first_reach``).  Ten
claim checks follow.

``--wire fused`` sends every run through ``absmax`` and
``quantize_pack_fused`` on the card.  A worker that is sampled out still
computes its gradient and its wire, as the reference's ``vmap`` computes
every lane, so each run launches each kernel once per worker and round.
The card is the default device: without one, and without ``--device
cpu``, this exits non-zero.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import (PAPER_CRITERION, first_reach, logreg_init, logreg_loss,
                     make_dataset)
from .tables import table_main

STEPS = 400
BITS = 4
ALPHA = 2.0
P_GRID = (1.0, 0.5, 0.2)
DELAY = 4
TARGET_TOL = 1.05     # reach within 5% of the dense-QGD floor
RICH_CRITERION = CriterionConfig(D=10, xi=0.08 / 10, t_bar=100)


def _methods(wire):
    """The runs by name, in the reference's order."""
    laq = StrategyConfig(kind="laq", bits=BITS, criterion=PAPER_CRITERION,
                         wire_backend=wire)
    qgd = laq._replace(kind="qgd")
    rich = laq._replace(criterion=RICH_CRITERION)

    def sampled(cfg, p):
        if p >= 1.0:
            return cfg
        return cfg._replace(participation="bernoulli", participation_p=p)

    cfgs = {}
    for p in P_GRID:
        cfgs[f"laq_p{p}"] = sampled(laq, p)
        cfgs[f"qgd_p{p}"] = sampled(qgd, p)
    for p in (1.0, 0.5):
        cfgs[f"laq_rich_p{p}"] = sampled(rich, p)
    cfgs[f"laq_d{DELAY}"] = laq._replace(participation="delay",
                                         max_delay=DELAY)
    # Markov burst-churn against i.i.d. sampling at matched mean
    # availability 0.5: ON streaks of 8 rounds, and of 1 / (1 - p) = 2,
    # whose stationary draw is i.i.d. Bernoulli
    cfgs["laq_mkv_burst"] = laq._replace(participation="markov",
                                         participation_p=0.5,
                                         markov_sojourn=8.0)
    cfgs["laq_mkv_iid"] = laq._replace(participation="markov",
                                       participation_p=0.5,
                                       markov_sojourn=2.0)
    return cfgs


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """Fill ``results`` with one row per run
    (``participation_frontier/<run>``) and the target's
    (``participation_frontier/target``); return the claim checks.
    ``traces``, when given, receives each run's :class:`RunResult`."""
    dev = resolve_device(device)
    traces = {} if traces is None else traces
    workers, full = make_dataset(device=dev)
    loss_fn = logreg_loss(full[0].shape[0])

    runs = {}
    for name, cfg in _methods(wire).items():
        runs[name] = traces[f"participation_frontier/{name}"] = \
            run_gradient_based(loss_fn, logreg_init(device=dev), workers,
                               cfg, steps=STEPS, alpha=ALPHA, device=dev)

    target = TARGET_TOL * float(runs["qgd_p1.0"].loss[-1])

    frontier = {}
    for name, r in runs.items():
        at = first_reach(r, target)
        frontier[name] = results[f"participation_frontier/{name}"] = dict(
            final_loss=float(r.loss[-1]),
            total_uploads=int(r.cum_uploads[-1]),
            total_bits=float(r.cum_bits[-1]),
            uploads_to_target=None if at is None else at[0],
            bits_to_target=None if at is None else at[1])
        out_rows.append((f"participation_{name}", float(r.cum_bits[-1]),
                         f"loss={frontier[name]['final_loss']:.4f};"
                         f"to_target={at}"))
    results["participation_frontier/target"] = dict(target_loss=target)

    def to_target(name, field="bits_to_target"):
        v = frontier[name][field]
        return np.inf if v is None else v

    up_ratio_qgd = (to_target("qgd_p0.5", "uploads_to_target")
                    / to_target("qgd_p1.0", "uploads_to_target"))
    up_ratio_rich = (to_target("laq_rich_p0.5", "uploads_to_target")
                     / to_target("laq_rich_p1.0", "uploads_to_target"))
    results["participation_frontier/claims"] = checks = {
        "LAQ reaches the target at every p and at D=4": all(
            frontier[n]["bits_to_target"] is not None
            for n in ("laq_p1.0", "laq_p0.5", "laq_p0.2", f"laq_d{DELAY}",
                      "laq_rich_p1.0", "laq_rich_p0.5")),
        "bits-to-target: LAQ < QGD at p=1.0":
            to_target("laq_p1.0") < to_target("qgd_p1.0"),
        "bits-to-target: LAQ < QGD at p=0.5 (skip rule composes)":
            to_target("laq_p0.5") < to_target("qgd_p0.5"),
        "bits-to-target: LAQ < QGD at p=0.2":
            to_target("laq_p0.2") < to_target("qgd_p0.2"),
        "dense uploads are p-scaled: QGD p=0.5 uses ~half of p=1.0":
            0.4 <= up_ratio_qgd <= 0.6,
        "comm-rich LAQ p=0.5 reaches target with ~half the uploads":
            0.35 <= up_ratio_rich <= 0.7,
        "sampling never increases LAQ communication":
            frontier["laq_p0.2"]["total_uploads"]
            <= frontier["laq_p0.5"]["total_uploads"]
            <= frontier["laq_p1.0"]["total_uploads"],
        f"bounded staleness D={DELAY} costs <= 1.5x bits-to-target":
            to_target(f"laq_d{DELAY}") <= 1.5 * to_target("laq_p1.0"),
        "markov churn (bursty and memoryless) reaches the target":
            frontier["laq_mkv_burst"]["bits_to_target"] is not None
            and frontier["laq_mkv_iid"]["bits_to_target"] is not None,
        "churn costs <= 1.05x full-participation LAQ bits (skips absorb it)":
            frontier["laq_mkv_burst"]["total_bits"]
            <= 1.05 * frontier["laq_p1.0"]["total_bits"]
            and frontier["laq_mkv_iid"]["total_bits"]
            <= 1.05 * frontier["laq_p1.0"]["total_bits"],
    }
    return checks


def main(argv=None) -> int:
    return table_main("participation_frontier", run, argv)


if __name__ == "__main__":
    sys.exit(main())
