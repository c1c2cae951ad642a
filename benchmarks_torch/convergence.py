"""Paper Figs. 3-5 on the port: convergence curves (loss residual, gradient
norm, quantization-error radius decay) and the heterogeneity study of the
supplement, port of ``benchmarks/convergence.py``.

    PYTHONPATH=src python -m benchmarks_torch.convergence \\
        [--device cuda|cpu] [--wire reference|fused]

GD / QGD / LAG / LAQ at b=4 on the logistic-regression workers of
``common.make_dataset``; ``f_star`` is the least final loss, and each
method's linear rate is the slope of a line fitted (``np.polyfit``, on
the host) to its log residual over rounds ``FIT``.  The curves keep every
``STRIDE``-th round.  The quantization error (``max_m R_m``) of LAQ decays
with the loss: the mean of its last ``DECAY_LATE`` rounds against the mean
over rounds ``DECAY_EARLY``.  LAQ runs again on non-i.i.d. shards
(``HETEROGENEITY``, data seed ``HET_SEED``).  Prints one JSON line per row
and the paper's four claim checks, and exits non-zero when one fails.
``--wire fused`` sends QGD's and LAQ's quantize step through the CUDA wire
kernels (``absmax`` and ``quantize_pack_fused``) on the card.  The card is
the default device: without one, and without ``--device cpu``, this exits
non-zero.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import PAPER_CRITERION, logreg_init, logreg_loss, make_dataset
from .tables import table_main

KINDS = ("gd", "qgd", "lag", "laq")
BITS = 4
ALPHA = 2.0
STEPS = 600
STEPS_HET = 400
FIT = (20, 400)            # rounds of the log-residual fit
STRIDE = 20                # every STRIDE-th round of each curve
DECAY_EARLY = (5, 50)      # rounds of the early quantization error
DECAY_LATE = 50            # the last rounds, against the early ones
HETEROGENEITY = 0.8
HET_SEED = 1


def _run(kind, workers, n_total, steps, *, device, wire):
    cfg = StrategyConfig(kind=kind, bits=BITS, criterion=PAPER_CRITERION,
                         wire_backend=wire)
    return run_gradient_based(logreg_loss(n_total), logreg_init(device=device),
                              workers, cfg, steps=steps, alpha=ALPHA,
                              device=device)


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """Fill ``results`` with the rows and return the claim checks.
    ``traces``, when given, receives each run's :class:`RunResult`."""
    dev = resolve_device(device)
    traces = {} if traces is None else traces
    workers, full = make_dataset(device=dev)
    curves = {}
    for kind in KINDS:
        curves[kind] = _run(kind, workers, full[0].shape[0], STEPS,
                            device=dev, wire=wire)
        traces[f"convergence/{kind}"] = curves[kind]
    f_star = min(float(r.loss[-1]) for r in curves.values())

    for kind, r in curves.items():
        resid = np.maximum(r.loss.numpy() - f_star, 1e-14)
        # linear-rate fit on the log residual (paper Fig. 4a / Theorem 1)
        seg = np.log(resid[FIT[0]:FIT[1]])
        slope = float(np.polyfit(np.arange(seg.size), seg, 1)[0])
        results[f"convergence/{kind}"] = dict(
            rate_log_slope=slope,
            loss_curve=r.loss.numpy()[::STRIDE].tolist(),
            grad_norm_curve=r.grad_norm_sq.numpy()[::STRIDE].tolist(),
            bits_curve=r.cum_bits.numpy()[::STRIDE].tolist(),
            rounds_curve=r.cum_uploads.numpy()[::STRIDE].tolist(),
            quant_radius_curve=r.quant_err.numpy()[::STRIDE].tolist())
        out_rows.append((f"convergence_{kind}", slope, "log-residual slope"))

    # the quantization error decays linearly alongside (Fig. 3 / Thm 1 19b)
    qe = curves["laq"].quant_err.numpy()
    early = float(np.mean(qe[DECAY_EARLY[0]:DECAY_EARLY[1]]))
    late = float(np.mean(qe[-DECAY_LATE:]))
    results["convergence/quant_error_decay"] = dict(
        early=early, late=late, ratio=late / max(early, 1e-12))

    # heterogeneity study (supp): non-i.i.d. shards, LAQ still converges
    workers_het, full_het = make_dataset(heterogeneity=HETEROGENEITY,
                                         seed=HET_SEED, device=dev)
    r = _run("laq", workers_het, full_het[0].shape[0], STEPS_HET,
             device=dev, wire=wire)
    traces["convergence/heterogeneous_laq"] = r
    results["convergence/heterogeneous_laq"] = dict(
        final_loss=float(r.loss[-1]), rounds=int(r.cum_uploads[-1]),
        bits=float(r.cum_bits[-1]))
    out_rows.append(("convergence_het_laq", float(r.loss[-1]),
                     f"rounds={int(r.cum_uploads[-1])}"))

    results["convergence/claims"] = checks = claims(results)
    return checks


def claims(results) -> dict:
    """The paper's four claim checks on the rows."""
    slope = {k: results[f"convergence/{k}"]["rate_log_slope"] for k in KINDS}
    return {
        "LAQ linear rate (slope<0)": slope["laq"] < -0.005,
        "LAQ ~ GD rate (within 2x)": slope["laq"] < 0.5 * slope["gd"],
        "quant error decays 20x+":
            results["convergence/quant_error_decay"]["ratio"] < 0.05,
        "heterogeneous LAQ converges":
            results["convergence/heterogeneous_laq"]["final_loss"] < 1.0,
    }


def main(argv=None) -> int:
    return table_main("convergence", run, argv)


if __name__ == "__main__":
    sys.exit(main())
