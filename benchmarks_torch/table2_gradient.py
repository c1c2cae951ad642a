"""Paper Table 2 on the port: gradient-based methods (GD / QGD / LAG /
LAQ), port of ``benchmarks/table2_gradient.py``.

    PYTHONPATH=src python -m benchmarks_torch.table2_gradient \\
        [--device cuda|cpu] [--wire reference|fused]

Logistic regression runs to a loss-residual threshold (paper: 1e-6, scaled
here to the synthetic problem); the NN runs a fixed number of iterations.
Reports iterations, communication rounds (uploads), total bits and
accuracy, then the paper's five claim checks; exits non-zero when one
fails.  ``--wire fused`` sends QGD's and LAQ's quantize step through the
CUDA wire kernels (``absmax`` and ``quantize_pack_fused``) on the card.
The card is the default device: without one, and without ``--device
cpu``, this exits non-zero.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import (PAPER_CRITERION, accuracy_logreg, accuracy_nn,
                     logreg_init, logreg_loss, make_dataset, nn_init, nn_loss)
from .tables import table_main

BITS_LOGREG = 4      # paper Sec. G: b=4 for logistic regression (gradient tests)
BITS_NN = 8
ALPHA = 2.0          # tuned to the synthetic mixture (paper used 0.02 on MNIST)
STEPS_LOGREG = 800
STEPS_NN = 500
TOL = 1e-6
KINDS = ("gd", "qgd", "lag", "laq")


def _first_below(loss, f_star, tol):
    resid = np.asarray(loss) - f_star
    hit = np.nonzero(resid <= tol)[0]
    return int(hit[0]) + 1 if hit.size else len(loss)


def run_logistic(out_rows, results, *, device="cuda", wire="reference",
                 traces=None):
    """The logistic-regression rows (strongly convex), each reported at the
    first iteration whose loss is within ``TOL`` of the best final loss."""
    dev = resolve_device(device)
    workers, full = make_dataset(device=dev)
    loss_fn = logreg_loss(full[0].shape[0])
    traces = {} if traces is None else traces
    runs = {}
    for kind in KINDS:
        cfg = StrategyConfig(kind=kind, bits=BITS_LOGREG,
                             criterion=PAPER_CRITERION, wire_backend=wire)
        runs[kind] = run_gradient_based(loss_fn, logreg_init(device=dev),
                                        workers, cfg, steps=STEPS_LOGREG,
                                        alpha=ALPHA, device=dev)
        traces[f"table2/logistic/{kind}"] = runs[kind]
    f_star = min(float(r.loss[-1]) for r in runs.values())
    for kind, r in runs.items():
        it = _first_below(r.loss.numpy(), f_star, TOL)
        rounds = int(r.cum_uploads[min(it, len(r.loss)) - 1])
        bits = float(r.cum_bits[min(it, len(r.loss)) - 1])
        acc = accuracy_logreg(r.params, *full)
        results[f"table2/logistic/{kind}"] = dict(
            iterations=it, rounds=rounds, bits=bits, accuracy=acc,
            final_loss=float(r.loss[-1]))
        out_rows.append((f"table2_logistic_{kind}", bits,
                         f"iters={it};rounds={rounds};acc={acc:.4f}"))


def run_nn(out_rows, results, *, device="cuda", wire="reference",
           traces=None):
    """The neural-network rows (nonconvex), a fixed number of iterations."""
    dev = resolve_device(device)
    workers, full = make_dataset(device=dev)
    loss_fn = nn_loss(full[0].shape[0])
    traces = {} if traces is None else traces
    for kind in KINDS:
        cfg = StrategyConfig(kind=kind, bits=BITS_NN,
                             criterion=PAPER_CRITERION, wire_backend=wire)
        r = run_gradient_based(loss_fn, nn_init(device=dev), workers, cfg,
                               steps=STEPS_NN, alpha=ALPHA, device=dev)
        traces[f"table2/nn/{kind}"] = r
        acc = accuracy_nn(r.params, *full)
        results[f"table2/nn/{kind}"] = dict(
            iterations=STEPS_NN, rounds=int(r.cum_uploads[-1]),
            bits=float(r.cum_bits[-1]), accuracy=acc,
            final_grad_norm_sq=float(r.grad_norm_sq[-1]))
        out_rows.append((f"table2_nn_{kind}", float(r.cum_bits[-1]),
                         f"rounds={int(r.cum_uploads[-1])};acc={acc:.4f}"))


def claims(results) -> dict:
    """The paper's five claim checks on the rows of both models."""
    t2 = results
    return {
        "bits: LAQ < LAG (logistic)":
            t2["table2/logistic/laq"]["bits"] < t2["table2/logistic/lag"]["bits"],
        "bits: LAQ < QGD < GD (logistic)":
            t2["table2/logistic/laq"]["bits"] < t2["table2/logistic/qgd"]["bits"]
            < t2["table2/logistic/gd"]["bits"],
        "rounds: LAQ << QGD (logistic)":
            t2["table2/logistic/laq"]["rounds"] < 0.5 * t2["table2/logistic/qgd"]["rounds"],
        "accuracy parity (logistic)":
            abs(t2["table2/logistic/laq"]["accuracy"]
                - t2["table2/logistic/gd"]["accuracy"]) < 0.02,
        "bits: LAQ lowest (nn)":
            t2["table2/nn/laq"]["bits"] == min(t2[f"table2/nn/{k}"]["bits"]
                                               for k in KINDS),
    }


MODELS = {"logistic": run_logistic, "nn": run_nn}


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """Fill ``results`` with the table's rows and return the claim checks.
    ``traces``, when given, receives each row's :class:`RunResult`."""
    for rows_of in MODELS.values():
        rows_of(out_rows, results, device=device, wire=wire, traces=traces)
    results["table2/claims"] = checks = claims(results)
    return checks


def main(argv=None) -> int:
    return table_main("table2_gradient", run, argv)


if __name__ == "__main__":
    sys.exit(main())
