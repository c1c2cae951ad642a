"""Paper Table 3 on the port: minibatch stochastic methods (SGD / QSGD /
SSGD / SLAQ), port of ``benchmarks/table3_stochastic.py``.

    PYTHONPATH=src python -m benchmarks_torch.table3_stochastic \\
        [--device cuda|cpu] [--wire reference|fused]

Prints the rows and the paper's four claim checks; exits non-zero when one
fails.  ``--wire`` sets SLAQ's wire backend; the dense baselines have no
LAQ wire.  The fused wire covers the packed widths (1, 2, 4, 8), as the
reference's does, so the logistic SLAQ row at the paper's b=3 runs on the
reference wire whatever ``--wire`` says (:func:`row_wire`), and the NN's
SLAQ (b=8) reaches the CUDA kernels.  The card is the default device:
without one, and without ``--device cpu``, this exits non-zero.
"""
from __future__ import annotations

import sys

from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.quantize import PACKABLE_BITS
from repro_torch.core.simulated import run_stochastic
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import (accuracy_logreg, accuracy_nn, logreg_init, logreg_loss,
                     make_dataset, nn_init, nn_loss)
from .tables import table_main

BITS = 3              # paper: b=3 for logistic regression (stochastic tests)
BITS_NN = 8
ALPHA = 0.5
BATCH = 50            # paper: 500 of 60k ~ same local fraction
STEPS = 400
STEPS_NN = 300
CRIT = CriterionConfig(D=10, xi=0.8 / 10, t_bar=100)
KINDS = ("sgd", "qsgd", "ssgd", "slaq")


def row_wire(wire: str, bits: int) -> str:
    """The wire backend SLAQ runs on at ``bits``: ``wire``, except that a
    width off the fused wire's packed grid stays on the reference wire."""
    return wire if wire != "fused" or bits in PACKABLE_BITS else "reference"


def _run_model(model, out_rows, results, *, device, wire, traces):
    dev = resolve_device(device)
    workers, full = make_dataset(device=dev)
    loss_fac, init_fn, acc_fn, steps, bits = {
        "logistic": (logreg_loss, logreg_init, accuracy_logreg, STEPS, BITS),
        "nn": (nn_loss, nn_init, accuracy_nn, STEPS_NN, BITS_NN)}[model]
    loss_fn = loss_fac(full[0].shape[0])
    traces = {} if traces is None else traces
    for kind in KINDS:
        laq_cfg = StrategyConfig(kind="laq", bits=bits, criterion=CRIT,
                                 wire_backend=row_wire(wire, bits))
        r = run_stochastic(loss_fn, init_fn(device=dev), workers, kind,
                           steps=steps, alpha=ALPHA, batch=BATCH, bits=bits,
                           density=0.1, laq_cfg=laq_cfg, device=dev)
        traces[f"table3/{model}/{kind}"] = r
        acc = acc_fn(r.params, *full)
        results[f"table3/{model}/{kind}"] = dict(
            iterations=steps, rounds=int(r.cum_uploads[-1]),
            bits=float(r.cum_bits[-1]), accuracy=acc,
            final_loss=float(r.loss[-1]))
        out_rows.append((f"table3_{model}_{kind}", float(r.cum_bits[-1]),
                         f"rounds={int(r.cum_uploads[-1])};acc={acc:.4f}"))


def run_logistic(out_rows, results, *, device="cuda", wire="reference",
                 traces=None):
    """The logistic-regression rows (b=3: SLAQ on the reference wire)."""
    _run_model("logistic", out_rows, results, device=device, wire=wire,
               traces=traces)


def run_nn(out_rows, results, *, device="cuda", wire="reference",
           traces=None):
    """The neural-network rows (b=8)."""
    _run_model("nn", out_rows, results, device=device, wire=wire,
               traces=traces)


def claims(results) -> dict:
    """The paper's four claim checks (all on the logistic rows)."""
    t3 = results
    return {
        "bits: SLAQ < QSGD (logistic)":
            t3["table3/logistic/slaq"]["bits"] < t3["table3/logistic/qsgd"]["bits"],
        "bits: SLAQ < SSGD (logistic)":
            t3["table3/logistic/slaq"]["bits"] < t3["table3/logistic/ssgd"]["bits"],
        "rounds: SLAQ <= SGD (logistic)":
            t3["table3/logistic/slaq"]["rounds"] <= t3["table3/logistic/sgd"]["rounds"],
        "accuracy parity (logistic)":
            abs(t3["table3/logistic/slaq"]["accuracy"]
                - t3["table3/logistic/sgd"]["accuracy"]) < 0.03,
    }


MODELS = {"logistic": run_logistic, "nn": run_nn}


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """Fill ``results`` with the table's rows and return the claim checks.
    ``traces``, when given, receives each row's :class:`RunResult`."""
    for rows_of in MODELS.values():
        rows_of(out_rows, results, device=device, wire=wire, traces=traces)
    results["table3/claims"] = checks = claims(results)
    return checks


def main(argv=None) -> int:
    return table_main("table3_stochastic", run, argv)


if __name__ == "__main__":
    sys.exit(main())
