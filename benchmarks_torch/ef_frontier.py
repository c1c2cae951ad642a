"""Error-feedback frontier on the port: EF-LAQ (top-k sparsify ->
sign-magnitude quantize -> pack, with damped error memory) against plain
dense LAQ at matched bit-widths, on the paper's logistic regression, port
of ``benchmarks/ef_frontier.py``.

    PYTHONPATH=src python -m benchmarks_torch.ef_frontier \\
        [--device cuda|cpu] [--wire reference|fused] [--tiny]

Plain LAQ at b = 4, 2 and 1, and EF-LAQ at b = 2 and 1 with the top
``EF_K`` fraction of the innovation's coordinates (k = 196 of p = 7840),
``STEPS`` rounds each (``TINY_STEPS`` with ``--tiny``).  The target loss
is ``TARGET_MULT`` times plain b=4's final loss (``TINY_TARGET_MULT``
with ``--tiny``); each row has the final loss, the total uploads and bits,
and the cumulative uploads and bits at the first sustained crossing of the
target (``common.first_reach``; ``rounds_to_target`` is that upload
count, as in the reference).  Five claim checks follow; ``--tiny`` skips
the one that needs the full horizon.  ``--wire fused`` sends the dense
runs' quantize step through ``absmax`` and ``quantize_pack_fused`` and the
EF runs' survivors through ``sparse_quantize_pack`` on the card.  Unlike
the reference, this writes no file: it prints its rows.  The card is the
default device: without one, and without ``--device cpu``, this exits
non-zero.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.compressors import static_k
from repro_torch.core.quantize import sparse_upload_bits
from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import (PAPER_CRITERION, first_reach, logreg_init, logreg_loss,
                     make_dataset)
from .tables import table_main

STEPS = 400
TINY_STEPS = 150          # before the EF runs cross the 1.75x target, so
TINY_TARGET_MULT = 3.0    # tiny gates on a looser multiplier
ALPHA = 2.0
EF_K = 0.025              # top-k keep fraction (2.5% of p=7840 -> k=196)
TARGET_MULT = 1.75        # target = MULT x the dense-b4 floor


def _methods(wire):
    plain = {f"plain_b{b}":
             StrategyConfig(kind="laq", bits=b, criterion=PAPER_CRITERION,
                            wire_backend=wire)
             for b in (4, 2, 1)}
    ef = {f"ef_topk_b{b}":
          StrategyConfig(kind="laq", bits=b, criterion=PAPER_CRITERION,
                         compressor="topk", compressor_k=EF_K,
                         error_feedback=True, wire_backend=wire)
          for b in (2, 1)}
    return {**plain, **ef}


def run(out_rows, results, *, device="cuda", wire="reference", tiny=False,
        traces=None):
    """Fill ``results`` with one row per method (``ef_frontier/<method>``)
    and the target's (``ef_frontier/target``); return the claim checks.
    ``traces``, when given, receives each run's :class:`RunResult`."""
    dev = resolve_device(device)
    traces = {} if traces is None else traces
    workers, full = make_dataset(device=dev)
    loss_fn = logreg_loss(full[0].shape[0])
    p = full[0].shape[1] * 10
    steps = TINY_STEPS if tiny else STEPS

    runs = {}
    for name, cfg in _methods(wire).items():
        runs[name] = traces[f"ef_frontier/{name}"] = run_gradient_based(
            loss_fn, logreg_init(device=dev), workers, cfg, steps=steps,
            alpha=ALPHA, device=dev)

    # target relative to the dense fallback the EF pipeline must match: the
    # floor plain LAQ only reaches by widening the grid to b=4
    floor = float(runs["plain_b4"].loss[-1])
    target = (TINY_TARGET_MULT if tiny else TARGET_MULT) * floor

    frontier = {}
    for name, r in runs.items():
        at = first_reach(r, target)
        frontier[name] = results[f"ef_frontier/{name}"] = dict(
            final_loss=float(r.loss[-1]),
            total_uploads=int(r.cum_uploads[-1]),
            total_bits=float(r.cum_bits[-1]),
            rounds_to_target=None if at is None else at[0],
            bits_to_target=None if at is None else at[1])
        out_rows.append((f"ef_frontier_{name}", float(r.cum_bits[-1]),
                         f"loss={frontier[name]['final_loss']:.4f};"
                         f"to_target={at}"))

    k = static_k(EF_K, p)
    payload = dict(ef_b2=float(sparse_upload_bits(p, k, 2, n_radii=2)),
                   dense_b2=float(32 + 2 * p))
    results["ef_frontier/target"] = dict(
        target_loss=target, dense_floor=floor, steps=steps, ef_k=EF_K,
        per_upload_bits=payload)

    def bits_to(name):
        v = frontier[name]["bits_to_target"]
        return np.inf if v is None else v

    results["ef_frontier/claims"] = checks = {
        "EF-topk b=2 reaches the dense-b4 target; plain b=2 plateaus":
            frontier["ef_topk_b2"]["bits_to_target"] is not None
            and frontier["plain_b2"]["bits_to_target"] is None,
        "EF-topk b=1 reaches it; plain b=1 diverges":
            frontier["ef_topk_b1"]["bits_to_target"] is not None
            and frontier["plain_b1"]["bits_to_target"] is None,
        "bits-to-target at b=2: EF-topk < plain":
            bits_to("ef_topk_b2") < bits_to("plain_b2"),
        # the margin needs the full horizon, so tiny records None (SKIP)
        "bits-to-target: EF-topk b=2 < plain b=4 (dense fallback)":
            None if tiny else bits_to("ef_topk_b2") < bits_to("plain_b4"),
        "per-upload payload: EF-topk b=2 < 1/4 dense b=2":
            payload["ef_b2"] < 0.25 * payload["dense_b2"],
    }
    return checks


def main(argv=None) -> int:
    return table_main("ef_frontier", run, argv, tiny=True)


if __name__ == "__main__":
    sys.exit(main())
