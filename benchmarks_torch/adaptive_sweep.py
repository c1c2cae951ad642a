"""Fixed-vs-adaptive bit-width frontier (A-LAQ) on a synthetic regression,
port of ``benchmarks/adaptive_sweep.py``.

    PYTHONPATH=src python -m benchmarks_torch.adaptive_sweep \\
        [--device cuda|cpu] [--wire reference|fused]

Distributed ridge regression ``f_m(w) = ||X_m w - y_m||^2 / (2N) +
lam/2 ||w||^2 / M`` over M = 10 workers at p = 50: strongly convex, so
LAQ converges linearly and the innovation radius decays, which is the
slack the adaptive schedules harvest.  LAQ runs at the fixed widths 2, 4
and 8, then with the radius schedule and with the budgeted controller over
the grid (2, 4, 8), both with thresholds that are fractions of each
worker's bootstrap radius (``threshold_mode="rel"``).  Each row has the
final loss, the total bits and uploads, the bits at the first round whose
loss reaches the fixed-4-bit final loss (+1e-7), and the mean width of the
last 50 rounds; four claim checks follow.  ``--wire fused`` sends the
quantize step through the CUDA wire kernels on the card: ``absmax`` and
``quantize_pack_fused`` at a fixed width, ``absmax`` and
``quantize_pack_adaptive`` under a schedule.  The card is the default
device: without one, and without ``--device cpu``, this exits non-zero.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.adaptive import BitSchedule
from repro_torch.core.quantize import fma_f32, tree_size, upload_bits
from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import F32, M_WORKERS, PAPER_CRITERION, _inv
from .tables import table_main

STEPS = 400
ALPHA = 0.3
LAMBDA = 0.01
GRID = (2, 4, 8)
FIXED_BITS = (2, 4, 8)
REL = dict(threshold_mode="rel", thresholds=(0.5, 2.0))
LATE = 50                  # rounds of mean_width_late
RUNS = ("fixed_b2", "fixed_b4", "fixed_b8", "adaptive_radius",
        "adaptive_budget")


def regression_setup(p=50, n_per_worker=40, seed=0, noise=0.05, *,
                     device="cuda"):
    """``(loss_fn, params0, (X, y), w_star)``: the reference's first three,
    bit for bit, and the true weights that drew ``y``.

    Eager JAX divides ``X`` by ``np.sqrt(p)`` as a true float32 division
    (a device tensor here: torch on CUDA multiplies by the reciprocal of a
    Python scalar divisor), evaluates ``einsum("mnp,p->mn", X, w_star)`` as
    a chain of fused multiply-adds from j = 0, and rounds ``noise * e`` and
    its sum with the product on their own."""
    dev = resolve_device(device)
    kw, kx, kn = random.split(random.PRNGKey(seed, device=dev), 3)
    w_star = random.normal(kw, (p,))
    X = (random.normal(kx, (M_WORKERS, n_per_worker, p))
         / torch.tensor(np.float32(np.sqrt(p)), device=dev))
    Xw = torch.zeros((M_WORKERS, n_per_worker), dtype=F32, device=dev)
    for j in range(p):
        Xw = fma_f32(X[..., j].contiguous(), w_star[j], Xw)
    y = Xw + torch.tensor(noise, dtype=F32, device=dev) * random.normal(
        kn, (M_WORKERS, n_per_worker))
    # the reference's loss runs under jit, where XLA turns each division
    # by a constant into a product with its float32 reciprocal
    inv_n, inv_m = _inv(M_WORKERS * n_per_worker), _inv(M_WORKERS)

    def loss_fn(params, data):
        Xm, ym = data
        w = params["w"]
        resid = Xm @ w - ym
        return (0.5 * torch.sum(resid * resid)
                + 0.5 * LAMBDA * torch.sum(w * w) * inv_m) * inv_n

    return (loss_fn, {"w": torch.zeros((p,), dtype=F32, device=dev)},
            (X, y), w_star)


def bits_to_reach(result, target: float):
    """Cumulative wire bits at the first round whose loss <= target (None
    if never reached)."""
    reached = np.asarray(result.loss) <= target
    if not reached.any():
        return None
    return float(result.cum_bits[int(np.argmax(reached))])


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """Fill ``results`` with one row per run (``adaptive_sweep/<run>``) and
    return the claim checks.  ``traces``, when given, receives each run's
    :class:`RunResult`."""
    dev = resolve_device(device)
    traces = {} if traces is None else traces
    loss_fn, p0, data, _ = regression_setup(device=dev)
    p = tree_size(p0)

    def laq(schedule=None, bits=4):
        cfg = StrategyConfig(kind="laq", bits=bits, criterion=PAPER_CRITERION,
                             bit_schedule=schedule, wire_backend=wire)
        return run_gradient_based(loss_fn, p0, data, cfg, steps=STEPS,
                                  alpha=ALPHA, device=dev)

    runs = {f"fixed_b{b}": laq(bits=b) for b in FIXED_BITS}
    # fractions of the bootstrap anchor: 4-bit bootstrap (th1 >= 1 keeps
    # 8-bit unreachable), 2-bit refinements once R < R_0 / 2
    runs["adaptive_radius"] = laq(BitSchedule(kind="radius", grid=GRID,
                                              **REL))
    budget_total = 2.0 * p * STEPS       # per worker: ~2 bits/coord/round
    runs["adaptive_budget"] = laq(BitSchedule(
        kind="budget", grid=GRID, **REL, total_bits=budget_total,
        horizon=STEPS))

    target = float(runs["fixed_b4"].loss[-1]) + 1e-7
    for name in RUNS:
        r = traces[f"adaptive_sweep/{name}"] = runs[name]
        btr = bits_to_reach(r, target)
        row = results[f"adaptive_sweep/{name}"] = dict(
            final_loss=float(r.loss[-1]), total_bits=float(r.cum_bits[-1]),
            rounds=int(r.cum_uploads[-1]), bits_to_fixed4_loss=btr,
            mean_width_late=float(np.asarray(r.mean_bits)[-LATE:].mean()))
        out_rows.append((f"adaptive_sweep_{name}", row["total_bits"],
                         f"loss={row['final_loss']:.3e};"
                         f"bits_to_target={btr}"))

    row = {n: results[f"adaptive_sweep/{n}"] for n in RUNS}
    fixed4_bits = row["fixed_b4"]["total_bits"]
    rb = row["adaptive_radius"]["bits_to_fixed4_loss"]
    bb = row["adaptive_budget"]["bits_to_fixed4_loss"]
    per_worker_cap = budget_total + upload_bits(p, 8, bit_sidecar=True)
    results["adaptive_sweep/claims"] = checks = {
        "adaptive(radius) reaches fixed-4 loss with fewer total bits":
            rb is not None and rb < fixed4_bits,
        "adaptive(budget) reaches fixed-4 loss with fewer total bits":
            bb is not None and bb < fixed4_bits,
        "budget controller respects its cumulative allowance":
            row["adaptive_budget"]["total_bits"] / M_WORKERS
            <= per_worker_cap,
        "late-training width collapses to the bottom of the grid":
            row["adaptive_radius"]["mean_width_late"] <= 4.0,
    }
    return checks


def main(argv=None) -> int:
    return table_main("adaptive_sweep", run, argv)


if __name__ == "__main__":
    sys.exit(main())
