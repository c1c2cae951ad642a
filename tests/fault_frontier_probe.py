"""The fault frontier at full size, the port on the CPU against the JAX
module (not a test):

    PYTHONPATH=src:.:tests JAX_PLATFORMS=cpu \\
        python tests/fault_frontier_probe.py [OUT.json]

1. The JAX side: ``benchmarks/fault_frontier.py`` ``run`` at its own
   ``STEPS`` (120), its ``BENCH_faults.json`` written to a temporary
   directory (the tracked one keeps its bytes), each cell's trajectory
   kept.  Prints each row's final uploads, bits and loss, ``finite``,
   ``bits_to_target``, the target, the watchdog's log and the claims:
   ``chip_smoke.py``'s ``JAX_FAULT_FRONTIER``.
2. The claim values behind the verdicts, with their ratios: the defended
   bits-to-target over the clean one, the naive crash's drift, the
   trimmed mean's gain over the sum (4.1x in the reference, against the
   claim's 10x), the gated lazy run's best loss against the target.
3. The port's module on the CPU, on the reference and the fused wire: for
   each cell the first round where its ``cum_uploads``, ``cum_bits`` or
   loss part from JAX's (rounds from 1), its final counts and the largest
   relative gap of its loss; whether the rows, the watchdog's log and the
   claims agree.

``OUT.json``, when given, receives it all.  About 2 min on one core.
"""
import json
import pathlib
import sys
import tempfile

import numpy as np

import benchmarks.fault_frontier as JF
import benchmarks_torch.fault_frontier as TF
from test_torch_fault_frontier import MODULE, ROOT_JSON, _bytes, want_rows
from torch_frontier_cases import arrays

COUNTS = ("cum_uploads", "cum_bits")


def jax_side():
    """``(results, trajectories by run)`` of the JAX module at full size."""
    calls = []
    jax_run, jax_watchdog = JF.run_gradient_based, JF.run_with_watchdog

    def recording(*a, **kw):
        r = jax_run(*a, **kw)
        calls.append(arrays(r))
        return r

    def watched(*a, **kw):
        r = jax_watchdog(*a, **kw)
        calls.append(arrays(r[0]))
        return r

    before = _bytes(ROOT_JSON)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        JF.ROOT_JSON = str(pathlib.Path(tmp) / "BENCH_faults.json")
        JF.run_gradient_based, JF.run_with_watchdog = recording, watched
        try:
            JF.run([], results)
        finally:
            JF.run_gradient_based, JF.run_with_watchdog = jax_run, jax_watchdog
    assert _bytes(ROOT_JSON) == before
    return results, {f"{MODULE}/{n}": t
                     for n, t in zip(TF.CELL_ORDER, calls)}


def _first_part(g, w):
    """``(field, round)`` where the port first parts from JAX (rounds from
    1; NaN equals NaN), or None."""
    for k in range(len(w["cum_uploads"])):
        for f in COUNTS + ("loss",):
            a, b = g[f][k], w[f][k]
            if not (a == b or (np.isnan(a) and np.isnan(b))):
                return f, k + 1
    return None


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    live = ~(np.isnan(a) & np.isnan(b))
    if not live.any():
        return 0.0
    return float(np.max(np.abs(a[live] - b[live])
                        / np.maximum(np.abs(b[live]), 1e-300)))


def constant(results):
    """``chip_smoke.py``'s ``JAX_FAULT_FRONTIER``."""
    res = results[MODULE]
    return {
        "rows": {n: [res[n]["total_uploads"], res[n]["total_bits"],
                     res[n]["final_loss"], res[n]["finite"],
                     res[n]["bits_to_target"]] for n in TF.CELL_ORDER},
        "target_loss": res["target_loss"],
        "watchdog_log": res["watchdog_log"],
        "claims": [None if v is None else bool(v)
                   for v in results[f"{MODULE}/claims"].values()],
    }


def ratios(res):
    """The claim values with their ratios."""
    def bt(n):
        v = res[n]["bits_to_target"]
        return np.inf if v is None else v
    return {
        "defended bits-to-target / clean (<= 1.5)":
            bt("inf_defended") / bt("clean"),
        "nan undefended uploads / clean (>= 1.10)":
            res["nan_undefended"]["total_uploads"]
            / res["clean"]["total_uploads"],
        "naive crash final / clean final (>= 1.3)":
            res["crash_naive"]["final_loss"] / res["clean_final"],
        "reconciled crash final / clean final (<= 1.05)":
            res["crash_reconciled"]["final_loss"] / res["clean_final"],
        "sum final / trimmed-mean final (>= 10)":
            res["scale_qgd_sum"]["final_loss"]
            / res["scale_qgd_trimmed"]["final_loss"],
        "gated lazy final / target (reaches it when <= 1)":
            res["scale_laq_gated"]["final_loss"] / res["target_loss"],
    }


def main(out=None):
    results, want_tr = jax_side()
    report = {"jax": constant(results), "ratios": ratios(results[MODULE])}
    print("JAX_FAULT_FRONTIER =", json.dumps(report["jax"], indent=1))
    for k, v in report["ratios"].items():
        print(f"  {k}: {v!r}")
    rows = want_rows(results)
    for wire in ("reference", "fused"):
        got, traces = {}, {}
        checks = TF.run([], got, device="cpu", wire=wire, traces=traces)
        got_tr = {k: arrays(r) for k, r in traces.items()}
        port = {}
        for run, w in want_tr.items():
            g = got_tr[run]
            port[run] = dict(first_part=_first_part(g, w),
                             uploads=int(g["cum_uploads"][-1]),
                             bits=float(g["cum_bits"][-1]),
                             loss_rel=_rel(g["loss"], w["loss"]))
            print(f"  {wire:9s} {run:32s} {port[run]}")
        same_rows = {
            r: all(got[r][k] == v or (isinstance(v, float) and np.isnan(v)
                                      and np.isnan(got[r][k]))
                   for k, v in w.items()
                   if k not in ("final_loss", "target_loss", "clean_final"))
            for r, w in rows.items()}
        same_claims = list(checks.values()) == list(
            results[f"{MODULE}/claims"].values())
        print(f"  {wire}: rows equal but the losses {same_rows}; claims "
              f"equal {same_claims}")
        report[wire] = dict(runs=port, rows_equal=same_rows,
                            claims_equal=same_claims)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main(*sys.argv[1:2])
