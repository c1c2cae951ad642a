"""The convergence study and the bits sweep at full size, the port on the
CPU against the JAX modules (not a test):

    PYTHONPATH=src:.:tests JAX_PLATFORMS=cpu \\
        python tests/paper_studies_probe.py [OUT.json]

1. The JAX side, as ``test_torch_convergence.py`` runs it at full size:
   ``benchmarks/convergence.py`` ``run`` (its ``run_gradient_based``
   wrapped to keep each run's trajectory) and
   the LAQ half of ``benchmarks/bits_sweep.py`` (``run_gradient_based``
   with that module's settings; its ``run`` also times interpret-mode
   Pallas kernels).  Prints each run's final uploads, bits and loss, the
   four slopes and the decay ratio: ``chip_smoke.py``'s ``JAX_STUDIES``
   and ``JAX_FIT``.
2. The port's ``benchmarks_torch/convergence.py`` and ``bits_sweep.py``
   ``run_sweep`` on the CPU, on the reference and the fused wire: for each
   run whether its per-round ``cum_uploads`` and ``cum_bits`` equal JAX's,
   the largest relative gap of its loss, ``grad_norm_sq`` and
   ``quant_err``, and of the slopes and the decay ratio, and whether the
   claims agree.  ``OUT.json``, when given, receives it all.
"""
import json
import sys
import time

import numpy as np
import torch

from benchmarks_torch import bits_sweep as TB
from benchmarks_torch import convergence as TC
from test_torch_convergence import arrays, jax_convergence, jax_sweep


def jax_side():
    results, traces = jax_convergence(TC.STEPS, TC.STEPS_HET)
    sweep, sweep_traces = jax_sweep(TB.SWEEP_STEPS)
    return {**results, **sweep}, {**traces, **sweep_traces}


def _fit(results):
    fit = {k: results[f"convergence/{k}"]["rate_log_slope"] for k in TC.KINDS}
    fit["decay_ratio"] = results["convergence/quant_error_decay"]["ratio"]
    return fit


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def main(out=None):
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    jres, jtr = jax_side()
    report = {"jax_seconds": time.perf_counter() - t0,
              "jax_finals": {k: (int(t["cum_uploads"][-1]),
                                 float(t["cum_bits"][-1]),
                                 float(t["loss"][-1]))
                             for k, t in jtr.items()},
              "jax_fit": _fit(jres), "port": {}}
    print(json.dumps({k: report[k] for k in ("jax_finals", "jax_fit")}))
    for wire in ("reference", "fused"):
        res, traces = {}, {}
        t0 = time.perf_counter()
        TC.run([], res, device="cpu", wire=wire, traces=traces)
        TB.run_sweep([], res, device="cpu", wire=wire, traces=traces)
        rep = {"seconds": time.perf_counter() - t0, "runs": {}}
        for run, w in jtr.items():
            g = arrays(traces[run])
            rep["runs"][run] = dict(
                counts_equal=all(np.array_equal(g[f], w[f])
                                 for f in ("cum_uploads", "cum_bits")),
                **{f"{f}_rel": _rel(g[f], w[f])
                   for f in ("loss", "grad_norm_sq", "quant_err")})
        rep["fit_rel"] = {k: _rel(v, report["jax_fit"][k])
                          for k, v in _fit(res).items()}
        rep["claims_agree"] = all(res[c] == jres[c] for c in (
            "convergence/claims", "bits_sweep/claims"))
        rep["claims"] = {**res["convergence/claims"],
                         **res["bits_sweep/claims"]}
        report["port"][wire] = rep
        print(json.dumps({wire: rep}))
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(*sys.argv[1:2])
