"""The A-LAQ width sweep and the error-feedback frontier at full size, the
port on the CPU against the JAX modules (not a test):

    PYTHONPATH=src:.:tests JAX_PLATFORMS=cpu \\
        python tests/frontiers_probe.py [OUT.json]

1. The JAX side: ``benchmarks/adaptive_sweep.py`` and
   ``benchmarks/ef_frontier.py`` ``run`` at their own steps (the latter's
   ``BENCH_ef.json`` written to a temporary directory), each run's
   trajectory kept.  Prints each run's final uploads, bits and loss, the
   rows' ``bits_to_*`` entries and the claims: ``chip_smoke.py``'s
   ``JAX_FRONTIERS`` and ``JAX_FRONTIER_ROWS``.
2. The port's two modules on the CPU, on the reference and the fused wire:
   for each run whether its per-round ``cum_uploads``, ``cum_bits`` and
   ``mean_bits`` equal JAX's, the first round where they part, its final
   counts and the largest relative gap of its loss; the rows' entries and
   whether the claims agree.
3. Where the fixed-4-bit run crosses ``bits_to_fixed4_loss``'s target:
   the round, and the loss before and at it against the target, for both.
4. The EF-top-k runs once more on the reference wire with each worker's
   gradient taken from JAX (``jax.grad`` of the reference's loss under
   ``jit``, at the port's own iterate): whether the counts then equal
   JAX's in every round, and the loss's largest relative gap.

``OUT.json``, when given, receives it all.
"""
import json
import pathlib
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import benchmarks.common as jcommon
import benchmarks_torch.adaptive_sweep as TA
import benchmarks_torch.common as tcommon
import benchmarks_torch.ef_frontier as TE
import repro_torch.core.strategy as strategy
from test_torch_frontiers import _jax_side, _want_rows, arrays

MODULES = {"adaptive_sweep": TA, "ef_frontier": TE}
COUNTS = ("cum_uploads", "cum_bits", "mean_bits")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _first_part(g, w):
    """``(field, round)`` where the port's counts first part from JAX's
    (rounds from 1), or None."""
    for k in range(len(w["cum_uploads"])):
        for f in COUNTS:
            if g[f][k] != w[f][k]:
                return f, k + 1
    return None


def _crossing(loss, target):
    k = int(np.argmax(np.asarray(loss) <= target))
    return dict(round=k + 1, before=float(loss[k - 1]) - target,
                at=float(loss[k]) - target)


def jax_side():
    with tempfile.TemporaryDirectory() as tmp:
        return {m: _jax_side(m, pathlib.Path(tmp), steps={}) for m in MODULES}


def with_jax_gradients():
    """The port's EF frontier on the reference wire with each worker's
    gradient replaced by JAX's at the port's iterate: the EF-top-k runs'
    trajectories by name."""
    workers, full = tcommon.make_dataset(device="cpu")
    jgrad = jax.jit(jax.grad(jcommon.logreg_loss(full[0].shape[0])))
    orig, calls = strategy.worker_update, [0]

    def swapped(grad_m, *a, **kw):
        m = calls[0] % tcommon.M_WORKERS
        calls[0] += 1
        g = jgrad({"w": jnp.asarray(kw["params"]["w"].numpy())},
                  (jnp.asarray(workers[0][m].numpy()),
                   jnp.asarray(workers[1][m].numpy())))["w"]
        return orig({"w": torch.from_numpy(np.array(g))}, *a, **kw)

    strategy.worker_update = swapped
    try:
        traces = {}
        TE.run([], {}, device="cpu", traces=traces)
    finally:
        strategy.worker_update = orig
    return {k: arrays(r) for k, r in traces.items() if "/ef_topk_" in k}


def main(out=None):
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    jax_runs = jax_side()
    report = {"jax_seconds": time.perf_counter() - t0, "jax_finals": {},
              "jax_rows": {}, "jax_claims": {}, "port": {}}
    for module, (res, traces) in jax_runs.items():
        for run, t in traces.items():
            report["jax_finals"][run] = (int(t["cum_uploads"][-1]),
                                         float(t["cum_bits"][-1]),
                                         float(t["loss"][-1]))
        for row, r in _want_rows(module, res).items():
            report["jax_rows"][row] = {k: v for k, v in r.items()
                                       if k.startswith(("bits_to",
                                                        "rounds_to"))}
        report["jax_claims"][module] = res[f"{module}/claims"]
    print(json.dumps({k: report[k] for k in ("jax_finals", "jax_rows",
                                             "jax_claims")}))
    target = jax_runs["adaptive_sweep"][0]["adaptive_sweep"]
    target = target["fixed_b4"]["final_loss"] + 1e-7
    jb4 = jax_runs["adaptive_sweep"][1]["adaptive_sweep/fixed_b4"]
    report["fixed4_crossing"] = {"jax": _crossing(jb4["loss"], target)}
    for wire in ("reference", "fused"):
        rep = {"runs": {}, "rows": {}, "claims_agree": {}}
        t0 = time.perf_counter()
        for module, tm in MODULES.items():
            res, traces = {}, {}
            tm.run([], res, device="cpu", wire=wire, traces=traces)
            want, want_tr = jax_runs[module]
            for run, w in want_tr.items():
                g = arrays(traces[run])
                rep["runs"][run] = dict(
                    first_part=_first_part(g, w),
                    finals=(int(g["cum_uploads"][-1]),
                            float(g["cum_bits"][-1]), float(g["loss"][-1])),
                    loss_rel=_rel(g["loss"], w["loss"]))
            for row in _want_rows(module, want):
                rep["rows"][row] = {k: v for k, v in res[row].items()
                                    if k.startswith(("bits_to", "rounds_to"))}
            rep["claims_agree"][module] = (res[f"{module}/claims"]
                                           == want[f"{module}/claims"])
            if module == "adaptive_sweep" and wire == "reference":
                report["fixed4_crossing"]["port"] = _crossing(
                    traces["adaptive_sweep/fixed_b4"].loss.numpy(),
                    res["adaptive_sweep/fixed_b4"]["final_loss"] + 1e-7)
        rep["seconds"] = time.perf_counter() - t0
        report["port"][wire] = rep
        print(json.dumps({wire: rep}))
    print(json.dumps({"fixed4_crossing": report["fixed4_crossing"]}))
    swap = {}
    for run, g in with_jax_gradients().items():
        w = jax_runs["ef_frontier"][1][run]
        swap[run] = dict(first_part=_first_part(g, w),
                         loss_rel=_rel(g["loss"], w["loss"]))
    report["with_jax_gradients"] = swap
    print(json.dumps({"with_jax_gradients": swap}))
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(*sys.argv[1:2])
