"""The port's convergence study and bits sweep (``benchmarks_torch``)
against the reference's (``benchmarks``) on the CPU.

Both run at reduced steps, the same on both sides, on the reference and
the fused wire.  ``benchmarks/convergence.py`` writes its step counts in
its body, so the JAX side runs with its module-level
``run_gradient_based`` wrapped (``monkeypatch``) to take the reduced
counts; the JAX file stays as it is.  The bits sweep's JAX side calls
``repro.core.run_gradient_based`` with ``benchmarks/bits_sweep.py``'s own
settings (LAQ, b in {2, 4, 8}, alpha 2, the paper's criterion): that
module's ``run`` also times interpret-mode Pallas kernels at n = 2^20.

Every run's ``cum_uploads`` and ``cum_bits`` equal JAX's in every round;
its loss, ``grad_norm_sq`` and ``quant_err`` are within ``RTOL`` (torch's
and XLA's matmul and ``log_softmax`` reduce in other orders), and so are
the reported rows (slopes, curves, the decay); the claims agree.  QGD's
radius is the exception (``QGD_RADIUS_RTOL``): QGD uploads every round,
so its radius ``max |g - q_hat|`` is mostly the last round's
quantization error, and a code on a rounding boundary, which the two
frameworks' gradients can put on either side, moves ``q_hat`` by a grid
step ``2 tau R``.
"""
import numpy as np
import pytest

import benchmarks.common as jcommon
import benchmarks.convergence as JC
import benchmarks_torch.bits_sweep as TB
import benchmarks_torch.convergence as TC
from repro.core import StrategyConfig as JStrategyConfig
from repro.core import run_gradient_based as j_run_gradient_based
from torch_threads import one_thread  # noqa: F401

RTOL = 1e-5
# QGD's quant_err and its curve; the largest gaps seen (both wires,
# tests/paper_studies_probe.py and these steps): 1.8e-4 here, 2.7e-2 at
# full size (every other run's radius within 7.4e-4 there, 5.6e-6 here)
QGD_RADIUS_RTOL = 1e-3
# reduced steps: the fit window [20, 400) holds 40 rounds and the decay's
# early window [5, 50) 45; LAQ's early skips (10, 0, 0, 1, 9, ... uploads)
STEPS, STEPS_HET, SWEEP_STEPS = 60, 40, 40
# benchmarks/bits_sweep.py's settings
SWEEP_BITS, SWEEP_ALPHA = (2, 4, 8), 2.0
FIELDS = ("loss", "grad_norm_sq", "cum_uploads", "cum_bits", "quant_err")


def arrays(r):
    return {f: np.asarray(getattr(r, f)) for f in FIELDS}


def jax_convergence(steps=STEPS, steps_het=STEPS_HET):
    """``(results, traces)`` of ``benchmarks/convergence.py`` ``run`` at
    ``steps`` rounds (its 600) and ``steps_het`` (its 400)."""
    calls = []

    def reduced(*a, steps, **kw):
        r = j_run_gradient_based(*a, steps=reduce[steps], **kw)
        calls.append(r)
        return r

    reduce = {600: steps, 400: steps_het}
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "run_gradient_based", reduced)
        JC.run([], results)
    keys = [f"convergence/{k}" for k in TC.KINDS] + [
        "convergence/heterogeneous_laq"]
    return results, dict(zip(keys, map(arrays, calls)))


def jax_sweep(steps=SWEEP_STEPS):
    """``(results, traces)`` of the LAQ sweep at ``bits_sweep.py``'s
    settings, ``steps`` rounds each."""
    workers, full = jcommon.make_dataset()
    loss_fn = jcommon.logreg_loss(full[0].shape[0])
    results, traces = {}, {}
    for b in SWEEP_BITS:
        r = j_run_gradient_based(
            loss_fn, jcommon.logreg_init(), workers,
            JStrategyConfig(kind="laq", bits=b,
                            criterion=jcommon.PAPER_CRITERION),
            steps=steps, alpha=SWEEP_ALPHA)
        traces[f"bits_sweep/b{b}"] = arrays(r)
        results[f"bits_sweep/b{b}"] = dict(
            bits=float(r.cum_bits[-1]), rounds=int(r.cum_uploads[-1]),
            final_loss=float(r.loss[-1]))
    b = {k: results[f"bits_sweep/b{k}"]["bits"] for k in SWEEP_BITS}
    results["bits_sweep/claims"] = {
        "fewer bits per round with smaller b": b[2] < b[4] < b[8]}
    return results, traces


@pytest.fixture(scope="module")
def jax_runs():
    return {"convergence": jax_convergence(), "bits_sweep": jax_sweep()}


def _port(study, wire):
    traces, results = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        if study == "convergence":
            mp.setattr(TC, "STEPS", STEPS)
            mp.setattr(TC, "STEPS_HET", STEPS_HET)
            TC.run([], results, device="cpu", wire=wire, traces=traces)
        else:
            mp.setattr(TB, "SWEEP_STEPS", SWEEP_STEPS)
            TB.run_sweep([], results, device="cpu", wire=wire, traces=traces)
    return results, {k: arrays(r) for k, r in traces.items()}


@pytest.mark.parametrize("wire", ("reference", "fused"))
@pytest.mark.parametrize("study", ("convergence", "bits_sweep"))
def test_study_at_reduced_steps(jax_runs, study, wire):
    want, want_tr = jax_runs[study]
    got, got_tr = _port(study, wire)
    assert sorted(got_tr) == sorted(want_tr)
    for run, w in want_tr.items():
        g = got_tr[run]
        for f in ("cum_uploads", "cum_bits"):
            np.testing.assert_array_equal(g[f], w[f], err_msg=f"{run} {f}")
        for f in ("loss", "grad_norm_sq", "quant_err"):
            rtol = (QGD_RADIUS_RTOL if (run, f) == ("convergence/qgd",
                                                   "quant_err") else RTOL)
            np.testing.assert_allclose(g[f], w[f], rtol=rtol,
                                       err_msg=f"{run} {f}")
    assert sorted(got) == sorted(want)
    claims = f"{study}/claims"
    assert got[claims] == want[claims]
    for row, w in want.items():
        if row == claims:
            continue
        g = got[row]
        assert sorted(g) == sorted(w), row
        for k, v in w.items():
            if k in ("rounds", "bits", "bits_curve", "rounds_curve"):
                assert g[k] == v, (row, k)
            rtol = (QGD_RADIUS_RTOL if (row, k) == ("convergence/qgd",
                                                   "quant_radius_curve")
                    else RTOL)
            np.testing.assert_allclose(g[k], v, rtol=rtol,
                                       err_msg=f"{row}/{k}")


@pytest.mark.parametrize("module", (TC, TB), ids=("convergence", "bits_sweep"))
def test_command_line_on_the_cpu(module, capsys, monkeypatch):
    """``--device cpu`` runs the study, prints one JSON line per row, one
    PASS or FAIL line per claim and the seconds, and exits 0 exactly when
    every claim holds; the kernel rows are the card's only."""
    for name, v in (("STEPS", 25), ("STEPS_HET", 8), ("SWEEP_STEPS", 8)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, v)
    rc = module.main(["--device", "cpu", "--wire", "fused"])
    lines = capsys.readouterr().out.splitlines()
    verdicts = [ln for ln in lines if ln.startswith(("PASS ", "FAIL "))]
    assert verdicts and rc == (1 if any(v.startswith("FAIL") for v in
                                        verdicts) else 0)
    assert '"device": "cpu"' in lines[-1] and '"wire": "fused"' in lines[-1]
    rows = [ln for ln in lines if ln.startswith('{"row"')]
    assert len(rows) == (6 if module is TC else 3)
    assert not any("kernel_" in ln for ln in rows)
