"""The port's participation frontier (``benchmarks_torch``) against the
reference's (``benchmarks``) on the CPU.

Both run at ``STEPS`` rounds, the same step constant set on the JAX and
the port module (``monkeypatch``; the JAX file stays as it is), the port
on the reference and the fused wire.  Every run's per-round
``cum_uploads`` and ``cum_bits`` equal the JAX run's, its loss is within
``LOSS_RTOL`` (torch's and XLA's matmuls and ``log_softmax`` reduce in
other orders), the rows agree (counts exactly) and so do the claims.  On
the fused wire every run calls ``absmax`` and ``quantize_pack_fused`` once
per worker and round, the sampled-out workers too: on the card each call
is one launch of kernels 1 and 2.

At full size (400 rounds, ``tests/stochastic_frontiers_probe.py``) the
communication-rich LAQ at p = 1.0 parts from JAX's for a stretch from
round 299 (ROADMAP queue 3); these steps stay before it.
"""
import json

import pytest

import benchmarks.participation_frontier as JP
import benchmarks_torch.participation_frontier as TP
from benchmarks_torch.common import M_WORKERS
from repro_torch.kernels import ops
from torch_frontier_cases import KERNELS, arrays, assert_frontier, count_calls
from torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
STEPS = 60


def jax_side(steps=STEPS):
    """``(results, trajectories by run)`` of the JAX module's ``run`` at
    ``steps`` rounds, its ``run_gradient_based`` wrapped to keep each
    trajectory."""
    calls = []
    jax_run = JP.run_gradient_based

    def recording(*a, **kw):
        r = jax_run(*a, **kw)
        calls.append(arrays(r))
        return r

    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "STEPS", steps)
        mp.setattr(JP, "run_gradient_based", recording)
        JP.run([], results)
    names = [f"participation_frontier/{n}" for n in TP._methods("reference")]
    assert len(calls) == len(names)
    return results, dict(zip(names, calls))


def want_rows(results):
    """The JAX module's rows keyed as the port keys them."""
    rows = {f"participation_frontier/{n}": row
            for n, row in results["participation_frontier"].items()
            if n != "target_loss"}
    rows["participation_frontier/target"] = dict(
        target_loss=results["participation_frontier"]["target_loss"])
    return rows


def port_side(wire, steps=STEPS, calls=None):
    """``(results, checks, trajectories by run)`` of the port's ``run`` on
    the CPU; ``calls``, when given, counts the calls of the two wrappers
    of kernels 1 and 2."""
    results, traces = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "STEPS", steps)
        if calls is not None:
            count_calls(mp, ops, calls)
        checks = TP.run([], results, device="cpu", wire=wire, traces=traces)
    return results, checks, {k: arrays(r) for k, r in traces.items()}


@pytest.fixture(scope="module")
def jax_runs():
    return jax_side()


@pytest.mark.parametrize("wire", ("reference", "fused"))
def test_participation_frontier_at_reduced_steps(jax_runs, wire):
    want, want_tr = jax_runs
    calls = dict.fromkeys(KERNELS, 0)
    got, checks, got_tr = port_side(wire, calls=calls)
    assert_frontier("participation_frontier", got, checks, got_tr, want,
                    want_tr, want_rows(want), lambda run: LOSS_RTOL,
                    ("final_loss", "target_loss"))
    # one call of each wrapper per worker and round of each of the 11
    # runs, the sampled-out and the Markov OFF workers too; none on the
    # reference wire
    n = len(want_tr) * STEPS * M_WORKERS if wire == "fused" else 0
    assert calls == dict.fromkeys(KERNELS, n)


def test_command_line_on_the_cpu(capsys, monkeypatch, tmp_path):
    """``--device cpu`` runs the frontier, prints one JSON line per row,
    one PASS or FAIL line per claim and the seconds, exits 0 exactly when
    every claim holds, and writes no file."""
    monkeypatch.setattr(TP, "STEPS", 10)
    monkeypatch.chdir(tmp_path)
    rc = TP.main(["--device", "cpu", "--wire", "fused"])
    lines = capsys.readouterr().out.splitlines()
    verdicts = [ln for ln in lines if ln.startswith(("PASS ", "FAIL "))]
    assert len(verdicts) == 10
    assert rc == (1 if any(v.startswith("FAIL") for v in verdicts) else 0)
    assert len([ln for ln in lines if ln.startswith('{"row"')]) == 12
    last = json.loads(lines[-1])
    assert last["device"] == "cpu" and last["wire"] == "fused"
    assert not any(tmp_path.iterdir())
