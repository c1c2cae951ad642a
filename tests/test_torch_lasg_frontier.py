"""The port's stochastic lazy-aggregation frontier (``benchmarks_torch``)
against the reference's (``benchmarks``) on the CPU.

Both run at ``STEPS`` rounds, the same step constant set on the JAX and
the port module (``monkeypatch``; the JAX file stays as it is).  The
minibatch indices are ``jax.random``'s bit for bit.  Every run's per-round
``cum_uploads`` and ``cum_bits`` (the deterministic-LAQ floor's too) equal
the JAX run's, its loss is within ``LOSS_RTOL`` (``ORDER_LOSS_RTOL`` for
SLAQ-WK and SLAQ-PS), the rows agree (counts exactly) and so do the
claims.  b = 3 is off the fused wire's packed widths, so ``--wire fused``
gives the same arrays and calls neither wrapper of kernels 1 and 2.

At full size (500 rounds, ``tests/stochastic_frontiers_probe.py``)
SLAQ-WK parts from JAX's in round 112 and SLAQ-PS in round 199 (ROADMAP
queue 3); these steps stay before both.
"""
import json

import pytest

import benchmarks.lasg_frontier as JL
import benchmarks_torch.lasg_frontier as TL
from repro_torch.kernels import ops
from torch_frontier_cases import KERNELS, arrays, assert_frontier, count_calls
from torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
# SLAQ-WK's and SLAQ-PS's loss: their skip decisions sit near the
# threshold every round, and their b = 3 codes follow the minibatch
# gradient's float32 order, which torch and XLA reduce apart (ROADMAP
# queue 3); the largest gaps at these steps are 5.3e-6 (WK) and 1.2e-5
# (PS), 6.1e-7 and 3.1e-7 with JAX's jitted gradient in the port's place
ORDER_LOSS_RTOL = 5e-5
STEPS = 60


def jax_side(steps=STEPS):
    """``(results, trajectories by run)`` of the JAX module's ``run`` at
    ``steps`` rounds, its ``run_gradient_based`` (the floor) and
    ``run_stochastic`` wrapped to keep each trajectory."""
    calls = []

    def recording(fn):
        def wrapped(*a, **kw):
            r = fn(*a, **kw)
            calls.append(arrays(r))
            return r
        return wrapped

    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "STEPS", steps)
        for name in ("run_gradient_based", "run_stochastic"):
            mp.setattr(JL, name, recording(getattr(JL, name)))
        JL.run([], results)
    assert len(calls) == len(TL.RUNS)
    return results, {f"lasg_frontier/{n}": t for n, t in zip(TL.RUNS, calls)}


def want_rows(results):
    """The JAX module's rows keyed as the port keys them."""
    front = results["lasg_frontier"]
    target = ("target_loss", "det_floor", "det_target")
    rows = {f"lasg_frontier/{n}": row for n, row in front.items()
            if n not in target}
    rows["lasg_frontier/target"] = {k: front[k] for k in target}
    return rows


def port_side(wire, steps=STEPS, calls=None):
    """``(results, checks, trajectories by run)`` of the port's ``run`` on
    the CPU; ``calls``, when given, counts the calls of the two wrappers
    of kernels 1 and 2."""
    results, traces = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "STEPS", steps)
        if calls is not None:
            count_calls(mp, ops, calls)
        checks = TL.run([], results, device="cpu", wire=wire, traces=traces)
    return results, checks, {k: arrays(r) for k, r in traces.items()}


def loss_rtol(run):
    return (ORDER_LOSS_RTOL if run.endswith(("/slaq_wk", "/slaq_ps"))
            else LOSS_RTOL)


@pytest.fixture(scope="module")
def jax_runs():
    return jax_side()


@pytest.mark.parametrize("wire", ("reference", "fused"))
def test_lasg_frontier_at_reduced_steps(jax_runs, wire):
    want, want_tr = jax_runs
    calls = dict.fromkeys(KERNELS, 0)
    got, checks, got_tr = port_side(wire, calls=calls)
    assert calls == dict.fromkeys(KERNELS, 0)
    assert_frontier("lasg_frontier", got, checks, got_tr, want, want_tr,
                    want_rows(want), loss_rtol,
                    ("final_loss", "target_loss", "det_floor", "det_target"))


def test_command_line_on_the_cpu(capsys, monkeypatch, tmp_path):
    """``--device cpu`` runs the frontier, prints one JSON line per row,
    one PASS or FAIL line per claim and the seconds, exits 0 exactly when
    every claim holds, and writes no file."""
    monkeypatch.setattr(TL, "STEPS", 10)
    monkeypatch.chdir(tmp_path)
    rc = TL.main(["--device", "cpu", "--wire", "fused"])
    lines = capsys.readouterr().out.splitlines()
    verdicts = [ln for ln in lines if ln.startswith(("PASS ", "FAIL "))]
    assert len(verdicts) == 8
    assert rc == (1 if any(v.startswith("FAIL") for v in verdicts) else 0)
    assert len([ln for ln in lines if ln.startswith('{"row"')]) == 8
    last = json.loads(lines[-1])
    assert last["device"] == "cpu" and last["wire"] == "fused"
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("run", ("slaq_wk", "slaq_ps"))
def test_chip_smoke_prefix_is_the_references(jax_runs, run):
    """``chip_smoke.py``'s ``JAX_STOCH_PREFIX`` holds the reference's own
    uploads per round, and its check (``_prefix_part``) passes the
    reference's run and finds the first round of a run planted to part."""
    import importlib.util
    import pathlib

    import numpy as np
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_prefix", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    key = f"lasg_frontier/{run}"
    digits = cs.JAX_STOCH_PREFIX[key][:STEPS]
    uploads, bits = cs.JAX_STOCH_FRONTIERS[key][:2]
    tr = {f: jax_runs[1][key][f].tolist()
          for f in ("cum_uploads", "cum_bits")}
    assert cs._prefix_part(tr, digits, bits / uploads) is None
    tr["cum_uploads"][STEPS // 2:] = (
        np.asarray(tr["cum_uploads"][STEPS // 2:]) + 1).tolist()
    assert cs._prefix_part(tr, digits, bits / uploads) == STEPS // 2 + 1
