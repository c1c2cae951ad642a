"""The port's fault frontier (``benchmarks_torch``) against the reference's
(``benchmarks``) on the CPU.

Both run with ``--tiny``, at ``STEPS`` rounds (the two modules'
``TINY_STEPS`` set with ``monkeypatch``; the JAX file stays as it is, and
its ``BENCH_faults.json`` goes to ``tmp_path``: the tracked one at the
repo root keeps its bytes), the port on the reference and the fused wire.
Every cell's per-round ``cum_uploads`` and ``cum_bits`` equal the JAX
run's, the watchdog row's too; its loss is within ``LOSS_RTOL``, NaN where
NaN; the rows agree (``finite``, the counts and ``bits_to_target``
exactly), and so do the watchdog's log and the claims, SKIP included.  On
the fused wire every cell calls ``absmax`` and ``quantize_pack_fused``
once per worker and round, and the watchdog once per worker and round of
its healthy and its wasted chunks: on the card each call is one launch of
kernels 1 and 2.

The problem's gradients and losses are the reference's jitted ones bit for
bit (``SoftmaxSource``, which writes XLA's CPU order and XLA's ``exp`` and
``log``), and the robust aggregators' rescale is contracted into the
server's addition as in the reference, so ten of the twelve losses equal
JAX's bit for bit.  The two crash cells part by a few ulps (4e-7 at 120
rounds): under crash faults the reference rounds a stored ``qhat`` apart
from the delta it aggregates (ROADMAP, reference-side discrepancies).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.fault_frontier as JF
import benchmarks_torch.fault_frontier as TF
from repro_torch.kernels import ops
from repro_torch.random import xla_exp, xla_log
from torch_frontier_cases import KERNELS, arrays, assert_frontier, count_calls
from torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
STEPS = 60
MODULE = "fault_frontier"
ROOT_JSON = os.path.join(os.path.dirname(__file__), os.pardir,
                         "BENCH_faults.json")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def jax_side(tmp_dir, steps=STEPS):
    """``(results, trajectories by run)`` of the JAX module's ``run`` with
    ``tiny`` at ``steps`` rounds, its ``run_gradient_based`` and
    ``run_with_watchdog`` wrapped to keep each trajectory, its
    ``BENCH_faults.json`` written into ``tmp_dir``."""
    calls = []

    def recording(*a, **kw):
        r = jax_run(*a, **kw)
        calls.append(arrays(r))
        return r

    def watched(*a, **kw):
        r = jax_watchdog(*a, **kw)
        calls.append(arrays(r[0]))
        return r

    jax_run, jax_watchdog = JF.run_gradient_based, JF.run_with_watchdog
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "TINY_STEPS", steps)
        mp.setattr(JF, "ROOT_JSON", str(tmp_dir / "BENCH_faults.json"))
        mp.setattr(JF, "run_gradient_based", recording)
        mp.setattr(JF, "run_with_watchdog", watched)
        JF.run([], results, tiny=True)
    names = [f"{MODULE}/{n}" for n in TF.CELL_ORDER]
    assert len(calls) == len(names)
    return results, dict(zip(names, calls))


def want_rows(results):
    """The JAX module's rows keyed as the port keys them."""
    res = results[MODULE]
    rows = {f"{MODULE}/{n}": res[n] for n in TF.CELL_ORDER}
    rows[f"{MODULE}/target"] = {k: res[k] for k in ("target_loss",
                                                    "clean_final", "steps")}
    rows[f"{MODULE}/watchdog_log"] = res["watchdog_log"]
    return rows


def port_side(wire, steps=STEPS, calls=None):
    """``(results, checks, trajectories by run)`` of the port's ``run`` with
    ``tiny`` on the CPU; ``calls``, when given, counts the calls of the two
    wrappers of kernels 1 and 2."""
    results, traces = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "TINY_STEPS", steps)
        if calls is not None:
            count_calls(mp, ops, calls)
        checks = TF.run([], results, device="cpu", wire=wire, tiny=True,
                        traces=traces)
    return results, checks, {k: arrays(r) for k, r in traces.items()}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    before = _bytes(ROOT_JSON)
    out = jax_side(tmp_path_factory.mktemp("jax_fault_frontier"))
    assert _bytes(ROOT_JSON) == before
    return out


@pytest.mark.parametrize("wire", ("reference", "fused"))
def test_fault_frontier_at_reduced_steps(jax_runs, wire):
    want, want_tr = jax_runs
    calls = dict.fromkeys(KERNELS, 0)
    got, checks, got_tr = port_side(wire, calls=calls)
    assert_frontier(MODULE, got, checks, got_tr, want, want_tr,
                    want_rows(want), lambda run: LOSS_RTOL,
                    ("final_loss", "target_loss", "clean_final"))
    assert list(checks.values()).count(None) == 2       # the margins SKIP
    # one call of each wrapper per worker and round of every cell, the
    # corrupted, crashed and rejected workers' too, and of the watchdog's
    # rolled-back chunks; none on the reference wire
    wasted = want[MODULE]["watchdog_log"]["wasted_rounds"]
    n = ((len(want_tr) * STEPS + wasted) * TF.W if wire == "fused" else 0)
    assert calls == dict.fromkeys(KERNELS, n)


def _params():
    rng = np.random.default_rng(7)
    ps = [np.zeros((8, 4), np.float32)]
    for scale in (0.1, 2.0, 30.0, 300.0):
        ps += [(rng.standard_normal((8, 4)) * scale).astype(np.float32)
               for _ in range(8)]
    return ps


def test_source_is_the_jitted_reference_bit_for_bit():
    """Every worker's gradient (``jax.vmap(jax.grad(loss))`` under ``jit``,
    as the reference's engine takes it), every worker's loss and the global
    loss (the sum of the vmapped losses) equal the port's, bit for bit,
    from the zero start to iterates large enough that the softmax
    saturates."""
    jloss, _, jdata = JF._problem()
    src, _ = TF.problem("cpu")
    for a, b in zip(jdata, src.worker_data):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    vgrad = jax.jit(jax.vmap(jax.grad(jloss), in_axes=(None, 0)))
    vloss = jax.jit(jax.vmap(jloss, in_axes=(None, 0)))
    gloss = jax.jit(lambda p, d: jnp.sum(jax.vmap(lambda s: jloss(p, s))(d)))
    for p in _params():
        t = torch.from_numpy(p)
        for got, want in ((src.grads(t), vgrad(p, jdata)),
                          (src.worker_losses(t), vloss(p, jdata)),
                          (src.global_loss(t), gloss(p, jdata))):
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


def test_xla_exp_and_log_are_jitted_jax_bit_for_bit():
    """``xla_exp`` and ``xla_log`` give ``jnp.exp`` and ``jnp.log`` under
    ``jit`` on the CPU bit for bit: dense ranges, both clamps of ``exp``,
    subnormals (flushed), +-0, +-inf and NaN (NaN as NaN)."""
    rng = np.random.default_rng(3)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                         88.7, -87.9, -88.5, 89.0, 1e30, -1e30, 1.0, -1.0],
                        np.float32)
    x = np.concatenate([rng.uniform(-100, 100, 20000),
                        -np.abs(rng.standard_normal(20000)) * 20,
                        specials]).astype(np.float32)
    s = np.concatenate([np.abs(rng.standard_normal(20000)) * 10,
                        rng.uniform(1, 4, 20000),
                        10.0 ** rng.uniform(-37, 38, 2000),
                        specials]).astype(np.float32)
    for fn, jfn, v in ((xla_exp, jnp.exp, x), (xla_log, jnp.log, s)):
        want = np.asarray(jax.jit(jfn)(v))
        got = fn(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        live = ~np.isnan(want)
        np.testing.assert_array_equal(got[live].view(np.uint32),
                                      want[live].view(np.uint32))


def test_command_line_on_the_cpu(capsys, monkeypatch, tmp_path):
    """``--tiny --device cpu`` runs the frontier, prints one JSON line per
    row (12 cells, the target, the watchdog's log), one PASS, FAIL or SKIP
    line per claim and the seconds, exits 1 (two claims fail in the
    reference too) and writes no file."""
    monkeypatch.setattr(TF, "TINY_STEPS", 10)
    monkeypatch.chdir(tmp_path)
    before = _bytes(ROOT_JSON)
    rc = TF.main(["--device", "cpu", "--wire", "fused", "--tiny"])
    lines = capsys.readouterr().out.splitlines()
    verdicts = [ln for ln in lines if ln.startswith(("PASS ", "FAIL ",
                                                     "SKIP "))]
    assert len(verdicts) == 11
    assert sum(v.startswith("SKIP") for v in verdicts) == 2
    assert rc == (1 if any(v.startswith("FAIL") for v in verdicts) else 0)
    rows = [json.loads(ln) for ln in lines if ln.startswith('{"row"')]
    assert [r["row"] for r in rows] == (
        [f"{MODULE}/{n}" for n in TF.CELL_ORDER]
        + [f"{MODULE}/target", f"{MODULE}/watchdog_log"])
    last = json.loads(lines[-1])
    assert last["device"] == "cpu" and last["tiny"] is True
    assert not any(tmp_path.iterdir())
    assert _bytes(ROOT_JSON) == before


def test_refuses_a_missing_card(capsys):
    """The frontier runs on the card unless told ``--device cpu``: without
    one it exits non-zero, and ``run`` raises, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for argv in ([], ["--wire", "fused"], ["--tiny"]):
        assert TF.main(argv) == 1
        assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="cuda"):
        TF.run([], {})
