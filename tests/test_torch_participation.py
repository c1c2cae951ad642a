"""The port's participation models (``core/engine.py``) against the JAX
package, run live on the CPU.

Masks: ``bernoulli`` and ``fixed_k`` cohorts bit for bit over seeds, rounds
and worker counts; 50 states of the Markov chain, at a ``p`` where
``f32(p_up) != p_up`` (the thresholds are doubles that JAX's weak types
compare in float32); the delay ring's iterates; the factory's
normalization of the degenerate knobs.  Runs: ``run_gradient_based`` and
``run_stochastic`` under each mode against the live JAX engine, a
sampled ``qsgd`` baseline included.  Uploads, bits and widths exact; loss,
gradient norm, radii and parameters to rtol 1e-5 / atol 1e-5 (XLA and
torch reduce in other orders), the stochastic runs to 1e-4, as
``test_torch_stochastic.py`` holds them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_engine_cases as C
from repro.core import engine as jengine
from repro.core.simulated import run_gradient_based as jrun_gb
from repro.core.simulated import run_stochastic as jrun_st
from repro_torch.core import engine as tengine
from repro_torch.core.simulated import run_gradient_based, run_stochastic
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("W", (1, 3, 10))
@pytest.mark.parametrize("mode,p", [("bernoulli", 0.5), ("bernoulli", 0.9),
                                    ("fixed_k", 0.3), ("fixed_k", 0.75)])
def test_masks_match_reference(mode, p, W):
    for seed in (0, 3, 2**31 + 1):
        kw = dict(participation=mode, participation_p=p,
                  participation_seed=seed)
        jc, tc = C.strategy(False, **kw), C.strategy(True, **kw)
        for step in (0, 1, 7, 50, 999):
            want = np.asarray(jax.jit(jengine.participation_mask,
                                      static_argnums=(0, 2))(jc, step, W))
            got = tengine.participation_mask(tc, step, W)
            assert got.dtype == torch.bool and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"seed {seed} step {step}")
            if mode == "fixed_k":
                assert int(got.sum()) == max(1, int(round(p * W)))


def test_stateless_mask_refuses_markov_and_skips_full_and_delay():
    assert tengine.participation_mask(C.strategy(True), 0, 4) is None
    assert tengine.participation_mask(
        C.strategy(True, participation="delay", max_delay=2), 0, 4) is None
    with pytest.raises(ValueError, match="markov"):
        tengine.participation_mask(
            C.strategy(True, participation="markov", participation_p=0.5),
            0, 4)


@pytest.mark.parametrize("p,sojourn,seed", [(0.7, 3.0, 1), (0.3, 8.0, 4),
                                            (0.55, 1.5, 9)])
def test_markov_states_match_reference(p, sojourn, seed):
    kw = dict(participation="markov", participation_p=p,
              markov_sojourn=sojourn, participation_seed=seed)
    jm = jengine.MarkovParticipation(C.strategy(False, **kw), 16)
    tm = tengine.MarkovParticipation(C.strategy(True, **kw), 16)
    assert tm.p_up == jm.p_up and tm.p_down == jm.p_down
    if seed == 1:       # the thresholds' float32 rounding is exercised
        assert float(np.float32(tm.p_up)) != tm.p_up
    js, ts = jm.init(None), tm.init(None)
    step = jax.jit(jm.begin_round)
    for k in range(50):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js),
                                      err_msg=f"state {k}")
        javail, _, js = step(js, k, None)
        tavail, thetas, ts = tm.begin_round(ts, k, None)
        assert thetas is None
        np.testing.assert_array_equal(tavail.numpy(), np.asarray(javail))


def test_delay_ring_serves_the_right_iterates():
    """Worker m computes at theta^{k - m mod (D + 1)}; the ring holds the
    iterates themselves (references), pushed at round start."""
    jd, td = jengine.DelayedParticipation(2, 5), tengine.DelayedParticipation(
        2, 5)
    jh = jd.init({"x": jnp.zeros(3)})
    p0 = {"x": torch.zeros(3)}
    th = td.init(p0)
    iterates = [p0]
    for k in range(6):
        params = {"x": torch.full((3,), float(k + 1))}
        _, jt, jh = jd.begin_round(jh, k, {"x": jnp.full((3,), float(k + 1))})
        avail, tt, th = td.begin_round(th, k, params)
        assert avail is None
        iterates.append(params)
        for m in range(5):
            d = m % 3
            want = np.asarray(jt["x"][m])
            np.testing.assert_array_equal(tt[m]["x"].numpy(), want)
            assert tt[m] is iterates[max(0, len(iterates) - 1 - d)]


KNOBS = [
    dict(),
    dict(participation="delay", max_delay=0),
    dict(participation="delay", max_delay=3),
    dict(participation="bernoulli", participation_p=1.0),
    dict(participation="bernoulli", participation_p=0.5),
    dict(participation="fixed_k", participation_p=1.0),
    dict(participation="fixed_k", participation_p=0.96),
    dict(participation="fixed_k", participation_p=0.5),
    dict(participation="markov", participation_p=1.0),
    dict(participation="markov", participation_p=0.5),
]


@pytest.mark.parametrize("kw", KNOBS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()) or "full")
def test_factory_normalizes_like_reference(kw):
    want = jengine.make_participation(C.strategy(False, **kw), 10)
    got = tengine.make_participation(C.strategy(True, **kw), 10)
    assert type(got).__name__ == type(want).__name__


def test_factory_refuses_bad_knobs():
    for kw in (dict(participation="sometimes"),
               dict(participation="delay", max_delay=-1),
               dict(participation="bernoulli", participation_p=0.0),
               dict(participation="markov", participation_p=0.5,
                    markov_sojourn=0.5)):
        with pytest.raises(ValueError):
            tengine.make_participation(C.strategy(True, **kw), 10)


MODES = {
    "bernoulli": dict(participation="bernoulli", participation_p=0.5,
                      participation_seed=3),
    "fixed_k": dict(participation="fixed_k", participation_p=0.3),
    "markov": dict(participation="markov", participation_p=0.7,
                   markov_sojourn=3.0, participation_seed=1),
    "delay": dict(participation="delay", max_delay=2),
}


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("mode", MODES)
def test_gradient_based_modes_match_reference(mode, backend):
    kw = dict(kind="laq", bits=4, wire_backend=backend, **MODES[mode])
    c, a = C.quadratic_data()
    want = jrun_gb(C.j_quadratic, {"x": np.zeros(C.P, np.float32)}, (c, a),
                   C.strategy(False, **kw), steps=40, alpha=0.3)
    got = run_gradient_based(C.t_quadratic, {"x": torch.zeros(C.P)},
                             (torch.from_numpy(c), torch.from_numpy(a)),
                             C.strategy(True, **kw), steps=40, alpha=0.3,
                             device="cpu")
    C.assert_runs_match(want, got)
    assert int(got.cum_uploads[-1]) < 40 * C.M


@pytest.mark.parametrize("kind", ("gd", "lag", "qgd"))
def test_dense_and_unlazy_kinds_upload_the_cohort(kind):
    kw = dict(kind=kind, bits=4, **MODES["fixed_k"])
    c, a = C.quadratic_data()
    want = jrun_gb(C.j_quadratic, {"x": np.zeros(C.P, np.float32)}, (c, a),
                   C.strategy(False, **kw), steps=20, alpha=0.3)
    got = run_gradient_based(C.t_quadratic, {"x": torch.zeros(C.P)},
                             (torch.from_numpy(c), torch.from_numpy(a)),
                             C.strategy(True, **kw), steps=20, alpha=0.3,
                             device="cpu")
    C.assert_runs_match(want, got)
    if kind != "lag":
        assert int(got.cum_uploads[-1]) == 20 * 3


STOCH = [
    ("slaq", "bernoulli"), ("slaq_wk", "markov"), ("slaq_ps", "fixed_k"),
    ("slaq_wk2", "delay"), ("qsgd", "bernoulli"), ("ssgd", "fixed_k"),
    ("sgd", "delay"), ("qsgd", "markov"),
]


@pytest.mark.parametrize("kind,mode", STOCH)
def test_stochastic_modes_match_reference(kind, mode):
    X, Y = C.regression_data()
    kw = dict(kind="laq", bits=4, wire_backend="fused", **MODES[mode])
    want = jrun_st(C.j_regression, {"w": jnp.zeros(C.RP)}, (X, Y), kind,
                   steps=30, alpha=0.3, batch=4, bits=4, seed=2,
                   laq_cfg=C.strategy(False, **kw))
    got = run_stochastic(C.t_regression, {"w": torch.zeros(C.RP)},
                         (torch.from_numpy(X), torch.from_numpy(Y)), kind,
                         steps=30, alpha=0.3, batch=4, bits=4, seed=2,
                         laq_cfg=C.strategy(True, **kw), device="cpu")
    C.assert_runs_match(want, got, rtol=1e-4, atol=1e-4)


def test_svrg_composes_with_delay_and_sampling():
    for mode in ("delay", "bernoulli"):
        kw = dict(kind="laq", bits=4, lazy_rule="lasg_wk2", grad_mode="svrg",
                  svrg_period=5, wire_backend="fused", **MODES[mode])
        (_, want), (_, got) = C.run_both(C.regression_engines(kw), 25)
        C.assert_runs_match(want, got, rtol=1e-4, atol=1e-4)


def test_unavailable_worker_is_held_like_a_skip():
    """Round by round under bernoulli sampling: an absent worker pays no
    bits, keeps its qhat and estimator state, and its clock grows."""
    kw = dict(kind="laq", bits=4, lazy_rule="lasg_wk", **MODES["bernoulli"])
    _, te, _, tp = C.regression_engines(kw)
    carry = te.init_carry(tp, device="cpu")
    absent = 0
    for k in range(10):
        cst = carry[1]
        avail = tengine.participation_mask(te.cfg, k, C.RM)
        before = ([q["w"].clone() for q in cst.qhat],
                  [g["w"].clone() for g in cst.lazy.grad_ema],
                  cst.lazy.stat_count.clone(), cst.clocks.clone(),
                  cst.bits_spent.clone())
        carry, _ = te.run_from(carry, 1)
        cst = carry[1]
        for m in np.nonzero(~avail.numpy())[0]:
            absent += 1
            assert torch.equal(cst.qhat[m]["w"], before[0][m])
            assert torch.equal(cst.lazy.grad_ema[m]["w"], before[1][m])
            assert cst.lazy.stat_count[m] == before[2][m]
            assert int(cst.clocks[m]) == int(before[3][m]) + 1
            assert cst.bits_spent[m] == before[4][m]
    assert absent
