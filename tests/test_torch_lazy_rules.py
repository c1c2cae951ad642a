"""``repro_torch.core.lazy_rules`` against ``repro.core.lazy_rules`` under
jit, on seeded inputs.

Decisions, counters and every float that the reference rounds once (the
powers ``d ** count``, the EMAs, the debiasing divisions, the rule's
left-hand side) must be bitwise equal.  A float that goes through a sum
over a tree (``||g - m||^2``, the drift, the same-sample difference, and
what is computed from them) is held to rtol 1e-5: XLA and torch add the
elements in other orders, a float32 reduction difference of a few ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lazy_rules as J
from repro.core.criterion import CriterionConfig as JCriterion
from repro_torch.core import lazy_rules as T
from repro_torch.core.criterion import CriterionConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

SHAPES = {"a": (37, 5), "b": (123,), "c": (4, 4, 3)}
COUNTS = (0.0, 1.0, 5.0, 31.0, 37.0, 95.0)
RTOL = 1e-5


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _states(rng, count, *, grad_ema=True, theta_last=False):
    """The same per-worker slice for both packages."""
    ema = _tree(rng, 0.5) if grad_ema else None
    th = _tree(rng) if theta_last else None
    scal = (np.float32(rng.uniform(0, 3)), np.float32(count),
            np.float32(rng.uniform(0, 2)))
    js = J.LazyState(ema, jnp.float32(scal[0]), jnp.float32(scal[1]),
                     jnp.float32(scal[2]), th)
    ts = T.LazyState(None if ema is None else _t(ema),
                     torch.tensor(scal[0]), torch.tensor(scal[1]),
                     torch.tensor(scal[2]), None if th is None else _t(th))
    return js, ts


def test_decay_pow_is_the_f64_power_rounded_once():
    counts = np.arange(0, 300, dtype=np.float32)
    want = np.asarray(jax.jit(lambda c: 0.9 ** c)(counts))
    got = np.array([float(T.decay_pow(0.9, c)) for c in counts], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # torch's float32 pow differs from XLA's at counts inside the goldens'
    # 50 rounds, which is why the port does not use it
    f32pow = torch.pow(torch.tensor(0.9), torch.from_numpy(counts)).numpy()
    assert {31, 37} <= set(np.nonzero(f32pow != want)[0].tolist())


def test_ema_is_one_fma():
    rng = np.random.default_rng(0)
    m = rng.uniform(-5, 5, 100_000).astype(np.float32)
    g = rng.uniform(-5, 5, 100_000).astype(np.float32)
    want = jax.jit(lambda m, g: 0.9 * m + (1.0 - 0.9) * g)(m, g)
    got = T._ema(0.9, torch.from_numpy(m), torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("count", COUNTS)
def test_variance_update(count):
    rng = np.random.default_rng(int(count) + 1)
    js, ts = _states(rng, count)
    g = _tree(rng)
    cfg_j, cfg_t = J.LasgConfig(), T.LasgConfig()
    sig_j, new_j = jax.jit(lambda s, g: J.variance_update(s, g, cfg_j))(js, g)
    sig_t, new_t = T.variance_update(ts, _t(g), cfg_t)
    for k in SHAPES:    # elementwise: the division by denom and one FMA
        np.testing.assert_array_equal(_bits(new_t.grad_ema[k]),
                                      _bits(new_j.grad_ema[k]), err_msg=k)
    assert float(new_t.stat_count) == float(new_j.stat_count) == count + 1
    np.testing.assert_allclose(float(new_t.stat_ema), float(new_j.stat_ema),
                               rtol=RTOL)
    np.testing.assert_allclose(float(sig_t), float(sig_j), rtol=RTOL)


@pytest.mark.parametrize("count", COUNTS)
def test_smoothness_sq(count):
    rng = np.random.default_rng(7)
    js, ts = _states(rng, count, grad_ema=False)
    cfg_j, cfg_t = J.LasgConfig(var_decay=0.8), T.LasgConfig(var_decay=0.8)
    want = jax.jit(lambda s: J.smoothness_sq(s, cfg_j))(js)
    got = T.smoothness_sq(ts, cfg_t)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isinf(float(got)) == (count == 0)


@pytest.mark.parametrize("c", (1.0, 0.7, 1.3))
@pytest.mark.parametrize("rule", J.LAZY_RULES)
def test_rule_lhs(rule, c):
    rng = np.random.default_rng(3)
    vals = (rng.uniform(0, 10, (200, 6))
            * 10.0 ** rng.uniform(-3, 3, (200, 6))).astype(np.float32)
    vals[:20, 3] = np.inf                       # PS before the first ratio
    vals[:10, 4] = 0.0
    names = ("innovation_sq", "sigma_sq", "sigma_hat_sq", "L_sq", "drift_sq",
             "same_diff_sq")
    cfg_j = J.LasgConfig(c_var=c, c_wk2=c, c_ps=c)
    cfg_t = T.LasgConfig(c_var=c, c_wk2=c, c_ps=c)
    want = np.asarray(jax.jit(jax.vmap(
        lambda v: J.rule_lhs(rule, cfg_j, **dict(zip(names, v)))))(vals))
    got = np.array([float(T.rule_lhs(rule, cfg_t, **{
        n: torch.tensor(x) for n, x in zip(names, row)})) for row in vals],
        np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("rule", J.LAZY_RULES)
def test_should_skip_rule_decisions(rule):
    """Decisions within 0.1% on either side of the threshold, and at the
    staleness bound.  Not at the threshold itself: inside a fused jit XLA
    may contract ``hist + 3 (eps^2 + eps_hat^2)`` into one FMA, so the
    reference's own threshold moves by an ulp with the fusion around it."""
    rng = np.random.default_rng(11)
    crit_j, crit_t = JCriterion(D=4, xi=0.1, t_bar=5), CriterionConfig(
        D=4, xi=0.1, t_bar=5)
    hist = rng.uniform(0, 1, 4).astype(np.float32)
    cfg_j, cfg_t = J.LasgConfig(), T.LasgConfig()
    rhs_j = jax.jit(lambda h, e, eh: J.rhs_threshold(h, 0.3, 4, e, eh, crit_j))
    skip_j = jax.jit(lambda h, e, eh, c, kw: J.should_skip_rule(
        rule, cfg_j, crit_j, theta_hist=h, alpha=0.3, M=4, eps_sq=e,
        eps_hat_sq=eh, clock=c, **kw))
    n_skips = 0
    for i in range(120):
        eps, eps_hat = (np.float32(x) for x in rng.uniform(0, 0.05, 2))
        clock = np.int32(rng.integers(0, 7))
        rhs = float(rhs_j(hist, eps, eps_hat))
        lhs = np.float32(rhs * [0.5, 0.999, 1.001, 2.0][i % 4])
        kw = dict(innovation_sq=lhs, sigma_sq=np.float32(0.0),
                  sigma_hat_sq=np.float32(0.0), drift_sq=lhs,
                  L_sq=np.float32(1.0), same_diff_sq=lhs)
        want = bool(skip_j(hist, eps, eps_hat, clock, kw))
        got = T.should_skip_rule(
            rule, cfg_t, crit_t, theta_hist=torch.from_numpy(hist), alpha=0.3,
            M=4, eps_sq=torch.tensor(eps), eps_hat_sq=torch.tensor(eps_hat),
            clock=clock, **{k: torch.tensor(v) for k, v in kw.items()})
        assert got == want, (i, rule)
        n_skips += got
    assert 0 < n_skips < 60


def _step_inputs(rng, rule, count):
    js, ts = _states(rng, count, grad_ema=rule == "lasg_wk",
                     theta_last=rule in ("lasg_wk2", "lasg_ps"))
    g, gs, params = _tree(rng), _tree(rng), _tree(rng)
    scal = dict(innovation_sq=np.float32(rng.uniform(0, 50)),
                err_sq=np.float32(rng.uniform(0, 1)),
                eps_hat_sq_m=np.float32(rng.uniform(0, 1)),
                clock_m=np.int32(rng.integers(0, 5)))
    hist = rng.uniform(0, 30, 10).astype(np.float32)
    return js, ts, g, gs, params, scal, hist


@pytest.mark.parametrize("count", (0.0, 3.0, 31.0))
@pytest.mark.parametrize("rule", ("lasg_wk", "lasg_wk2", "lasg_ps"))
def test_lazy_rule_step_and_commit(rule, count):
    crit_j = JCriterion(D=10, xi=0.08, t_bar=20)
    crit_t = CriterionConfig(D=10, xi=0.08, t_bar=20)
    cfg_j, cfg_t = J.LasgConfig(), T.LasgConfig()

    @jax.jit
    def ref(js, g, gs, params, scal, hist):
        skip, pre, stats = J.lazy_rule_step(
            rule, cfg_j, crit_j, grad_m=g, params=params, lazy_m=js,
            theta_hist=hist, alpha=0.3, n_workers=6, grad_stale_m=gs, **scal)
        up = jnp.logical_not(skip)
        new = J.commit_upload(rule, cfg_j, pre, up, stats, params=params,
                              innovation_sq=scal["innovation_sq"])
        return skip, new, stats

    for trial in range(6):
        rng = np.random.default_rng(100 * trial + int(count))
        js, ts, g, gs, params, scal, hist = _step_inputs(rng, rule, count)
        skip_j, new_j, stats_j = ref(js, g, gs, params, scal, hist)
        same = (T.wk2_same_diff_sq(ts, _t(g), _t(gs))
                if rule == "lasg_wk2" else None)
        skip_t, pre_t, stats_t = T.lazy_rule_step(
            rule, cfg_t, crit_t, grad_m=_t(g), params=_t(params), lazy_m=ts,
            theta_hist=torch.from_numpy(hist), alpha=0.3, n_workers=6,
            same_diff_sq=same, **{k: torch.tensor(v)
                                  for k, v in scal.items()})
        new_t = T.commit_upload(rule, cfg_t, pre_t, not skip_t, stats_t,
                                params=_t(params),
                                innovation_sq=torch.tensor(
                                    scal["innovation_sq"]))
        assert skip_t == bool(skip_j), (trial, rule, count)
        assert float(new_t.stat_count) == float(new_j.stat_count)
        for f in ("stat_ema", "sigma_hat_sq"):
            np.testing.assert_allclose(float(getattr(new_t, f)),
                                       float(getattr(new_j, f)), rtol=RTOL,
                                       err_msg=f)
        for f in ("sigma_sq", "drift_sq"):
            np.testing.assert_allclose(float(stats_t[f]), float(stats_j[f]),
                                       rtol=RTOL, err_msg=f)
        for f in ("grad_ema", "theta_last"):
            want = getattr(new_j, f)
            got = getattr(new_t, f)
            assert (got is None) == (want is None), f
            if want is not None:
                for k in SHAPES:
                    np.testing.assert_array_equal(
                        _bits(got[k]), _bits(want[k]), err_msg=f"{f}/{k}")


def test_commit_shares_the_iterate_and_freezes_on_a_skip():
    rng = np.random.default_rng(5)
    _, ts = _states(rng, 2.0, grad_ema=False, theta_last=True)
    params = _t(_tree(rng))
    for rule in ("lasg_wk2", "lasg_ps"):
        stats = {"sigma_sq": torch.tensor(1.0), "drift_sq": torch.tensor(2.0)}
        up = T.commit_upload(rule, T.LasgConfig(), ts, True, stats,
                             params=params, innovation_sq=torch.tensor(3.0))
        assert all(a is b for a, b in zip(tree_leaves(up.theta_last),
                                          tree_leaves(params)))
        kept = T.commit_upload(rule, T.LasgConfig(), ts, False, stats,
                               params=params, innovation_sq=torch.tensor(3.0))
        assert kept.theta_last is ts.theta_last
        assert float(kept.stat_count) == 2.0 and float(kept.stat_ema) == float(
            ts.stat_ema)


def test_init_lazy_state_gates_fields_and_shares_the_snapshot():
    template = {"w": torch.ones(3, 2), "b": torch.zeros(4)}
    for rule in J.LAZY_RULES:
        st = T.init_lazy_state(rule, template, 3)
        assert (st.grad_ema is None) == (rule != "lasg_wk")
        assert (st.theta_last is None) == (rule not in ("lasg_wk2",
                                                        "lasg_ps"))
        assert st.stat_count.shape == (3,) and float(st.stat_count.sum()) == 0
        if st.theta_last is not None:
            assert st.theta_last[0]["w"] is template["w"]
            assert st.theta_last[0] is st.theta_last[2]
        if st.grad_ema is not None:
            assert st.grad_ema[0]["w"] is not st.grad_ema[1]["w"]
    with pytest.raises(ValueError, match="unknown lazy rule"):
        T.init_lazy_state("lasg_x", template, 2)


def test_missing_state_and_inputs_raise():
    rng = np.random.default_rng(2)
    _, ts = _states(rng, 1.0, grad_ema=False)
    kw = dict(grad_m=_t(_tree(rng)), params=_t(_tree(rng)), lazy_m=ts,
              innovation_sq=torch.tensor(1.0), err_sq=torch.tensor(0.0),
              eps_hat_sq_m=torch.tensor(0.0), clock_m=0,
              theta_hist=torch.zeros(10), alpha=0.3, n_workers=2)
    cfg, crit = T.LasgConfig(), CriterionConfig()
    with pytest.raises(ValueError, match="grad_ema"):
        T.lazy_rule_step("lasg_wk", cfg, crit, **kw)
    with pytest.raises(ValueError, match="grad_stale_m"):
        T.lazy_rule_step("lasg_wk2", cfg, crit, **kw)
    with pytest.raises(ValueError, match="theta_last"):
        T.lazy_rule_step("lasg_ps", cfg, crit, **kw)
    with pytest.raises(ValueError, match="unknown lazy rule"):
        T.rule_lhs("nope", cfg)
