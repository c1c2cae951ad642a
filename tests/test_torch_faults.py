"""The port's robustness layer (``core/faults.py``, ``core/defense.py`` and
their branches in ``worker_update``, ``aggregate`` and ``RoundEngine``)
against the JAX package, run live on the CPU.

The helpers are held bit for bit against the jitted reference: the fault
streams, ``corrupt_grads``, ``codes_of_delta`` and ``flip_wire_codes``,
``defense_step`` (vmapped there, as the engine runs it) and
``robust_aggregate`` with NaN, +-inf and +-0 planted, ``n <= 2t`` and
``n = 0``; ``apply_crashes`` with a NaN in a ``qhat``.  Engine runs of
every fault kind, defended and not, hold uploads, bits, widths and each
worker's rejections exactly, and the loss, gradient norm and radii to
rtol 1e-5 / atol 1e-5 (XLA contracts and reduces in other orders than
torch; the decisions come out the same).  The parameters are held to
atol 1e-3: a gradient that differs at the ulp can move a code that sits
on a rounding boundary by one grid step ``2 tau R``, and the parameters
then move by ``alpha`` times that step each round until that worker
uploads again.  In ``inf_validate`` a code of an honest worker (R = 1.4e-3)
moves in round 36, and by round 40 one coordinate of 20 is 2.9e-4 off
(every count still exact).  A NaN innovation under top-k and rand-k
(with error feedback, defended and not, full-batch and minibatch) gives
the reference's counts, rejects and NaN losses.  The three watchdog
scenarios of ``test_faults.py`` give equal logs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_engine_cases as C
from repro.core import defense as jdef
from repro.core import faults as jfaults
from repro.core.wire import codes_of_delta as j_codes_of_delta
from repro.core.wire import get_backend as j_backend
from repro_torch import random as R
from repro_torch.core import defense as tdef
from repro_torch.core import faults as tfaults
from repro_torch.core.wire import codes_of_delta, delta_of_codes
from torch_threads import one_thread  # noqa: F401

SEEDS, STEPS = (0, 5, 2**31 + 7), (0, 1, 17, 300)


# ---------------------------------------------------------------------------
# The fault streams and the corruption primitives, bitwise.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", (1, 4, 10))
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_streams_match_reference(seed, W):
    kw = dict(corrupt_p=0.3, crash_p=0.45, fault_seed=seed)
    jf, tf = jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)
    for step in STEPS:
        for name in ("corruption_mask", "crash_mask", "bitflip_keys"):
            want = np.asarray(jax.jit(getattr(jfaults, name),
                                      static_argnums=(0, 2))(jf, step, W))
            got = getattr(tfaults, name)(tf, step, W).numpy()
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=f"{name} step {step}")


def test_fault_predicates_match_reference():
    for kw in (dict(), dict(corrupt_p=0.1), dict(crash_p=0.1),
               dict(corrupt_p=0.1, corrupt_kind="bitflip")):
        jf, tf = jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)
        for p in ("active", "grad_faulty", "wire_faulty", "crashy"):
            assert getattr(tf, p) == getattr(jf, p), (kw, p)
    assert tfaults.FaultConfig._fields == jfaults.FaultConfig._fields
    assert tfaults.FaultConfig() == tuple(jfaults.FaultConfig())


@pytest.mark.parametrize("kind", ("nan", "inf", "sign_flip", "scale"))
def test_corrupt_grads_match_reference(kind):
    rng = np.random.default_rng(1)
    g = {"w": rng.standard_normal((4, 5, 3)).astype(np.float32),
         "b": rng.standard_normal((4, 7)).astype(np.float32)}
    mask = np.array([True, False, True, False])
    kw = dict(corrupt_p=1.0, corrupt_kind=kind, corrupt_scale=-40.0)
    want = jax.jit(lambda g, m: jfaults.corrupt_grads(
        g, m, jfaults.FaultConfig(**kw)))(g, mask)
    got = tfaults.corrupt_grads(
        [{k: torch.from_numpy(v[m].copy()) for k, v in g.items()}
         for m in range(4)], torch.from_numpy(mask), tfaults.FaultConfig(**kw))
    for k in g:
        np.testing.assert_array_equal(
            np.stack([x[k].numpy() for x in got]), np.asarray(want[k]))
    with pytest.raises(ValueError):
        tfaults.corrupt_grad(got[0], tfaults.FaultConfig(corrupt_kind="bitflip"))


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_codes_of_delta_matches_reference(bits):
    """Round half to even and a true division: exact on the forward map's
    own output, and equal to the jitted reference on noise, NaN and +-inf
    (which become code 0), and at R == 0 (the midpoint code)."""
    rng = np.random.default_rng(bits)
    jit = jax.jit(j_codes_of_delta, static_argnums=2)
    for trial in range(20):
        R = np.float32(abs(rng.standard_normal()) * 10 ** rng.uniform(-6, 3))
        codes = rng.integers(0, 2**bits, 999).astype(np.uint8)
        d = delta_of_codes(torch.from_numpy(codes), torch.tensor(R), bits)
        np.testing.assert_array_equal(codes_of_delta(d, R, bits).numpy(),
                                      codes)
        noise = (rng.uniform(-1.3, 1.3, 999) * R).astype(np.float32)
        noise[:5] = [np.nan, np.inf, -np.inf, 0.0, -0.0]
        for x, r in ((d.numpy(), R), (noise, R), (noise, np.float32(0.0))):
            np.testing.assert_array_equal(
                codes_of_delta(torch.from_numpy(x.copy()), torch.tensor(r),
                               bits).numpy(),
                np.asarray(jit(x, r, bits)))


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_flip_wire_codes_matches_reference(bits):
    """Positions from ``uniform(fold_in(key, i), leaf.shape)`` with i the
    leaf index in JAX's order, flips of the top bit, re-emitted deltas:
    bitwise, per-leaf radii with one leaf at R == 0 and an empty leaf."""
    rng = np.random.default_rng(10 + bits)
    g = {"a": rng.standard_normal((33, 7)).astype(np.float32),
         "b": rng.standard_normal(501).astype(np.float32),
         "c": np.zeros(64, np.float32), "e": np.zeros((0, 3), np.float32)}
    q = {k: np.zeros_like(v) for k, v in g.items()}
    rt = j_backend("reference").roundtrip(g, q, bits, per_leaf=True)
    key = jfaults.bitflip_keys(jfaults.FaultConfig(fault_seed=3), 2, 4)[1]
    want = jax.jit(lambda d, r, k: jfaults.flip_wire_codes(
        d, r, bits, k, 0.25))(rt.delta, rt.R_tree, key)
    got = tfaults.flip_wire_codes(
        {k: torch.from_numpy(np.array(v)) for k, v in rt.delta.items()},
        {k: torch.tensor(np.asarray(v)) for k, v in rt.R_tree.items()}, bits,
        torch.from_numpy(np.asarray(key).astype(np.int64)), 0.25)
    moved = 0
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        moved += int((got[k].numpy() != np.asarray(rt.delta[k])).sum())
    assert moved > 100


# ---------------------------------------------------------------------------
# The defense helpers, bitwise.
# ---------------------------------------------------------------------------

DEFENSES = {
    "validate": dict(validate=True),
    "gate": dict(validate=True, gate_mult=4.0),
    "gate_only": dict(gate_mult=2.5, gate_decay=0.7),
    "clip": dict(clip_mult=4.0),
    "all": dict(validate=True, gate_mult=4.0, clip_mult=3.0, gate_decay=0.95),
}


def _defense_inputs(rng, n=400):
    inn = (rng.lognormal(0.0, 2.0, n)).astype(np.float32)
    err = (rng.lognormal(-3.0, 1.0, n)).astype(np.float32)
    ema = (rng.lognormal(0.0, 2.0, n)).astype(np.float32)
    count = rng.integers(0, 60, n).astype(np.float32)
    count[:40] = 0.0
    for x in (inn, err):
        idx = rng.choice(n, 20, replace=False)
        x[idx[:7]] = np.nan
        x[idx[7:14]] = np.inf
        x[idx[14:]] = 0.0
    up = rng.uniform(size=n) < 0.8
    rej = rng.integers(0, 5, n).astype(np.int32)
    return inn, err, ema, count, up, rej


@pytest.mark.parametrize("name", DEFENSES)
def test_defense_step_matches_reference(name):
    kw = DEFENSES[name]
    rng = np.random.default_rng(len(name))
    inn, err, ema, count, up, rej = _defense_inputs(rng)
    jd = jdef.DefenseConfig(**kw)

    def one(i, e, em, c, u, r):
        return jdef.defense_step(jd, jdef.DefenseState(em, c, r), i, e, u)

    acc, sc, ds = jax.jit(jax.vmap(one))(inn, err, ema, count, up, rej)
    td = tdef.DefenseConfig(**kw)
    for k in range(inn.size):
        a, s, d = tdef.defense_step(
            td, tdef.DefenseState(torch.tensor(ema[k]), torch.tensor(count[k]),
                                  torch.tensor(rej[k])),
            torch.tensor(inn[k]), torch.tensor(err[k]), bool(up[k]))
        got = (a, float(s), float(d.norm_ema), float(d.norm_count),
               int(d.rejects))
        want = (bool(acc[k]), float(sc[k]), float(ds.norm_ema[k]),
                float(ds.norm_count[k]), int(ds.rejects[k]))
        assert np.array_equal(np.array(got[1:4], np.float32),
                              np.array(want[1:4], np.float32),
                              equal_nan=True) and got[0] == want[0] \
            and got[4] == want[4], (k, got, want)


def test_defense_config_matches_reference():
    assert tdef.DefenseConfig._fields == jdef.DefenseConfig._fields
    assert tdef.DefenseConfig() == tuple(jdef.DefenseConfig())
    for kw in DEFENSES.values():
        assert tdef.DefenseConfig(**kw).active
    assert not tdef.DefenseConfig(reconcile_crashes=False).active
    with pytest.raises(ValueError):
        tdef.defense_step(tdef.DefenseConfig(), tdef.empty_defense_state(),
                          0.0, 0.0, True)


ROBUST = [
    # (W, committed, trim_frac)
    (5, (1, 1, 1, 1, 1), 0.2),
    (5, (1, 1, 1, 1, 0), 0.2),
    (4, (1, 0, 1, 1), 0.34),
    (3, (1, 1, 0), 0.34),        # n <= 2t: the plain sum
    (8, (1, 1, 0, 1, 1, 1, 0, 1), 0.25),
    (4, (0, 0, 0, 0), 0.34),     # n = 0
    (6, (1, 1, 1, 1, 1, 1), 0.5),
]


@pytest.mark.parametrize("aggregator", ("trimmed_mean", "median"))
@pytest.mark.parametrize("case", range(len(ROBUST)))
def test_robust_aggregate_matches_reference(aggregator, case):
    """Values from a small set, so that ties, +-0, +-inf and NaN meet in
    the sort; the non-committed lanes are zero in the reference's input
    (its ``delta_masked``) and absent in the port's."""
    W, comm, frac = ROBUST[case]
    rng = np.random.default_rng(case)
    pool = np.array([0.0, -0.0, 1.5, -2.25, 3.0, np.inf, -np.inf, np.nan,
                     1e-30, -7.0], np.float32)
    d = {"a": pool[rng.integers(0, pool.size, (W, 301))],
         "b": rng.standard_normal((W, 6, 5)).astype(np.float32),
         "z": np.zeros((W, 0), np.float32)}
    committed = np.array(comm, bool)
    masked = {k: np.where(committed.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                          np.float32(0.0)) for k, v in d.items()}
    want = jax.jit(lambda x, c: jdef.robust_aggregate(
        aggregator, x, c, frac))(masked, committed)
    deltas = [{k: torch.from_numpy(v[m].copy()) for k, v in d.items()}
              if committed[m] else None for m in range(W)]
    got = tdef.robust_aggregate(aggregator, deltas, committed.tolist(), frac,
                                template={k: torch.zeros(v.shape[1:])
                                          for k, v in d.items()})
    for k in d:
        # bitwise, signed zeros included; a NaN is a NaN (the sign of the
        # NaN that inf - inf makes is the platform's)
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.shape == g.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        live = ~np.isnan(w)
        np.testing.assert_array_equal(g[live].view(np.int32),
                                      w[live].view(np.int32), err_msg=k)


@pytest.mark.parametrize("aggregator", ("trimmed_mean", "median"))
@pytest.mark.parametrize("case", range(len(ROBUST)))
def test_robust_aggregate_into_the_server_aggregate(aggregator, case):
    """The engine's form: ``server_agg + robust`` under jit, in which XLA
    contracts the rescale ``mean * n`` into the addition, equals the port's
    ``robust_aggregate(..., into=server_agg)`` bit for bit (NaN as NaN);
    the product rounded before the addition parts from it."""
    W, comm, frac = ROBUST[case]
    rng = np.random.default_rng(100 + case)
    d = {"a": rng.standard_normal((W, 301)).astype(np.float32) * 3,
         "b": rng.standard_normal((W, 6, 5)).astype(np.float32)}
    d["a"][:, :4] = np.array([np.inf, np.nan, 0.0, -0.0], np.float32)
    agg = {k: rng.standard_normal(v.shape[1:]).astype(np.float32)
           for k, v in d.items()}
    committed = np.array(comm, bool)
    masked = {k: np.where(committed.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                          np.float32(0.0)) for k, v in d.items()}
    want = jax.jit(lambda a, x, c: jax.tree.map(
        lambda u, r: u + r, a, jdef.robust_aggregate(aggregator, x, c, frac)))(
            agg, masked, committed)
    into = {k: torch.from_numpy(v.copy()) for k, v in agg.items()}
    deltas = [{k: torch.from_numpy(v[m].copy()) for k, v in d.items()}
              if committed[m] else None for m in range(W)]
    got = tdef.robust_aggregate(aggregator, deltas, committed.tolist(), frac,
                                template=into, into=into)
    assert got is into
    for k in d:
        w, g = np.asarray(want[k]), into[k].numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        live = ~np.isnan(w)
        np.testing.assert_array_equal(g[live].view(np.int32),
                                      w[live].view(np.int32), err_msg=k)


def test_sort_matches_jnp_sort_on_special_values():
    """``torch.sort(stable=True)`` orders NaN last and keeps ``-0`` and
    ``+0`` in input order, as ``jnp.sort`` (stable, -0 == +0) does."""
    x = np.array([[0.0, np.nan, -0.0, 1.0], [-0.0, 2.0, np.inf, np.nan],
                  [np.nan, -np.inf, 0.0, -0.0], [1.0, 0.0, -0.0, 3e38]],
                 np.float32)
    want = np.asarray(jnp.sort(x, axis=0))
    got = torch.sort(torch.from_numpy(x), dim=0, stable=True).values.numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# apply_crashes.
# ---------------------------------------------------------------------------

def _rich_state(steps=6):
    """Both engines after a few rounds of a run that allocates every
    per-worker field the crash resets: lasg_wk (grad_ema), EF top-k (the
    residual), validation (the defense ledger)."""
    kw = dict(kind="laq", bits=4, lazy_rule="lasg_wk", error_feedback=True,
              compressor="topk", defense=dict(validate=True))
    return C.run_both(C.quadratic_engines(kw), steps), kw


@pytest.mark.parametrize("reconcile", (True, False))
@pytest.mark.parametrize("nan_qhat", (False, True))
def test_apply_crashes_matches_reference(reconcile, nan_qhat):
    ((jc, _), (tc, _)), kw = _rich_state()
    jp, jcst, _ = jc
    tp, tcst, _ = tc
    if nan_qhat:     # a poisoned qhat of a worker that does NOT crash
        jcst = jcst._replace(qhat={"x": jcst.qhat["x"].at[3, 5].set(jnp.nan)})
        tcst.qhat[3]["x"][5] = float("nan")
    mask = np.zeros(C.M, bool)
    mask[[1, 6]] = True
    grads = {"x": np.full((C.M, C.P), 0.5, np.float32)}
    want = jfaults.apply_crashes(jcst, jnp.asarray(mask), jp, grads,
                                 C.strategy(False, **kw), reconcile=reconcile)
    got = tfaults.apply_crashes(tcst, torch.from_numpy(mask), tp,
                                C.strategy(True, **kw), reconcile=reconcile)
    np.testing.assert_allclose(got.server_agg["x"].numpy(),
                               np.asarray(want.server_agg["x"]), rtol=1e-6,
                               atol=1e-6)
    if nan_qhat:
        assert bool(got.server_agg["x"][5].isnan()) == reconcile
        assert np.isnan(np.asarray(want.server_agg["x"])[5]) == reconcile
    # the two runs' float state agrees to float32 reduction order; the
    # resets are exact zeros and t_bar
    np.testing.assert_array_equal(got.clocks.numpy(), np.asarray(want.clocks))
    for name in ("eps_hat_sq", "R_anchor"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, err_msg=name)
    for name in ("stat_ema", "stat_count", "sigma_hat_sq"):
        np.testing.assert_allclose(getattr(got.lazy, name).numpy(),
                                   np.asarray(getattr(want.lazy, name)),
                                   rtol=1e-4, err_msg=name)
    for name in ("eps_hat_sq", "R_anchor"):
        assert not getattr(got, name)[mask].any()
    assert not got.lazy.stat_count[mask].any()
    for m in range(C.M):
        for field, tl, jl in (("qhat", got.qhat, want.qhat["x"]),
                              ("grad_ema", got.lazy.grad_ema,
                               want.lazy.grad_ema["x"]),
                              ("residual", got.error.residual,
                               want.error.residual["x"])):
            np.testing.assert_allclose(tl[m]["x"].numpy(), np.asarray(jl[m]),
                                       rtol=1e-5, atol=1e-6, err_msg=field)
        if mask[m]:
            assert not tl[m]["x"].any()
    assert int(got.clocks[1]) == C.CRIT["t_bar"]
    np.testing.assert_array_equal(got.defense.rejects.numpy(),
                                  np.asarray(want.defense.rejects))


def test_apply_crashes_resets_svrg_and_theta_last_snapshots():
    """The restarted worker's snapshots are the current iterate; its SVRG
    ``mu`` is left for the engine to set from this round's gradient (the
    engine runs with crashes and SVRG are held in
    ``test_stochastic_fault_runs_match_reference_engine``)."""
    kw = dict(kind="laq", bits=4, lazy_rule="lasg_wk2", grad_mode="svrg",
              svrg_period=5)
    (jc, _), (tc, _) = C.run_both(C.regression_engines(kw), 3)
    mask = np.array([False, True, False, False, True, False])
    got = tfaults.apply_crashes(tc[1], torch.from_numpy(mask), tc[0],
                                C.strategy(True, **kw))
    for m in range(C.RM):
        if mask[m]:
            assert got.lazy.theta_last[m] is got.svrg.theta_anchor[m]
            np.testing.assert_array_equal(
                got.svrg.theta_anchor[m]["w"].numpy(), tc[0]["w"].numpy())
            assert got.svrg.mu_anchor[m] is None
            assert float(got.lazy.stat_count[m]) == 0.0
        else:
            assert got.svrg.mu_anchor[m] is not None


# ---------------------------------------------------------------------------
# Engine runs of every fault kind, defended and not.
# ---------------------------------------------------------------------------

FAULT_RUNS = {
    "nan": dict(faults=dict(corrupt_p=0.2, corrupt_kind="nan", fault_seed=1)),
    "nan_validate": dict(faults=dict(corrupt_p=0.2, corrupt_kind="nan",
                                     fault_seed=1),
                         defense=dict(validate=True)),
    "inf": dict(faults=dict(corrupt_p=0.2, corrupt_kind="inf", fault_seed=2)),
    "inf_validate": dict(faults=dict(corrupt_p=0.3, corrupt_kind="inf",
                                     fault_seed=2),
                         defense=dict(validate=True)),
    "sign_flip_gate": dict(faults=dict(corrupt_p=0.2,
                                       corrupt_kind="sign_flip", fault_seed=2),
                           defense=dict(validate=True, gate_mult=4.0)),
    "scale": dict(faults=dict(corrupt_p=0.2, corrupt_kind="scale",
                              corrupt_scale=-40.0, fault_seed=2)),
    "scale_clip": dict(faults=dict(corrupt_p=0.2, corrupt_kind="scale",
                                   corrupt_scale=-40.0, fault_seed=2),
                       defense=dict(clip_mult=4.0)),
    "scale_gate_clip": dict(faults=dict(corrupt_p=0.25, corrupt_kind="scale",
                                        corrupt_scale=-40.0, crash_p=0.1,
                                        fault_seed=7),
                            defense=dict(validate=True, gate_mult=4.0,
                                         clip_mult=4.0)),
    "bitflip": dict(faults=dict(corrupt_p=0.3, corrupt_kind="bitflip",
                                fault_seed=4)),
    "bitflip_gate": dict(faults=dict(corrupt_p=0.3, corrupt_kind="bitflip",
                                     bitflip_frac=0.5, fault_seed=4),
                         defense=dict(validate=True, gate_mult=1.5)),
    "crash": dict(faults=dict(crash_p=0.1, fault_seed=5)),
    "crash_no_reconcile": dict(faults=dict(crash_p=0.1, fault_seed=5),
                               defense=dict(reconcile_crashes=False)),
    "trimmed_mean_scale": dict(faults=dict(
        corrupt_p=0.15, corrupt_kind="scale", corrupt_scale=-40.0),
        aggregator="trimmed_mean", trim_frac=0.2),
    "median_nan": dict(faults=dict(corrupt_p=0.2, corrupt_kind="nan",
                                   fault_seed=1), aggregator="median"),
    "trimmed_mean_bitflip": dict(faults=dict(
        corrupt_p=0.3, corrupt_kind="bitflip", fault_seed=4),
        aggregator="trimmed_mean", trim_frac=0.1),
}


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("name", FAULT_RUNS)
def test_fault_runs_match_reference_engine(name, backend):
    kw = dict(dict(kind="laq", bits=4, wire_backend=backend),
              **FAULT_RUNS[name])
    (jc, want), (tc, got) = C.run_both(C.quadratic_engines(kw), 40)
    C.assert_runs_match(want, got, param_atol=1e-3)
    rj, rt = C.rejects(jc), C.rejects(tc)
    if rj is None:
        assert rt is None
    else:
        np.testing.assert_array_equal(rt, rj)
    if "validate" in name or "gate" in name:
        assert rj.sum() > 0          # the scenario fired
    assert int(got.cum_uploads[-1]) < 40 * C.M or kw["kind"] == "qgd" \
        or name in ("inf",)


STOCH_FAULT_RUNS = {
    "wk_scale_gate": dict(lazy_rule="lasg_wk", faults=dict(
        corrupt_p=0.25, corrupt_kind="scale", corrupt_scale=30.0,
        fault_seed=3), defense=dict(validate=True, gate_mult=4.0)),
    "wk2_svrg_crash": dict(lazy_rule="lasg_wk2", grad_mode="svrg",
                           svrg_period=5, faults=dict(crash_p=0.2,
                                                      fault_seed=6)),
    "ps_inf_validate_bernoulli": dict(
        lazy_rule="lasg_ps", participation="bernoulli", participation_p=0.7,
        faults=dict(corrupt_p=0.2, corrupt_kind="inf", fault_seed=8),
        defense=dict(validate=True)),
    "ef_topk_clip_crash": dict(compressor="topk", compressor_k=0.5,
                               error_feedback=True,
                               faults=dict(crash_p=0.15, fault_seed=9),
                               defense=dict(clip_mult=3.0)),
    "alaq_sign_gate_markov": dict(
        bits=8, bit_schedule=dict(kind="radius", grid=(2, 4, 8),
                                  thresholds=(0.05, 0.3)),
        participation="markov", participation_p=0.6, markov_sojourn=3.0,
        faults=dict(corrupt_p=0.2, corrupt_kind="sign_flip", fault_seed=10),
        defense=dict(gate_mult=3.0)),
}


@pytest.mark.parametrize("name", STOCH_FAULT_RUNS)
def test_stochastic_fault_runs_match_reference_engine(name):
    kw = dict(dict(kind="laq", bits=4, wire_backend="fused"),
              **STOCH_FAULT_RUNS[name])
    (jc, want), (tc, got) = C.run_both(C.regression_engines(kw), 30)
    C.assert_runs_match(want, got, rtol=1e-4, atol=1e-4, param_atol=1e-3)
    rj = C.rejects(jc)
    if rj is not None:
        np.testing.assert_array_equal(C.rejects(tc), rj)


# A NaN innovation under the sparse compressors: top-k selects the NaN
# coordinates first (``jax.lax.top_k`` ranks NaN above +inf), the grid's
# endpoints are NaN and so is every survivor's deq.  (name -> (kw, source,
# rounds, the reference's rejects after the last round or None, whether
# the reference's last loss is NaN)); the rejects and the NaN-ness are
# asserted, not only compared, so that a change of the reference shows.
NAN_SPARSE = dict(kind="laq", bits=4, compressor="topk", compressor_k=0.25,
                  error_feedback=True,
                  faults=dict(corrupt_p=0.3, corrupt_kind="nan", fault_seed=1))
NAN_SPARSE_RUNS = {
    "topk_validate": (dict(NAN_SPARSE, defense=dict(validate=True)),
                      "quadratic", 6, [3, 2, 3, 2, 3, 2, 2, 1, 2, 0], False),
    "topk_undefended": (NAN_SPARSE, "quadratic", 6, None, True),
    "topk_validate_minibatch": (dict(NAN_SPARSE, defense=dict(validate=True)),
                                "regression", 4, [2, 2, 1, 1, 1, 1], False),
    "randk_validate": (dict(NAN_SPARSE, compressor="randk",
                            defense=dict(validate=True)),
                       "quadratic", 6, None, False),
}


@pytest.mark.parametrize("name", NAN_SPARSE_RUNS)
def test_sparse_nan_innovation_matches_reference_engine(name):
    """Uploads, bits and rejects exact, the loss NaN exactly where the
    reference's is, and the rest as in the fault runs above."""
    kw, source, rounds, want_rejects, nan_loss = NAN_SPARSE_RUNS[name]
    engines = (C.quadratic_engines(kw) if source == "quadratic"
               else C.regression_engines(kw, batch=4))
    (jc, want), (tc, got) = C.run_both(engines, rounds)
    _eq = np.testing.assert_array_equal
    _eq(np.isnan(got.loss.numpy()), np.isnan(np.asarray(want.loss)))
    assert bool(np.isnan(np.asarray(want.loss)[-1])) == nan_loss
    C.assert_runs_match(want, got, rtol=1e-4, atol=1e-4, param_atol=1e-3)
    rj = C.rejects(jc)
    if rj is None:
        assert C.rejects(tc) is None
    else:
        _eq(C.rejects(tc), rj)
        assert rj.sum() > 0
    if want_rejects is not None:
        _eq(rj, want_rejects)


def test_rejected_upload_is_masked_like_a_skip_but_pays_bits():
    """Round by round: a rejected worker's qhat, eps_hat and clock are as
    after a skip, its bits are paid, and the server aggregate stays
    finite (the reference's accounting contract)."""
    kw = dict(kind="laq", bits=4, faults=dict(corrupt_p=0.3,
                                              corrupt_kind="inf",
                                              fault_seed=2),
              defense=dict(validate=True))
    _, te, _, tp = C.quadratic_engines(kw)
    carry, hit = te.init_carry(tp, device="cpu"), 0
    for _ in range(12):
        cst = carry[1]
        before = ([q["x"].clone() for q in cst.qhat], cst.eps_hat_sq.clone(),
                  cst.clocks.clone(), cst.bits_spent.clone(),
                  cst.defense.rejects.clone())
        carry, _ = te.run_from(carry, 1)
        cst = carry[1]
        for m in np.nonzero((cst.defense.rejects > before[4]).numpy())[0]:
            hit += 1
            assert torch.equal(cst.qhat[m]["x"], before[0][m])
            assert cst.eps_hat_sq[m] == before[1][m]
            assert int(cst.clocks[m]) == int(before[2][m]) + 1
            assert cst.bits_spent[m] > before[3][m]
        assert torch.isfinite(cst.server_agg["x"]).all()
    assert hit


def test_baselines_refuse_faults_and_bitflips_need_the_fixed_width_wire():
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    kw = dict(kind="gd", faults=dict(crash_p=0.1))
    with pytest.raises(ValueError, match="fault injection"):
        C.regression_engines(kw, baseline="qsgd")
    src = FullBatchSource(C.t_quadratic, tuple(
        torch.from_numpy(x) for x in C.quadratic_data()))
    flips = dict(kind="laq", faults=dict(corrupt_p=0.1,
                                         corrupt_kind="bitflip"))
    for bad in (dict(kind="lag"), dict(compressor="topk"),
                dict(bits=8, bit_schedule=dict(kind="radius",
                                               thresholds=(0.1, 0.5)))):
        with pytest.raises(ValueError, match="bit-flips"):
            RoundEngine(src, C.strategy(True, **dict(flips, **bad)),
                        alpha=0.1)
    for bad, what in ((dict(faults=dict(corrupt_kind="zap")), "corrupt_kind"),
                      (dict(aggregator="mean"), "aggregator"),
                      (dict(participation="sometimes"), "participation")):
        with pytest.raises(ValueError, match=what):
            RoundEngine(src, C.strategy(True, **bad), alpha=0.1)


# ---------------------------------------------------------------------------
# The watchdog: the three scenarios of test_faults.py, equal logs.
# ---------------------------------------------------------------------------

WATCHDOG = {
    "rollback_escalate": (dict(faults=dict(corrupt_p=0.1, corrupt_kind="inf")),
                          60, dict(chunk=10), True),
    "healthy": (dict(), 30, dict(chunk=10), False),
    "gives_up": (dict(faults=dict(corrupt_p=0.5, corrupt_kind="inf")), 40,
                 dict(chunk=10, max_rollbacks=2), False),
}


@pytest.mark.parametrize("name", WATCHDOG)
def test_watchdog_matches_reference(name, tmp_path):
    kw, steps, wd, esc = WATCHDOG[name]
    kw = dict(kind="laq", bits=4, **kw)
    je, te, jp, tp = C.quadratic_engines(kw)

    def escalator(port):
        def escalate(engine):
            cfg = engine.cfg._replace(defense=(tdef if port else jdef)
                                      .DefenseConfig(validate=True))
            return type(engine)(engine.source, cfg, alpha=engine.alpha)
        return escalate if esc else None

    want, wlog, wcarry = jdef.run_with_watchdog(
        je, jp, steps, ckpt_path=str(tmp_path / "jax.npz"),
        wd=jdef.WatchdogConfig(**wd), escalate=escalator(False))
    got, glog, gcarry = tdef.run_with_watchdog(
        te, tp, steps, ckpt_path=str(tmp_path / "port.npz"),
        wd=tdef.WatchdogConfig(**wd), escalate=escalator(True), device="cpu")
    assert glog == wlog
    if want.loss is None:
        assert got.loss is None
    else:
        C.assert_runs_match(want, got)
    rj = C.rejects(wcarry)
    if rj is not None:
        np.testing.assert_array_equal(C.rejects(gcarry), rj)
    if name == "rollback_escalate":
        assert glog["rollbacks"] and not glog["gave_up"]
        assert rj.sum() >= 1
    if name == "gives_up":
        assert glog["gave_up"] and len(glog["rollbacks"]) == 3


def test_migrate_carry_keeps_what_survives_the_escalation():
    _, te, _, tp = C.quadratic_engines(dict(kind="laq", bits=4))
    carry, _ = te.run_from(te.init_carry(tp, device="cpu"), 3)
    te2 = type(te)(te.source, te.cfg._replace(
        defense=tdef.DefenseConfig(validate=True)), alpha=te.alpha)
    fresh = te2.init_carry(carry[0], device="cpu")
    params, cst, ps = tdef.migrate_carry(carry, fresh)
    assert params is carry[0] and cst.qhat is carry[1].qhat
    assert cst.step == 3 and cst.defense is fresh[1].defense
    assert cst.defense.rejects is not None


def test_random_uniform_threshold_matches_weak_typed_compare():
    """``u < frac`` compares in float32 (JAX's weak types): at a frac that
    float32 rounds up, the port flips where the reference does."""
    frac = 0.1 + 1e-9     # f32(frac) == f32(0.1) != frac
    key = R.PRNGKey(4, device="cpu")
    u = R.uniform(key, (200000,))
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (200000,))
                      < frac)
    np.testing.assert_array_equal(
        (u < torch.tensor(frac, dtype=torch.float32)).numpy(), want)


def test_check_supported_gates_only_bf16_state_of_participation_and_robustness():
    """``check_supported`` takes participation, the robustness layer and
    bfloat16 state; ``RoundEngine`` refuses bfloat16 state, which the
    reference's engine cannot run
    (``test_reference_engine_refuses_bf16_state``)."""
    from repro_torch.core.strategy import check_supported
    for kw in (dict(participation="markov", participation_p=0.5),
               dict(participation="delay", max_delay=3),
               dict(faults=dict(corrupt_p=0.1, corrupt_kind="bitflip",
                                crash_p=0.1)),
               dict(defense=dict(validate=True, gate_mult=2.0,
                                 clip_mult=3.0, reconcile_crashes=False)),
               dict(aggregator="median"), dict(aggregator="trimmed_mean"),
               dict(state_bf16=True)):
        check_supported(C.strategy(True, kind="laq", bits=4, **kw))
    with pytest.raises(ValueError, match="state_bf16 runs in the sharded"):
        C.quadratic_engines(dict(kind="laq", bits=4, state_bf16=True))


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("kind", ("laq", "qgd"))
def test_reference_engine_refuses_bf16_state(kind, backend):
    """The reason of the port's refusal: the reference's ``aggregate``
    adds the float32 delta sum to the bfloat16 ``server_agg``, and the
    ``lax.scan`` of ``RoundEngine.run`` rejects the carry whose dtype
    changed."""
    from repro.core.engine import FullBatchSource, RoundEngine
    strat = C.strategy(False, kind=kind, bits=4, wire_backend=backend,
                       state_bf16=True)
    engine = RoundEngine(FullBatchSource(C.j_quadratic, C.quadratic_data()),
                         strat, alpha=0.3)
    with pytest.raises(TypeError, match="server_agg.*bfloat16.*float32"):
        engine.run({"x": np.zeros(C.P, np.float32)}, 2)
