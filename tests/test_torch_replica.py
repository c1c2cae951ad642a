"""The port's lazy-replica publisher (``repro_torch/core/replica.py``,
``launch/publish.py``) against the JAX package's, on the CPU.

Every contract of ``tests/test_replica.py`` runs on the port, on both wire
backends.  Then both publishers run on the same trajectories, carried
through numpy: ``test_replica.py``'s converging ``_trajectory`` and 40
rounds of ``benchmarks/serve_frontier.py``'s micro-LM trainer on the JAX
engine.  Kinds, widths, bits, counts and ``rounds_behind`` must be
identical, and the radii, ``R_anchor``, payload bytes (the first
``ceil(n b / 8)`` of each leaf: the packages pad differently),
``theta_pub`` and the replica's weights bitwise equal.  A message cut by
either package, applied by the other's replica, gives bitwise-equal
weights.  Both publishers round as eager JAX does (the product and the
difference of the dequantization rounded on their own; ``select_bits``'s
budget product and sum too), which the last tests pin against JAX
directly.  ``serve_frontier --tiny --device cpu`` must pass every check.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import serve_frontier as jax_frontier
from benchmarks_torch import serve_frontier
from repro.core import replica as jrep
from repro.core.adaptive import BitSchedule as JBitSchedule
from repro.core.adaptive import select_bits as j_select_bits
from repro.core.wire import delta_of_codes as j_delta_of_codes
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.adaptive import BitSchedule, select_bits
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.engine import FullBatchSource, RoundEngine
from repro_torch.core.quantize import dense_bits, tree_size, upload_bits
from repro_torch.core.replica import (DeltaMsg, PublishConfig, ResyncMsg,
                                      apply_message, init_publisher,
                                      init_replica, publish, staleness_drift)
from repro_torch.core.strategy import StrategyConfig
from repro_torch.core.wire import delta_of_codes, delta_of_codes_eager
from repro_torch.launch.publish import (ReplicaFleet, publish_trajectory,
                                        trainer_rounds)
from repro_torch.tree import tree_leaves, tree_map
from test_replica import _trajectory as jax_trajectory
from torch_threads import one_thread  # noqa: F401

BACKENDS = ("reference", "fused")
RADIUS = dict(kind="radius", grid=(2, 4, 8), threshold_mode="rel",
              thresholds=(0.05, 0.5))
# (threshold, max_staleness, bits, schedule) of each parity policy
POLICIES = {
    "always_b4": dict(bits=4, threshold=0.0),
    "lazy_b4": dict(bits=4, threshold=0.35, max_staleness=5),
    "resync_only": dict(threshold=1.5, max_staleness=3),
    "adaptive": dict(threshold=0.0, schedule=RADIUS),
    "lazy_budget": dict(threshold=0.2, max_staleness=4, schedule=dict(
        RADIUS, kind="budget", total_bits=2.0e4, horizon=24)),
}


def _tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def traj():
    return [_to_torch(p) for p in jax_trajectory()]


@pytest.fixture(scope="module")
def trajectories():
    """The two trajectories in both packages: JAX arrays and torch."""
    jq = jax_trajectory()
    p0, lm = jax_frontier._train_trajectory(40)
    jl = [p0] + lm
    return {"converging": (jq, [_to_torch(p) for p in jq]),
            "micro_lm": (jl, [_to_torch(p) for p in jl])}


# ---------------------------------------------------------------------------
# The contracts of tests/test_replica.py, on the port.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_always_push_replica_equals_published_view_bitwise(traj, backend):
    cfg = PublishConfig(bits=4, threshold=0.0, wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    rep = init_replica(traj[0])
    for params in traj[1:]:
        msg, st = publish(cfg, st, params)
        assert isinstance(msg, DeltaMsg)
        rep = apply_message(rep, msg, cfg)
        assert _tree_equal(rep.params, st.theta_pub)
    assert st.n_pushes == len(traj) - 1 and st.n_resyncs == 0
    assert staleness_drift(traj[-1], rep) < 2.0 / (2 ** 4 - 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lazy_skip_bounds_drift_by_relative_threshold(traj, backend):
    cfg = PublishConfig(bits=4, threshold=0.4, max_staleness=100,
                        wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    rep = init_replica(traj[0])
    n_skips = 0
    for params in traj[1:]:
        prev_anchor = float(st.R_anchor)
        msg, st = publish(cfg, st, params)
        rep = apply_message(rep, msg, cfg)
        if msg is None:
            n_skips += 1
            anchor = max(float(st.R_anchor), prev_anchor)
            assert staleness_drift(params, rep) <= cfg.threshold * anchor + 1e-7
        else:
            assert _tree_equal(rep.params, st.theta_pub)
    assert n_skips > 0
    assert st.n_pushes + n_skips == len(traj) - 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_max_staleness_resync_restores_exact_equality(traj, backend):
    cfg = PublishConfig(threshold=1.5, max_staleness=3, wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    rep = init_replica(traj[0])
    resync_rounds = []
    for k, params in enumerate(traj[1:]):
        msg, st = publish(cfg, st, params)
        rep = apply_message(rep, msg, cfg)
        if msg is not None:
            assert isinstance(msg, ResyncMsg)
            resync_rounds.append(k)
            assert _tree_equal(rep.params, params)
            assert _tree_equal(st.theta_pub, params)
            assert st.rounds_behind == 0
        else:
            assert rep.rounds_behind <= cfg.max_staleness
    assert resync_rounds
    gaps = np.diff([-1] + resync_rounds)
    assert (gaps == cfg.max_staleness + 1).all()
    assert st.n_resyncs == len(resync_rounds) and st.n_pushes == 0
    assert st.bits_sent == dense_bits(tree_size(traj[0])) * (1 + st.n_resyncs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_zero_innovation_skips_without_resync(traj, backend):
    cfg = PublishConfig(threshold=0.25, max_staleness=2, wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    for _ in range(10):
        msg, st = publish(cfg, st, traj[0])
        assert msg is None
    assert st.n_resyncs == 0 and st.n_pushes == 0 and st.rounds_behind == 10


def test_backend_parity_schedule_payloads_and_weights(traj):
    reps, sts, scheds, raws = {}, {}, {}, {}
    for backend in BACKENDS:
        cfg = PublishConfig(bits=4, threshold=0.35, max_staleness=5,
                            wire_backend=backend)
        st = init_publisher(traj[0], cfg)
        rep = init_replica(traj[0])
        sched, raw = [], []
        for params in traj[1:]:
            msg, st = publish(cfg, st, params)
            rep = apply_message(rep, msg, cfg)
            sched.append(None if msg is None else type(msg).__name__)
            if isinstance(msg, DeltaMsg):
                raw.append(msg.payloads)
        reps[backend], sts[backend] = rep, st
        scheds[backend], raws[backend] = sched, raw
    assert scheds["reference"] == scheds["fused"]
    assert "DeltaMsg" in scheds["fused"]
    for mr, mf in zip(raws["reference"], raws["fused"]):
        for lr, lf in zip(mr, mf):
            n = min(lr.numel(), lf.numel())
            assert torch.equal(lr[:n], lf[:n])
    assert _tree_equal(reps["reference"].params, reps["fused"].params)
    assert sts["reference"].bits_sent == sts["fused"].bits_sent


@pytest.mark.parametrize("backend", BACKENDS)
def test_adaptive_width_pushes_decode_bitwise(traj, backend):
    cfg = PublishConfig(threshold=0.0, wire_backend=backend,
                        bit_schedule=BitSchedule(**RADIUS))
    st = init_publisher(traj[0], cfg)
    rep = init_replica(traj[0])
    widths = []
    for params in traj[1:]:
        msg, st = publish(cfg, st, params)
        rep = apply_message(rep, msg, cfg)
        if msg is not None:
            widths.append(msg.width)
            assert _tree_equal(rep.params, st.theta_pub)
    assert set(widths) <= {2, 4, 8} and len(set(widths)) > 1
    p, L = tree_size(traj[0]), len(tree_leaves(traj[0]))
    assert st.bits_sent == dense_bits(p) + sum(
        upload_bits(p, b, n_radii=L, bit_sidecar=True) for b in widths)


@pytest.mark.parametrize("backend", BACKENDS)
def test_always_push_bits_accounting_is_analytic(traj, backend):
    cfg = PublishConfig(bits=8, threshold=0.0, wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    for params in traj[1:]:
        _, st = publish(cfg, st, params)
    p, L = tree_size(traj[0]), len(tree_leaves(traj[0]))
    assert st.bits_sent == dense_bits(p) + st.n_pushes * upload_bits(
        p, 8, n_radii=L)


def test_config_validation():
    with pytest.raises(AssertionError):
        PublishConfig(bits=3).validate()
    with pytest.raises(AssertionError):
        PublishConfig(threshold=-0.1).validate()
    with pytest.raises(AssertionError):
        PublishConfig(bit_schedule=BitSchedule(
            kind="radius", grid=(2, 4, 8), threshold_mode="abs",
            thresholds=(0.1, 1.0))).validate()


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_delay_serves_the_delayed_published_view(traj, backend):
    """Replica r at round k holds the published view of round k - d_r.
    The publisher updates theta_pub in place, so the views kept here are
    clones."""
    cfg = PublishConfig(bits=4, threshold=0.3, max_staleness=4,
                        wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    fleet = ReplicaFleet(traj[0], 3, cfg, max_delay=2)
    views = [tree_map(torch.clone, st.theta_pub)]
    for params in traj[1:]:
        msg, st = publish(cfg, st, params)
        fleet.deliver(msg)
        views.append(tree_map(torch.clone, st.theta_pub))
        for r, d in enumerate(fleet.delays):
            want = views[max(0, len(views) - 1 - d)]
            assert _tree_equal(fleet.replicas[r].params, want)
    assert max(fleet.freshness()) <= cfg.max_staleness + 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_synchronous_equals_single_replica(traj, backend):
    cfg = PublishConfig(bits=4, threshold=0.3, max_staleness=4,
                        wire_backend=backend)
    st = init_publisher(traj[0], cfg)
    rep = init_replica(traj[0])
    fleet = ReplicaFleet(traj[0], 2, cfg, max_delay=0)
    for params in traj[1:]:
        msg, st = publish(cfg, st, params)
        rep = apply_message(rep, msg, cfg)
        fleet.deliver(msg)
    for fr in fleet.replicas:
        assert _tree_equal(fr.params, rep.params)


def _quadratic(M=6, p=16, seed=3):
    key = jax.random.PRNGKey(seed)
    kc, ka = jax.random.split(key)
    centers = torch.from_numpy(np.array(jax.random.normal(kc, (M, p))))
    scales = torch.from_numpy(np.array(0.5 + jax.random.uniform(ka, (M, p))))

    def loss_fn(params, data):
        c, a = data
        return 0.5 * torch.sum(a * torch.square(params["x"] - c)) / M
    return loss_fn, {"x": torch.zeros(p)}, (centers, scales)


@pytest.mark.parametrize("backend", BACKENDS)
def test_publish_trajectory_over_engine_rounds(backend):
    """A LAQ RoundEngine trainer feeds publish_trajectory; the fleet stays
    within its staleness budget and its drift decays with the iterates."""
    loss_fn, p0, data = _quadratic()
    eng = RoundEngine(FullBatchSource(loss_fn, data),
                      StrategyConfig(kind="laq", bits=8, per_leaf_radius=True,
                                     criterion=CriterionConfig(D=10, xi=0.08,
                                                               t_bar=100)),
                      alpha=0.3)
    cfg = PublishConfig(bits=4, threshold=0.3, max_staleness=4,
                        wire_backend=backend)
    st = init_publisher(p0, cfg)
    fleet = ReplicaFleet(p0, 2, cfg, max_delay=1)
    st, rows = publish_trajectory(trainer_rounds(eng, p0, 40, device="cpu"),
                                  cfg, st, fleet=fleet)
    assert len(rows) == 40
    kinds = {r["kind"] for r in rows}
    assert "push" in kinds and "skip" in kinds
    assert max(r["fleet_max_behind"] for r in rows) <= cfg.max_staleness + 1
    bits = [r["bits_sent"] for r in rows]
    assert all(b2 >= b1 for b1, b2 in zip(bits, bits[1:]))
    drifts = [r["fleet_max_drift"] for r in rows]
    assert np.mean(drifts[-5:]) < 0.1 * (np.mean(drifts[:5]) + 1e-12)


def test_no_storage_is_shared(traj):
    """init_publisher, init_replica, a resync's theta_pub and its message
    are copies: in-place pushes touch neither the trainer nor another
    replica."""
    p0 = tree_map(torch.clone, traj[0])
    cfg = PublishConfig(bits=4, threshold=0.0)
    st = init_publisher(p0, cfg)
    fleet = ReplicaFleet(p0, 2, cfg, max_delay=1)
    ptrs = lambda t: {l.data_ptr() for l in tree_leaves(t)}
    owners = [ptrs(p0), ptrs(st.theta_pub)] + [ptrs(r.params)
                                               for r in fleet.replicas]
    assert sum(len(o) for o in owners) == len(set().union(*owners))
    msg, st = publish(cfg, st, traj[1])
    fleet.deliver(msg)
    assert _tree_equal(p0, traj[0])
    assert not _tree_equal(fleet.replicas[0].params, fleet.replicas[1].params)
    rcfg = PublishConfig(threshold=1.5, max_staleness=0)
    params = tree_map(torch.clone, traj[2])
    rst = init_publisher(p0, rcfg)
    fleet = ReplicaFleet(p0, 2, rcfg)
    msg, rst = publish(rcfg, rst, params)
    fleet.deliver(msg)
    assert isinstance(msg, ResyncMsg)
    held = [ptrs(params), ptrs(msg.params), ptrs(rst.theta_pub)] + [
        ptrs(r.params) for r in fleet.replicas]
    assert sum(len(o) for o in held) == len(set().union(*held))
    assert all(_tree_equal(r.params, params) for r in fleet.replicas)


# ---------------------------------------------------------------------------
# Parity with the JAX publisher on the same trajectories.
# ---------------------------------------------------------------------------

def _configs(policy, backend):
    kw = dict(POLICIES[policy])
    sched = kw.pop("schedule", None)
    return (jrep.PublishConfig(wire_backend=backend, **kw,
                               bit_schedule=sched and JBitSchedule(**sched)),
            PublishConfig(wire_backend=backend, **kw,
                          bit_schedule=sched and BitSchedule(**sched)))


def _payload_len(n, bits):
    return math.ceil(n * bits / 8)


def _assert_round_equal(where, jmsg, jst, jrp, tmsg, tst, trp):
    assert type(jmsg).__name__ == type(tmsg).__name__, where
    for f in ("rounds_behind", "seq", "n_pushes", "n_resyncs", "bits_sent"):
        assert getattr(jst, f) == getattr(tst, f), (where, f)
    assert np.array_equal(np.asarray(jst.R_anchor), tst.R_anchor.numpy()), where
    for f in ("rounds_behind", "seq", "n_applied", "n_resyncs"):
        assert getattr(jrp, f) == getattr(trp, f), (where, f)
    if isinstance(tmsg, DeltaMsg):
        assert (jmsg.seq, jmsg.width, jmsg.bits) == (
            tmsg.seq, tmsg.width, tmsg.bits), where
        leaves = jax.tree.leaves(jst.theta_pub)
        for leaf, jp, tp, jR, tR in zip(leaves, jmsg.payloads, tmsg.payloads,
                                        jmsg.radii, tmsg.radii):
            nb = _payload_len(leaf.size, tmsg.width)
            assert np.array_equal(np.asarray(jp)[:nb], tp[:nb].numpy()), where
            assert np.array_equal(np.asarray(jR), tR.numpy()), where
    elif isinstance(tmsg, ResyncMsg):
        assert (jmsg.seq, jmsg.bits) == (tmsg.seq, tmsg.bits), where
    for tree_j, tree_t in ((jst.theta_pub, tst.theta_pub),
                           (jrp.params, trp.params)):
        for a, b in zip(jax.tree.leaves(tree_j), tree_leaves(tree_t)):
            assert np.array_equal(np.asarray(a), b.numpy()), where


# every policy on the converging trajectory; b=4 and the adaptive
# schedule on the micro LM's (eager JAX takes ~3 s per 40-round run)
PARITY = ([("converging", p) for p in POLICIES]
          + [("micro_lm", "lazy_b4"), ("micro_lm", "adaptive")])


@pytest.fixture(scope="module")
def jax_runs(trajectories):
    """The JAX publisher and one replica over a trajectory, per (which,
    policy, backend): one ``(msg, state, replica)`` per round (JAX values
    are immutable, so the records stay valid), run once for every test."""
    runs = {}

    def get(which, policy, backend):
        key = (which, policy, backend)
        if key not in runs:
            jtraj = trajectories[which][0]
            jcfg = _configs(policy, backend)[0]
            st, rp = jrep.init_publisher(jtraj[0], jcfg), jrep.init_replica(
                jtraj[0])
            recs = []
            for params in jtraj[1:]:
                msg, st = jrep.publish(jcfg, st, params)
                rp = jrep.apply_message(rp, msg, jcfg)
                recs.append((msg, st, rp))
            runs[key] = recs
        return runs[key]
    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("which,policy", PARITY)
def test_publisher_matches_jax_bitwise(trajectories, jax_runs, which, policy,
                                       backend):
    ttraj = trajectories[which][1]
    tcfg = _configs(policy, backend)[1]
    tst, trp = init_publisher(ttraj[0], tcfg), init_replica(ttraj[0])
    kinds = []
    for k, (tp, (jmsg, jst, jrp)) in enumerate(
            zip(ttraj[1:], jax_runs(which, policy, backend))):
        tmsg, tst = publish(tcfg, tst, tp)
        trp = apply_message(trp, tmsg, tcfg)
        _assert_round_equal((which, policy, backend, k), jmsg, jst, jrp,
                            tmsg, tst, trp)
        kinds.append(type(tmsg).__name__)
    assert ("ResyncMsg" if policy == "resync_only" else "DeltaMsg") in kinds


def _jax_msg_to_torch(msg):
    if isinstance(msg, jrep.DeltaMsg):
        return DeltaMsg(msg.seq, msg.width, msg.bits,
                        [torch.from_numpy(np.array(p)) for p in msg.payloads],
                        [torch.from_numpy(np.array(R)) for R in msg.radii])
    return ResyncMsg(msg.seq, msg.bits, _to_torch(msg.params))


def _torch_msg_to_jax(msg):
    if isinstance(msg, DeltaMsg):
        return jrep.DeltaMsg(msg.seq, msg.width, msg.bits,
                             [jnp.asarray(p.numpy()) for p in msg.payloads],
                             [jnp.asarray(R.numpy()) for R in msg.radii])
    return jrep.ResyncMsg(msg.seq, msg.bits,
                          jax.tree.map(jnp.asarray, params_to_numpy(msg.params)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", ("lazy_b4", "adaptive"))
def test_messages_cross_the_packages(trajectories, jax_runs, policy, backend):
    """Each package's replica applies the other's messages: all four
    replicas stay bitwise equal."""
    jtraj, ttraj = trajectories["micro_lm"]
    jcfg, tcfg = _configs(policy, backend)
    tst = init_publisher(ttraj[0], tcfg)
    j_of_t = jrep.init_replica(jtraj[0])
    t_of_t, t_of_j = init_replica(ttraj[0]), init_replica(ttraj[0])
    for tp, (jmsg, _, j_of_j) in zip(ttraj[1:],
                                     jax_runs("micro_lm", policy, backend)):
        tmsg, tst = publish(tcfg, tst, tp)
        j_of_t = jrep.apply_message(
            j_of_t, tmsg and _torch_msg_to_jax(tmsg), jcfg)
        t_of_t = apply_message(t_of_t, tmsg, tcfg)
        t_of_j = apply_message(t_of_j, jmsg and _jax_msg_to_torch(jmsg), tcfg)
        for a, b, c, d in zip(jax.tree.leaves(j_of_j.params),
                              jax.tree.leaves(j_of_t.params),
                              tree_leaves(t_of_t.params),
                              tree_leaves(t_of_j.params)):
            a = np.asarray(a)
            assert np.array_equal(a, np.asarray(b))
            assert np.array_equal(a, c.numpy()) and np.array_equal(a, d.numpy())


# ---------------------------------------------------------------------------
# The eager roundings, against JAX.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_eager_and_jitted_dequantizations_match_jax(bits):
    """delta_of_codes_eager is eager JAX's delta_of_codes bit for bit, and
    delta_of_codes the jitted one's; the two forms differ on some
    elements (why both exist)."""
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, 4001).astype(np.uint8)
    n_diff = 0
    for R in np.float32(rng.uniform(1e-4, 3.0, 6)).tolist() + [0.0]:
        R32 = np.float32(R)
        eager = np.asarray(j_delta_of_codes(jnp.asarray(codes), R32, bits))
        jitted = np.asarray(jax.jit(j_delta_of_codes, static_argnums=2)(
            jnp.asarray(codes), R32, bits))
        t_codes = torch.from_numpy(codes)
        assert np.array_equal(delta_of_codes_eager(t_codes, R32, bits).numpy(),
                              eager)
        assert np.array_equal(delta_of_codes(t_codes, R32, bits).numpy(),
                              jitted)
        n_diff += int((eager != jitted).sum())
    assert n_diff > 0 or bits == 1


def test_select_bits_budget_rounds_as_eager_jax():
    """The budget allowance ``rate (step + 1) + cost - spent``: eager JAX
    rounds the product and the sum on their own, jitted JAX contracts them
    into one FMA; ``select_bits(eager=True)`` is the first, the default the
    second.  The inputs put the spend at a grid cost's edge wherever the
    two roundings of the sum differ, so that some widths split."""
    kw = dict(RADIUS, kind="budget", total_bits=3.3e6, horizon=7)
    jsched, tsched = JBitSchedule(**kw), BitSchedule(**kw)
    p, L = 1000, 2
    costs = [upload_bits(p, b, n_radii=L, bit_sidecar=True)
             for b in jsched.grid]
    rate = np.float32(kw["total_bits"] / kw["horizon"])
    jitted = jax.jit(lambda s, k: j_select_bits(
        jsched, jnp.float32(2.0), s, k, p, n_radii=L,
        R_anchor=jnp.float32(1.0)))
    n_cases = n_split = 0
    for step in range(300):
        k1 = np.float32(step) + np.float32(1)
        sums = (np.float32(np.float32(rate * k1) + np.float32(costs[-1])),
                np.float32(np.float64(rate) * np.float64(k1) + costs[-1]))
        if sums[0] == sums[1]:
            continue
        for cost in costs[:2]:
            spent = float(np.float32(max(sums) - np.float32(cost)))
            want_e = j_select_bits(jsched, jnp.float32(2.0), spent, step, p,
                                   n_radii=L, R_anchor=jnp.float32(1.0))
            want_j = jitted(jnp.float32(spent), jnp.int32(step))
            got_e = select_bits(tsched, 2.0, spent, step, p, n_radii=L,
                                R_anchor=1.0, eager=True)
            got_j = select_bits(tsched, 2.0, spent, step, p, n_radii=L,
                                R_anchor=1.0)
            for got, want in ((got_e, want_e), (got_j, want_j)):
                for a, b in zip(got, want):
                    assert np.array_equal(a.numpy(), np.asarray(b)), step
            n_cases += 1
            n_split += float(want_e[0]) != float(want_j[0])
    assert n_cases >= 10 and n_split > 0


def test_serve_frontier_tiny_passes_every_check(tmp_path):
    out = tmp_path / "serve.json"
    assert serve_frontier.main(["--tiny", "--device", "cpu", "--out",
                                str(out)]) == 0
    import json
    got = json.loads(out.read_text())
    assert len(got["checks"]) == 8
    assert all(v in (True, None) for v in got["checks"].values())
    assert {r["policy"] for r in got["rows"]} == {
        "float32_push", "quant_push", "lazy_quant", "lazy_adaptive",
        "lazy_quant_fleet", "decode_rate"}
