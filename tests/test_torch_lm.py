"""The port's LM slice against the JAX reference, run live, on the smoke
variant of stablelm-1.6b in float32.

Both sides start from the reference's parameters (carried over with
``repro_torch.convert.params_from_numpy``) and the reference's token
corpus (through numpy).  ``lm_loss`` is held to rtol 1e-5: the two
frameworks reduce the softmax and the matmuls in another order.  The
deterministic LAQ engine (b=8, per-leaf radii, fused wire, lm_frontier's
criterion and 1/t stepsize) runs 12 rounds on each side, the last of which
skips; upload and bit counts must be identical and the loss trajectory
agree to rtol 1e-4.  The same 12 LAQ rounds run on smoke mamba2-130m (20 leaves) and smoke
zamba2-2.7b (29 leaves, the shared block's gradient summed over its
applications) at alpha 0.02, held the same way.  lm_frontier's two
other deterministic methods, A-LAQ
(radius schedule, grid (2, 4, 8), relative thresholds) and EF-top-k (b=4,
5% of the coordinates, error feedback), run 5 rounds each, held the same
way, with the per-round mean width exact too.  chip_smoke.py's
robust_full settings (fixed_k participation, scaling and crash faults,
validation, gate, clip, reconciliation) run 5 rounds against JAX's live
engine with every worker's rejections exact as well.

The gradients of the two frameworks differ at the ulp, which moves the
few codes that sit on a rounding boundary by one grid step, and the next
round's gradient sees that.  At lm_frontier's alpha=0.5 the smoke model
oscillates (the loss reaches 39 by round 6) and the two trajectories part
by 2e-4 within 4 rounds and by a skip decision at round 10.  At
alpha=0.05 they stay within 1.4e-5 for the 12 rounds, so the test runs
there.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import (CriterionConfig as JCriterion, EtaSchedule as JEta,
                        RoundEngine as JEngine, StrategyConfig as JStrategy)
from repro.core.adaptive import BitSchedule as JBitSchedule
from repro.core.engine import AccumulatingSource as JSource
from repro.data import lm_worker_corpus as jax_corpus
from repro.models import init_params as jax_init_params
from repro.models import lm_worker_loss as jax_worker_loss
from repro.models.model import lm_loss as jax_lm_loss
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import strategy as tstrategy
from repro_torch.core.adaptive import BitSchedule, EtaSchedule, select_bits
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.engine import AccumulatingSource, RoundEngine
from repro_torch.core.strategy import StrategyConfig
from repro_torch.data.synthetic import lm_worker_corpus
from repro_torch.models.config import n_params
from repro_torch.models.model import init_params, lm_loss, lm_worker_loss
from repro_torch.tree import tree_leaves

W, N_LOCAL, SEQ, ACCUM, ROUNDS, ALPHA = 4, 2, 32, 2, 12, 0.05


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_smoke_config(jax_get_config("stablelm-1.6b")),
                                param_dtype=jnp.float32,
                                compute_dtype=jnp.float32)
    cfg_t = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params_j = jax_init_params(jax.random.PRNGKey(0), cfg_j)
    corpus_j = jax_corpus(0, W, N_LOCAL, SEQ, cfg_j.vocab)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    corpus_t = {k: torch.from_numpy(np.array(v)).long()
                for k, v in corpus_j.items()}
    return cfg_j, cfg_t, params_j, corpus_j, params_t, corpus_t


def test_smoke_config_matches_reference(setup):
    cfg_j, cfg_t, params_j, _, params_t, _ = setup
    for f in ("n_layers", "d_model", "vocab", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "rope_theta", "q_chunk", "kv_chunk"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert sum(l.numel() for l in tree_leaves(params_t)) == n_params(cfg_t)
    assert n_params(get_config("stablelm-1.6b")) == 1_644_267_520


def test_param_leaf_order_is_jax_order(setup):
    _, _, params_j, _, params_t, _ = setup
    got = [tuple(l.shape) for l in tree_leaves(params_t)]
    assert got == [l.shape for l in jax.tree.leaves(params_j)]
    assert len(got) == 12
    back = params_to_numpy(params_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_lm_loss_matches_reference(setup):
    cfg_j, cfg_t, params_j, corpus_j, params_t, corpus_t = setup
    for m in range(W):
        want = float(jax.jit(lambda p, b: jax_lm_loss(p, b, cfg_j))(
            params_j, jax.tree.map(lambda x: x[m], corpus_j)))
        got = float(lm_loss(params_t, {k: v[m] for k, v in corpus_t.items()},
                            cfg_t))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_laq_lm_rounds_match_reference_engine(setup):
    cfg_j, cfg_t, params_j, corpus_j, params_t, corpus_t = setup
    crit, eta = dict(D=10, xi=0.08, t_bar=100), dict(kind="inv_t", t0=30.0)
    jcfg = JStrategy(kind="laq", bits=8, per_leaf_radius=True,
                     wire_backend="fused", criterion=JCriterion(**crit),
                     eta_schedule=JEta(**eta))
    want = JEngine(JSource(jax_worker_loss(cfg_j, W), corpus_j,
                           deterministic=True, accum=ACCUM, scale=1.0),
                   jcfg, alpha=ALPHA).run(params_j, ROUNDS)

    tcfg = StrategyConfig(kind="laq", bits=8, per_leaf_radius=True,
                          wire_backend="fused", criterion=CriterionConfig(**crit),
                          eta_schedule=EtaSchedule(**eta))
    got = RoundEngine(AccumulatingSource(lm_worker_loss(cfg_t, W), corpus_t,
                                         deterministic=True, accum=ACCUM,
                                         scale=1.0),
                      tcfg, alpha=ALPHA).run(params_t, ROUNDS, device="cpu")

    np.testing.assert_array_equal(got.cum_uploads.numpy(),
                                  np.asarray(want.cum_uploads))
    np.testing.assert_array_equal(got.cum_bits.numpy(),
                                  np.asarray(want.cum_bits))
    assert int(got.cum_uploads[0]) == W          # first_round_upload
    assert int(got.cum_uploads[-1]) < W * ROUNDS  # laziness shows
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)


def _live_f32_bytes():
    seen, total = set(), 0
    for o in gc.get_objects():
        if (isinstance(o, torch.Tensor) and o.dtype == torch.float32
                and o.device.type == "cpu"):
            s = o.untyped_storage()
            if s.data_ptr() not in seen:
                seen.add(s.data_ptr())
                total += s.nbytes()
    return total


def test_round_memory_is_w_plus_4_model_copies_between_workers(setup):
    """Workers run one at a time: when a worker's gradient is requested, the
    round holds theta, W qhat, the server aggregate and the two running
    sums, and nothing of the previous worker (no reference cycle keeps its
    gradient, delta or q_new alive)."""
    _, cfg_t, _, _, _, corpus_t = setup
    model_bytes = 4 * n_params(cfg_t)
    source = AccumulatingSource(lm_worker_loss(cfg_t, W), corpus_t,
                                deterministic=True, accum=ACCUM, scale=1.0)
    copies = []
    grad_at = source.grad_at

    def probe(*args):
        copies.append((_live_f32_bytes() - base) / model_bytes)
        return grad_at(*args)

    source.grad_at = probe
    engine = RoundEngine(source, StrategyConfig(
        kind="laq", bits=8, per_leaf_radius=True, wire_backend="fused",
        criterion=CriterionConfig(D=10, xi=0.08, t_bar=100)), alpha=ALPHA)
    base = _live_f32_bytes()      # the fixture's own parameter copies
    carry = engine.init_carry(init_params(0, cfg_t, device="cpu"),
                              device="cpu")
    for _ in range(2):
        carry, _ = engine.round(carry)
    assert len(copies) == 2 * W
    assert max(copies) < W + 4 + 0.01, copies


LM_CRIT, LM_ETA = dict(D=10, xi=0.08, t_bar=100), dict(kind="inv_t", t0=30.0)
FRONTIER = {     # benchmarks/lm_frontier.py:84-96, on the fused wire
    "alaq": dict(kind="laq", bits=8, per_leaf_radius=True,
                 wire_backend="fused"),
    "ef_topk": dict(kind="laq", bits=4, per_leaf_radius=True,
                    wire_backend="fused", compressor="topk",
                    compressor_k=0.05, error_feedback=True),
}
# lm_frontier's schedule keeps b=8 for these 5 rounds at alpha=0.05 (R
# never falls to half its anchor); the tighter thresholds make the engine
# select b=4, so that a narrow arm inside the engine is held too.  A narrow
# width goes with a small radius, whose worker then skips: the mean width
# of the uploads stays 8.
SCHEDULES = {"alaq": (0.05, 0.5), "alaq_tight": (0.5, 0.9)}
FRONTIER["alaq_tight"] = FRONTIER["alaq"]


@pytest.mark.parametrize("method", FRONTIER)
def test_frontier_lm_rounds_match_reference_engine(setup, method,
                                                   monkeypatch):
    cfg_j, cfg_t, params_j, corpus_j, params_t, corpus_t = setup
    kw, rounds = FRONTIER[method], 5
    sched = dict(kind="radius", grid=(2, 4, 8), threshold_mode="rel",
                 thresholds=SCHEDULES.get(method, ()))
    jsched = JBitSchedule(**sched) if method in SCHEDULES else None
    tsched = BitSchedule(**sched) if method in SCHEDULES else None
    jcfg = JStrategy(**kw, bit_schedule=jsched, criterion=JCriterion(**LM_CRIT),
                     eta_schedule=JEta(**LM_ETA))
    want = JEngine(JSource(jax_worker_loss(cfg_j, W), corpus_j,
                           deterministic=True, accum=ACCUM, scale=1.0),
                   jcfg, alpha=ALPHA).run(params_j, rounds)
    tcfg = StrategyConfig(**kw, bit_schedule=tsched,
                          criterion=CriterionConfig(**LM_CRIT),
                          eta_schedule=EtaSchedule(**LM_ETA))
    selected = []

    def spy(*args, **kw):
        out = select_bits(*args, **kw)
        selected.append(float(out[0]))
        return out

    monkeypatch.setattr(tstrategy, "select_bits", spy)
    got = RoundEngine(AccumulatingSource(lm_worker_loss(cfg_t, W), corpus_t,
                                         deterministic=True, accum=ACCUM,
                                         scale=1.0),
                      tcfg, alpha=ALPHA).run(params_t, rounds, device="cpu")

    np.testing.assert_array_equal(got.cum_uploads.numpy(),
                                  np.asarray(want.cum_uploads))
    np.testing.assert_array_equal(got.cum_bits.numpy(),
                                  np.asarray(want.cum_bits))
    np.testing.assert_array_equal(got.mean_bits.numpy(),
                                  np.asarray(want.mean_bits))
    assert int(got.cum_uploads[0]) == W
    if method in SCHEDULES:     # the rel bootstrap picks the widest
        assert float(got.mean_bits[0]) == 8.0
    if method in SCHEDULES:     # every worker selects every round
        assert len(selected) == rounds * W
    if method == "alaq_tight":
        assert min(selected) < 8.0, selected
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)


def test_fused_alaq_round_holds_no_more_model_copies_than_laq(setup,
                                                              monkeypatch):
    """The fused A-LAQ worker takes its radii without materializing the
    diff ``g - qhat``: during each pass-2 launch it holds no more float32
    memory than the fixed-width LAQ worker does during its own."""
    from repro_torch.core import wire
    _, cfg_t, _, _, _, corpus_t = setup
    model_bytes = 4 * n_params(cfg_t)
    peaks = {}

    def run(name, tcfg, op):
        seen, calls = [], []
        real = getattr(wire.ops, op)

        def probe(*args):       # at each worker's first leaf
            if len(calls) % 12 == 0:
                seen.append(_live_f32_bytes())
            calls.append(1)
            return real(*args)

        monkeypatch.setattr(wire.ops, op, probe)
        source = AccumulatingSource(lm_worker_loss(cfg_t, W), corpus_t,
                                    deterministic=True, accum=ACCUM,
                                    scale=1.0)
        engine = RoundEngine(source, tcfg, alpha=ALPHA)
        carry = engine.init_carry(init_params(0, cfg_t, device="cpu"),
                                  device="cpu")
        carry, _ = engine.round(carry)
        monkeypatch.setattr(wire.ops, op, real)
        assert len(calls) == W * 12
        peaks[name] = max(seen) / model_bytes
        del carry, engine

    kw = dict(kind="laq", bits=8, per_leaf_radius=True, wire_backend="fused",
              criterion=CriterionConfig(**LM_CRIT))
    run("laq", StrategyConfig(**kw), "quantize_pack_fused")
    run("alaq", StrategyConfig(**kw, bit_schedule=BitSchedule(
        kind="radius", grid=(2, 4, 8), threshold_mode="rel",
        thresholds=(0.05, 0.5))), "quantize_pack_adaptive")
    assert peaks["alaq"] < peaks["laq"] + 0.05, peaks


@pytest.mark.parametrize("args", [(0, W, N_LOCAL, SEQ, None),
                                  (3, W, 4, 512, 100352)],
                         ids=("smoke", "stablelm_vocab"))
def test_lm_worker_corpus_matches_reference(setup, args):
    """The port draws the reference's corpus, token for token (default
    threefry layout)."""
    vocab = args[4] or setup[1].vocab
    want = jax_corpus(*args[:4], vocab)
    got = lm_worker_corpus(*args[:4], vocab, device="cpu")
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# lm_frontier's stochastic "slaq" (benchmarks/lm_frontier.py:99-104: rule
# lasg_wk, b=4; here on the fused wire), the same at b=8, and the WK2 rule
# with SVRG anchors refreshed every 2 rounds.  At b=4 the quantization
# slack lets every worker skip after the bootstrap round; at b=8 the
# variance term makes every worker upload every round.
STOCHASTIC = {
    "slaq": dict(kind="laq", bits=4, lazy_rule="lasg_wk"),
    "slaq_b8": dict(kind="laq", bits=8, lazy_rule="lasg_wk"),
    "slaq_wk2_svrg": dict(kind="laq", bits=4, lazy_rule="lasg_wk2",
                          grad_mode="svrg", svrg_period=2),
}


@pytest.mark.parametrize("method", STOCHASTIC)
def test_stochastic_lm_rounds_match_reference_engine(setup, method):
    """4 rounds of a stochastic AccumulatingSource (batch 4 in 2
    microbatches, seed 0): the same sampled indices, exact uploads and
    bits, loss to rtol 1e-4."""
    cfg_j, cfg_t, params_j, corpus_j, params_t, corpus_t = setup
    kw, rounds = dict(STOCHASTIC[method], per_leaf_radius=True,
                      wire_backend="fused"), 4
    src_j = JSource(jax_worker_loss(cfg_j, W), corpus_j, batch=4, seed=0,
                    accum=ACCUM, scale=1.0)
    want = JEngine(src_j, JStrategy(**kw, criterion=JCriterion(**LM_CRIT),
                                    eta_schedule=JEta(**LM_ETA)),
                   alpha=ALPHA).run(params_j, rounds)
    src_t = AccumulatingSource(lm_worker_loss(cfg_t, W), corpus_t, batch=4,
                               seed=0, accum=ACCUM, scale=1.0)
    got = RoundEngine(src_t, StrategyConfig(
        **kw, criterion=CriterionConfig(**LM_CRIT),
        eta_schedule=EtaSchedule(**LM_ETA)), alpha=ALPHA).run(
            params_t, rounds, device="cpu")
    for step in range(rounds):
        keys = src_j.stream_keys(0, step)
        want_idx = np.stack([np.asarray(jax.random.randint(k, (4,), 0,
                                                           N_LOCAL))
                             for k in keys])
        np.testing.assert_array_equal(src_t.indices(step).numpy(), want_idx)
    np.testing.assert_array_equal(got.cum_uploads.numpy(),
                                  np.asarray(want.cum_uploads))
    np.testing.assert_array_equal(got.cum_bits.numpy(),
                                  np.asarray(want.cum_bits))
    assert int(got.cum_uploads[0]) == W
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)


# chip_smoke.py phase 9's robust_full path on the smoke model: fixed_k
# participation (3 of 4), the -40x Byzantine scaling and crash-restart
# faults, validation, norm gate, clip and crash reconciliation, at b=8 on
# the fused wire.  The seeds put in 5 rounds an absent worker in every
# round, crashes of reachable workers in rounds 2 and 5 and corrupted
# uploads of warm (already accepted) workers in rounds 3 and 5.
ROBUST_FULL = dict(kind="laq", bits=8, per_leaf_radius=True,
                   wire_backend="fused", participation="fixed_k",
                   participation_p=0.75, participation_seed=0)
ROBUST_FAULTS = dict(corrupt_p=0.25, corrupt_kind="scale",
                     corrupt_scale=-40.0, crash_p=0.25, fault_seed=25)
ROBUST_DEFENSE = dict(validate=True, gate_mult=4.0, clip_mult=4.0,
                      reconcile_crashes=True)


def test_robust_full_lm_rounds_match_reference_engine(setup):
    """5 rounds: uploads, bits and every worker's rejections exact, loss to
    rtol 1e-4 as above."""
    from repro.core import DefenseConfig as JDefense, FaultConfig as JFault
    from repro_torch.core.defense import DefenseConfig
    from repro_torch.core.engine import participation_mask
    from repro_torch.core.faults import FaultConfig, corruption_mask, crash_mask
    cfg_j, cfg_t, params_j, corpus_j, params_t, corpus_t = setup
    rounds = 5
    jcfg = JStrategy(**ROBUST_FULL, faults=JFault(**ROBUST_FAULTS),
                     defense=JDefense(**ROBUST_DEFENSE),
                     criterion=JCriterion(**LM_CRIT), eta_schedule=JEta(**LM_ETA))
    je = JEngine(JSource(jax_worker_loss(cfg_j, W), corpus_j,
                         deterministic=True, accum=ACCUM, scale=1.0),
                 jcfg, alpha=ALPHA)
    jcarry, want = je.run_from(je.init_carry(params_j), rounds)
    tcfg = StrategyConfig(**ROBUST_FULL, faults=FaultConfig(**ROBUST_FAULTS),
                          defense=DefenseConfig(**ROBUST_DEFENSE),
                          criterion=CriterionConfig(**LM_CRIT),
                          eta_schedule=EtaSchedule(**LM_ETA))
    te = RoundEngine(AccumulatingSource(lm_worker_loss(cfg_t, W), corpus_t,
                                        deterministic=True, accum=ACCUM,
                                        scale=1.0), tcfg, alpha=ALPHA)
    tcarry, got = te.run_from(te.init_carry(params_t, device="cpu"), rounds)

    avail = [participation_mask(tcfg, k, W) for k in range(rounds)]
    crashed = [crash_mask(tcfg.faults, k, W) for k in range(rounds)]
    corrupt = [corruption_mask(tcfg.faults, k, W) for k in range(rounds)]
    assert all(int(a.sum()) == 3 for a in avail)
    assert any(bool((a & c).any()) for a, c in zip(avail[1:], crashed[1:]))
    assert any(bool((a & c).any()) for a, c in zip(avail[1:], corrupt[1:]))
    np.testing.assert_array_equal(got.cum_uploads.numpy(),
                                  np.asarray(want.cum_uploads))
    np.testing.assert_array_equal(got.cum_bits.numpy(),
                                  np.asarray(want.cum_bits))
    np.testing.assert_array_equal(tcarry[1].defense.rejects.numpy(),
                                  np.asarray(jcarry[1].defense.rejects))
    assert int(tcarry[1].defense.rejects.sum()) > 0
    assert np.all(np.isfinite(got.loss.numpy()))
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)


MAMBA_ALPHA = 0.02


@pytest.mark.parametrize("arch,leaves", [("mamba2-130m", 20),
                                         ("zamba2-2.7b", 29)])
def test_mamba_laq_rounds_match_reference_engine(arch, leaves):
    """12 deterministic LAQ rounds (b=8, per-leaf radii, fused wire,
    lm_frontier's criterion and 1/t stepsize) of the smoke Mamba2 models
    from the reference's parameters and corpus, float32, at alpha 0.02:
    uploads and bits exact, the loss to rtol 1e-4, the final parameters
    as in ``tests/test_torch_moe.py``.  At 0.02 the losses fall from 6.8
    to 2.6-2.8 and the trajectories stay within 2.1e-6 (measured on the
    CPU, jax 0.9.0, torch 2.13); at 0.05 they oscillate (4.1 in round 5)
    and zamba2's part by 6.4e-5 by round 12, with equal counts."""
    cj = dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                             param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(smoke_config(get_config(arch)),
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    corpus_j = jax_corpus(0, W, N_LOCAL, SEQ, cj.vocab)
    corpus_t = {k: torch.from_numpy(np.array(v)).long()
                for k, v in corpus_j.items()}
    crit, eta = dict(D=10, xi=0.08, t_bar=100), dict(kind="inv_t", t0=30.0)
    strat = dict(kind="laq", bits=8, per_leaf_radius=True,
                 wire_backend="fused")
    je = JEngine(JSource(jax_worker_loss(cj, W), corpus_j,
                         deterministic=True, accum=ACCUM, scale=1.0),
                 JStrategy(**strat, criterion=JCriterion(**crit),
                           eta_schedule=JEta(**eta)), alpha=MAMBA_ALPHA)
    jcarry, want = je.run_from(je.init_carry(pj), ROUNDS)
    te = RoundEngine(AccumulatingSource(lm_worker_loss(ct, W), corpus_t,
                                        deterministic=True, accum=ACCUM,
                                        scale=1.0),
                     StrategyConfig(**strat, criterion=CriterionConfig(**crit),
                                    eta_schedule=EtaSchedule(**eta)),
                     alpha=MAMBA_ALPHA)
    tcarry, got = te.run_from(te.init_carry(pt, device="cpu"), ROUNDS)

    np.testing.assert_array_equal(got.cum_uploads.numpy(),
                                  np.asarray(want.cum_uploads))
    np.testing.assert_array_equal(got.cum_bits.numpy(),
                                  np.asarray(want.cum_bits))
    assert int(got.cum_uploads[0]) == W
    assert int(got.cum_uploads[-1]) < W * ROUNDS
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)
    final_t = tree_leaves(params_to_numpy(tcarry[0]))
    final_j = jax.tree.leaves(jcarry[0])
    assert len(final_t) == len(final_j) == leaves
    for a, b in zip(final_t, final_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=5e-4)
