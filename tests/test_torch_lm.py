"""The port's LM slice against the JAX reference, run live, on the smoke
variant of stablelm-1.6b in float32.

Both sides start from the reference's parameters (carried over with
``repro_torch.convert.params_from_numpy``) and the reference's token
corpus (through numpy).  ``lm_loss`` is held to rtol 1e-5: the two
frameworks reduce the softmax and the matmuls in another order.  The
deterministic LAQ engine (b=8, per-leaf radii, fused wire, lm_frontier's
criterion and 1/t stepsize) runs 12 rounds on each side, the last of which
skips; upload and bit counts must be identical and the loss trajectory
agree to rtol 1e-4.

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
from repro.core.engine import AccumulatingSource as JSource
from repro.data import lm_worker_corpus as jax_corpus
from repro.models import init_params as jax_init_params
from repro.models import lm_worker_loss as jax_worker_loss
from repro.models.model import lm_loss as jax_lm_loss
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.adaptive import EtaSchedule
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.engine import AccumulatingSource, RoundEngine
from repro_torch.core.strategy import StrategyConfig
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
