"""The port's stochastic round (paper Table 3: SGD, QSGD, SSGD and the SLAQ
family with the LASG rules and SVRG) against the JAX package.

Goldens: ``tests/data/engine_goldens.npz`` holds the 18 ``stoch/*``
trajectories of ``tests/test_engine_parity.py`` (the 9 ``STOCH_CASES`` x
the reference and fused wires: linear regression with M=6 workers of 12
examples, p=8, batch 4, b=4, D=10, xi=0.08, t_bar=20, svrg_period=7, 50
rounds, alpha=0.3, seed 2).  They were captured before jax 0.5 made the
partitionable threefry layout the default, so the data is drawn with
``jax.random`` under ``jax.threefry_partitionable(False)`` and the port's
minibatches with ``repro_torch.random`` in the legacy layout.

Uploads, bits and ``mean_bits`` are held exactly.  ``loss``,
``grad_norm_sq``, ``quant_err`` and the parameters are held to rtol 1e-4
/ atol 1e-4: the JAX reference itself, run today (jax 0.9) on the same
inputs, reproduces the integers exactly but drifts from the goldens' floats
by up to 2.1e-5 (``params0`` of ``stoch/slaq/svrg``), XLA and torch reduce
in other orders, and an ulp in a radius moves a code by one grid step.

The live cases run the port and the JAX package's ``run_stochastic`` in
the default (partitionable) layout, under the same contract.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.criterion import CriterionConfig as JCriterion
from repro.core.simulated import run_stochastic as jrun
from repro.core.strategy import StrategyConfig as JStrategy
from repro_torch import random as R
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.simulated import run_stochastic
from repro_torch.core.strategy import StrategyConfig
from torch_threads import one_thread  # noqa: F401

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "engine_goldens.npz")
M, N_LOCAL, P = 6, 12, 8
STOCH_CASES = (
    ("sgd", "sgd"), ("qsgd", "sgd"), ("ssgd", "sgd"),
    ("slaq", "sgd"), ("slaq_wk", "sgd"), ("slaq_wk2", "sgd"),
    ("slaq_ps", "sgd"), ("slaq", "svrg"), ("slaq_wk2", "svrg"),
)
BACKENDS = ("reference", "fused")
RTOL = ATOL = 1e-4
EXACT = ("cum_uploads", "cum_bits", "mean_bits")
CLOSE = ("loss", "grad_norm_sq", "quant_err")


def regression_data(seed=3):
    """``tests/test_engine_parity.py``'s regression data, in the legacy
    layout the goldens were captured in."""
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
        kx, ky = jax.random.split(key)
        X = jax.random.normal(kx, (M, N_LOCAL, P))
        w_true = jnp.linspace(-1.0, 1.0, P)
        Y = X @ w_true + 0.3 * jax.random.normal(ky, (M, N_LOCAL))
    return np.array(X), np.array(Y)


def loss_fn(params, data):
    x, y = data
    return 0.5 * torch.sum(torch.square(x @ params["w"] - y)) / (M * N_LOCAL)


def _jax_loss(params, data):
    x, y = data
    return 0.5 * jnp.sum(jnp.square(x @ params["w"] - y)) / (M * N_LOCAL)


def _cfg(cls, crit_cls, backend, grad_mode):
    return cls(kind="laq", bits=4, wire_backend=backend,
               criterion=crit_cls(D=10, xi=0.08, t_bar=20),
               grad_mode=grad_mode, svrg_period=7)


def run_port(kind, grad_mode, backend):
    X, Y = regression_data()
    return run_stochastic(loss_fn, {"w": torch.zeros(P)},
                          (torch.from_numpy(X), torch.from_numpy(Y)), kind,
                          steps=50, alpha=0.3, batch=4, bits=4, seed=2,
                          laq_cfg=_cfg(StrategyConfig, CriterionConfig,
                                       backend, grad_mode), device="cpu")


def _check(got, want, tag):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f"{tag}/{f}")
    for f in CLOSE:
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                   rtol=RTOL, atol=ATOL, err_msg=f"{tag}/{f}")
    np.testing.assert_allclose(got.params["w"].numpy(), want["params0"],
                               rtol=RTOL, atol=ATOL, err_msg=f"{tag}/params0")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,grad_mode", STOCH_CASES)
def test_port_reproduces_stochastic_golden(kind, grad_mode, backend):
    goldens = np.load(GOLDEN_PATH)
    tag = f"stoch/{kind}/{grad_mode}/{backend}"
    with R.threefry_partitionable(False):
        got = run_port(kind, grad_mode, backend)
    want = {f: goldens[f"{tag}/{f}"] for f in EXACT + CLOSE + ("params0",)}
    _check(got, want, tag)
    if kind.startswith("slaq"):     # the round-1 bootstrap, then laziness
        assert int(got.cum_uploads[0]) == M
        # (at batch 4 the WK variance term keeps every worker uploading)
        assert (int(got.cum_uploads[-1]) < 50 * M) == (kind != "slaq_wk")


def test_layouts_draw_other_batches():
    """The goldens need the legacy layout: under the default layout the
    same seed draws other minibatches, and the run differs."""
    with R.threefry_partitionable(False):
        legacy = run_port("slaq", "sgd", "fused")
    default = run_port("slaq", "sgd", "fused")
    assert not np.array_equal(legacy.cum_uploads.numpy(),
                              default.cum_uploads.numpy()) or not np.allclose(
        legacy.loss.numpy(), default.loss.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ("slaq", "slaq_wk", "qsgd", "ssgd"))
def test_port_matches_live_reference_in_the_default_layout(kind, backend):
    X, Y = regression_data()
    want = jrun(_jax_loss, {"w": jnp.zeros((P,))}, (X, Y), kind, steps=50,
                alpha=0.3, batch=4, bits=4, seed=2,
                laq_cfg=_cfg(JStrategy, JCriterion, backend, "sgd"))
    got = run_port(kind, "sgd", backend)
    ref = {f: np.asarray(getattr(want, f)) for f in EXACT + CLOSE}
    ref["params0"] = np.asarray(want.params["w"])
    _check(got, ref, f"live/{kind}/{backend}")


@pytest.mark.parametrize("compressor", ("topk", "randk"))
def test_same_sample_rule_with_error_feedback_matches_live_reference(
        compressor):
    """lasg_wk2 over the EF compressor wire: the rule reads the raw
    minibatch gradients while the wire sends the EF-corrected ones (the
    port once dropped the raw gradient under error feedback and raised)."""
    X, Y = regression_data()
    ef = dict(compressor=compressor, compressor_k=0.5, error_feedback=True)
    want = jrun(_jax_loss, {"w": jnp.zeros((P,))}, (X, Y), "slaq_wk2",
                steps=50, alpha=0.3, batch=4, bits=4, seed=2,
                laq_cfg=_cfg(JStrategy, JCriterion, "fused",
                             "sgd")._replace(**ef))
    got = run_stochastic(loss_fn, {"w": torch.zeros(P)},
                         (torch.from_numpy(X), torch.from_numpy(Y)),
                         "slaq_wk2", steps=50, alpha=0.3, batch=4, bits=4,
                         seed=2, laq_cfg=_cfg(StrategyConfig, CriterionConfig,
                                              "fused", "sgd")._replace(**ef),
                         device="cpu")
    ref = {f: np.asarray(getattr(want, f)) for f in EXACT + CLOSE}
    ref["params0"] = np.asarray(want.params["w"])
    _check(got, ref, f"live/slaq_wk2/ef_{compressor}")
    assert M < int(got.cum_uploads[-1]) < 50 * M


def test_baselines_need_a_stochastic_source_and_known_kinds():
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    X, Y = regression_data()
    src = FullBatchSource(loss_fn, (torch.from_numpy(X), torch.from_numpy(Y)))
    with pytest.raises(ValueError, match="stochastic source"):
        RoundEngine(src, StrategyConfig(kind="gd"), alpha=0.1,
                    baseline="qsgd")
    with pytest.raises(ValueError, match="baseline"):
        RoundEngine(src, StrategyConfig(kind="gd"), alpha=0.1,
                    baseline="topk")
    with pytest.raises(ValueError, match="stochastic kind"):
        run_port("slaq_xx", "sgd", "fused")
