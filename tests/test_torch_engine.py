"""The port's deterministic engine reproduces the JAX engine's goldens.

``tests/data/engine_goldens.npz`` holds the eight ``grad/{gd,qgd,lag,laq}/
{reference,fused}`` trajectories of ``tests/test_engine_parity.py`` (the
quadratic M=10, p=20, b=4, D=10, xi=0.08, t_bar=100, 60 rounds, alpha=0.3).
The fixture data is drawn with ``jax.random`` as there, under
``jax.threefry_partitionable(False)``: the goldens were captured before jax
0.5 turned partitionable threefry on by default, and with the new default
``jax.random`` draws other centers and scales (which is why
``test_engine_parity.py`` fails under jax >= 0.5).  The data reaches the
port through numpy.

Upload and bit counts are held exactly, against the goldens and against
the JAX engine run today on the same data.  Loss, params, grad_norm_sq and
the radius trajectory are held to rtol 1e-5 / atol 1e-5: XLA contracts the
gradient's multiplies into FMAs and reduces in another order than torch,
so the float trajectories differ at the ulp, and an ulp in a late radius
can move one code across its rounding boundary, which shifts that
coordinate by one grid step 2 tau R (a few 1e-6 here).

One golden decision is not today's: XLA (jax 0.9) contracts the update
``theta - alpha * agg`` into one FMA, and the port rounds it so too.  With
it the JAX engine itself uploads one more time in round 60 of ``grad/laq``
than the golden, captured with an older XLA, records; the port does the
same, and its parameters then equal the JAX engine's bit for bit.  All 60
rounds' counts are held to the JAX engine and to the golden, which differs
only in that one upload of round 60: one more upload, its 32 + 4 P wire
bits, and a mean width of 4 where the golden has none.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from torch_threads import one_thread  # noqa: F401

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "engine_goldens.npz")
M, P = 10, 20
RTOL, ATOL = 1e-5, 1e-5


def quadratic_data(seed=0):
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
        kc, ka = jax.random.split(key)
        centers = np.array(jax.random.normal(kc, (M, P)))
        scales = np.array(0.5 + jax.random.uniform(ka, (M, P)))
    return torch.from_numpy(centers), torch.from_numpy(scales)


def quadratic_loss(params, data):
    c, a = data
    return 0.5 * torch.sum(a * torch.square(params["x"] - c)) / M


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("kind", ("gd", "qgd", "lag", "laq"))
def test_port_reproduces_engine_golden(kind, backend):
    from repro.core.criterion import CriterionConfig as JCriterion
    from repro.core.simulated import run_gradient_based as jrun
    from repro.core.strategy import StrategyConfig as JStrategy

    goldens = np.load(GOLDEN_PATH)
    tag = f"grad/{kind}/{backend}"
    crit = dict(D=10, xi=0.08, t_bar=100)
    cfg = StrategyConfig(kind=kind, bits=4, wire_backend=backend,
                         criterion=CriterionConfig(**crit))
    res = run_gradient_based(quadratic_loss,
                             {"x": torch.zeros(P, dtype=torch.float32)},
                             quadratic_data(), cfg, steps=60, alpha=0.3,
                             device="cpu")
    centers, scales = quadratic_data()
    live = jrun(_jax_quadratic_loss, {"x": np.zeros(P, np.float32)},
                (centers.numpy(), scales.numpy()),
                JStrategy(kind=kind, bits=4, wire_backend=backend,
                          criterion=JCriterion(**crit)), steps=60, alpha=0.3)
    # the golden's round 60 of grad/laq predates XLA's FMA update: the
    # one upload it lacks, and nothing else, is added to it
    extra = {"cum_uploads": 1, "cum_bits": 32 + 4 * P, "mean_bits": 4}
    for field in ("cum_uploads", "cum_bits", "mean_bits"):
        got = getattr(res, field).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(live, field)),
                                      err_msg=field)
        want = goldens[f"{tag}/{field}"].copy()
        if kind == "laq":
            want[59] += extra[field]
        np.testing.assert_array_equal(got, want, err_msg=field)
    for field, got in (("loss", res.loss), ("grad_norm_sq", res.grad_norm_sq),
                       ("quant_err", res.quant_err),
                       ("params0", res.params["x"])):
        np.testing.assert_allclose(got.numpy(), goldens[f"{tag}/{field}"],
                                   rtol=RTOL, atol=ATOL, err_msg=field)


def _jax_quadratic_loss(params, data):
    import jax.numpy as jnp
    c, a = data
    return 0.5 * jnp.sum(a * jnp.square(params["x"] - c)) / M


# The A-LAQ and EF-LAQ branches on the same quadratic, against the JAX
# engine run live: an EF damping of 0.3 (its injection g + 0.3 e is one FMA
# under jit), EF with the dense wire, with top-k and with rand-k (its
# support drawn per round and worker from compressor_keys), and the budget
# controller of A-LAQ.
FRONTIER_CASES = {
    "ef_dense": dict(kind="laq", bits=4, error_feedback=True, ef_damping=0.3),
    "ef_topk": dict(kind="laq", bits=2, compressor="topk", compressor_k=0.25,
                    error_feedback=True, ef_damping=0.3),
    "topk_no_ef": dict(kind="qgd", bits=4, compressor="topk",
                       compressor_k=0.5),
    "ef_randk": dict(kind="laq", bits=2, compressor="randk",
                     compressor_k=0.25, error_feedback=True, ef_damping=0.3,
                     compressor_seed=3),
    "alaq_budget": dict(kind="laq", bits=8, bit_schedule=dict(
        kind="budget", grid=(2, 4, 8), thresholds=(0.05, 0.3),
        total_bits=5000.0, horizon=40)),
}


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("case", FRONTIER_CASES)
def test_adaptive_and_ef_branches_match_reference_engine(case, backend):
    from repro.core.adaptive import BitSchedule as JBitSchedule
    from repro.core.criterion import CriterionConfig as JCriterion
    from repro.core.simulated import run_gradient_based as jrun
    from repro.core.strategy import StrategyConfig as JStrategy
    from repro_torch.core.adaptive import BitSchedule

    kw = dict(FRONTIER_CASES[case], wire_backend=backend)
    sched = kw.pop("bit_schedule", None)
    crit = dict(D=10, xi=0.08, t_bar=100)
    centers, scales = quadratic_data()
    jcfg = JStrategy(**kw, criterion=JCriterion(**crit),
                     bit_schedule=sched and JBitSchedule(**sched))
    want = jrun(_jax_quadratic_loss, {"x": np.zeros(P, np.float32)},
                (centers.numpy(), scales.numpy()), jcfg, steps=40, alpha=0.3)
    tcfg = StrategyConfig(**kw, criterion=CriterionConfig(**crit),
                          bit_schedule=sched and BitSchedule(**sched))
    got = run_gradient_based(quadratic_loss,
                             {"x": torch.zeros(P, dtype=torch.float32)},
                             (centers, scales), tcfg, steps=40, alpha=0.3,
                             device="cpu")
    for field in ("cum_uploads", "cum_bits", "mean_bits"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.cum_uploads[-1]) < 40 * M or kw["kind"] == "qgd"
    if sched:                   # widths below 8, and mixed within rounds
        assert len(set(got.mean_bits.tolist()) - {0.0, 2.0, 4.0, 8.0}) > 0
    for field in ("loss", "grad_norm_sq", "quant_err"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
