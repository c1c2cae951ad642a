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

Upload and bit counts are held exactly.  Loss, params, grad_norm_sq and the
radius trajectory are held to rtol 1e-5 / atol 1e-5: XLA may contract
``theta - alpha * g`` and the gradient's multiplies into FMAs and reduces in
another order than torch, so the float trajectories differ at the ulp, and
an ulp in a late radius can move one code across its rounding boundary,
which shifts that coordinate by one grid step 2 tau R (a few 1e-6 here).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig

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
    goldens = np.load(GOLDEN_PATH)
    tag = f"grad/{kind}/{backend}"
    cfg = StrategyConfig(kind=kind, bits=4, wire_backend=backend,
                         criterion=CriterionConfig(D=10, xi=0.08, t_bar=100))
    res = run_gradient_based(quadratic_loss,
                             {"x": torch.zeros(P, dtype=torch.float32)},
                             quadratic_data(), cfg, steps=60, alpha=0.3,
                             device="cpu")
    np.testing.assert_array_equal(res.cum_uploads.numpy(),
                                  goldens[f"{tag}/cum_uploads"])
    np.testing.assert_array_equal(res.cum_bits.numpy(),
                                  goldens[f"{tag}/cum_bits"])
    np.testing.assert_array_equal(res.mean_bits.numpy(),
                                  goldens[f"{tag}/mean_bits"])
    for field, got in (("loss", res.loss), ("grad_norm_sq", res.grad_norm_sq),
                       ("quant_err", res.quant_err),
                       ("params0", res.params["x"])):
        np.testing.assert_allclose(got.numpy(), goldens[f"{tag}/{field}"],
                                   rtol=RTOL, atol=ATOL, err_msg=field)
