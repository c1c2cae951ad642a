"""The port's sharded step against the reference's with bernoulli
participation (p=0.5) and the defense's validation and norm gate, on both
wires (``torch_dist_cases.TRAIN_DEFENDED``), on the setting of
``test_torch_train.py`` and to its tolerances, in a reference subprocess
and four gloo ranks of this file's own.  Each worker reads its slot of the
round's cohort, and an absent or rejected worker is masked off the wire
like a skip.
"""
import numpy as np
import pytest

import torch_dist_cases as C
from repro_torch.core.strategy import StrategyConfig
from torch_threads import one_thread  # noqa: F401

CONFIGS = C.TRAIN_DEFENDED


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.run_train(str(tmp_path_factory.mktemp("sharded_step_defended")),
                       CONFIGS)


@pytest.mark.parametrize("config", CONFIGS)
def test_participation_and_defense_match_reference(runs, config):
    """Bernoulli participation (p=0.5) with validation and the norm gate:
    each worker reads its slot of the cohort, and uploads, bits, every
    worker's bits and rejections equal the reference's; loss and
    parameters as in ``test_torch_train.py``."""
    from repro_torch.core.engine import participation_mask
    want, got = runs
    strat = StrategyConfig(**C.TRAIN_PARTICIPATION)
    masks = [participation_mask(strat, k, C.TRAIN_W).numpy()
             for k in range(C.TRAIN_STEPS)]
    assert not all(m.all() for m in masks)       # a worker was absent
    ups = want[f"{config}/uploads"]
    assert ups[0] == masks[0].sum()
    for m, g in enumerate(got):
        for field in ("uploads", "bits"):
            np.testing.assert_array_equal(g[f"{config}/{field}"],
                                          want[f"{config}/{field}"])
        np.testing.assert_array_equal(g[f"{config}/bits_spent"],
                                      want[f"{config}/bits_spent"][:, m])
        np.testing.assert_array_equal(g[f"{config}/rejects"],
                                      want[f"{config}/rejects"][:, m])
        if not masks[0][m]:
            assert g[f"{config}/bits_spent"][0] == 0.0
    np.testing.assert_allclose(got[0][f"{config}/loss"],
                               want[f"{config}/loss"], rtol=1e-4)
    w, g = C.params_of(want, config), C.params_of(got[0], config)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=5e-4,
                                   err_msg=k)
    for other in got[1:]:
        for k, v in C.params_of(other, config).items():
            np.testing.assert_array_equal(v, g[k], err_msg=k)


def test_defended_wires_give_bitwise_equal_params(runs):
    _, got = runs
    C.check_wires_bitwise(got, "defended_float", "defended_packed",
                          ("loss", "uploads", "bits", "grad_sq", "bits_spent",
                           "rejects"))
