"""The port's sharded step against the reference's under the lazy rules,
SVRG and the compressors (``torch_dist_cases.TRAIN_RULES``), on the
setting of ``test_torch_train.py`` and to its tolerances, in a reference
subprocess and four gloo ranks of this file's own.

The configurations, 3 steps each: the lazy rules lasg_wk, lasg_wk2 and
lasg_ps and SVRG's streaming anchor (refreshed in steps 1 and 3) on the
packed wire, lasg_wk2 + SVRG on both wires (the anchor's and the stale
iterate's backprops through the same microbatch fold), and EF-top-k,
rand-k and EF-rand-k on the float wire, each with a criterion that splits
the workers (``torch_dist_cases.TRAIN_CRITERIA``).
"""
import pytest

import torch_dist_cases as C
from torch_threads import one_thread  # noqa: F401

CONFIGS = tuple(C.TRAIN_RULES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.run_train(str(tmp_path_factory.mktemp("sharded_step_lazy")),
                       CONFIGS)


@pytest.mark.parametrize("config", CONFIGS)
def test_uploads_bits_and_widths_match_reference(runs, config):
    C.check_uploads_bits_and_widths(runs, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_loss_and_params_match_reference(runs, config):
    C.check_loss_and_params(runs, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_state_dtypes_after_every_step(runs, config):
    C.check_state_dtypes(runs, config)


@pytest.mark.parametrize("float_cfg,packed_cfg",
                         [p for p in C.TRAIN_WIRE_PAIRS if p[0] in CONFIGS])
def test_lazy_packed_and_float_wires_give_bitwise_equal_params(
        runs, float_cfg, packed_cfg):
    """The float/packed check under lasg_wk2 + SVRG: the anchor's and the
    stale iterate's backprops, the refresh and the correction are the same
    on both wires, so only the bytes on the link differ."""
    _, got = runs
    C.check_wires_bitwise(got, float_cfg, packed_cfg,
                          ("loss", "uploads", "bits", "grad_sq",
                           "bits_spent"))


@pytest.mark.parametrize("config", CONFIGS)
def test_every_rank_holds_the_same_params(runs, config):
    C.check_every_rank_holds_the_same_params(runs, config)
