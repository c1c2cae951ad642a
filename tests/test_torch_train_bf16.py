"""The port's sharded step against the reference's with bfloat16 LAQ
state (``state_bf16``: ``qhat`` and ``server_agg`` stored in bfloat16),
on the setting of ``test_torch_train.py`` and to its tolerances, in a
reference subprocess and four gloo ranks of this file's own.

The configurations (``torch_dist_cases.TRAIN_BF16``), 3 steps each, are
twins of five others, each named after ``bf16_``: the float, packed and
adaptive wires, wk2 + SVRG on the packed wire and EF-top-k.  The state's
dtypes are checked after every step, on every rank and in the reference.
"""
import pytest

import torch_dist_cases as C
from torch_threads import one_thread  # noqa: F401

CONFIGS = C.TRAIN_BF16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.run_train(str(tmp_path_factory.mktemp("sharded_step_bf16")),
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
    """The float/packed check with bfloat16 state: the two wires round
    ``q_new`` and the stored aggregate alike, so only the bytes on the
    link differ."""
    _, got = runs
    C.check_wires_bitwise(got, float_cfg, packed_cfg,
                          ("loss", "uploads", "bits", "grad_sq",
                           "bits_spent"))


@pytest.mark.parametrize("config", CONFIGS)
def test_every_rank_holds_the_same_params(runs, config):
    C.check_every_rank_holds_the_same_params(runs, config)
