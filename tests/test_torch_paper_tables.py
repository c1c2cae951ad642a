"""The port's paper tables (``benchmarks_torch``) against the reference's
(``benchmarks``) on the CPU.

The data (``classification_dataset``, ``split_workers`` at three
heterogeneities) and the NN's initial weights (``nn_init``) are the
reference's bit for bit.  Tables 2 and 3 run at reduced steps, the same
step constants set on the JAX and the port modules (``monkeypatch``; the
JAX files stay as they are), on the reference and the fused wire: every
row's ``cum_uploads`` and ``cum_bits`` equal the JAX run's in every round,
the reported rounds and bits equal the JAX table's, the claims agree, and
the per-round loss is within ``LOSS_RTOL`` (torch's and XLA's matmul and
``log_softmax`` reduce in other orders).

SSGD's rows are the exception (ROADMAP queue 3): its support, kept where
a uniform draw falls below ``k |v_i| / sum |v|``, is a knife edge on the
gradients, and the two frameworks' gradients agree only to float32
reduction accuracy (about a third of the NN's first-layer gradient is
bitwise equal at its initial weights, ``tests/paper_tables_probe.py``;
torch's own CPU gradients change with its thread count).  Its uploads are exact (every worker, every round); its bits, and
its loss, which follows another support once one coordinate flips, are
held to ``SSGD_RTOL``.
"""
import jax
import numpy as np
import pytest
import torch

import benchmarks.common as jcommon
import benchmarks.table2_gradient as J2
import benchmarks.table3_stochastic as J3
import benchmarks_torch.common as tcommon
import benchmarks_torch.table2_gradient as T2
import benchmarks_torch.table3_stochastic as T3
from repro import data as jdata
from repro_torch import random as R
from repro_torch.data import synthetic as tdata
from torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
# SSGD's bits and loss once its support differs; the largest gaps seen:
# bits 3.9e-6 (NN, round 5), loss 2.6e-5 (NN, full size)
SSGD_RTOL = 1e-4
# reduced steps, (logistic, NN) of each table: the JAX runs' early skips
# (LAQ uploads 10, 0, 0, 1, 9, ... on the logistic model, SLAQ 10, 10, 10,
# 10, 9, 8, ... on the NN) and SSGD's first divergence (NN, round 5)
STEPS = {"table2": dict(STEPS_LOGREG=30, STEPS_NN=20),
         "table3": dict(STEPS=20, STEPS_NN=15)}
MODULES = {"table2": (J2, T2, "run_gradient_based"),
           "table3": (J3, T3, "run_stochastic")}


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.fixture(params=(True, False), ids=("partitionable", "legacy"))
def layout(request):
    with jax.threefry_partitionable(request.param), \
            R.threefry_partitionable(request.param):
        yield request.param


@pytest.fixture(scope="module")
def datasets():
    return {flag: _draw(flag) for flag in (True, False)}


def _draw(flag):
    with jax.threefry_partitionable(flag), R.threefry_partitionable(flag):
        jX, jY = jdata.classification_dataset(jax.random.PRNGKey(0),
                                              n_per_class=60)
        tX, tY = tdata.classification_dataset(R.PRNGKey(0, device="cpu"),
                                              n_per_class=60)
    return (jX, jY), (tX, tY)


def test_classification_dataset(layout, datasets):
    (jX, jY), (tX, tY) = datasets[layout]
    assert tX.shape == (600, 784) and tX.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tX), _bits(jX))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))


def test_classification_dataset_at_other_sizes():
    """Another key, class count, width, separation and noise."""
    kw = dict(n_per_class=7, n_classes=3, n_features=50, separation=3.5,
              noise=0.25)
    jX, jY = jdata.classification_dataset(jax.random.PRNGKey(9), **kw)
    tX, tY = tdata.classification_dataset(R.PRNGKey(9, device="cpu"), **kw)
    np.testing.assert_array_equal(_bits(tX), _bits(jX))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))


@pytest.mark.parametrize("heterogeneity", (0.0, 0.5, 1.0))
def test_split_workers(layout, datasets, heterogeneity):
    (jX, jY), (tX, tY) = datasets[layout]
    with jax.threefry_partitionable(layout), R.threefry_partitionable(layout):
        jXw, jYw = jdata.split_workers(jX, jY, 10, heterogeneity=heterogeneity)
        tXw, tYw = tdata.split_workers(tX, tY, 10, heterogeneity=heterogeneity)
    assert tXw.shape == (10, 60, 784)
    np.testing.assert_array_equal(_bits(tXw), _bits(jXw))
    np.testing.assert_array_equal(tYw.numpy(), np.asarray(jYw))


def test_split_workers_with_a_key_and_a_remainder(datasets):
    """An explicit key, and N not a multiple of W (the tail is dropped)."""
    (jX, jY), (tX, tY) = datasets[True]
    jXw, jYw = jdata.split_workers(jX, jY, 7, heterogeneity=0.3,
                                   key=jax.random.PRNGKey(5))
    tXw, tYw = tdata.split_workers(tX, tY, 7, heterogeneity=0.3,
                                   key=R.PRNGKey(5, device="cpu"))
    np.testing.assert_array_equal(_bits(tXw), _bits(jXw))
    np.testing.assert_array_equal(tYw.numpy(), np.asarray(jYw))


def test_make_dataset_and_nn_init():
    (jXw, jYw), (jX, _) = jcommon.make_dataset()
    (tXw, tYw), (tX, _) = tcommon.make_dataset(device="cpu")
    np.testing.assert_array_equal(_bits(tXw), _bits(jXw))
    np.testing.assert_array_equal(tYw.numpy(), np.asarray(jYw))
    for seed in (0, 3):
        jp, tp = jcommon.nn_init(seed), tcommon.nn_init(seed, device="cpu")
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert tp[k].dtype == torch.float32
            np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]))


def test_losses_and_accuracies_match(datasets):
    """The two losses and their gradients at the NN's initial weights and a
    nonzero logistic iterate, and both accuracies."""
    (jX, jY), (tX, tY) = datasets[True]
    jp, tp = jcommon.nn_init(1), tcommon.nn_init(1, device="cpu")
    jl, jg = jax.value_and_grad(jcommon.nn_loss(600))(jp, (jX, jY))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tl = tcommon.nn_loss(600)(tp, (tX, tY))
    tg = torch.autograd.grad(tl, list(tp.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for k, g in zip(tp, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-7)
    w = 0.01 * np.arange(7840, dtype=np.float32).reshape(10, 784) / 7840
    jl = jcommon.logreg_loss(600)({"w": w}, (jX, jY))
    tl = tcommon.logreg_loss(600)({"w": torch.from_numpy(w)}, (tX, tY))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    assert tcommon.accuracy_logreg({"w": torch.from_numpy(w)}, tX, tY) == \
        jcommon.accuracy_logreg({"w": w}, jX, jY)
    assert tcommon.accuracy_nn({k: v.detach() for k, v in tp.items()},
                               tX, tY) == jcommon.accuracy_nn(jp, jX, jY)


def _run_table(table, port, wire=None):
    """Run one table module at the reduced steps; return ``(results,
    traces)``, the traces keyed by row with the per-round arrays."""
    jmod, tmod, runner = MODULES[table]
    mod = tmod if port else jmod
    traces = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, v in STEPS[table].items():
            mp.setattr(mod, name, v)
        results = {}
        if port:
            mod.run([], results, device="cpu", wire=wire, traces=traces)
        else:
            calls = []
            inner = getattr(mod, runner)

            def recording(*a, **kw):
                r = inner(*a, **kw)
                calls.append(r)
                return r
            mp.setattr(mod, runner, recording)
            mod.run([], results)
            rows = [k for k in results if not k.endswith("/claims")]
            traces = dict(zip(rows, calls))
    return results, {k: {f: np.asarray(getattr(r, f)) for f in
                         ("loss", "cum_uploads", "cum_bits")}
                     for k, r in traces.items()}


@pytest.fixture(scope="module")
def jax_tables():
    return {t: _run_table(t, port=False) for t in MODULES}


@pytest.mark.parametrize("wire", ("reference", "fused"))
@pytest.mark.parametrize("table", tuple(MODULES))
def test_table_at_reduced_steps(jax_tables, table, wire):
    want, want_tr = jax_tables[table]
    got, got_tr = _run_table(table, port=True, wire=wire)
    assert sorted(got) == sorted(want)
    assert got[f"{table}/claims"] == want[f"{table}/claims"]
    for row in want_tr:
        g, w = got_tr[row], want_tr[row]
        np.testing.assert_array_equal(g["cum_uploads"], w["cum_uploads"],
                                      err_msg=row)
        if row.endswith("/ssgd"):
            np.testing.assert_allclose(g["cum_bits"], w["cum_bits"],
                                       rtol=SSGD_RTOL, err_msg=row)
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=SSGD_RTOL,
                                       err_msg=row)
        else:
            np.testing.assert_array_equal(g["cum_bits"], w["cum_bits"],
                                          err_msg=row)
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL,
                                       err_msg=row)
        assert got[row]["iterations"] == want[row]["iterations"], row
        assert got[row]["rounds"] == want[row]["rounds"], row
        if not row.endswith("/ssgd"):
            assert got[row]["bits"] == want[row]["bits"], row
        assert got[row]["accuracy"] == want[row]["accuracy"], row


def test_table3_logistic_slaq_stays_on_the_reference_wire():
    """The fused wire covers the packed widths (1, 2, 4, 8), as the
    reference's does: Table 3's logistic SLAQ at b=3 stays on the
    reference wire, the NN's (b=8) takes the fused one."""
    assert T3.row_wire("fused", T3.BITS) == "reference"
    assert T3.row_wire("fused", T3.BITS_NN) == "fused"
    assert T3.row_wire("reference", T3.BITS_NN) == "reference"


@pytest.mark.parametrize("module", (T2, T3), ids=("table2", "table3"))
def test_command_line_refuses_a_missing_card(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    assert module.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="cuda"):
        module.run([], {})
