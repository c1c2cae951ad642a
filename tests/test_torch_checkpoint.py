"""The port's checkpoints (``repro_torch/checkpoint/ckpt.py``): the
reference's npz layout, so that a carry saved by either package resumes in
the other.

A round trip keeps every leaf, dtype and the step; bfloat16 is stored as
float32 under ``BF16::``; the file is written through ``.tmp``; a missing
or extra key raises ``KeyError`` naming every offender and a shape
mismatch ``ValueError``.  The port's per-worker lists are stored stacked on
a leading W axis under the reference's keys.  A run split by a save and a
load equals the unbroken run bit for bit; a carry saved by the JAX engine
after k rounds and resumed in the port for k more (and the reverse) agrees
with JAX's 2k rounds: counts exact, floats to rtol 1e-5 / atol 1e-5 (1e-4
for the stochastic run), as ``test_torch_participation.py`` holds them.
A resumed carry of a run with shared iterates (``lasg_ps``, ``delay``,
``lasg_wk2`` with SVRG) holds one tensor per distinct iterate, no more
storage than the unbroken carry at the same round.
"""
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import torch_engine_cases as C
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.tree import SharedIterates, tree_leaves
from torch_threads import one_thread  # noqa: F401


class Pair(NamedTuple):
    a: object
    b: object


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "h": torch.linspace(-1, 1, 5).to(torch.bfloat16),
        "n": Pair(a=torch.tensor([1, 2], dtype=torch.int32), b=None),
        "workers": [{"q": torch.full((2,), float(m))} for m in range(3)],
        "t": (torch.tensor([True, False]), 7),
    }


def test_round_trip_keeps_leaves_dtypes_and_step(tmp_path):
    path = str(tmp_path / "sub" / "ck.npz")
    tree = _tree()
    save_checkpoint(path, tree, 42)
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as z:
        keys = set(z.files)
        assert z["workers/q"].shape == (3, 2)      # the list, stacked
        assert z["t/1"].dtype == np.int32 and int(z["__step__"]) == 42
    assert keys == {"w", "BF16::h", "n/a", "workers/q", "t/0", "t/1",
                    "__step__"}
    back, step = load_checkpoint(path, _tree())
    assert step == 42
    for k in ("w", "h"):
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])
    assert torch.equal(back["n"].a, tree["n"].a) and back["n"].b is None
    assert back["n"].a.dtype == torch.int32
    for m in range(3):
        assert torch.equal(back["workers"][m]["q"], tree["workers"][m]["q"])
    assert torch.equal(back["t"][0], tree["t"][0]) and back["t"][1] == 7


def test_reference_reads_the_port_layout_and_back(tmp_path):
    """The port's list is the reference's leading axis: JAX loads the port's
    file into its own stacked template, and the port loads JAX's."""
    import jax.numpy as jnp
    path = str(tmp_path / "ck.npz")
    tree = _tree()
    save_checkpoint(path, {"workers": tree["workers"], "w": tree["w"]}, 3)
    jt = {"workers": {"q": jnp.zeros((3, 2))}, "w": jnp.zeros((3, 4))}
    back, step = jload(path, jt)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(back["workers"]["q"]),
                                  np.stack([np.full(2, m, np.float32)
                                            for m in range(3)]))
    jsave(path, back, 4)
    again, step = load_checkpoint(path, {"workers": tree["workers"],
                                         "w": tree["w"]})
    assert step == 4 and torch.equal(again["w"], tree["w"])


def test_key_errors_name_every_offender(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"a": torch.zeros(2), "b": torch.zeros(3),
                           "c": torch.zeros(1)}, 0)
    with pytest.raises(KeyError) as e:
        load_checkpoint(path, {"a": torch.zeros(2), "x": torch.zeros(3),
                               "y": torch.zeros(1)})
    msg = str(e.value)
    for key in ("'x'", "'y'", "'b'", "'c'"):
        assert key in msg, (key, msg)
    with pytest.raises(ValueError, match="shape mismatch at 'b'"):
        load_checkpoint(path, {"a": torch.zeros(2), "b": torch.zeros(4),
                               "c": torch.zeros(1)})
    np.savez(str(tmp_path / "other.npz"), a=np.zeros(2))
    with pytest.raises(KeyError, match="__step__"):
        load_checkpoint(str(tmp_path / "other.npz"), {"a": torch.zeros(2)})


SPLIT = {
    "laq_defended_crashes": ("quadratic", dict(
        kind="laq", bits=4, faults=dict(corrupt_p=0.2, corrupt_kind="inf",
                                        crash_p=0.1, fault_seed=2),
        defense=dict(validate=True, gate_mult=4.0))),
    "markov_ef": ("quadratic", dict(
        kind="laq", bits=4, compressor="topk", error_feedback=True,
        participation="markov", participation_p=0.6, markov_sojourn=3.0)),
    "delay": ("quadratic", dict(kind="laq", bits=4, participation="delay",
                                max_delay=2)),
    "wk2_svrg_bernoulli": ("regression", dict(
        kind="laq", bits=4, lazy_rule="lasg_wk2", grad_mode="svrg",
        svrg_period=4, participation="bernoulli", participation_p=0.6)),
    "wk_trimmed_mean": ("regression", dict(
        kind="laq", bits=4, lazy_rule="lasg_wk", aggregator="trimmed_mean",
        trim_frac=0.2)),
}


def _engines(problem, kw):
    return (C.quadratic_engines(kw) if problem == "quadratic"
            else C.regression_engines(kw))


def _port_results_equal(a, b):
    for f in C.EXACT + C.CLOSE:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", SPLIT)
def test_split_run_equals_the_unbroken_one(name, tmp_path):
    problem, kw = SPLIT[name]
    _, te, _, tp = _engines(problem, kw)
    _, whole = te.run_from(te.init_carry(tp, device="cpu"), 16)
    path = str(tmp_path / "ck.npz")
    carry0 = te.init_carry(tp, device="cpu")
    save_checkpoint(path, carry0, 0)           # before any round, too
    carry0, step = load_checkpoint(path, carry0)
    assert step == 0
    carry, first = te.run_from(carry0, 8)
    save_checkpoint(path, carry, 8)
    fresh = te.init_carry(tp, device="cpu")
    resumed, step = load_checkpoint(path, fresh)
    assert step == 8 and resumed[1].step == 8
    _, second = te.run_from(resumed, 8)
    for f in C.EXACT + C.CLOSE:
        joined = torch.cat([getattr(first, f), getattr(second, f)])
        assert torch.equal(joined, getattr(whole, f)), f
    for k in whole.params:
        assert torch.equal(second.params[k], whole.params[k])


# the runs whose carry holds SharedIterates lists: the stale iterates of
# lasg_ps, the delay ring, the SVRG anchors and lasg_wk2's stale iterates
SHARED = {
    "lasg_ps": ("regression", dict(kind="laq", bits=4, lazy_rule="lasg_ps")),
    "delay": SPLIT["delay"],
    "wk2_svrg_bernoulli": SPLIT["wk2_svrg_bernoulli"],
}


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``'s tensor leaves."""
    seen = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


@pytest.mark.parametrize("name", SHARED)
def test_resumed_carry_keeps_the_shared_iterates(name, tmp_path):
    """A load gives the shared iterates back as one tensor per distinct
    iterate: the resumed carry holds no more storage than the unbroken
    run's carry at the same round, and runs on bit for bit as it."""
    problem, kw = SHARED[name]
    _, te, _, tp = _engines(problem, kw)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, te.init_carry(tp, device="cpu"), 0)
    fresh, _ = load_checkpoint(path, te.init_carry(tp, device="cpu"))
    lists = [x for x in (fresh[1].lazy.theta_last, fresh[1].svrg.theta_anchor,
                         fresh[2]) if isinstance(x, SharedIterates)]
    assert lists
    # before any round every slot holds the initial iterate: one storage
    assert len({leaf.untyped_storage().data_ptr()
                for x in lists for leaf in tree_leaves(x)}) == len(
                    tree_leaves(tp))
    carry, first = te.run_from(te.init_carry(tp, device="cpu"), 8)
    save_checkpoint(path, carry, 8)
    resumed, step = load_checkpoint(path, te.init_carry(tp, device="cpu"))
    assert step == 8
    assert _storage_bytes(resumed) <= _storage_bytes(carry), (
        _storage_bytes(resumed), _storage_bytes(carry))
    _, whole = te.run_from(carry, 8)
    _, second = te.run_from(resumed, 8)
    for f in C.EXACT + C.CLOSE:
        assert torch.equal(getattr(second, f), getattr(whole, f)), f
    for k in whole.params:
        assert torch.equal(second.params[k], whole.params[k])


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
@pytest.mark.parametrize("name", ("laq_defended_crashes", "delay",
                                  "markov_ef", "wk2_svrg_bernoulli"))
def test_carry_resumes_across_the_packages(name, direction, tmp_path):
    problem, kw = SPLIT[name]
    je, te, jp, tp = _engines(problem, kw)
    k = 6
    _, want = je.run_from(je.init_carry(jp), 2 * k)
    path = str(tmp_path / "ck.npz")
    if direction == "jax_to_port":
        jc, jfirst = je.run_from(je.init_carry(jp), k)
        jsave(path, jc, k)
        carry, step = load_checkpoint(path, te.init_carry(tp, device="cpu"))
        _, second = te.run_from(carry, k)
        first = jfirst
    else:
        tc, first = te.run_from(te.init_carry(tp, device="cpu"), k)
        save_checkpoint(path, tc, k)
        carry, step = jload(path, je.init_carry(jp))
        _, second = je.run_from(carry, k)
    assert step == k
    tol = 1e-4 if problem == "regression" else 1e-5
    for f in C.EXACT:
        joined = np.concatenate([np.asarray(getattr(first, f)),
                                 np.asarray(getattr(second, f))])
        np.testing.assert_array_equal(joined, np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in C.CLOSE:
        joined = np.concatenate([np.asarray(getattr(first, f)),
                                 np.asarray(getattr(second, f))])
        np.testing.assert_allclose(joined, np.asarray(getattr(want, f)),
                                   rtol=tol, atol=tol, err_msg=f)
    for key in want.params:
        np.testing.assert_allclose(np.asarray(second.params[key]),
                                   np.asarray(want.params[key]), rtol=tol,
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
def test_bf16_comm_state_crosses_the_packages(direction, tmp_path):
    """A ``state_bf16`` comm state (the sharded step's: W=4 workers' bf16
    ``qhat`` and the bf16 ``server_agg``, a float32 error-feedback
    residual beside them) saved by one package loads in the other, with
    its bf16 leaves under ``BF16::`` keys, bf16 again after the load and
    bitwise equal: +-0, +-inf, subnormals and ordinary values, and NaN
    where NaN was (torch and XLA write other NaN payloads)."""
    import jax.numpy as jnp
    from repro.core.strategy import init_comm_state as j_init
    from repro_torch.core.strategy import init_comm_state as t_init
    W, kw = 4, dict(kind="laq", bits=4, state_bf16=True,
                    compressor="topk", error_feedback=True)
    rng = np.random.default_rng(21)
    vals = rng.standard_normal((W + 2, C.P)).astype(np.float32)
    vals[:, :6] = np.array([0x0, 0x80000000, 0x7F800000, 0xFF800000,
                            0x7FC00000, 0x00010000],
                           np.uint32).view(np.float32)
    q16 = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16))
    bits16 = q16.view(np.uint16)
    jc = j_init({"x": jnp.zeros(C.P, jnp.float32)}, W, C.strategy(False, **kw))
    tc = t_init({"x": torch.zeros(C.P)}, W, C.strategy(True, **kw))
    t16 = lambda a: torch.from_numpy(a.view(np.int16).copy()).view(
        torch.bfloat16)
    path = str(tmp_path / "ck.npz")
    if direction == "port_to_jax":
        tc.qhat[:] = [{"x": t16(q16[m])} for m in range(W)]
        tc.server_agg["x"] = t16(q16[W])
        tc.error.residual[1]["x"] = torch.from_numpy(vals[W + 1].copy())
        save_checkpoint(path, tc, 5)
        back, step = jload(path, jc)
        qhat, agg = np.asarray(back.qhat["x"]), np.asarray(back.server_agg["x"])
        resid = np.asarray(back.error.residual["x"])[1]
    else:
        jc = jc._replace(
            qhat={"x": jnp.asarray(q16[:W])},
            server_agg={"x": jnp.asarray(q16[W])},
            error=jc.error._replace(residual={"x": jnp.asarray(
                np.stack([np.zeros(C.P, np.float32), vals[W + 1]]
                         + [np.zeros(C.P, np.float32)] * (W - 2)))}))
        jsave(path, jc, 5)
        back, step = load_checkpoint(path, tc)
        assert all(q["x"].dtype == torch.bfloat16 for q in back.qhat)
        assert back.server_agg["x"].dtype == torch.bfloat16
        as16 = lambda t: t.view(torch.int16).numpy().view(np.uint16)
        qhat = np.stack([as16(q["x"]) for q in back.qhat])
        agg = as16(back.server_agg["x"])
        resid = back.error.residual[1]["x"].numpy()
    with np.load(path) as z:
        assert {"BF16::qhat/x", "BF16::server_agg/x"} <= set(z.files)
        assert "error/residual/x" in z.files
    assert step == 5
    if direction == "port_to_jax":
        assert qhat.dtype == agg.dtype == jnp.bfloat16
        qhat, agg = qhat.view(np.uint16), agg.view(np.uint16)
    # a NaN stays NaN; its payload is the converting library's
    nan = np.isnan(q16.astype(np.float32))
    for got, want, where in ((qhat, bits16[:W], nan[:W]),
                             (agg, bits16[W], nan[W])):
        np.testing.assert_array_equal(got[~where], want[~where])
        assert ((got[where] & 0x7FFF) > 0x7F80).all()
    np.testing.assert_array_equal(resid.view(np.uint32),
                                  vals[W + 1].view(np.uint32))
