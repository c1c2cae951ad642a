"""The port's adaptive width (A-LAQ) against the reference, run under
``jax.jit``: the width selection and the dynamic-width roundtrip.

``select_bits`` is held exactly (width, onehot and anchor) over sweeps of
R, spent bits and round index that put R on a threshold and the budget's
allowance on a grid cost, including allowances where XLA's contraction of
``rate * (step + 1) + cost`` into one FMA decides the width.  The
roundtrip's q_new and delta are bitwise on both backends; the moments agree
to rtol 1e-5 (float32 reduction order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import wire as jwire
from repro_torch.core import adaptive as tad
from repro_torch.core import wire as twire
from repro_torch.core.quantize import fma_f32
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

P = 123_457
SCHEDULES = {
    "radius_abs": dict(kind="radius", grid=(2, 4, 8), thresholds=(0.05, 0.5)),
    "radius_rel": dict(kind="radius", grid=(2, 4, 8), thresholds=(0.05, 0.5),
                       threshold_mode="rel", anchor_decay=0.9),
    "radius_rel_24": dict(kind="radius", grid=(2, 4), thresholds=(0.3,),
                          threshold_mode="rel"),
    # budgets whose allowance rate * (step + 1) + cost rounds otherwise
    # when contracted, at 16 and 14 of the rounds 0-59
    "budget": dict(kind="budget", grid=(2, 4, 8), thresholds=(0.05, 0.5),
                   total_bits=1.814e6, horizon=47),
    "budget_rel": dict(kind="budget", grid=(2, 4, 8), thresholds=(0.05, 0.5),
                       threshold_mode="rel", total_bits=8.454e6, horizon=2),
}


def _cases(name, seed):
    """(R, spent, step, anchor) tuples for one schedule."""
    kw = SCHEDULES[name]
    rng = np.random.default_rng(seed)
    th = np.asarray(kw["thresholds"], np.float32)
    out = []
    anchors = [0.0, 1.0, 0.37]
    for anchor in anchors:
        # R exactly on each threshold (absolute or as a fraction of the
        # anchor it will get), and just beside it
        scale = np.float32(anchor) if kw.get("threshold_mode") == "rel" else 1
        for t in th:
            r = np.float32(t * scale) if scale else np.float32(t)
            for x in (r, np.nextafter(r, np.float32(np.inf)),
                      np.nextafter(r, np.float32(0))):
                out.append((float(x), 0.0, 0, anchor))
        for r in rng.uniform(0, 1.2, 6).astype(np.float32):
            out.append((float(r), 0.0, int(rng.integers(0, 50)), anchor))
    if kw["kind"] == "budget":
        ts = tad.BitSchedule(**kw)
        costs = tad.grid_costs(ts, P, 3)
        rate = torch.tensor(kw["total_bits"] / kw["horizon"],
                            dtype=torch.float32)
        for step in range(60):
            s1 = torch.tensor(float(step)) + 1.0
            fused = fma_f32(rate, s1, costs[-1])
            split = rate * s1 + costs[-1]
            for x in (fused, split):
                for c in costs:     # the allowance lands on each grid cost
                    spent = x - c
                    for s in (spent, torch.nextafter(spent, spent + 1),
                              torch.nextafter(spent, spent - 1)):
                        out.append((1.0, float(s), step, 0.0))
    return out


@pytest.mark.parametrize("name", SCHEDULES)
def test_select_bits_matches_reference(name):
    kw = SCHEDULES[name]
    js, ts = jad.BitSchedule(**kw), tad.BitSchedule(**kw)
    f = jax.jit(lambda R, sp, st, an: jad.select_bits(js, R, sp, st, P,
                                                      n_radii=3, R_anchor=an))
    for R, spent, step, anchor in _cases(name, len(name)):
        want = f(jnp.float32(R), jnp.float32(spent), jnp.int32(step),
                 jnp.float32(anchor))
        got = tad.select_bits(ts, R, torch.tensor(spent), step, P,
                              n_radii=3, R_anchor=torch.tensor(anchor))
        case = (R, spent, step, anchor)
        np.testing.assert_array_equal(got[0].numpy(), want[0], str(case))
        np.testing.assert_array_equal(got[1].numpy(), want[1], str(case))
        np.testing.assert_array_equal(got[2].numpy(), want[2], str(case))


def test_budget_width_turns_on_the_contracted_allowance():
    """The sweep above reaches allowances where one FMA and a multiply then
    an add disagree on the width, so the contraction is held, not assumed."""
    kw = SCHEDULES["budget"]
    ts = tad.BitSchedule(**kw)
    seen = 0
    for R, spent, step, anchor in _cases("budget", 0):
        if R != 1.0 or spent == 0.0:       # the budget-boundary cases only
            continue
        a = tad.select_bits(ts, R, torch.tensor(spent), step, P, n_radii=3)[0]
        costs = tad.grid_costs(ts, P, 3)
        rate = torch.tensor(kw["total_bits"] / kw["horizon"],
                            dtype=torch.float32)
        allow = (rate * (torch.tensor(float(step)) + 1.0) + costs[-1]
                 - torch.tensor(spent))
        fits = (costs <= allow).nonzero().reshape(-1)
        b_split = ts.grid[min(2, int(fits.max()) if fits.numel() else 0)]
        seen += float(a) != b_split
    assert seen > 0


def test_validate_rejects_malformed_schedules():
    with pytest.raises(ValueError, match="thresholds"):
        tad.BitSchedule(kind="radius", grid=(2, 4, 8),
                        thresholds=(0.5,)).validate()
    with pytest.raises(ValueError, match="grid"):
        tad.BitSchedule(kind="radius", grid=(8, 4)).validate()
    with pytest.raises(ValueError, match="budget"):
        tad.BitSchedule(kind="budget").validate()


SHAPES = {"w": (65, 33), "b": (4096 + 7,), "empty": (0, 4), "s": (3,)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
         for i, (k, s) in enumerate(SHAPES.items())}
    q = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    to_t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
    return g, q, to_t(g), to_t(q)


@pytest.mark.parametrize("grid", [(2, 4, 8), (2, 4)])
@pytest.mark.parametrize("per_leaf", (False, True))
@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_adaptive_roundtrip_matches_reference(backend, per_leaf, grid):
    g, q, tg, tq = _trees(len(grid) + 3 * per_leaf)
    jb, tb = jwire.get_backend(backend), twire.get_backend(backend)
    for sel in range(len(grid)):
        onehot = np.eye(len(grid), dtype=np.float32)[sel]

        def ref(a, b, o):
            diff, R_tree, _ = jb.innovation(a, b, per_leaf)
            return jb.adaptive_roundtrip(a, b, diff, R_tree, grid, o)

        want = jax.jit(ref)(g, q, onehot)
        diff, R_tree, _ = tb.innovation(tg, tq, per_leaf)
        if backend == "fused":
            assert diff is None          # no materialized diff
        got = tb.adaptive_roundtrip(tg, tq, diff, R_tree, grid,
                                    torch.from_numpy(onehot))
        for w_tree, t_tree in zip(want[:2], got[:2]):
            w_leaves, t_leaves = jax.tree.leaves(w_tree), tree_leaves(t_tree)
            assert len(w_leaves) == len(t_leaves) == len(SHAPES)
            for w, t in zip(w_leaves, t_leaves):
                np.testing.assert_array_equal(t.numpy(), w)
        for w, t in zip(want[2:], got[2:]):
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5)


@pytest.mark.parametrize("per_leaf", (False, True))
def test_staged_adaptive_roundtrip_matches_reference(per_leaf):
    g, q, tg, tq = _trees(9)
    grid = (2, 4, 8)
    for sel in range(3):
        onehot = np.eye(3, dtype=np.float32)[sel]
        want = jax.jit(lambda a, b, o: jad.adaptive_roundtrip(
            a, b, grid, o, per_leaf))(g, q, onehot)
        got = tad.adaptive_roundtrip(tg, tq, grid, torch.from_numpy(onehot),
                                     per_leaf)
        for w_tree, t_tree in zip(want[:2], got[:2]):
            for w, t in zip(jax.tree.leaves(w_tree), tree_leaves(t_tree)):
                np.testing.assert_array_equal(t.numpy(), w)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-5)


def test_tau_lookups_match_reference():
    grid = (2, 4, 8)
    for sel in range(3):
        onehot = np.eye(3, dtype=np.float32)[sel]
        np.testing.assert_array_equal(
            tad.tau_of_selection(grid, torch.from_numpy(onehot)).numpy(),
            jad.tau_of_selection(grid, onehot))
    b = np.array([[2.0, 8.0], [4.0, 3.0]], np.float32)
    np.testing.assert_array_equal(tad.tau_of_width(grid, torch.from_numpy(b))
                                  .numpy(), jad.tau_of_width(grid, b))
    np.testing.assert_array_equal(tad.grid_costs(tad.BitSchedule(), 10**9, 12)
                                  .numpy(),
                                  jad.grid_costs(jad.BitSchedule(), 10**9, 12))
