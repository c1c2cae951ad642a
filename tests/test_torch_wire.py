"""The port's wire backends against the reference's, on a multi-leaf dict
with an empty leaf, global and per-leaf radii.

q_new, delta, the radii and the payload bytes are bitwise (both payloads
pad a tail byte with the midpoint code); the moments agree to rtol 1e-5.
The reference's fused backend runs its jnp lowering here, as on any CPU.
"""
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro_torch.core import wire as twire
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

SHAPES = {"w": (65, 33), "b": (4096 + 7,), "empty": (0, 4), "s": (3,)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
         for i, (k, s) in enumerate(SHAPES.items())}
    q = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    to_t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
    return g, q, to_t(g), to_t(q)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("per_leaf", (False, True))
@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_roundtrip_matches_reference(backend, per_leaf, bits):
    g, q, tg, tqh = _trees(bits + 10 * per_leaf)
    jb = jwire.get_backend(backend)
    want = jax.jit(lambda a, b: jb.roundtrip(a, b, bits, per_leaf,
                                             with_payload=True))(g, q)
    got = twire.get_backend(backend).roundtrip(tg, tqh, bits, per_leaf,
                                               with_payload=True)
    for field in ("q_new", "delta", "R_tree"):
        w_leaves = jax.tree.leaves(getattr(want, field))
        g_leaves = tree_leaves(getattr(got, field))
        assert len(w_leaves) == len(g_leaves) == len(SHAPES)
        for w, t in zip(w_leaves, g_leaves):
            _eq(t.numpy(), w)
    _eq(got.R_max.numpy(), want.R_max)
    assert len(got.payload) == len(want.payload) == len(SHAPES)
    for w, t in zip(want.payload, got.payload):
        _eq(t.numpy(), w)
    np.testing.assert_allclose(got.err_sq.numpy(), want.err_sq, rtol=1e-5)
    np.testing.assert_allclose(got.innovation_sq.numpy(), want.innovation_sq,
                               rtol=1e-5)


@pytest.mark.parametrize("per_leaf", (False, True))
def test_fused_innovation_radii_match_reference(per_leaf):
    g, q, tg, tqh = _trees(5)
    want = jax.jit(lambda a, b: jwire.FusedWire().innovation(a, b, per_leaf))(
        g, q)
    got = twire.FusedWire().innovation(tg, tqh, per_leaf)
    for w, t in zip(jax.tree.leaves(want[1]), tree_leaves(got[1])):
        _eq(t.numpy(), w)
    _eq(got[2].numpy(), want[2])


def test_fused_roundtrip_frees_unrequested_payloads(monkeypatch):
    """Without ``with_payload`` each leaf's packed codes are freed while the
    next leaves are quantized: at stablelm-1.6b's width the 12 payloads
    together are 1.6 GB at b=8."""
    _, _, tg, tqh = _trees(7)
    refs = []
    quantize = twire.ops.quantize_pack_fused

    def spy(*args):
        assert all(r() is None for r in refs[:-1])
        out = quantize(*args)
        refs.append(weakref.ref(out[0]))
        return out

    monkeypatch.setattr(twire.ops, "quantize_pack_fused", spy)
    twire.FusedWire().roundtrip(tg, tqh, 8, per_leaf=True)
    assert len(refs) == len(SHAPES)


def test_unported_methods_name_their_roadmap_item():
    """Every wire method is ported now; the rand-k sparse wire, the last of
    them, still refuses to run without its selection key."""
    _, _, tg, tqh = _trees(9)
    with pytest.raises(ValueError, match="selection key"):
        twire.sparse_roundtrip("fused", tg, tqh, 4, 8, "randk")
    with pytest.raises(ValueError):
        twire.get_backend("nope")
