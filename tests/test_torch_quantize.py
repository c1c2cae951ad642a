"""``repro_torch.core.quantize`` against ``repro.core.quantize`` under
``jax.jit``: the same numpy inputs, bit for bit.

Covers b in {1, 2, 4, 8}, lengths that are and are not multiples of the
Pallas block (4096), R == 0, and a pytree with an empty leaf.  Under jit
XLA contracts the dequantization ``2 tau R q - R`` into an FMA; the port's
float64-then-round form must reproduce it exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro_torch.core import quantize as tq
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

BITS = (1, 2, 4, 8)
SIZES = (1, 7, 4096 * 2, 4096 + 37)


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 3.0).astype(np.float32)
    q = (rng.standard_normal(n) * 1.5).astype(np.float32)
    return g, q


def _bits_eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", BITS)
def test_codes_and_dequant_bitwise(bits, n):
    g, q = _pair(n, 10 * bits + n)
    d = g - q
    R = np.float32(np.abs(d).max())
    want_q = jax.jit(jq.quantize_codes, static_argnums=2)(d, R, bits)
    got_q = tq.quantize_codes(torch.from_numpy(d), torch.tensor(R), bits)
    _bits_eq(got_q.numpy(), want_q)
    want_d = jax.jit(lambda c, r: jq.dequantize_innovation(c, r, bits))(
        want_q, R)
    got_d = tq.dequantize_innovation(got_q, torch.tensor(R), bits)
    _bits_eq(got_d.numpy(), want_d)


@pytest.mark.parametrize("bits", BITS)
def test_zero_radius_gives_midpoint_and_zero_delta(bits):
    d = np.zeros(4096 + 5, np.float32)
    want_q = jax.jit(jq.quantize_codes, static_argnums=2)(d, np.float32(0), bits)
    got_q = tq.quantize_codes(torch.from_numpy(d), torch.tensor(0.0), bits)
    _bits_eq(got_q.numpy(), want_q)
    assert int(got_q[0]) == 2 ** (bits - 1)
    got_d = tq.dequantize_innovation(got_q, torch.tensor(0.0), bits)
    assert not got_d.any()


@pytest.mark.parametrize("n", (8, 4096 * 2 + 8))
@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bitwise(bits, n):
    codes = np.random.default_rng(bits).integers(0, 2 ** bits, n).astype(np.uint8)
    want = jax.jit(jq.pack_codes, static_argnums=1)(codes, bits)
    got = tq.pack_codes(torch.from_numpy(codes), bits)
    _bits_eq(got.numpy(), want)
    _bits_eq(tq.unpack_codes(got, bits).numpy(),
             jax.jit(jq.unpack_codes, static_argnums=1)(want, bits))
    _bits_eq(tq.unpack_codes(got, bits).numpy(), codes)


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (33, 17), "b": (4096 + 3,), "e": (0,), "a": (5,)}
    g = {k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
         for i, (k, s) in enumerate(shapes.items())}
    q = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    to_t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
    return g, q, to_t(g), to_t(q)


@pytest.mark.parametrize("per_leaf", (False, True))
def test_innovation_bitwise(per_leaf):
    g, q, tg, tqh = _trees(1)
    want = jax.jit(lambda a, b: jq.innovation(a, b, per_leaf))(g, q)
    got = tq.innovation(tg, tqh, per_leaf)
    for w, t in zip(jax.tree.leaves(want[0]), tree_leaves(got[0])):
        _bits_eq(t.numpy(), w)
    for w, t in zip(jax.tree.leaves(want[1]), tree_leaves(got[1])):
        _bits_eq(t.numpy(), w)
    _bits_eq(got[2].numpy(), want[2])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("per_leaf", (False, True))
def test_roundtrip_parts_bitwise(per_leaf, bits):
    g, q, tg, tqh = _trees(2 + bits)
    want = jax.jit(lambda a, b: jq.roundtrip_parts(a, b, bits, per_leaf))(g, q)
    got = tq.roundtrip_parts(tg, tqh, bits, per_leaf)
    for part in range(4):       # codes, radii, delta, q_new
        for w, t in zip(jax.tree.leaves(want[part]), tree_leaves(got[part])):
            _bits_eq(t.numpy(), w)
    _bits_eq(got[4].numpy(), want[4])
    # err_sq is a reduction: float32 reduction order may differ
    np.testing.assert_allclose(got[5].numpy(), want[5], rtol=1e-6)


def test_norms_sizes_and_costs():
    g, _, tg, _ = _trees(3)
    np.testing.assert_allclose(tq.tree_sq_norm(tg).numpy(),
                               jax.jit(jq.tree_sq_norm)(g), rtol=1e-6)
    _bits_eq(tq.tree_inf_norm(tg).numpy(), jax.jit(jq.tree_inf_norm)(g))
    assert tq.tree_size(tg) == jq.tree_size(g)
    for b in BITS:
        assert tq.tau(b) == jq.tau(b)
        assert tq.upload_bits(1000, b, n_radii=3) == jq.upload_bits(1000, b,
                                                                    n_radii=3)
    assert tq.dense_bits(1000) == jq.dense_bits(1000)
    assert float(tq.tree_sq_norm({})) == 0.0


def test_fma_f32_rounds_once_like_the_contracted_jit():
    """``fma_f32`` against XLA's contracted ``a * b + c`` under jit, with
    addends spread over 70 binades so that many sums need more than 53
    bits; and against exact rational arithmetic on a sample."""
    from fractions import Fraction

    from repro_torch.core.quantize import fma_f32
    rng = np.random.default_rng(0)
    n = 100_003
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * np.exp(rng.uniform(-60, 10, n))).astype(
        np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    np.testing.assert_array_equal(got, want)
    for i in range(300):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        err = abs(Fraction(float(got[i])) - exact)
        for nb in (np.nextafter(got[i], np.float32(np.inf)),
                   np.nextafter(got[i], np.float32(-np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact)
    # a Python scalar is rounded to float32 first, as a weak type is
    s = fma_f32(0.3, torch.from_numpy(a), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(
        s, np.asarray(jax.jit(lambda x, z: 0.3 * x + z)(a, c)))


@pytest.mark.parametrize("p", (1, 2, 3, 1024, 1025, 822_118_400,
                               1_644_267_520))
def test_sparse_upload_bits_match_reference(p):
    assert tq.index_bits(p) == jq.index_bits(p)
    k = max(1, p // 20)
    for bits in BITS:
        assert (tq.sparse_upload_bits(p, k, bits, n_radii=2)
                == jq.sparse_upload_bits(p, k, bits, n_radii=2))
