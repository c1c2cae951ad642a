"""``repro_torch.random`` against ``jax.random``, bit for bit, in both
threefry layouts (partitionable, the default since jax 0.5, and legacy),
eager and jitted.

Keys, ``fold_in``, ``split`` and the 32-bit draws are integers and must be
equal.  ``uniform`` is compared by its float32 bit patterns: it is integer
work plus an exact subtraction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as R

SEEDS = (0, 2, 12345, 2**31 - 1, 2**32 + 7, -3)
SHAPES = ((), (0,), (1,), (7,), (8,), (3, 5))
LAYOUTS = (True, False)
SPANS = ((0, 12), (0, 16), (3, 10), (5, 5), (7, 2), (-5, 2**31 - 1),
         (-2**31, 2**31 - 1))


# jitted once per static shape (the layout is part of jit's cache key)
_j_uniform = jax.jit(jax.random.uniform, static_argnums=(1,))
_j_randint = jax.jit(jax.random.randint, static_argnums=(1,))
_j_bernoulli = jax.jit(jax.random.bernoulli, static_argnums=(2,))


def _key(seed):
    return R.PRNGKey(seed, device="cpu")


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.fixture(params=LAYOUTS, ids=("partitionable", "legacy"))
def layout(request):
    with jax.threefry_partitionable(request.param), \
            R.threefry_partitionable(request.param):
        yield request.param


def test_default_layout_is_partitionable():
    k = _key(2)
    default = R.split(k)
    with R.threefry_partitionable(False):
        assert not torch.equal(R.split(k), default)
    with R.threefry_partitionable(True):
        assert torch.equal(R.split(k), default)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split(layout, seed):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    for d in (0, 1, 3, 1000, 2**32 - 1):
        np.testing.assert_array_equal(R.fold_in(tk, d).numpy(),
                                      _u32(jax.random.fold_in(jk, d)))
    for num in (1, 2, 3, 5):
        np.testing.assert_array_equal(R.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))


def test_layouts_differ_where_jax_says():
    """``fold_in`` is the same in both layouts; ``split`` is not (the
    values are jax 0.9's for ``PRNGKey(2)``)."""
    k = _key(2)
    with R.threefry_partitionable(True):
        part, fold_p = R.split(k)[1].tolist(), R.fold_in(k, 3).tolist()
    with R.threefry_partitionable(False):
        legacy, fold_l = R.split(k)[1].tolist(), R.fold_in(k, 3).tolist()
    assert part == [637334850, 3278974502]
    assert legacy == [2425776485, 230565590]
    assert fold_p == fold_l


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(layout, seed, shape):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    got = R.uniform(tk, shape)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(_j_uniform(jk, shape)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("span", SPANS, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(layout, seed, span):
    """Spans that are and are not powers of two, minval > 0, maxval <=
    minval (always minval) and spans near 2^32, where the uint32 products
    of the reference wrap."""
    lo, hi = span
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    for shape in SHAPES:
        got = R.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(_j_randint(jk, shape, lo, hi)))
    np.testing.assert_array_equal(
        R.randint(tk, (7,), lo, hi).numpy(),
        np.asarray(jax.random.randint(jk, (7,), lo, hi)))


@pytest.mark.parametrize("p", (0.0, 0.5, 0.9))
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli(layout, seed, p):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    for shape in SHAPES:
        got = R.bernoulli(tk, p, shape)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(_j_bernoulli(jk, p, shape)))
    probs = np.array([0.1, 0.5, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(
        R.bernoulli(tk, torch.from_numpy(probs)).numpy(),
        np.asarray(jax.random.bernoulli(jk, jnp.asarray(probs))))


def test_random_bits_of_a_large_draw(layout):
    """A draw long enough that the legacy layout's two halves and the
    partitionable counters both matter: 2^20 + 3 words."""
    jk, tk = jax.random.PRNGKey(9), _key(9)
    n = (1 << 20) + 3
    want = jax.jit(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk)
    np.testing.assert_array_equal(R.random_bits(tk, (n,)).numpy(),
                                  _u32(want))


def test_minibatch_stream_keys_match_the_reference():
    """The engine's index stream: ``fold_in`` of (seed, stream, round,
    worker), then ``randint`` (the reference's MinibatchSource)."""
    key0 = _key(4)
    for step in (0, 1, 17):
        ks = R.fold_in(R.fold_in(key0, 0), step)
        jks = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(4), 0),
                                 step)
        for m in range(3):
            got = R.randint(R.fold_in(ks, m), (5,), 0, 12)
            want = jax.random.randint(jax.random.fold_in(jks, m), (5,), 0, 12)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
