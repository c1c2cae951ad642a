"""``repro_torch.random`` against ``jax.random``, bit for bit, in both
threefry layouts (partitionable, the default since jax 0.5, and legacy),
eager and jitted.

Keys, ``fold_in``, ``split``, the 32-bit draws and ``permutation`` are
integers and must be equal.  ``uniform`` and ``normal`` are compared by
their float32 bit patterns; ``normal``'s ``erf_inv`` and ``log1p`` also on
dense grids against XLA's jitted ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as R
from torch_threads import one_thread  # noqa: F401

SEEDS = (0, 2, 12345, 2**31 - 1, 2**32 + 7, -3)
SHAPES = ((), (0,), (1,), (7,), (8,), (3, 5))
LAYOUTS = (True, False)
SPANS = ((0, 12), (0, 16), (3, 10), (5, 5), (7, 2), (-5, 2**31 - 1),
         (-2**31, 2**31 - 1))


# jitted once per static shape (the layout is part of jit's cache key)
_j_uniform = jax.jit(jax.random.uniform, static_argnums=(1,))
_j_randint = jax.jit(jax.random.randint, static_argnums=(1,))
_j_bernoulli = jax.jit(jax.random.bernoulli, static_argnums=(2,))
_j_log1p = jax.jit(jnp.log1p)
_j_erf_inv = jax.jit(jax.lax.erf_inv)
_j_normal_of_u = jax.jit(lambda u: np.float32(np.sqrt(2)) * jax.lax.erf_inv(u))


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


def test_lm_batches_match_the_reference(layout):
    """``data.synthetic.lm_batches``: the first 3 batches of the infinite
    iterator equal the reference's, tokens and targets (int32 there, int64
    here), in both layouts."""
    from repro.data import synthetic as jsyn
    from repro_torch.data.synthetic import lm_batches
    got = lm_batches(3, 4, 16, 500, device="cpu")
    want = jsyn.lm_batches(3, 4, 16, 500)
    for _ in range(3):
        g, w = next(got), next(want)
        for k in ("tokens", "targets"):
            assert g[k].dtype == torch.int64 and g[k].shape == (4, 16)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# float32 edge values: both ends of erf_inv's domain, +-0, subnormals, the
# smallest normals, tiny normals whose square is subnormal, and the
# endpoints of the normal draw's uniform, [nextafter(-1, 0), 1)
_EDGES = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38,
                   1.17549435e-38, -1.17549435e-38, 1.2e-38, 1e-37, 1e-20,
                   3e-20, 1e-19, 2.0 ** -24, -(2.0 ** -24), 0.5, -0.5,
                   np.nextafter(np.float32(-1), np.float32(0)), -1.0, 1.0,
                   np.nextafter(np.float32(1), np.float32(0))],
                  dtype=np.float32)


def _grid(lo, hi, n=200_001):
    """A dense float32 grid of [lo, hi] with the edge values that lie in it."""
    g = np.linspace(lo, hi, n, dtype=np.float32)
    return np.concatenate([g, _EDGES[(_EDGES >= lo) & (_EDGES <= hi)]])


@pytest.mark.parametrize("lo,hi", ((-1.0, 1.0), (-0.42, -0.40), (-1.0, -0.99),
                                   (-1e-3, 1e-3), (1.0, 1e30)), ids=str)
def test_log1p_is_xlas_cpu_log1p(lo, hi):
    """``_log1p`` on a dense grid, both branches and their border at
    sqrt(2) - 1, the logf branch's mantissa split, t = 1 + x at 0, and +inf,
    against jitted ``jnp.log1p``, bit for bit."""
    x = np.concatenate([_grid(lo, hi), np.float32([np.inf])]
                       if hi > 1 else [_grid(lo, hi)])
    np.testing.assert_array_equal(_bits(R._log1p(torch.from_numpy(x))),
                                  _bits(_j_log1p(x)))


@pytest.mark.parametrize("lo,hi", ((-1.0, 1.0), (0.99, 1.0), (-1.0, -0.999),
                                   (-1e-2, 1e-2)), ids=str)
def test_erf_inv_is_xlas_cpu_erf_inv(lo, hi):
    """``_erf_inv`` (both of chlo's branches, w < 5 and sqrt(w) - 3) and the
    product with f32(sqrt(2)) that ``normal`` takes, against the jitted
    ops, bit for bit, ends, +-0 and subnormals included."""
    u = torch.from_numpy(_grid(lo, hi))
    np.testing.assert_array_equal(_bits(R._erf_inv(u)),
                                  _bits(_j_erf_inv(u.numpy())))
    np.testing.assert_array_equal(_bits(R._ftz(R._erf_inv(u) * R._SQRT2_F32)),
                                  _bits(_j_normal_of_u(u.numpy())))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal(layout, seed, shape):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    got = R.normal(tk, shape)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax.random.normal(jk, shape)))


def test_normal_of_a_large_draw(layout):
    """200,001 draws (an odd count, so the legacy layout pads its halves)."""
    jk, tk = jax.random.PRNGKey(5), _key(5)
    np.testing.assert_array_equal(_bits(R.normal(tk, (200_001,))),
                                  _bits(jax.random.normal(jk, (200_001,))))


def test_uniform_on_an_interval(layout):
    """``uniform`` with bounds: ``floats * (maxval - minval) + minval`` as one
    FMA, then the max with minval, as the jitted reference."""
    jk, tk = jax.random.PRNGKey(11), _key(11)
    for lo, hi in ((-0.99999994, 1.0), (-3.0, 7.0), (0.1, 0.3), (2.5, 2.5)):
        np.testing.assert_array_equal(
            _bits(R.uniform(tk, (4097,), minval=lo, maxval=hi)),
            _bits(jax.random.uniform(jk, (4097,), minval=lo, maxval=hi)))


# sizes of 0 and 1 shuffle rounds (up to 1625) and of 2 (1626 on)
@pytest.mark.parametrize("n", (0, 1, 2, 7, 600, 1625, 1626, 4001))
@pytest.mark.parametrize("seed", (0, 3, 2**31 - 1))
def test_permutation(layout, seed, n):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    got = R.permutation(tk, n)
    assert got.dtype == torch.int64 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.permutation(jk, n)))


def test_permutation_rounds():
    """The reference's round count, ceil(3 ln n / ln(2^32 - 1)): 0 rounds
    leave arange(n) as it is; 1626 is the first size with two."""
    import math
    rounds = [math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
              for n in (0, 1, 2, 1625, 1626)]
    assert rounds == [0, 0, 1, 1, 2]
    assert R.permutation(_key(0), 1).tolist() == [0]


def test_tensor_hash_path_of_small_draws(layout, monkeypatch):
    """A key on the card hashes with int64 tensor operations, not numpy's
    uint32; that path, forced here on the CPU, gives the reference's bits
    for keys, integers, floats and a shuffle."""
    monkeypatch.setattr(R, "_counters", lambda key, n: torch.arange(
        n, dtype=torch.int64, device=key.device))
    jk, tk = jax.random.PRNGKey(7), _key(7)
    np.testing.assert_array_equal(R.fold_in(tk, 2**32 - 1).numpy(),
                                  _u32(jax.random.fold_in(jk, 2**32 - 1)))
    for num in (1, 3):
        np.testing.assert_array_equal(R.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))
    np.testing.assert_array_equal(R.randint(tk, (7,), -5, 2**31 - 1).numpy(),
                                  np.asarray(_j_randint(jk, (7,), -5,
                                                        2**31 - 1)))
    np.testing.assert_array_equal(_bits(R.normal(tk, (3, 5))),
                                  _bits(jax.random.normal(jk, (3, 5))))
    np.testing.assert_array_equal(R.permutation(tk, 600).numpy(),
                                  np.asarray(jax.random.permutation(jk, 600)))
