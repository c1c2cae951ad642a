"""The port's sparse wire (``repro_torch.core.compressors`` and
``wire.sparse_roundtrip``) against the reference's, run under ``jax.jit``.

The top-k support is identical to ``jax.lax.top_k``'s, NaN first and
ties to the lowest index, indices ascending; so is the rand-k support, drawn with
``repro_torch.random`` from the same key.  Codes, deq, lo/hi (b > 1), q_new, delta and the
payload are bitwise; the two moments agree to rtol 1e-5 (float32 reduction
order).  At b = 1 the grid endpoints are a mean, which torch reduces in
another order than XLA, so b = 1 is held at the kernel level with the
reference's lo/hi passed in (``tests/test_torch_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import wire as jwire
from repro_torch.core import compressors as tcomp
from repro_torch.core import wire as twire
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

SHAPES = {"w": (65, 33), "b": (4096 + 7,), "empty": (0, 4), "s": ()}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("frac,p", [(0.05, 1_644_267_520), (0.05, 822_118_400),
                                    (0.25, 10), (0.0, 7), (1.0, 7),
                                    (0.5, 5), (0.5, 7), (0.125, 4)])
def test_static_k_matches_reference(frac, p):
    assert tcomp.static_k(frac, p) == jcomp.static_k(frac, p)
    assert tcomp.static_k(0.05, 1_644_267_520) == 82_213_376


def _planted_ties(seed):
    """Magnitudes with many ties at the k-th largest value, both signs."""
    rng = np.random.default_rng(seed)
    mags = rng.choice(np.array([0.5, 1.0, 1.5, 3.0], np.float32), 5003)
    mags[rng.choice(5003, 40, replace=False)] = 0.0
    sign = np.where(rng.random(5003) < 0.5, -1.0, 1.0).astype(np.float32)
    return mags * sign


@pytest.mark.parametrize("k", [1, 700, 1251, 2500, 4999, 5003, 0])
def test_topk_support_breaks_ties_like_jax(k):
    flat = _planted_ties(k)
    got = tcomp.select_support("topk", torch.from_numpy(flat), k)
    want = jax.jit(lambda x: jcomp.select_support("topk", x, k))(flat)
    _eq(got.idx.numpy(), want.idx)
    _eq(got.vals.numpy(), want.vals)
    if 0 < k < flat.size:                 # ties at the k-th value were cut
        kth = np.sort(np.abs(flat))[::-1][k - 1]
        assert (np.abs(flat) == kth).sum() > (np.abs(got.vals.numpy())
                                              == kth).sum()


def _planted_nan(k):
    """The tie-heavy magnitudes with NaN (both signs) and +-inf planted:
    two NaNs at k = 1 (more than the places), 5 NaNs and 3 infinities
    otherwise."""
    flat = _planted_ties(k)
    nans = [17, 3] if k == 1 else [17, 3, 4001, 2500, 4998]
    for i, j in enumerate(nans):
        flat[j] = np.float32(np.nan) if i % 2 else -np.float32(np.nan)
    if k > 1:
        flat[[9, 1200, 4990]] = [np.inf, -np.inf, np.inf]
    return flat


@pytest.mark.parametrize("k", [1, 700, 4999])
def test_topk_support_refuses_a_nan_innovation(k):
    """A NaN innovation is not refused: the support is the reference's,
    NaN first (lowest index first, as ``jax.lax.top_k`` ranks NaN above
    +inf), then the largest |d| with ties to the lowest index."""
    flat = _planted_nan(k)
    got = tcomp.select_support("topk", torch.from_numpy(flat), k)
    want = jax.jit(lambda x: jcomp.select_support("topk", x, k))(flat)
    _eq(got.idx.numpy(), want.idx)
    _eq(np.isnan(got.vals.numpy()), np.isnan(want.vals))
    ok = ~np.isnan(np.asarray(want.vals))
    _eq(got.vals.numpy()[ok], np.asarray(want.vals)[ok])
    assert np.isnan(got.vals.numpy()).sum() == min(k, 2 if k == 1 else 5)


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
@pytest.mark.parametrize("vals", (
    [1.0, -2.0, np.nan, 0.5], [1.0, -2.0, np.inf, 0.5],
    [1.0, -np.inf, np.inf, -0.5], [np.nan, -np.nan], [-0.0, 0.0, 3.0]),
    ids=["nan", "inf", "both_infs", "all_nan", "zeros"])
def test_sparse_grid_and_codes_on_nan_and_inf_survivors(bits, vals):
    """The grid on survivors that hold NaN or +-inf, where the step is NaN
    or infinite: the jitted reference's mag is 0 there (XLA converts a NaN
    to the integer 0), so the codes carry only the sign bit and deq is
    NaN; both packages agree on codes bitwise, on lo/hi and deq bitwise
    or NaN alike."""
    v = np.array(vals, np.float32)
    lo, hi = tcomp.sparse_grid(torch.from_numpy(v), bits)
    codes, deq = tcomp.reference_sparse_quantize(torch.from_numpy(v), lo,
                                                 hi, bits)

    def ref(x):
        a, b = jcomp.sparse_grid(x, bits)
        return (a, b) + jcomp.reference_sparse_quantize(x, a, b, bits)

    wlo, whi, wcodes, wdeq = jax.jit(ref)(v)
    _eq(codes.numpy(), wcodes)
    for got, want in ((lo, wlo), (hi, whi), (deq, wdeq)):
        got, want = got.numpy(), np.asarray(want)
        _eq(np.isnan(got), np.isnan(want))
        _eq(got[~np.isnan(want)], want[~np.isnan(want)])


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_sparse_grid_matches_reference(bits):
    v = (np.random.default_rng(bits).standard_normal(3001) * 1e-2).astype(
        np.float32)
    lo, hi = tcomp.sparse_grid(torch.from_numpy(v), bits)
    wlo, whi = jax.jit(lambda x: jcomp.sparse_grid(x, bits))(v)
    _eq(lo.numpy(), wlo)
    _eq(hi.numpy(), whi)
    z = tcomp.sparse_grid(torch.zeros(0), bits)
    assert float(z[0]) == float(z[1]) == 0.0


@pytest.mark.parametrize("k", (1, 31, 32, 33, 196, 1025, 3001, 40000))
def test_b1_grid_mean_is_xla_cpus_sum(k):
    """The b=1 grid's mean |v| equals the jitted reference's bit for bit:
    XLA's CPU reduction order (windows of 32, padded on both sides, the
    partial sums reduced again) at lengths under, at and over one and two
    windows, survivors spread over six decades, both vmapped over workers
    (the engine's form) and alone."""
    rng = np.random.default_rng(k)
    v = (rng.standard_normal((3, k))
         * np.exp(rng.uniform(-7, 7, (3, k)))).astype(np.float32)
    want = jax.jit(jax.vmap(lambda x: jcomp.sparse_grid(x, 1)[0]))(v)
    for m in range(3):
        lo, hi = tcomp.sparse_grid(torch.from_numpy(v[m]), 1)
        _eq(lo.numpy(), want[m])
        _eq(hi.numpy(), want[m])
    _eq(tcomp.xla_cpu_sum(torch.from_numpy(np.abs(v[0]))).numpy(),
        jax.jit(jnp.sum)(np.abs(v[0])))


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_sparse_dequantize_inverts_the_code_map(bits):
    v = (np.random.default_rng(bits).standard_normal(2001)).astype(np.float32)
    lo, hi = jax.jit(lambda x: jcomp.sparse_grid(x, bits))(v)
    tlo, thi = torch.tensor(np.asarray(lo)), torch.tensor(np.asarray(hi))
    codes, deq = tcomp.reference_sparse_quantize(torch.from_numpy(v), tlo,
                                                 thi, bits)
    got = tcomp.sparse_dequantize(codes, tlo, thi, bits)
    _eq(got.numpy(), deq.numpy())
    want = jax.jit(lambda c, a, b: jcomp.sparse_dequantize(c, a, b, bits))(
        codes.numpy(), lo, hi)
    _eq(got.numpy(), want)


def _trees(seed):
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
         for i, (k, s) in enumerate(SHAPES.items())}
    q = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    to_t = lambda t: {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
    return g, q, to_t(g), to_t(q)


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("frac", (0.05, 0.5))
@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_sparse_roundtrip_matches_reference(backend, frac, bits):
    g, q, tg, tq = _trees(bits)
    p = sum(int(np.prod(s)) for s in SHAPES.values())
    k = jcomp.static_k(frac, p)
    jb = jwire.get_backend(backend)
    want = jax.jit(lambda a, b: jwire.sparse_roundtrip(
        jb, a, b, bits, k, "topk", with_payload=True))(g, q)
    got = twire.sparse_roundtrip(backend, tg, tq, bits, k, "topk",
                                 with_payload=True)
    for field in ("q_new", "delta"):
        w_leaves = jax.tree.leaves(getattr(want, field))
        g_leaves = tree_leaves(getattr(got, field))
        assert len(w_leaves) == len(g_leaves) == len(SHAPES)
        for w, t in zip(w_leaves, g_leaves):
            assert tuple(t.shape) == w.shape
            _eq(t.numpy(), w)
    for field in ("lo", "R", "idx", "codes", "payload"):
        _eq(getattr(got, field).numpy(), getattr(want, field))
    for field in ("err_sq", "innovation_sq"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(want, field), rtol=1e-5)
    # the inputs are left as they were (the roundtrip works on flat copies)
    for k_, v in g.items():
        _eq(tg[k_].numpy(), v)


@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_sparse_roundtrip_reads_a_bf16_qhat_as_float32(backend):
    """Under ``state_bf16`` ``qhat`` is bfloat16: the roundtrip's flat
    copy of it is float32, so ``q_new = f32(qhat) + delta`` is not
    rounded into bf16; q_new, delta, the support and the codes equal the
    jitted reference's bit for bit."""
    g, q, tg, _ = _trees(5)
    q16 = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in q.items()}
    tq16 = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(
        torch.bfloat16) for k, v in q16.items()}
    p = sum(int(np.prod(s)) for s in SHAPES.values())
    k = jcomp.static_k(0.25, p)
    want = jax.jit(lambda a, b: jwire.sparse_roundtrip(
        jwire.get_backend(backend), a, b, 4, k, "topk"))(g, q16)
    got = twire.sparse_roundtrip(backend, tg, tq16, 4, k, "topk")
    for field in ("q_new", "delta"):
        for w, t in zip(jax.tree.leaves(getattr(want, field)),
                        tree_leaves(getattr(got, field))):
            assert t.dtype == torch.float32 and w.dtype == jnp.float32
            _eq(t.numpy(), w)
    for field in ("idx", "codes"):
        _eq(getattr(got, field).numpy(), getattr(want, field))


def test_randk_names_rng_parity():
    """rand-k is ported with RNG parity: it needs its selection key, as the
    reference does, and the strategy lets it through."""
    with pytest.raises(ValueError, match="selection key"):
        tcomp.select_support("randk", torch.ones(10), 3)
    from repro_torch.core.strategy import StrategyConfig, check_supported
    check_supported(StrategyConfig(compressor="randk", error_feedback=True))
    with pytest.raises(ValueError, match="unknown sparsifier"):
        tcomp.select_support("bottomk", torch.ones(10), 3)


def test_error_state_is_gated_per_worker():
    template = {"a": torch.ones(3, 2), "b": torch.ones(4)}
    assert tcomp.init_error_state(False, template, 3).residual is None
    res = tcomp.init_error_state(True, template, 3).residual
    assert len(res) == 3 and res[0] is not res[1]
    assert all(float(l.abs().sum()) == 0.0 for r in res for l in tree_leaves(r))
    assert tcomp.empty_error_state() == tcomp.ErrorState(None)
    flat, meta = tcomp._flat(template)
    back = tcomp._unflat(flat, meta)
    assert back["a"].data_ptr() == flat.data_ptr()      # views, no copy
    assert flat.data_ptr() != template["a"].data_ptr()


def _tkey(seed, step=0):
    from repro_torch import random
    return random.fold_in(random.PRNGKey(seed, device="cpu"), step)


def _jkey(seed, step=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


@pytest.mark.parametrize("k", [1, 700, 2500, 4999, 5003, 0])
@pytest.mark.parametrize("p", [5003, 1 << 16])
def test_randk_support_matches_reference(k, p):
    """The k largest of p uniform scores; at p = 2^16 the scores tie (a
    float32 uniform has 2^23 values), and the ties go to the lowest index
    as in ``jax.lax.top_k``."""
    flat = np.random.default_rng(k).standard_normal(p).astype(np.float32)
    got = tcomp.select_support("randk", torch.from_numpy(flat), k,
                               _tkey(k, 3))
    want = jax.jit(lambda x, key: jcomp.select_support("randk", x, k, key))(
        flat, _jkey(k, 3))
    _eq(got.idx.numpy(), want.idx)
    _eq(got.vals.numpy(), want.vals)


def test_compressor_keys_match_reference():
    got = tcomp.compressor_keys(5, 11, 4, device="cpu")
    want = jcomp.compressor_keys(5, 11, 4)
    _eq(got.numpy(), np.asarray(want).astype(np.int64))


def _grad_tree(seed, integers):
    """Leaves of both signs; ``integers`` makes every value a small
    integer, so the norm and the |v| sum are exact in float32 in any
    order, and the outputs can be held bitwise."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (37, 5), "b": (123,), "c": (4, 4, 3)}
    if integers:
        return {n: rng.integers(-9, 10, s).astype(np.float32)
                for n, s in shapes.items()}
    return {n: (rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 2)).astype(
        np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("integers", (True, False), ids=("exact", "float"))
@pytest.mark.parametrize("bits", (2, 3, 4, 8))
def test_qsgd_matches_reference(bits, integers):
    """Same key, same levels: bitwise where the norm is exact; otherwise
    the norm is a float32 sum of squares in another order, and the
    outputs agree to rtol 1e-6 (a few ulps of the norm).  ``* norm / s``
    is XLA's ``* norm * f32(1/s)`` in both cases."""
    for seed in range(4):
        g = _grad_tree(seed, integers)
        want, wbits = jax.jit(lambda k, g: jcomp.qsgd_compress(k, g, bits))(
            _jkey(seed), g)
        got, tbits = tcomp.qsgd_compress(
            _tkey(seed), {n: torch.from_numpy(v) for n, v in g.items()}, bits)
        assert float(tbits) == float(wbits)
        for n in g:
            if integers:
                _eq(got[n].numpy(), want[n])
            else:
                np.testing.assert_allclose(got[n].numpy(), want[n],
                                           rtol=1e-6, atol=0)


@pytest.mark.parametrize("integers", (True, False), ids=("exact", "float"))
@pytest.mark.parametrize("density", (0.05, 0.1, 0.5, 1.0))
def test_ssgd_matches_reference(density, integers):
    """Same key, same survivors: the wire bits are exact; the rescaled
    survivors bitwise where the |v| sum is exact, else to rtol 1e-6."""
    for seed in range(4):
        g = _grad_tree(seed, integers)
        want, wbits = jax.jit(lambda k, g: jcomp.ssgd_compress(
            k, g, density))(_jkey(seed), g)
        got, tbits = tcomp.ssgd_compress(
            _tkey(seed), {n: torch.from_numpy(v) for n, v in g.items()},
            density)
        assert float(tbits) == float(wbits)
        for n in g:
            _eq(got[n].numpy() != 0, np.asarray(want[n]) != 0)
            if integers:
                _eq(got[n].numpy(), want[n])
            else:
                np.testing.assert_allclose(got[n].numpy(), want[n],
                                           rtol=1e-6, atol=0)


def test_dense_baselines_of_a_zero_gradient():
    z = {"w": torch.zeros(5, 3)}
    out, bits = tcomp.qsgd_compress(_tkey(0), z, 4)
    assert float(out["w"].abs().sum()) == 0 and float(bits) == 32 + 5 * 15
    out, bits = tcomp.ssgd_compress(_tkey(0), z, 0.5)
    assert float(out["w"].abs().sum()) == 0 and float(bits) == 0
