"""The port's wire-kernel dispatch layer (plain path, CPU tensors) against
the reference's Pallas kernels in interpret mode and against the jitted
jnp lowering of the fused pass (``repro.core.wire._fused_leaf_jnp``).

R, codes, delta and q_new are bitwise.  The payload bytes that carry real
codes are bitwise: the Pallas payload is padded to its 4096-element block
with quantized zeros, the port's ends at ceil(n b / 8) bytes with midpoint
pad lanes, the same bytes ``_fused_leaf_jnp`` emits in full.  Moments agree
to rtol 1e-5 (float32 reduction order: block partials vs one reduce).
Sizes stay at a few blocks: interpret mode runs the grid serially.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wire import _fused_leaf_jnp
from repro.kernels import ops as jops
from repro_torch.core.quantize import unpack_codes
from repro_torch.kernels import ops
from torch_threads import one_thread  # noqa: F401

BITS = (1, 2, 4, 8)
CASES = ("two_blocks", "ragged", "zero_radius")


def _operands(case, seed):
    n = {"two_blocks": 4096 * 2, "ragged": 4096 + 1001,
         "zero_radius": 4096 + 3}[case]
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 2.0).astype(np.float32)
    q = g.copy() if case == "zero_radius" else (
        rng.standard_normal(n).astype(np.float32))
    return g, q


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", CASES)
def test_absmax_matches_pallas(case):
    g, q = _operands(case, 0)
    got = ops.absmax(torch.from_numpy(g), torch.from_numpy(q))
    _eq(got.numpy(), jops.absmax(g, q, interpret=True))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_fused_matches_pallas_and_jnp(bits, case):
    g, q = _operands(case, bits)
    n = g.size
    R = jops.absmax(g, q, interpret=True)
    pk, dl, qn, esq, isq = ops.quantize_pack_fused(
        torch.from_numpy(g), torch.from_numpy(q), torch.tensor(np.asarray(R)),
        bits)
    assert pk.numel() == -(-n * bits // 8)

    want = jops.quantize_pack_fused(g, q, R, bits, interpret=True)
    _eq(dl.numpy(), want[1])
    _eq(qn.numpy(), want[2])
    full = n * bits // 8                    # bytes holding only real codes
    _eq(pk[:full].numpy(), np.asarray(want[0])[:full])
    _eq(unpack_codes(pk, bits)[:n].numpy(),
        unpack_codes(torch.from_numpy(np.array(want[0])), bits)[:n].numpy())
    np.testing.assert_allclose(esq.numpy(), want[3], rtol=1e-5)
    np.testing.assert_allclose(isq.numpy(), want[4], rtol=1e-5)

    jd, jqn, jesq, jisq, jpk = jax.jit(
        lambda a, b, r: _fused_leaf_jnp(a, b, r, bits, True))(g, q, R)
    _eq(dl.numpy(), jd)
    _eq(qn.numpy(), jqn)
    _eq(pk.numpy(), jpk)
    np.testing.assert_allclose(esq.numpy(), jesq, rtol=1e-5)
    np.testing.assert_allclose(isq.numpy(), jisq, rtol=1e-5)


def test_wrappers_count_no_cpu_launches():
    before = (ops.absmax.launches, ops.quantize_pack_fused.launches)
    g = torch.ones(10)
    R = ops.absmax(g, torch.zeros(10))
    ops.quantize_pack_fused(g, torch.zeros(10), R, 4)
    assert (ops.absmax.launches, ops.quantize_pack_fused.launches) == before


# --- adaptive pass 2 (kernel 4) -------------------------------------------
# The Pallas payload is provisioned at max(grid) and padded to its block
# with quantized zeros; the port's ends at ceil(n max(grid) / 8) bytes and
# its tail byte's unused lanes carry the selected width's midpoint code
# 2^(b-1), so that a pinned selection is the fixed-width payload.  The
# bytes that hold only real codes are compared, and the real codes in full.

GRIDS = ((2, 4, 8), (2, 4), (4,))
ADAPTIVE_CASES = ("two_blocks", "ragged", "zero_radius")


def _sel_cases():
    return [(grid, sel, case) for grid in GRIDS for sel in range(len(grid))
            for case in ADAPTIVE_CASES]


@pytest.mark.parametrize("grid,sel,case", _sel_cases(),
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_quantize_pack_adaptive_matches_pallas_and_jnp(grid, sel, case):
    from repro.core.adaptive import tau_of_selection
    from repro.core.wire import _fused_leaf_adaptive_jnp

    g, q = _operands(case, 7 * sel + len(grid))
    if case == "ragged":
        g, q = g[:4096 + 1001 - 2], q[:4096 + 1001 - 2]   # odd length
    n, lanes, bits = g.size, max(grid), grid[sel]
    onehot = np.eye(len(grid), dtype=np.float32)[sel]
    R = jops.absmax(g, q, interpret=True)
    tg, tq = torch.from_numpy(g), torch.from_numpy(q)
    tR = torch.tensor(np.asarray(R))
    pk, dl, qn, esq, isq = ops.quantize_pack_adaptive(
        tg, tq, tR, torch.from_numpy(onehot), grid)
    assert pk.numel() == -(-n * lanes // 8)

    want = jops.quantize_pack_adaptive(g, q, R, onehot, grid, interpret=True)
    _eq(dl.numpy(), want[1])
    _eq(qn.numpy(), want[2])
    full = n * lanes // 8
    _eq(pk[:full].numpy(), np.asarray(want[0])[:full])
    codes = unpack_codes(pk, lanes)
    _eq(codes[:n].numpy(),
        unpack_codes(torch.from_numpy(np.array(want[0])), lanes)[:n].numpy())
    assert bool((codes[n:] == 2 ** (bits - 1)).all())      # tail lanes
    np.testing.assert_allclose(esq.numpy(), want[3], rtol=1e-5)
    np.testing.assert_allclose(isq.numpy(), want[4], rtol=1e-5)

    jd, jqn, jesq, jisq, jpk = jax.jit(
        lambda a, b, r, o: _fused_leaf_adaptive_jnp(
            a, b, r, grid, o, tau_of_selection(grid, o), True))(g, q, R,
                                                               onehot)
    _eq(dl.numpy(), jd)
    _eq(qn.numpy(), jqn)
    _eq(pk[:full].numpy(), np.asarray(jpk)[:full])
    np.testing.assert_allclose(esq.numpy(), jesq, rtol=1e-5)
    np.testing.assert_allclose(isq.numpy(), jisq, rtol=1e-5)

    if bits == lanes:       # pinned at the provision width: kernel 2 itself
        fixed = ops.quantize_pack_fused(tg, tq, tR, bits)
        for a, b in zip((pk, dl, qn, esq, isq), fixed):
            _eq(a.numpy(), b.numpy())


@pytest.mark.parametrize("grid,sel", [(g, s) for g in GRIDS
                                      for s in range(len(g))])
def test_pinned_adaptive_selection_is_the_fixed_width_pass(grid, sel):
    g, q = _operands("ragged", 11 + sel)
    tg, tq = torch.from_numpy(g), torch.from_numpy(q)
    R = ops.absmax(tg, tq)
    onehot = torch.eye(len(grid))[sel]
    got = ops.quantize_pack_adaptive(tg, tq, R, onehot, grid)
    fixed = ops.quantize_pack_fused(tg, tq, R, grid[sel])
    for a, b in zip(got[1:], fixed[1:]):
        _eq(a.numpy(), b.numpy())
    _eq(unpack_codes(got[0], max(grid))[:g.size].numpy(),
        unpack_codes(fixed[0], grid[sel])[:g.size].numpy())


# --- sparse quantize + pack (kernel 7) ------------------------------------
# The Pallas payload is padded to its block with quantized zeros; the
# port's ends at ceil(k b / 8) bytes with midpoint codes 2^b / 2 in the tail
# byte's unused lanes, the canonical sparse payload (repro.core.wire
# sparse_roundtrip).  Real payload bytes are compared with both.

SPARSE_CASES = ("spread", "ragged", "lo_eq_hi", "lo_far_below_step")


def _midpoint_survivors():
    """Survivors whose grid products mag * step are float32 midpoints, with
    lo = 1e-30 far below step: lo + mag * step then needs more than 53 bits,
    and rounding it in float64 first and to float32 after would round the
    midpoint to even instead of up."""
    rng = np.random.default_rng(5)
    while True:
        hi = np.float32(rng.uniform(1.0, 2.0))
        lo = np.float32(1e-30)
        step = np.float32(np.float32(hi - lo) * np.float32(1.0 / 127))
        vals = []
        for mag in range(1, 128):
            x = float(step) * mag
            f = np.float32(x)
            if float(f) == x:
                continue
            lo_n = np.nextafter(f, np.float32(-np.inf)) if float(f) > x else f
            hi_n = np.nextafter(lo_n, np.float32(np.inf))
            mid = (float(lo_n) + float(hi_n)) / 2
            even_low = int(np.float32(lo_n).view(np.uint32)) % 2 == 0
            if x == mid and even_low:
                vals.append(x)
        if len(vals) >= 3:
            v = np.array([lo, hi] + vals * 10, dtype=np.float32)
            return v * np.where(np.arange(v.size) % 3 == 0, -1, 1).astype(
                np.float32)


def _sparse_vals(case, seed):
    rng = np.random.default_rng(seed)
    if case == "lo_far_below_step":
        return _midpoint_survivors()
    k = {"spread": 4096 * 2, "ragged": 4096 + 1001, "lo_eq_hi": 4096 + 3}[case]
    v = (rng.standard_normal(k) * 1e-3).astype(np.float32)
    if case == "lo_eq_hi":
        v = np.where(v < 0, -1.0, 1.0).astype(np.float32) * np.float32(2e-3)
    return v


@pytest.mark.parametrize("case", SPARSE_CASES)
@pytest.mark.parametrize("bits", BITS)
def test_sparse_quantize_pack_matches_pallas_and_jit(bits, case):
    from repro.core.compressors import reference_sparse_quantize, sparse_grid
    from repro.core.wire import sparse_roundtrip as jsparse_roundtrip
    from repro_torch.core.compressors import sparse_grid as tsparse_grid

    v = _sparse_vals(case, bits)
    k = v.size
    lo, hi = jax.jit(lambda x: sparse_grid(x, bits))(v)
    tlo, thi = tsparse_grid(torch.from_numpy(v), bits)
    _eq(tlo.numpy(), lo)
    _eq(thi.numpy(), hi)
    if case == "lo_far_below_step" and bits == 8:
        assert float(lo) == np.float32(1e-30)
    pk, codes, deq = ops.sparse_quantize_pack(
        torch.from_numpy(v), torch.tensor(np.asarray(lo)),
        torch.tensor(np.asarray(hi)), bits)
    assert pk.numel() == -(-k * bits // 8)

    wpk, wcodes, wdeq = jops.sparse_quantize_pack(v, lo, hi, bits,
                                                  interpret=True)
    _eq(codes.numpy(), wcodes)
    _eq(deq.numpy(), wdeq)
    full = k * bits // 8
    _eq(pk[:full].numpy(), np.asarray(wpk)[:full])
    jcodes, jdeq = jax.jit(lambda x, a, b: reference_sparse_quantize(
        x, a, b, bits))(v, lo, hi)
    _eq(codes.numpy(), jcodes)
    _eq(deq.numpy(), jdeq)
    # the whole payload, tail lanes included, is the canonical wire's
    want = jax.jit(lambda x: jsparse_roundtrip(
        "reference", {"v": x}, {"v": jnp.zeros_like(x)}, bits, k, "topk",
        with_payload=True).payload)(v)
    _eq(pk.numpy(), want)
    mid = 2 ** bits // 2
    assert bool((unpack_codes(pk, bits)[k:] == mid).all())


def test_sparse_plain_version_rounds_once_where_float64_would_not():
    """The lo-far-below-step input is one where rounding lo + mag * step in
    float64 and then to float32 gives another value than one FMA."""
    from repro_torch.core.compressors import grid_step
    v = torch.from_numpy(_midpoint_survivors())
    a = v.abs()
    lo, hi = a.amin(), a.amax()
    _, codes, deq = ops.sparse_quantize_pack(v, lo, hi, 8)
    mag = (codes & 127).double()
    twice = (mag * grid_step(lo, hi, 8).double() + lo.double()).float()
    assert bool((deq.abs() != twice).any())


def test_adaptive_and_sparse_wrappers_count_no_cpu_launches():
    before = (ops.quantize_pack_adaptive.launches,
              ops.sparse_quantize_pack.launches)
    g = torch.ones(10)
    R = ops.absmax(g, torch.zeros(10))
    ops.quantize_pack_adaptive(g, torch.zeros(10), R, torch.eye(3)[1],
                               (2, 4, 8))
    ops.sparse_quantize_pack(g, R, R, 4)
    assert (ops.quantize_pack_adaptive.launches,
            ops.sparse_quantize_pack.launches) == before
