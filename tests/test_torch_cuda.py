"""The hand-written CUDA wire kernels against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These are small, quick cases (the first call builds the kernels with
``nvcc``); ``chip_smoke.py`` holds the kernels at the model's own leaf
shapes.  R, codes, packed bytes, delta and q_new are bitwise; the moments
agree to rtol 1e-5, because the kernel sums per thread in float64 and the
plain version reduces in float32.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

LENGTHS = {"empty": (0, 0), "one": (1, 0), "seven": (7, 0),
           "ragged": (3 * 4096 + 1239, 0), "unaligned": (100_003, 1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(dev, n, shift, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    g = torch.randn(n + shift, generator=gen, device=dev) * 1e-3
    qh = g + torch.randn(n + shift, generator=gen, device=dev) * 1e-4
    return g[shift:], qh[shift:]        # shift=1: operands off 16-byte alignment


def _check_against_plain(g, qh, bits):
    before = (ops.absmax.launches, ops.quantize_pack_fused.launches)
    R = ops.absmax(g, qh)
    got = ops.quantize_pack_fused(g, qh, R, bits)
    torch.cuda.synchronize()
    assert (ops.absmax.launches, ops.quantize_pack_fused.launches) == (
        before[0] + 1, before[1] + 1)
    R_ref = ref.absmax_ref(g, qh)
    assert torch.equal(R, R_ref) or (R.isnan() and R_ref.isnan())
    want = ref.quantize_pack_fused_ref(g, qh, R, bits)
    for name, a, b in zip(("packed", "delta", "q_new"), got[:3], want[:3]):
        assert a.shape == b.shape and torch.equal(a, b), name
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, equal_nan=True)
    return R, got


@pytest.mark.parametrize("case", LENGTHS)
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_kernels_match_plain_versions(cuda, bits, case):
    n, shift = LENGTHS[case]
    g, qh = _pair(cuda, n, shift, seed=bits * 31 + n)
    _check_against_plain(g, qh, bits)


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_zero_radius_sends_midpoint_codes(cuda, bits):
    g, _ = _pair(cuda, 4096 + 5, 0, seed=bits)
    R, (packed, delta, q_new, _, inn) = _check_against_plain(g, g.clone(), bits)
    assert float(R) == 0.0 and not delta.any() and float(inn) == 0.0
    assert torch.equal(q_new, g)
    mid = 2 ** (bits - 1)
    byte = sum(mid << (bits * j) for j in range(8 // bits))
    assert bool((packed == byte).all())


def test_nan_radius_propagates(cuda):
    g, qh = _pair(cuda, 50_000, 0, seed=3)
    g[12_345] = float("nan")
    R, (_, delta, q_new, err, _) = _check_against_plain(g, qh, 8)
    assert R.isnan() and not delta.any() and err.isnan()
    assert torch.equal(q_new, qh)


def test_non_contiguous_operand_is_refused(cuda):
    g = torch.zeros(64, 2, device=cuda)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        ops.absmax(g, g)


def _adaptive_check(g, qh, grid, sel):
    before = ops.quantize_pack_adaptive.launches
    R = ops.absmax(g, qh)
    onehot = torch.eye(len(grid))[sel]
    got = ops.quantize_pack_adaptive(g, qh, R, onehot, grid)
    torch.cuda.synchronize()
    assert ops.quantize_pack_adaptive.launches == before + 1
    want = ref.quantize_pack_adaptive_ref(g, qh, R, grid, sel)
    for name, a, b in zip(("packed", "delta", "q_new"), got[:3], want[:3]):
        assert a.shape == b.shape and torch.equal(a, b), name
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, equal_nan=True)
    return R, got


@pytest.mark.parametrize("case", LENGTHS)
@pytest.mark.parametrize("grid,sel", [((2, 4, 8), 0), ((2, 4, 8), 1),
                                      ((2, 4, 8), 2), ((2, 4), 0),
                                      ((2, 4), 1), ((4,), 0)])
def test_adaptive_kernel_matches_plain_version(cuda, grid, sel, case):
    n, shift = LENGTHS[case]
    g, qh = _pair(cuda, n, shift, seed=7 * sel + n)
    R, got = _adaptive_check(g, qh, grid, sel)
    fixed = ops.quantize_pack_fused(g, qh, R, grid[sel])
    for a, b in zip(got[1:], fixed[1:]):    # a pinned width is kernel 2
        assert torch.equal(a, b)
    if grid[sel] == max(grid):
        assert torch.equal(got[0], fixed[0])


def test_adaptive_kernel_zero_radius_and_nan(cuda):
    g, _ = _pair(cuda, 4096 + 5, 0, seed=1)
    R, (packed, delta, q_new, _, _) = _adaptive_check(g, g.clone(), (2, 4), 0)
    assert float(R) == 0.0 and not delta.any() and torch.equal(q_new, g)
    assert bool((packed == (2 | 2 << 4)).all())     # midpoint 2 in 4-bit lanes
    g, qh = _pair(cuda, 50_000, 0, seed=3)
    g[777] = float("nan")
    R, (_, delta, q_new, err, _) = _adaptive_check(g, qh, (2, 4, 8), 1)
    assert R.isnan() and not delta.any() and err.isnan()


SPARSE_LENGTHS = {"empty": (0, 0), "seven": (7, 0), "ragged": (3 * 4096 + 1239, 0),
                  "unaligned": (100_003, 1)}


def _sparse_check(v, lo, hi, bits):
    before = ops.sparse_quantize_pack.launches
    got = ops.sparse_quantize_pack(v, lo, hi, bits)
    torch.cuda.synchronize()
    assert ops.sparse_quantize_pack.launches == before + 1
    want = ref.sparse_quantize_pack_ref(v, lo, hi, bits)
    for name, a, b in zip(("packed", "codes", "deq"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    return got


@pytest.mark.parametrize("case", SPARSE_LENGTHS)
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_sparse_kernel_matches_plain_version(cuda, bits, case):
    from repro_torch.core.compressors import sparse_grid
    n, shift = SPARSE_LENGTHS[case]
    v, _ = _pair(cuda, n, shift, seed=bits + n)
    lo, hi = sparse_grid(v, bits)
    _sparse_check(v, lo, hi, bits)


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_sparse_kernel_edge_grids(cuda, bits):
    v, _ = _pair(cuda, 20_000, 0, seed=bits)
    same = torch.where(v < 0, -1.0, 1.0) * 2e-3          # lo == hi
    lo = torch.tensor(2e-3, device=cuda)
    _, codes, deq = _sparse_check(same, lo, lo, bits)
    assert bool((codes & (2 ** (bits - 1) - 1) == 0).all())
    assert torch.equal(deq, same)
    tiny = v.clone()                                     # lo far below step
    tiny[0] = 1e-30
    a = tiny.abs()
    _sparse_check(tiny, a.amin(), a.amax(), bits)
