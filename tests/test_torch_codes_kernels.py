"""The last four wire kernels' plain versions (the port's dispatch layer on
CPU tensors) against the reference: kernel 5 (``quantize_codes_fused``),
kernel 6 (``quantize_codes_adaptive``), kernel 3 (``quantize_pack``) and
kernel 8 (``dequant_acc``), against the Pallas kernels in interpret mode
and the jitted reference expressions; then the wire backends' per-leaf
primitives, receive side and axis codec against the reference's.

Every comparison is bitwise (tolerance 0): codes, delta, packed bytes
(kernel 3's block padding included) and the decoded sums.  The one
exception is where the reference disagrees with itself: with an
accumulator, the Pallas ``dequant_acc`` adds ``acc`` first and the jitted
``dequant_acc_ref`` adds it last, so the fused and reference backends'
``dequant_acc`` agree only to float32 rounding there (rtol 1e-6).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.adaptive import tau_of_selection as jtau_of_selection
from repro.kernels import ops as jops
from repro.kernels.ref import dequant_acc_ref as jdequant_acc_ref
from repro_torch.core import wire as twire
from repro_torch.core.adaptive import tau_of_selection
from repro_torch.kernels import ops
from torch_threads import one_thread  # noqa: F401

BITS = (1, 2, 4, 8)
CASES = ("two_blocks", "ragged", "zero_radius", "odd")
GRID = (2, 4, 8)


def _operands(case, seed):
    n = {"two_blocks": 4096 * 2, "ragged": 4096 + 1001,
         "zero_radius": 4096 + 3, "odd": 77}[case]
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 2.0).astype(np.float32)
    q = g.copy() if case == "zero_radius" else (
        rng.standard_normal(n).astype(np.float32))
    return g, q


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_codes_matches_pallas_and_jit(bits, case):
    """Kernel 5: unpacked codes and delta."""
    g, q = _operands(case, bits)
    R = jops.absmax(g, q, interpret=True)
    codes, delta = ops.quantize_codes_fused(_t(g), _t(q), _t(R), bits)
    wc, wd = jops.quantize_codes_fused(g, q, R, bits, interpret=True)
    _eq(codes.numpy(), wc)
    _eq(delta.numpy(), wd)
    jc, jd = jax.jit(lambda a, b, r: jwire.ReferenceWire().leaf_quantize(
        a, b, r, bits))(g, q, R)
    _eq(codes.numpy(), jc)
    _eq(delta.numpy(), jd)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sel", range(len(GRID)))
def test_quantize_codes_adaptive_matches_pallas_and_jit(sel, case):
    """Kernel 6: kernel 5 at the selected width; a pinned width is kernel 5
    bit for bit."""
    g, q = _operands(case, 20 + sel)
    R = jops.absmax(g, q, interpret=True)
    onehot = np.eye(len(GRID), dtype=np.float32)[sel]
    codes, delta = ops.quantize_codes_adaptive(_t(g), _t(q), _t(R),
                                               _t(onehot), GRID)
    wc, wd = jops.quantize_codes_adaptive(g, q, R, onehot, GRID,
                                          interpret=True)
    _eq(codes.numpy(), wc)
    _eq(delta.numpy(), wd)
    jc, jd = jax.jit(lambda a, b, r, o: jwire.ReferenceWire()
                     .leaf_quantize_adaptive(a, b, r, GRID, o,
                                             jtau_of_selection(GRID, o)))(
        g, q, R, onehot)
    _eq(codes.numpy(), jc)
    _eq(delta.numpy(), jd)
    fixed = ops.quantize_codes_fused(_t(g), _t(q), _t(R), GRID[sel])
    _eq(codes.numpy(), fixed[0].numpy())
    _eq(delta.numpy(), fixed[1].numpy())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_matches_pallas_padding_included(bits, case):
    """Kernel 3: the payload is the Pallas wrapper's, padded to 4096
    elements with the codes of d = 0, byte for byte."""
    g, q = _operands(case, 40 + bits)
    R = jops.absmax(g, q, interpret=True)
    packed, delta = ops.quantize_pack(_t(g), _t(q), _t(R), bits)
    wp, wd = jops.quantize_pack(g, q, R, bits, interpret=True)
    assert packed.numel() == -(-g.size // 4096) * 4096 * bits // 8
    _eq(packed.numpy(), wp)
    _eq(delta.numpy(), wd)


def _payloads(bits, W, n, seed):
    """W payloads of kernel 3 (block-padded), their radii and a random
    accumulator; worker 1's radius is 0."""
    rng = np.random.default_rng(seed)
    packed, radii = [], []
    for w in range(W):
        g = (rng.standard_normal(n) * (w + 1)).astype(np.float32)
        q = g.copy() if w == 1 else rng.standard_normal(n).astype(np.float32)
        R = jops.absmax(g, q, interpret=True)
        packed.append(np.asarray(jops.quantize_pack(g, q, R, bits,
                                                    interpret=True)[0]))
        radii.append(np.float32(R))
    acc = (rng.standard_normal(n) * 3.0).astype(np.float32)
    return np.stack(packed), np.array(radii, np.float32), acc


KEEPS = {1: (1,), 2: (1, 0), 4: (1, 0, 1, 1)}


@pytest.mark.parametrize("W", sorted(KEEPS))
@pytest.mark.parametrize("bits", BITS)
def test_dequant_acc_matches_pallas_with_and_without_acc(bits, W):
    """Kernel 8 in the Pallas kernel's order (acc first, then worker by
    worker), and equal to the jitted reference without acc."""
    n = 4096 * 2 + 1001
    packed, R, acc = _payloads(bits, W, n, seed=bits * 10 + W)
    keep = np.array(KEEPS[W], np.float32)
    for a in (None, acc):
        got = ops.dequant_acc(_t(packed), _t(R), _t(keep), bits, n,
                              None if a is None else _t(a))
        want = jops.dequant_acc(packed, R, keep, bits, n, a, interpret=True)
        _eq(got.numpy(), want)
    got = ops.dequant_acc(_t(packed), _t(R), _t(keep), bits, n)
    _eq(got.numpy(), jax.jit(lambda p, r, k: jdequant_acc_ref(
        p, r, k, bits, n))(packed, R, keep))


def test_dequant_acc_takes_an_unpadded_payload():
    """A payload of exactly ceil(n b / 8) bytes decodes as its padded
    form does."""
    n, bits = 4096 + 77, 4
    packed, R, acc = _payloads(bits, 2, n, seed=3)
    keep = np.ones(2, np.float32)
    short = packed[:, :-(-n * bits // 8)]
    full = ops.dequant_acc(_t(packed), _t(R), _t(keep), bits, n, _t(acc))
    cut = ops.dequant_acc(_t(short), _t(R), _t(keep), bits, n, _t(acc))
    _eq(cut.numpy(), full.numpy())
    with pytest.raises(ValueError, match="fewer than"):
        ops.dequant_acc(_t(short[:, :-1]), _t(R), _t(keep), bits, n)


def _planted():
    """Four workers' payloads whose sum order shows: code 0 decodes to
    exactly -R, every R_w is 2^-24 (half an ulp of 1.0) and acc is -1."""
    bits, n = 8, 6
    R = np.full(4, 2.0 ** -24, np.float32)
    packed = np.zeros((4, 4096), np.uint8)
    keep = np.ones(4, np.float32)
    acc = np.full(n, -1.0, np.float32)
    return packed, R, keep, bits, n, acc


def test_dequant_acc_sum_order_is_the_pallas_kernels_with_planted_values():
    packed, R, keep, bits, n, acc = _planted()
    tt = [_t(x) for x in (packed, R, keep)]
    no_acc = ops.dequant_acc(*tt, bits, n)
    assert float(no_acc[0]) == -(2.0 ** -22)
    _eq(no_acc.numpy(), jops.dequant_acc(packed, R, keep, bits, n,
                                         interpret=True))
    _eq(no_acc.numpy(), jax.jit(lambda p, r, k: jdequant_acc_ref(
        p, r, k, bits, n))(packed, R, keep))
    # acc first: each -2^-24 is half an ulp of -1 and ties back to -1
    fused = ops.dequant_acc(*tt, bits, n, _t(acc))
    assert float(fused[0]) == -1.0
    _eq(fused.numpy(), jops.dequant_acc(packed, R, keep, bits, n, acc,
                                        interpret=True))
    # acc last: -1 + (-2^-22) is exact
    ref = twire.ReferenceWire().dequant_acc(*tt, bits, n, _t(acc))
    assert float(ref[0]) == -1.0 - 2.0 ** -22
    _eq(ref.numpy(), jax.jit(lambda p, r, k, a: jdequant_acc_ref(
        p, r, k, bits, n, a))(packed, R, keep, acc))


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_wire_backends_dequant_acc_match_reference_backends(bits):
    """``FusedWire.dequant_acc`` is kernel 8 (the Pallas order) on either
    device, ``ReferenceWire.dequant_acc`` the reference's order; without
    acc both are bitwise the reference backends', with it the fused one is
    bitwise the Pallas kernel and allclose to the reference backend."""
    n = 4096 + 555
    packed, R, acc = _payloads(bits, 4, n, seed=bits)
    keep = np.array(KEEPS[4], np.float32)
    tt = [_t(x) for x in (packed, R, keep)]
    for name in ("reference", "fused"):
        got = twire.get_backend(name).dequant_acc(*tt, bits, n)
        want = jax.jit(lambda p, r, k: jwire.ReferenceWire().dequant_acc(
            p, r, k, bits, n))(packed, R, keep)
        _eq(got.numpy(), want)
    ref = twire.ReferenceWire().dequant_acc(*tt, bits, n, _t(acc))
    _eq(ref.numpy(), jax.jit(lambda p, r, k, a: jwire.ReferenceWire()
                             .dequant_acc(p, r, k, bits, n, a))(
        packed, R, keep, acc))
    fused = twire.FusedWire().dequant_acc(*tt, bits, n, _t(acc))
    _eq(fused.numpy(), jops.dequant_acc(packed, R, keep, bits, n, acc,
                                        interpret=True))
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


LEAF_SHAPES = {"w": (16, 24), "odd": (5, 3), "b": (40,), "empty": (0, 4)}


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("bits", (2, 4, 8))
def test_leaf_primitives_match_reference_backends(backend, bits):
    """``leaf_absmax``, ``leaf_quantize`` and ``leaf_quantize_adaptive`` of
    both backends against the reference's under jit, leaf-shaped, an empty
    leaf included."""
    rng = np.random.default_rng(bits)
    onehot = np.eye(3, dtype=np.float32)[GRID.index(bits)]
    tb, jb = twire.get_backend(backend), jwire.get_backend(backend)
    for k, s in LEAF_SHAPES.items():
        g = rng.standard_normal(s).astype(np.float32)
        q = rng.standard_normal(s).astype(np.float32)
        R = tb.leaf_absmax(_t(g), _t(q))
        _eq(R.numpy(), jax.jit(jb.leaf_absmax)(g, q))
        codes, delta = tb.leaf_quantize(_t(g), _t(q), R, bits)
        assert codes.shape == delta.shape == s and codes.dtype == torch.uint8
        jc, jd = jax.jit(lambda a, b, r: jb.leaf_quantize(a, b, r, bits))(
            g, q, R.numpy())
        _eq(codes.numpy(), jc)
        _eq(delta.numpy(), jd)
        ac, ad = tb.leaf_quantize_adaptive(
            _t(g), _t(q), R, GRID, _t(onehot),
            tau_of_selection(GRID, _t(onehot)))
        _eq(ac.numpy(), jc)
        _eq(ad.numpy(), jd)


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_axis_codec_and_delta_of_codes_match_reference(bits):
    rng = np.random.default_rng(50 + bits)
    for s in ((16, 24), (5, 3), (40,), (3, 0), (7,)):
        codes = rng.integers(0, 2 ** bits, size=s).astype(np.uint8)
        tc = _t(codes)
        assert twire.axis_packable(tc, bits) == jwire.axis_packable(codes,
                                                                    bits)
        packed = twire.pack_codes_along_axis(tc, bits)
        _eq(packed.numpy(), jax.jit(lambda c: jwire.pack_codes_along_axis(
            c, bits))(codes))
        back = twire.unpack_codes_along_axis(packed, bits, tc)
        _eq(back.numpy(), codes)
        R = np.float32(rng.uniform(0.1, 2.0))
        _eq(twire.delta_of_codes(tc, torch.tensor(R), bits).numpy(),
            jax.jit(lambda c, r: jwire.delta_of_codes(c, r, bits))(codes, R))
    _eq(twire.delta_of_codes(tc, torch.tensor(0.0), bits).numpy(),
        np.zeros(tc.shape, np.float32))


def test_new_wrappers_count_no_cpu_launches():
    before = (ops.quantize_codes_fused.launches,
              ops.quantize_codes_adaptive.launches,
              ops.quantize_pack.launches, ops.dequant_acc.launches)
    g = torch.ones(10)
    R = ops.absmax(g, torch.zeros(10))
    ops.quantize_codes_fused(g, torch.zeros(10), R, 4)
    ops.quantize_codes_adaptive(g, torch.zeros(10), R, torch.eye(3)[0], GRID)
    packed, _ = ops.quantize_pack(g, torch.zeros(10), R, 4)
    ops.dequant_acc(packed[None], R.reshape(1), torch.ones(1), 4, 10)
    assert (ops.quantize_codes_fused.launches,
            ops.quantize_codes_adaptive.launches,
            ops.quantize_pack.launches, ops.dequant_acc.launches) == before
    assert ops.quantize_codes_adaptive.launches_by_width == {}


def test_dequant_acc_refuses_bad_operands():
    p = torch.zeros((2, 8), dtype=torch.uint8)
    ok = torch.ones(2)
    with pytest.raises(TypeError, match="uint8"):
        ops.dequant_acc(p.float(), ok, ok, 4, 16)
    with pytest.raises(ValueError, match="R must be"):
        ops.dequant_acc(p, torch.ones(3), ok, 4, 16)
    with pytest.raises(ValueError, match="acc must be"):
        ops.dequant_acc(p, ok, ok, 4, 16, torch.ones(15))
    with pytest.raises(ValueError, match="bits"):
        ops.dequant_acc(p, ok, ok, 3, 16)
