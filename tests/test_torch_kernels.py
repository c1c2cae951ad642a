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
import numpy as np
import pytest
import torch

from repro.core.wire import _fused_leaf_jnp
from repro.kernels import ops as jops
from repro_torch.core.quantize import unpack_codes
from repro_torch.kernels import ops

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
