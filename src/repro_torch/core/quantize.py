"""Gradient-innovation quantizer (paper eq. 5-6), port of
``repro/core/quantize.py``.

The innovation ``g - q_hat`` is quantized onto a uniform b-bit grid whose
radius is its infinity norm ``R``; the wire cost of one upload is
``32 * n_radii + b * p`` bits.  Byte layout: ``docs/wire-format.md``.

Bit-identity with the JAX reference (which always runs under ``jit``):

* ``2 tau R`` folds ``2 * tau`` in double and rounds it once to float32,
  as JAX's weak-typed Python floats do, then multiplies by ``R`` in f32.
* XLA contracts the dequantization ``2 tau R * q - R`` into one fused
  multiply-add, so the port rounds ``delta`` once as well.  Here that is
  done in float64 and rounded to f32: ``f32(2 tau R) * q`` (q < 256) and
  the subtraction of ``R`` span fewer than 53 bits, so the double result is
  exact and its one rounding equals the FMA's.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

F32 = torch.float32


def tree_inf_norm(tree) -> torch.Tensor:
    """Global infinity norm over a pytree (the paper's ``R_m^k``)."""
    leaves = [l for l in tree_leaves(tree) if l.numel()]
    if not leaves:
        return torch.zeros((), dtype=F32)
    return torch.stack([l.abs().amax().to(F32) for l in leaves]).amax()


def tree_sq_norm(tree) -> torch.Tensor:
    """Global squared L2 norm over a pytree."""
    leaves = [l for l in tree_leaves(tree) if l.numel()]
    if not leaves:
        return torch.zeros((), dtype=F32)
    return torch.stack([l.to(F32).square().sum() for l in leaves]).sum()


def tree_size(tree) -> int:
    """Total number of coordinates p."""
    return sum(l.numel() for l in tree_leaves(tree))


def tau(bits: int) -> float:
    """Quantization granularity tau = 1/(2^b - 1)."""
    return 1.0 / (2.0**bits - 1.0)


def two_tau_f32(bits: int, device=None) -> torch.Tensor:
    """``f32(2 tau)``: folded in double, rounded once."""
    return torch.tensor(2.0 * tau(bits), dtype=F32, device=device)


def _leaf_radius(d: torch.Tensor) -> torch.Tensor:
    if not d.numel():
        return torch.zeros((), dtype=F32, device=d.device)
    return d.abs().amax().to(F32)


def innovation(grad, qhat, per_leaf: bool = False):
    """``(diff, R_tree, R_max)`` for the innovation ``grad - qhat``."""
    diff = tree_map(lambda g, q: g.to(F32) - q.to(F32), grad, qhat)
    if per_leaf:
        R_tree = tree_map(_leaf_radius, diff)
    else:
        R = tree_inf_norm(diff)
        R_tree = tree_map(lambda _: R, diff)
    R_max = torch.stack(tree_leaves(R_tree)).amax()
    return diff, R_tree, R_max


def quantize_codes(d: torch.Tensor, R: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes ``clip(floor((d + R) / (2 tau R) + 1/2), 0, 2^b - 1)`` as uint8;
    ``R == 0`` gives the midpoint code (it dequantizes to 0)."""
    levels = 2**bits - 1
    live = R > 0
    denom = torch.where(live, two_tau_f32(bits, R.device) * R,
                        torch.ones_like(R))
    q = torch.floor((d + R) / denom + 0.5).clamp(0, levels)
    q = torch.where(live, q, torch.full_like(q, (levels + 1) // 2))
    return q.to(torch.uint8)


def dequantize_leaf(q: torch.Tensor, R: torch.Tensor, bits: int) -> torch.Tensor:
    """``delta = 2 tau R q - R`` rounded once (see the module docstring);
    0 where ``R == 0``."""
    denom = two_tau_f32(bits, R.device) * R
    d = (denom.double() * q.double() - R.double()).to(F32)
    return torch.where(R > 0, d, torch.zeros_like(d))


def quantize_innovation(grad, qhat, bits: int, per_leaf: bool = False):
    """``(qints, R_tree)``: per-leaf uint8 codes and per-leaf radii."""
    diff, R_tree, _ = innovation(grad, qhat, per_leaf)
    qints = tree_map(lambda d, R: quantize_codes(d, R, bits), diff, R_tree)
    return qints, R_tree


def dequantize_innovation(qints, R_tree, bits: int):
    """Inverse map ``delta_i = 2 tau R q_i - R`` (paper eq. 6)."""
    return tree_map(lambda q, R: dequantize_leaf(q, R, bits), qints, R_tree)


def roundtrip_parts(grad, qhat, bits: int, per_leaf: bool = False):
    """``(qints, R_tree, delta, q_new, R_max, err_sq)``: the whole roundtrip
    with every intermediate, the reference wire's single source."""
    qints, R_tree = quantize_innovation(grad, qhat, bits, per_leaf)
    delta = dequantize_innovation(qints, R_tree, bits)
    q_new = tree_map(lambda q, d: q.to(F32) + d, qhat, delta)
    err_sq = tree_sq_norm(tree_map(lambda g, qn: g.to(F32) - qn, grad, q_new))
    R_max = torch.stack(tree_leaves(R_tree)).amax()
    return qints, R_tree, delta, q_new, R_max, err_sq


# ---------------------------------------------------------------------------
# Bit packing: code i lands in byte i // (8/b) at bit offset b * (i % (8/b)).
# ---------------------------------------------------------------------------

PACKABLE_BITS = (1, 2, 4, 8)


def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack a flat uint8 vector of b-bit codes, 8/b per byte (length a
    multiple of 8/b: pad upstream)."""
    if bits not in PACKABLE_BITS:
        raise ValueError(f"bits must be one of {PACKABLE_BITS}, got {bits}")
    cpb = 8 // bits
    q = q.to(torch.uint8)
    if cpb == 1:
        return q
    lanes = q.reshape(-1, cpb)
    acc = lanes[:, 0].clone()
    for j in range(1, cpb):
        acc |= lanes[:, j] << (bits * j)
    return acc


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: the flat uint8 code vector."""
    if bits not in PACKABLE_BITS:
        raise ValueError(f"bits must be one of {PACKABLE_BITS}, got {bits}")
    cpb = 8 // bits
    if cpb == 1:
        return packed.to(torch.uint8)
    shifts = torch.arange(cpb, dtype=torch.uint8, device=packed.device) * bits
    lanes = (packed.reshape(-1, 1) >> shifts[None, :]) & ((1 << bits) - 1)
    return lanes.reshape(-1)


def pad_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pad a flat code vector to whole bytes with the midpoint code
    (``docs/wire-format.md``, padding)."""
    pad = (-q.numel()) % (8 // bits)
    if not pad:
        return q
    mid = torch.full((pad,), 2**bits // 2, dtype=torch.uint8, device=q.device)
    return torch.cat([q.reshape(-1), mid])


def upload_bits(p: int, bits, *, n_radii: int = 1, bit_sidecar: bool = False):
    """Wire cost of one upload: ``32 * n_radii`` sidecar bits, b bits per
    coordinate, plus one width byte for adaptive LAQ."""
    return 32 * n_radii + (8 if bit_sidecar else 0) + bits * p


def dense_bits(p: int) -> int:
    """Uncompressed float32 upload cost (GD / LAG per-round cost)."""
    return 32 * p
