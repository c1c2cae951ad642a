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
* Where the operands can span more than 53 bits (the sparse grid's
  ``lo + mag * step`` with ``lo`` far below ``step``, the error-feedback
  injection ``g + eta * e``), :func:`fma_f32` rounds once by rounding the
  double sum to odd first.
"""
from __future__ import annotations

import math

import torch

from ..tree import tree_leaves, tree_map

F32 = torch.float32


_FMA_CHUNK = 1 << 24   # elements per float64 pass of fma_f32


def _fma_f32_flat(a, b, c) -> torch.Tensor:
    p = a.double() * b.double()          # exact: two 24-bit significands
    c = c.double()
    s = p + c
    # TwoSum: p + c == s + err exactly
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # round to odd: an inexact sum moves to the odd one of its two double
    # neighbours, so the rounding to float32 below happens once
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.to(F32)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32: what a fused multiply-add
    gives, and what XLA emits when it contracts a multiply and an add under
    jit.  Each operand is a float32 tensor of the output's shape or a
    scalar (a Python float is rounded to float32 first, as JAX's weak types
    are).  The float64 work runs in chunks, so its temporaries stay small."""
    dev = next((x.device for x in (a, b, c) if isinstance(x, torch.Tensor)),
               None)
    a, b, c = (torch.as_tensor(x, dtype=F32, device=dev) for x in (a, b, c))
    shapes = {x.shape for x in (a, b, c) if x.dim()}
    # (torch.broadcast_shapes costs more than a small fma itself)
    shape = (shapes.pop() if len(shapes) == 1 else torch.Size(())
             if not shapes else torch.broadcast_shapes(a.shape, b.shape,
                                                       c.shape))
    out = torch.empty(shape, dtype=F32, device=dev)

    def flat(t):
        if t.dim() == 0:
            return lambda j: t
        if t.shape != shape:
            raise ValueError(f"fma_f32 operand {tuple(t.shape)} is neither a "
                             f"scalar nor of the output's shape {shape}")
        v = t.reshape(-1)
        return lambda j: v[j]

    fa, fb, fc = flat(a), flat(b), flat(c)
    fo = out.reshape(-1)
    for i in range(0, fo.numel(), _FMA_CHUNK):
        j = slice(i, i + _FMA_CHUNK)
        fo[j] = _fma_f32_flat(fa(j), fb(j), fc(j))
    return out


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


def tree_sq_norm_diff(a_tree, b_tree) -> torch.Tensor:
    """``tree_sq_norm(a - b)`` with one leaf's difference live at a time
    (the same per-leaf sums, stacked and summed)."""
    parts = [(a.to(F32) - b.to(F32)).square().sum()
             for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree))
             if a.numel()]
    if not parts:
        return torch.zeros((), dtype=F32)
    return torch.stack(parts).sum()


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


def dequantize_leaf(q: torch.Tensor, R: torch.Tensor, bits: int = None, *,
                    two_tau: torch.Tensor = None) -> torch.Tensor:
    """``delta = 2 tau R q - R`` rounded once (see the module docstring);
    0 where ``R == 0``.  ``two_tau`` (float32) replaces ``f32(2 tau(bits))``
    for a width selected at run time."""
    if two_tau is None:
        two_tau = two_tau_f32(bits, R.device)
    denom = (two_tau.to(R.device) * R).double()
    if R.dim():
        d = (denom * q.double() - R.double()).to(F32)
    else:   # one radius: the float64 work in chunks, as fma_f32's
        d = torch.empty(q.shape, dtype=F32, device=q.device)
        fq, fd, Rd = q.reshape(-1), d.view(-1), R.double()
        for i in range(0, fq.numel(), _FMA_CHUNK):
            j = slice(i, i + _FMA_CHUNK)
            fd[j] = (denom * fq[j].double() - Rd).to(F32)
    return d.masked_fill_(~(R > 0), 0.0)


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


def pad_codes(q: torch.Tensor, bits: int, mid: int = None) -> torch.Tensor:
    """Pad a flat code vector to whole bytes of ``bits``-bit lanes with the
    midpoint code ``2^b / 2`` (``docs/wire-format.md``, padding), or with
    ``mid``."""
    pad = (-q.numel()) % (8 // bits)
    if not pad:
        return q
    mid = torch.full((pad,), 2**bits // 2 if mid is None else mid,
                     dtype=torch.uint8, device=q.device)
    return torch.cat([q.reshape(-1), mid])


def upload_bits(p: int, bits, *, n_radii: int = 1, bit_sidecar: bool = False):
    """Wire cost of one upload: ``32 * n_radii`` sidecar bits, b bits per
    coordinate, plus one width byte for adaptive LAQ."""
    return 32 * n_radii + (8 if bit_sidecar else 0) + bits * p


def dense_bits(p: int) -> int:
    """Uncompressed float32 upload cost (GD / LAG per-round cost)."""
    return 32 * p


def index_bits(p: int) -> int:
    """Bits to address one of ``p`` coordinates: ``ceil(log2 p)``."""
    return max(1, int(math.ceil(math.log2(max(p, 2)))))


def sparse_upload_bits(p: int, k: int, bits, *, n_radii: int = 1):
    """Wire cost of one sparse upload (EF-LAQ): ``32 * n_radii`` sidecar
    bits plus, per surviving coordinate, its ``ceil(log2 p)``-bit index and
    its b-bit code (``k`` is static, so no count sidecar)."""
    return 32 * n_radii + k * (bits + index_bits(p))
