"""Plain PyTorch versions of the CUDA wire kernels, port of
``repro/kernels/ref.py``.

They are what the dispatch layer runs on CPU tensors, and what
``chip_smoke.py`` holds each kernel against on the card.  Same semantics as
:mod:`repro_torch.core.quantize`, specialised to one flat leaf.
"""
from __future__ import annotations

import torch

from ..core.compressors import reference_sparse_quantize
from ..core.quantize import (dequantize_leaf, pack_codes, pad_codes,
                             quantize_codes)


def absmax_ref(grad: torch.Tensor, qhat: torch.Tensor) -> torch.Tensor:
    """R = ||grad - qhat||_inf, float32 0-d (pass-1 oracle)."""
    d = grad.reshape(-1).float() - qhat.reshape(-1).float()
    if not d.numel():
        return torch.zeros((), dtype=torch.float32, device=d.device)
    return d.abs().amax()


def _pass2(grad: torch.Tensor, qhat: torch.Tensor, R: torch.Tensor,
           bits: int):
    """``(codes, delta, q_new, err_sq, innovation_sq)`` of pass 2 on one
    flat leaf, with ``q_new = qhat + delta`` and ``err = grad - q_new``."""
    g = grad.reshape(-1).float()
    qh = qhat.reshape(-1).float()
    q = quantize_codes(g - qh, R, bits)
    delta = dequantize_leaf(q, R, bits)
    q_new = qh + delta
    err = g - q_new
    return q, delta, q_new, (err * err).sum(), (delta * delta).sum()


def quantize_pack_fused_ref(grad: torch.Tensor, qhat: torch.Tensor,
                            R: torch.Tensor, bits: int):
    """Pass-2 oracle on one flat leaf: ``(packed, delta, q_new, err_sq,
    innovation_sq)``.  ``packed`` holds ``ceil(n b / 8)`` bytes, the tail
    byte's unused lanes carrying the midpoint code."""
    q, *rest = _pass2(grad, qhat, R, bits)
    return (pack_codes(pad_codes(q, bits), bits), *rest)


def quantize_pack_adaptive_ref(grad: torch.Tensor, qhat: torch.Tensor,
                               R: torch.Tensor, grid: tuple, sel: int):
    """Oracle of the adaptive pass 2: :func:`quantize_pack_fused_ref` at
    ``b = grid[sel]``, with the codes in ``max(grid)``-bit lanes
    (``ceil(n max(grid) / 8)`` bytes, the tail byte's unused lanes carrying
    the b-bit midpoint code).  A pinned selection is the fixed-width pass
    at that width."""
    bits, lanes = grid[sel], max(grid)
    q, *rest = _pass2(grad, qhat, R, bits)
    return (pack_codes(pad_codes(q, lanes, mid=2 ** (bits - 1)), lanes),
            *rest)


def sparse_quantize_pack_ref(vals: torch.Tensor, lo: torch.Tensor,
                             hi: torch.Tensor, bits: int):
    """Oracle of the sparse quantize + pack on the k gathered survivors:
    ``(packed uint8 [ceil(k b / 8)], codes uint8 [k], deq f32 [k])`` on the
    sign-magnitude grid of
    :func:`repro_torch.core.compressors.reference_sparse_quantize`; the
    tail byte's unused lanes carry the midpoint code ``2^b / 2``, as the
    canonical sparse payload does."""
    codes, deq = reference_sparse_quantize(vals.reshape(-1), lo, hi, bits)
    return pack_codes(pad_codes(codes, bits), bits), codes, deq
