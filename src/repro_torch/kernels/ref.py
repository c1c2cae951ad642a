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
                             quantize_codes, unpack_codes)

BLOCK = 4096    # the Pallas kernels' block: kernel 3's payload is padded to it


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


def quantize_codes_ref(grad: torch.Tensor, qhat: torch.Tensor,
                       R: torch.Tensor, bits: int):
    """Oracle of the sharded wire's send-side sweep on one flat leaf:
    ``(codes uint8 [n], delta f32 [n])``, the codes left unpacked."""
    d = grad.reshape(-1).float() - qhat.reshape(-1).float()
    q = quantize_codes(d, R, bits)
    return q, dequantize_leaf(q, R, bits)


def quantize_codes_adaptive_ref(grad: torch.Tensor, qhat: torch.Tensor,
                                R: torch.Tensor, grid: tuple, sel: int):
    """Oracle of the width-switched send-side sweep: :func:`quantize_codes_ref`
    at ``b = grid[sel]``."""
    return quantize_codes_ref(grad, qhat, R, grid[sel])


def quantize_pack_payload_ref(grad: torch.Tensor, qhat: torch.Tensor,
                              R: torch.Tensor, bits: int):
    """Oracle of the payload-only pass 2: ``(packed uint8 [ceil(n / 4096)
    * 4096 * b / 8], delta f32 [n])``.  The payload keeps the Pallas
    kernel's block padding byte for byte: the pad elements are quantized
    as ``d = 0`` under R, as the kernel quantizes its zero-padded input."""
    d = grad.reshape(-1).float() - qhat.reshape(-1).float()
    n = d.numel()
    pad = (-n) % BLOCK
    if pad:
        d = torch.cat([d, d.new_zeros(pad)])
    q = quantize_codes(d, R, bits)
    return pack_codes(q, bits), dequantize_leaf(q[:n], R, bits)


def dequant_acc_ref(packed: torch.Tensor, R: torch.Tensor,
                    keep: torch.Tensor, bits: int, n: int,
                    acc: torch.Tensor = None) -> torch.Tensor:
    """Oracle of the receive side: ``acc + sum_w keep_w * delta_w`` from the
    packed payloads ``[W, nbytes]`` (``nbytes * 8 / b >= n``; a padded
    payload's tail is ignored), f32 ``[n]``.

    The sum runs in the Pallas kernel's order: ``acc`` first, then worker
    by worker, ``((acc + d_0) + d_1) + ...``, starting from 0 without
    ``acc``.  ``keep`` is a 0/1 mask, so ``delta_w * keep_w`` is exact."""
    out = (torch.zeros(n, dtype=torch.float32, device=packed.device)
           if acc is None else acc.reshape(-1).float().clone())
    for w in range(packed.shape[0]):
        q = unpack_codes(packed[w], bits)[:n]
        out += dequantize_leaf(q, R[w], bits) * keep[w]
    return out
