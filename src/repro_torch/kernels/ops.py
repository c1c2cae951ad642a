"""Dispatch layer for the wire kernels, port of ``repro/kernels/ops.py``.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`); a
CUDA tensor goes to the hand-written kernel (:mod:`.quant_pack`), and the
wrapper raises if the kernel cannot take it.  There is no fallback from
one to the other.  Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``, incremented only where it
launches, so a run can show that its main path went through the kernel.

Unlike the Pallas wrappers, nothing is padded to a block: the CUDA kernels
mask the ragged tail themselves, and the payload is ``ceil(n b / 8)``
bytes.
"""
from __future__ import annotations

import torch

from . import quant_pack
from .ref import (absmax_ref, quantize_pack_adaptive_ref,
                  quantize_pack_fused_ref, sparse_quantize_pack_ref)

PACKED_BITS = (1, 2, 4, 8)


def _flat_pair(grad: torch.Tensor, qhat: torch.Tensor):
    """Validate one leaf's operands; returns them as flat vectors."""
    for name, t in (("grad", grad), ("qhat", qhat)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} on unsupported device {t.device}")
    if grad.device != qhat.device:
        raise ValueError(f"grad on {grad.device}, qhat on {qhat.device}")
    if grad.numel() != qhat.numel():
        raise ValueError(f"grad has {grad.numel()} elements, qhat "
                         f"{qhat.numel()}")
    if grad.device.type == "cuda" and not (grad.is_contiguous()
                                           and qhat.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous operands")
    return grad.reshape(-1), qhat.reshape(-1)


def _check_bits(bits):
    if bits not in PACKED_BITS:
        raise ValueError(f"bits must be one of {PACKED_BITS}, got {bits}")


def _check_scalar(name, x, device):
    if x.dtype != torch.float32 or x.numel() != 1 or x.device != device:
        raise ValueError(f"{name} must be one float32 on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def absmax(grad: torch.Tensor, qhat: torch.Tensor) -> torch.Tensor:
    """Pass 1: R = ||grad - qhat||_inf without materializing the diff;
    a float32 0-d tensor on the operands' device."""
    g, qh = _flat_pair(grad, qhat)
    if g.device.type == "cpu":
        return absmax_ref(g, qh)
    out = quant_pack.absmax_cuda(g, qh)
    absmax.launches += 1
    return out


absmax.launches = 0


def quantize_pack_fused(grad: torch.Tensor, qhat: torch.Tensor,
                        R: torch.Tensor, bits: int):
    """Pass 2: codes packed little-end-first, delta, q_new and both
    criterion moments in one sweep.

    Returns ``(packed uint8 [ceil(n b / 8)], delta f32 [n], q_new f32 [n],
    err_sq, innovation_sq)``; the moments are ``||grad - q_new||^2`` and
    ``||delta||^2`` as float32 0-d tensors.
    """
    _check_bits(bits)
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_pack_fused_ref(g, qh, R.reshape(()), bits)
    out = quant_pack.quantize_pack_cuda(g, qh, R.reshape(()).contiguous(),
                                        bits)
    quantize_pack_fused.launches += 1
    return out


quantize_pack_fused.launches = 0


def quantize_pack_adaptive(grad: torch.Tensor, qhat: torch.Tensor,
                           R: torch.Tensor, onehot, grid: tuple):
    """Adaptive pass 2: :func:`quantize_pack_fused` at the width ``onehot``
    selects from the ascending static ``grid``, with the codes packed into
    ``max(grid)``-bit lanes (``ceil(n max(grid) / 8)`` bytes).  The
    selection is read on the host (``onehot`` comes from
    ``adaptive.select_bits`` there), which picks the kernel's arm.  A
    pinned selection equals :func:`quantize_pack_fused` at that width on R,
    codes, delta, q_new and the moments.

    Returns ``(packed, delta, q_new, err_sq, innovation_sq)``.
    """
    grid = tuple(grid)
    for b in grid:
        _check_bits(b)
    if list(grid) != sorted(grid) or len(onehot) != len(grid):
        raise ValueError(f"grid {grid} must be ascending, one onehot entry "
                         f"per width (got {len(onehot)})")
    sel = int(torch.as_tensor(onehot).argmax())
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_pack_adaptive_ref(g, qh, R.reshape(()), grid, sel)
    out = quant_pack.quantize_pack_cuda(g, qh, R.reshape(()).contiguous(),
                                        grid[sel], max(grid))
    quantize_pack_adaptive.launches += 1
    by_width = quantize_pack_adaptive.launches_by_width
    by_width[grid[sel]] = by_width.get(grid[sel], 0) + 1
    return out


quantize_pack_adaptive.launches = 0
# the same launches split by the selected width (the kernel's arm)
quantize_pack_adaptive.launches_by_width = {}


def sparse_quantize_pack(vals: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, bits: int):
    """Sparse quantize + pack on the k gathered survivors of the EF-LAQ
    wire: the sign-magnitude b-bit grid on [lo, hi].

    Returns ``(packed uint8 [ceil(k b / 8)], codes uint8 [k], deq f32
    [k])``; the tail byte's unused lanes carry the midpoint code.
    """
    _check_bits(bits)
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vals on unsupported device {vals.device}")
    if vals.device.type == "cuda" and not vals.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous operands")
    for name, x in (("lo", lo), ("hi", hi)):
        _check_scalar(name, x, vals.device)
    v = vals.reshape(-1)
    if v.device.type == "cpu":
        return sparse_quantize_pack_ref(v, lo.reshape(()), hi.reshape(()),
                                        bits)
    out = quant_pack.sparse_quantize_pack_cuda(
        v, lo.reshape(()).contiguous(), hi.reshape(()).contiguous(), bits)
    sparse_quantize_pack.launches += 1
    return out


sparse_quantize_pack.launches = 0
