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
from .ref import absmax_ref, quantize_pack_fused_ref


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
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"bits must be one of (1, 2, 4, 8), got {bits}")
    g, qh = _flat_pair(grad, qhat)
    if R.dtype != torch.float32 or R.numel() != 1 or R.device != g.device:
        raise ValueError(f"R must be one float32 on {g.device}, got "
                         f"{R.dtype} {tuple(R.shape)} on {R.device}")
    if g.device.type == "cpu":
        return quantize_pack_fused_ref(g, qh, R.reshape(()), bits)
    out = quant_pack.quantize_pack_cuda(g, qh, R.reshape(()).contiguous(),
                                        bits)
    quantize_pack_fused.launches += 1
    return out


quantize_pack_fused.launches = 0
