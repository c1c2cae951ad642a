"""Plain PyTorch versions of the CUDA wire kernels, port of
``repro/kernels/ref.py``.

They are what the dispatch layer runs on CPU tensors, and what
``chip_smoke.py`` holds each kernel against on the card.  Same semantics as
:mod:`repro_torch.core.quantize`, specialised to one flat leaf.
"""
from __future__ import annotations

import torch

from ..core.quantize import dequantize_leaf, pack_codes, pad_codes, quantize_codes


def absmax_ref(grad: torch.Tensor, qhat: torch.Tensor) -> torch.Tensor:
    """R = ||grad - qhat||_inf, float32 0-d (pass-1 oracle)."""
    d = grad.reshape(-1).float() - qhat.reshape(-1).float()
    if not d.numel():
        return torch.zeros((), dtype=torch.float32, device=d.device)
    return d.abs().amax()


def quantize_pack_fused_ref(grad: torch.Tensor, qhat: torch.Tensor,
                            R: torch.Tensor, bits: int):
    """Pass-2 oracle on one flat leaf: ``(packed, delta, q_new, err_sq,
    innovation_sq)`` with ``q_new = qhat + delta`` and ``err = grad -
    q_new``.  ``packed`` holds ``ceil(n b / 8)`` bytes, the tail byte's
    unused lanes carrying the midpoint code."""
    g = grad.reshape(-1).float()
    qh = qhat.reshape(-1).float()
    q = quantize_codes(g - qh, R, bits)
    delta = dequantize_leaf(q, R, bits)
    q_new = qh + delta
    err = g - q_new
    packed = pack_codes(pad_codes(q, bits), bits)
    return packed, delta, q_new, (err * err).sum(), (delta * delta).sum()
