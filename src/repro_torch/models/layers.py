"""Shared layers: norms, rotary embeddings, SwiGLU MLP, initializers
(port of ``repro/models/layers.py``).

Matrix products cast the weight to the activation's dtype, so float32
parameters run their products in ``compute_dtype`` (bf16 by default).  The
reference would promote ``bf16 @ f32`` to float32 instead; with float32
compute, as the parity tests run, the two agree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen, device=device)).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation's dtype."""
    return x @ w.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # [hd/2]
    ang = positions[..., None].float() * freqs            # [S, hd/2]
    cos = torch.cos(ang)[..., None, :]                    # [S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(linear(x, w_gate)) * linear(x, w_up)
    return linear(h, w_down)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device, n_layers: int):
    """Stacked ``[n_layers, ...]`` SwiGLU weights."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    L = (n_layers,)
    return {
        "w_gate": normal_init(gen, L + (d_model, d_ff), s_in, dtype, device),
        "w_up": normal_init(gen, L + (d_model, d_ff), s_in, dtype, device),
        "w_down": normal_init(gen, L + (d_ff, d_model), s_out, dtype, device),
    }
