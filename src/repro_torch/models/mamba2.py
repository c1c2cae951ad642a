"""Mamba2 / SSD (state-space duality) block, port of
``repro/models/mamba2.py``: the chunked scan of the train/prefill path and
the one-token recurrent decode.  Plain torch: the reference computes SSD
in ``jnp`` outside any Pallas kernel.

The sequence is split into chunks of ``Q = min(ssm_chunk, S)`` tokens
(``S`` must be a multiple of ``Q``; the port raises, as the reference
asserts, and does not pad); within a chunk the recurrence is a masked,
decay-weighted quadratic form, across chunks a loop carries the float32
``[B, H, N, P]`` state.

Block parameters (stacked with a leading layer dim by the stack): the
per-stream projections ``w_z``, ``w_x`` [D, d_inner], ``w_B``, ``w_C``
[D, G*N], ``w_dt`` [D, H]; the depthwise causal convolutions ``conv_x``,
``conv_B``, ``conv_C`` [K, C] and their biases; ``A_log``, ``Dp`` and
``dt_bias`` [H], float32 whatever ``param_dtype`` is; ``gate_norm``
[d_inner] and ``out_proj`` [d_inner, D].  Weights are cast to the
activations' dtype (``layers.linear``'s rule).

Each path casts where the reference does: ``att`` goes to ``x.dtype``
before the ``y_intra`` product, the ``states`` product runs in
``x.dtype``, ``y_inter`` in float32; the forward multiplies by ``Dp`` cast
to the compute dtype, decode by the float32 ``Dp``.  ``dt`` is
``logaddexp(v, 0)`` of a float32 sum (``jax.nn.softplus``; torch's
``softplus`` switches to the identity past a threshold).

The decode cache of one block is ``{"ssm" [B, H, P, N] float32,
"conv_x", "conv_B", "conv_C" [B, K-1, C]}``; ``mamba2_decode`` writes it
in place, as ``attention.decode_attention`` writes the KV cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import linear, normal_init, rms_norm
from ..device import resolve_device


def init_mamba2(gen, cfg: ModelConfig, dtype, device, n_layers: int):
    """Stacked ``[n_layers, ...]`` Mamba2 weights, with the reference's
    shapes, dtypes and scales; ``dt_bias`` is the inverse softplus of a
    log-uniform step in [0.001, 0.1]."""
    D = cfg.d_model
    di, H, GN, K = (cfg.d_inner, cfg.ssm_heads,
                    cfg.ssm_n_groups * cfg.ssm_state, cfg.ssm_conv)
    L = (n_layers,)
    s, sk = D ** -0.5, K ** -0.5
    f32 = torch.float32
    p = {
        "w_z": normal_init(gen, L + (D, di), s, dtype, device),
        "w_x": normal_init(gen, L + (D, di), s, dtype, device),
        "w_B": normal_init(gen, L + (D, GN), s, dtype, device),
        "w_C": normal_init(gen, L + (D, GN), s, dtype, device),
        "w_dt": normal_init(gen, L + (D, H), s, dtype, device),
        "conv_x": normal_init(gen, L + (K, di), sk, dtype, device),
        "conv_B": normal_init(gen, L + (K, GN), sk, dtype, device),
        "conv_C": normal_init(gen, L + (K, GN), sk, dtype, device),
        "conv_x_b": torch.zeros(L + (di,), dtype=dtype, device=device),
        "conv_B_b": torch.zeros(L + (GN,), dtype=dtype, device=device),
        "conv_C_b": torch.zeros(L + (GN,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=device)
                           ).expand(L + (H,)).contiguous(),
        "Dp": torch.ones(L + (H,), dtype=f32, device=device),
        "gate_norm": torch.zeros(L + (di,), dtype=dtype, device=device),
        "out_proj": normal_init(gen, L + (di, D), di ** -0.5, dtype, device),
    }
    u = torch.rand(L + (H,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    return p


def _softplus(v: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def _causal_conv(u, w, b):
    """Depthwise causal conv. u:[B,S,C], w:[K,C] -> [B,S,C]."""
    K, S = w.shape[0], u.shape[1]
    w, b = w.to(u.dtype), b.to(u.dtype)
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD scan. x:[B,S,H,P] dt:[B,S,H] (float32) A:[H] Bm,Cm:[B,S,N]
    (G=1).  Returns y:[B,S,H,P] in ``x.dtype`` and the float32 final state
    [B,H,P,N] (the decode cache's layout)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"a sequence of {S} tokens is not a multiple of the "
                         f"SSD chunk {Q}")
    nc = S // Q
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    cum_a = torch.cumsum(dtc * A, dim=2)               # [B,nc,Q,H] log-decay
    seg_a = cum_a[:, :, -1:]                           # chunk total [B,nc,1,H]

    # ---- intra-chunk (quadratic, attention-like) ----
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # [B,nc,Q,Q]
    # clamp: above-diagonal (i<j) exponents are positive and would overflow
    # to inf, and the backward of the masking where() would make 0*inf = NaN
    decay = torch.exp(torch.clamp_max(cum_a[:, :, :, None, :]
                                      - cum_a[:, :, None, :, :], 0.0))
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    att = torch.where(mask[None, None, :, :, None],
                      CB[..., None] * decay * dtc[:, :, None, :, :], 0.0)
    del decay                                          # [B,nc,Q,Q,H] float32
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(x.dtype), xc)
    del att

    # ---- chunk summary states: sum_j exp(seg_a - cum_a_j) dt_j B_j x_j ----
    # in x.dtype, with the product B_j w_j rounded first: the order that
    # jnp.einsum's path takes for the reference's three-operand einsum
    w_j = (torch.exp(seg_a - cum_a) * dtc).to(x.dtype)            # [B,nc,Q,H]
    Bw = Bc.to(x.dtype)[..., :, None] * w_j[..., None, :]         # [B,nc,Q,N,H]
    states = torch.einsum("bcjnh,bcjhp->bchnp", Bw, xc)           # [B,nc,H,N,P]
    del Bw

    # ---- inter-chunk recurrence over nc: the state entering each chunk ----
    seg_decay = torch.exp(seg_a[:, :, 0, :])                      # [B,nc,H]
    R = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(R)
        R = R * seg_decay[:, c, :, None, None] + states[:, c].to(f32)
    R_in = torch.stack(entering, dim=1)                           # [B,nc,H,N,P]

    # ---- inter-chunk contribution ----
    Ce = Cc.to(f32)[:, :, :, None, :] * torch.exp(cum_a)[..., None]
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ce, R_in)       # float32
    y = (y_intra.to(f32) + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), R.transpose(2, 3)


def mamba2_forward(p, x, cfg: ModelConfig):
    """Train/prefill path. x:[B,S,D] -> ``(out [B,S,D], final state
    [B,H,P,N] float32, conv tail)``; the tail holds the last K-1 *pre-conv*
    projections ``{"x", "B", "C"}`` (views of them) for decode."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z = linear(x, p["w_z"])
    xw, Bw, Cw = (linear(x, p[k]) for k in ("w_x", "w_B", "w_C"))
    xin = F.silu(_causal_conv(xw, p["conv_x"], p["conv_x_b"]))
    Bm = F.silu(_causal_conv(Bw, p["conv_B"], p["conv_B_b"]))
    Cm = F.silu(_causal_conv(Cw, p["conv_C"], p["conv_C_b"]))
    dt = _softplus(linear(x, p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, H, P)
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["Dp"][:, None].to(x.dtype)
    y = rms_norm(y.reshape(B, S, cfg.d_inner) * F.silu(z), p["gate_norm"],
                 cfg.norm_eps)
    out = linear(y, p["out_proj"])
    K = cfg.ssm_conv
    tail = {"x": xw[:, -(K - 1):], "B": Bw[:, -(K - 1):],
            "C": Cw[:, -(K - 1):]}
    return out, state, tail


def init_mamba_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                     dtype=torch.float32, *, device="cuda"):
    """Zero cache stacked over blocks: ``ssm`` float32 [n, B, H, P, N] and
    the conv tails [n, B, K-1, C] in ``dtype`` (float32, the reference's
    default; ``prefill`` fills them with the compute-dtype projections)."""
    dev = resolve_device(device)
    H, P, N, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    GN = cfg.ssm_n_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((n_blocks, batch, H, P, N), dtype=torch.float32,
                           device=dev),
        "conv_x": torch.zeros((n_blocks, batch, K - 1, cfg.d_inner),
                              dtype=dtype, device=dev),
        "conv_B": torch.zeros((n_blocks, batch, K - 1, GN), dtype=dtype,
                              device=dev),
        "conv_C": torch.zeros((n_blocks, batch, K - 1, GN), dtype=dtype,
                              device=dev),
    }


def _conv_step(tail, new, w, b):
    """tail:[B,K-1,C], new:[B,1,C] -> out [B,C] in the tail's dtype; the
    tail is shifted by one in place."""
    window = torch.cat([tail, new.to(tail.dtype)], dim=1)          # [B,K,C]
    out = torch.einsum("bkc,kc->bc", window, w.to(window.dtype))
    tail.copy_(window[:, 1:])
    return out + b.to(out.dtype)


def mamba2_decode(p, x, cache, cfg: ModelConfig):
    """One-token recurrent step. x:[B,1,D]; ``cache``: one block's slice
    (views into the stacked cache), written in place.  Returns ``(out
    [B,1,D], cache)``."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    z = linear(x, p["w_z"])[:, 0]
    xin = _conv_step(cache["conv_x"], linear(x, p["w_x"]), p["conv_x"],
                     p["conv_x_b"])
    Bm = _conv_step(cache["conv_B"], linear(x, p["w_B"]), p["conv_B"],
                    p["conv_B_b"])
    Cm = _conv_step(cache["conv_C"], linear(x, p["w_C"]), p["conv_C"],
                    p["conv_C_b"])
    xin, Bm, Cm = F.silu(xin), F.silu(Bm), F.silu(Cm)
    dt = _softplus(linear(x, p["w_dt"])[:, 0].float() + p["dt_bias"])  # [B,H]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))                        # [B,H]
    xh = xin.reshape(B, H, P).to(f32)
    s = (cache["ssm"] * dA[..., None, None]
         + (dt[..., None] * xh)[..., None] * Bm.to(f32)[:, None, None, :])
    cache["ssm"].copy_(s)
    y = torch.einsum("bhpn,bn->bhp", s, Cm.to(f32))                    # [B,H,P]
    y = y + xh * p["Dp"][:, None]
    y = y.reshape(B, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return linear(y, p["out_proj"])[:, None], cache
