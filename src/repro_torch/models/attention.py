"""Grouped-query causal attention, port of ``repro/models/attention.py``:
the train/prefill path and the one-token decode against a KV cache.

The online-softmax chunking of the reference is kept: queries in chunks of
``q_chunk``, and for each chunk only the key/value blocks at or before it,
so the score transient stays ``[B, KV, G, Cq, Ck]`` whatever the length.
Plain ``einsum``; the port does not call a fused attention operator.

The decode cache is written **in place** (the counterpart of the
reference's donated cache): ``decode_attention`` stores the new key and
value into its ``cache_k``/``cache_v`` views of the stacked cache and
returns them.  With ``sliding_window`` set, the cache is a ring of
``min(max_len, window)`` slots.
"""
from __future__ import annotations

import math

import torch

from .config import ModelConfig
from ..device import resolve_device
from .layers import apply_rope, linear, normal_init, rms_norm


def init_attention(gen, cfg: ModelConfig, dtype, device, n_layers: int):
    """Stacked ``[n_layers, ...]`` attention weights."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s_in, s_out = D ** -0.5, (H * hd) ** -0.5
    L = (n_layers,)
    p = {
        "wq": normal_init(gen, L + (D, H * hd), s_in, dtype, device),
        "wk": normal_init(gen, L + (D, KV * hd), s_in, dtype, device),
        "wv": normal_init(gen, L + (D, KV * hd), s_in, dtype, device),
        "wo": normal_init(gen, L + (H * hd, D), s_out, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(L + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros(L + (hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, positions, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(x, p["wq"]).reshape(B, S, H, hd)
    k = linear(x, p["wk"]).reshape(B, S, KV, hd)
    v = linear(x, p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def chunked_causal_attention(q, k, v, q_positions, kv_positions,
                             cfg: ModelConfig):
    """Online-softmax causal attention. q:[B,S,H,hd] k,v:[B,S,KV,hd]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    Cq = min(cfg.q_chunk, S)
    if S % Cq:
        Cq = S                      # irregular lengths: one q chunk
    Ck = math.gcd(min(cfg.kv_chunk, Cq), Cq)
    f32 = torch.float32

    out_chunks = []
    for qi in range(S // Cq):
        qg = q[:, qi * Cq:(qi + 1) * Cq].reshape(B, Cq, KV, G, hd)
        qp = q_positions[qi * Cq:(qi + 1) * Cq]
        m = torch.full((B, KV, G, Cq), -math.inf, dtype=f32, device=q.device)
        l = torch.zeros((B, KV, G, Cq), dtype=f32, device=q.device)
        acc = torch.zeros((B, KV, G, Cq, hd), dtype=f32, device=q.device)
        for j in range((qi + 1) * Cq // Ck):    # blocks at/below the diagonal
            kj = k[:, j * Ck:(j + 1) * Ck]
            vj = v[:, j * Ck:(j + 1) * Ck]
            kpj = kv_positions[j * Ck:(j + 1) * Ck]
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj).float() * scale
            mask = qp[:, None] >= kpj[None, :]
            if cfg.sliding_window:
                mask &= (qp[:, None] - kpj[None, :]) < cfg.sliding_window
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1))
            pexp = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", pexp.to(vj.dtype), vj).float()
            m = m_new
        o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        # [B,KV,G,Cq,hd] -> [B,Cq,KV,G,hd] -> [B,Cq,H,hd]
        out_chunks.append(o.permute(0, 3, 1, 2, 4).reshape(B, Cq, H, hd))
    return torch.cat(out_chunks, dim=1)


def attention_forward(p, x, positions, cfg: ModelConfig, *,
                      return_kv: bool = False):
    """Train/prefill path. x:[B,S,D]; positions:[S].  With ``return_kv``
    also the post-RoPE keys and the values, ``(k, v)`` of ``[B,S,KV,hd]``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, positions, cfg)
    o = chunked_causal_attention(q, k, v, positions, positions, cfg)
    out = linear(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"])
    return (out, (k, v)) if return_kv else out


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots per sequence: ``max_len``, or a ring of ``min(max_len,
    sliding_window)`` when the config has a window."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_blocks: int,
                  dtype=torch.bfloat16, *, device="cuda"):
    """Zero KV cache stacked over layers: ``{"k", "v"}`` of
    ``[n_blocks, batch, Sc, KV, hd]``, ``Sc = cache_len(cfg, max_len)``."""
    dev = resolve_device(device)
    shape = (n_blocks, batch, cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_attention(p, x, cache_k, cache_v, pos: int, cfg: ModelConfig):
    """One-token decode. x:[B,1,D]; cache_[kv]:[B,Sc,KV,hd]; pos: the
    token's position (a Python int).

    Writes k and v at slot ``pos % Sc`` (window) or ``pos``, in place, and
    returns ``(out [B,1,D], cache_k, cache_v)``.  The scores are the
    reference's: the product in the activations' dtype, then float32,
    divided by ``sqrt(hd)`` (a true division), the slots at or past
    ``min(pos + 1, Sc)`` masked with -1e30, a float32 softmax, and the
    value product in the cache's dtype.
    """
    B = x.shape[0]
    Sc = cache_k.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, positions, cfg)
    slot = pos % Sc if cfg.sliding_window else pos
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.to(q.dtype)).float()
    s = s / torch.tensor(math.sqrt(hd), dtype=torch.float32, device=s.device)
    valid = torch.arange(Sc, device=s.device) < min(pos + 1, Sc)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(cache_v.dtype), cache_v)
    # ``o @ wo`` promotes to the activations' dtype in the reference
    out = linear(o.reshape(B, 1, H * hd).to(x.dtype), p["wo"])
    return out, cache_k, cache_v
