"""Mixture of experts, port of ``repro/models/moe.py``: a top-k router, the
capacity path with gather dispatch (train and prefill, S > 1) and its two
combines, and the dense path (decode, S == 1).  Plain torch: the
reference's MoE has no Pallas kernel.

Block parameters (stacked with a leading layer dim by the stack):
``router`` [D, E], float32 whatever ``param_dtype`` is, and the expert
weights ``w_gate``, ``w_up`` [E, D, F] and ``w_down`` [E, F, D].  The router
runs on ``x.float()`` in float32; the experts run in the activations'
dtype, with their weights cast to it (``layers.linear``'s rule).

Not ported:
- ``_shard_experts``: a GSPMD sharding constraint, with no meaning on one
  device.
- the argmax top-k of the jax-0.4 partial-auto region (a jax-version
  shim, ``moe.py:120-136``).
- the hand-written VJP of ``_make_dispatch``: it exists so that GSPMD
  partitions the gather's transpose.  The port's autograd of the same
  gather is the same scatter-add (``index_put_`` with ``accumulate``,
  which sorts the indices on CUDA and so sums in a fixed order).

Ties in the router go to the lowest expert index, as ``jax.lax.top_k``
gives them: the first K of a stable descending sort (``torch.topk``
promises no order among ties).  The reference writes the slot map with
``mode="drop"`` (out-of-range writes are dropped); the port sends every
dropped entry to a spare slot ``C`` and cuts it off, so only kept entries
land, at positions that are unique within one (row, expert).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal_init


def init_moe(gen, cfg: ModelConfig, dtype, device, n_layers: int):
    """Stacked ``[n_layers, ...]`` router and expert weights.  The expert
    leaves are drawn one layer at a time into a preallocated ``dtype``
    tensor: at qwen3-moe's widths and 48 layers a leaf holds 9.66 G
    elements, whose float32 draw in one piece would not fit on the card."""
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": normal_init(gen, (n_layers, D, E), D ** -0.5,
                               torch.float32, device)}
    for name, shape, scale in (("w_gate", (E, D, Fd), D ** -0.5),
                               ("w_up", (E, D, Fd), D ** -0.5),
                               ("w_down", (E, Fd, D), Fd ** -0.5)):
        w = torch.empty((n_layers,) + shape, dtype=dtype, device=device)
        for i in range(n_layers):
            w[i] = normal_init(gen, shape, scale, dtype, device)
        p[name] = w
    return p


def router(p, x, cfg: ModelConfig):
    """x:[..., D] -> (top-k weights [..., K] normalized to sum 1, top-k
    ids [..., K], aux loss).  The aux is Switch's load balance
    ``E * sum_e f_e * P_e``: ``f_e``, the share of assignments to expert e,
    carries no gradient; ``P_e``, its mean probability, carries it into
    the router."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[..., :K], top_ids[..., :K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    assign = F.one_hot(top_ids, E).to(torch.float32).sum(-2)
    dims = tuple(range(assign.ndim - 1))
    aux = E * torch.sum(assign.mean(dims) * probs.mean(dims))
    return top_w, top_ids, aux


def capacity(S: int, cfg: ModelConfig) -> int:
    """Slots per expert and batch row: ``S * K / E * capacity_factor``,
    floored, at least 1 and at most S (Python doubles, in that order)."""
    return min(max(1, int(S * cfg.top_k / cfg.n_experts
                          * cfg.capacity_factor)), S)


def _place(top_ids, slot, values, fill, C: int, E: int):
    """``[B, E, C]`` of ``fill`` with ``values[b, s, k]`` written at
    ``(b, top_ids[b, s, k], slot[b, s, k])``; ``slot == C`` is dropped."""
    B = top_ids.shape[0]
    out = torch.full((B, E, C + 1), fill, dtype=values.dtype,
                     device=values.device)
    b = torch.arange(B, device=top_ids.device)[:, None, None]
    return out.index_put((b, top_ids, slot), values)[..., :C]


def slots(top_ids, C: int, E: int):
    """The capacity map: ``pos_k`` [B,S,K], each assignment's position in
    its expert's buffer (in token order); ``keep`` = ``pos_k < C``; and
    ``src`` [B,E,C], the token feeding each slot (-1 for an empty one)."""
    B, S, K = top_ids.shape
    assign = F.one_hot(top_ids, E).sum(2)                    # [B,S,E]
    pos_all = torch.cumsum(assign, dim=1) * assign - 1
    pos_k = torch.gather(pos_all, 2, top_ids)                # [B,S,K]
    keep = pos_k < C
    t = torch.arange(S, device=top_ids.device)[None, :, None].expand(B, S, K)
    src = _place(top_ids, torch.where(keep, pos_k, C), t, -1, C, E)
    return pos_k, keep, src


def _experts_apply(p, xe):
    """xe:[B,E,C,D] grouped per expert; batched SwiGLU."""
    wg, wu, wd = (p[k].to(xe.dtype) for k in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("becd,edf->becf", xe, wg))
    h = h * torch.einsum("becd,edf->becf", xe, wu)
    return torch.einsum("becf,efd->becd", h, wd)


def moe_forward_capacity(p, x, cfg: ModelConfig):
    """Train/prefill path. x:[B,S,D] -> ([B,S,D], aux).  Groups are batch
    rows; each expert takes at most ``capacity(S)`` tokens of a row, in
    token order, and the overflow is dropped (a dropped assignment adds
    nothing)."""
    B, S, D = x.shape
    E = cfg.n_experts
    C = capacity(S, cfg)
    top_w, top_ids, aux = router(p, x, cfg)                  # [B,S,K]
    pos_k, keep, src = slots(top_ids, C, E)

    b = torch.arange(B, device=x.device)[:, None, None]
    valid = (src >= 0)[..., None]
    xe = torch.where(valid, x[b, src.clamp_min(0)], 0)       # [B,E,C,D]
    ye = _experts_apply(p, xe)                               # [B,E,C,D]

    if cfg.moe_combine == "scatter":
        wsrc = _place(top_ids, torch.where(keep, pos_k, C),
                      top_w * keep.to(torch.float32), 0.0, C, E)
        upd = torch.where(valid, ye * wsrc[..., None].to(ye.dtype), 0)
        out = torch.zeros((B, S, D), dtype=x.dtype, device=x.device)
        out = out.index_put((b, src.clamp_min(0)), upd, accumulate=True)
    else:
        # a dropped assignment reads slot C - 1 and weighs it by 0 (a NaN
        # there propagates, as in the reference)
        out_k = ye[b, top_ids, pos_k.clamp_max(C - 1)]       # [B,S,K,D]
        w = (top_w * keep.to(torch.float32)).to(x.dtype)
        out = torch.einsum("bskd,bsk->bsd", out_k, w)
    return out, aux


def moe_forward_dense(p, x, cfg: ModelConfig):
    """Decode path (S small): every expert on every token, combined with
    the router's weights (zero off the top-k).  Each expert's matmul reads
    its weight where it lies: a matmul batched over the expert dim, with
    no permuted copy of the weights."""
    B, S, D = x.shape
    top_w, top_ids, aux = router(p, x, cfg)                  # [B,S,K]
    gate = (F.one_hot(top_ids, cfg.n_experts).to(torch.float32)
            * top_w[..., None]).sum(2)                       # [B,S,E]
    wg, wu, wd = (p[k].to(x.dtype) for k in ("w_gate", "w_up", "w_down"))
    xt = x.reshape(1, B * S, D)
    h = F.silu(torch.matmul(xt, wg)) * torch.matmul(xt, wu)  # [E,T,F]
    ye = torch.matmul(h, wd)                                 # [E,T,D]
    out = torch.einsum("etd,te->td", ye,
                       gate.reshape(B * S, -1).to(x.dtype))
    return out.reshape(B, S, D), aux


def moe_forward(p, x, cfg: ModelConfig):
    if x.shape[1] == 1:
        return moe_forward_dense(p, x, cfg)
    return moe_forward_capacity(p, x, cfg)
