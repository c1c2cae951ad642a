"""Decoder stack of the attention families (dense, moe, vlm, audio), port
of ``repro/models/stack.py``.  ``vlm`` and ``audio`` run the dense stack
over precomputed codebook ids, as in the reference; ``moe`` swaps the
block's SwiGLU for ``models/moe.py``.  SSM and hybrid stacks are not
ported (ROADMAP.md queue 1, item 1).

Block parameters are **stacked** with a leading layer dim, as the reference
builds them, so a dense model is 12 parameter leaves (``blocks.attn.{wk,wo,
wq,wv}``, ``blocks.{ln1,ln2}``, ``blocks.mlp.{w_down,w_gate,w_up}``,
``embed``, ``final_norm``, ``lm_head``), and a MoE model has
``blocks.moe.{router,w_down,w_gate,w_up}`` in place of the mlp (15 leaves
with qk-norm).  The wire quantizes per leaf, so the leaf set is part of the
algorithm: one module per layer would make it 219 leaves with other radii.

The model is therefore a function of that pytree, as in the reference,
and not an ``nn.Module``: the engine differentiates, quantizes and updates
the pytree leaf by leaf, and a module would be a second registry of the
same tensors that nothing reads.

Each block returns the MoE router's load-balance aux (0 for a dense
block); ``forward_with_aux`` sums it over the layers for ``lm_loss``, and
``forward`` returns the logits alone.

Serving (``init_cache``, ``prefill``, ``decode_step``) runs the same
per-layer loop without gradients; decode takes the MoE's dense path.  The
cache is ``{"pos": int, "attn": {"k", "v"}}`` with ``[L, B, Sc, KV, hd]``
tensors; ``decode_step`` writes it in place and returns it with ``pos + 1``
(callers rebind to what the step returns, as with the reference's donated
cache).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_flatten, tree_unflatten
from .attention import (attention_forward, cache_len, decode_attention,
                        init_attention, init_kv_cache)
from .config import ModelConfig, check_family
from .layers import init_mlp, linear, normal_init, rms_norm, swiglu
from .moe import init_moe, moe_forward, moe_forward_dense


def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``): same shapes, dtypes and scales as the reference's
    ``init_params``; the same distribution, not the same bits."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = cfg.param_dtype
    V, D, L = cfg.padded_vocab(), cfg.d_model, cfg.n_layers
    # the draws' order fixes the weights of a seed: embed, lm_head, attn,
    # then the feed-forward
    params = {
        "embed": normal_init(gen, (V, D), 1.0, dtype, dev),
        "final_norm": torch.zeros(D, dtype=torch.float32, device=dev),
        "lm_head": normal_init(gen, (D, V), D ** -0.5, dtype, dev),
        "blocks": {
            "ln1": torch.zeros((L, D), dtype=torch.float32, device=dev),
            "ln2": torch.zeros((L, D), dtype=torch.float32, device=dev),
            "attn": init_attention(gen, cfg, dtype, dev, L),
        },
    }
    if cfg.n_experts:
        params["blocks"]["moe"] = init_moe(gen, cfg, dtype, dev, L)
    else:
        params["blocks"]["mlp"] = init_mlp(gen, D, cfg.d_ff, dtype, dev, L)
    return params


def _ffn(bp, h, cfg: ModelConfig, moe_fn):
    """The block's feed-forward and its aux: the MoE (``moe_fn``), or the
    SwiGLU and ``None`` (a dense block adds nothing to the aux)."""
    if "moe" in bp:
        return moe_fn(bp["moe"], h, cfg)
    return swiglu(h, **bp["mlp"]), None


def attn_block_fwd(bp, x, positions, cfg: ModelConfig, *, return_kv=False):
    """One block: ``(x, aux)``, or ``(x, aux, (k, v))`` with
    ``return_kv``; ``aux`` is ``None`` for a dense block."""
    h = attention_forward(bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                          positions, cfg, return_kv=return_kv)
    h, kv = h if return_kv else (h, None)
    x = x + h
    m, aux = _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg, moe_forward)
    return (x + m, aux, kv) if return_kv else (x + m, aux)


def _layers(params, n_layers: int):
    """The stacked block leaves as one parameter dict per layer.  One
    unbind per stacked leaf: its backward stacks the per-layer gradients
    once, where indexing a[i] would build a full-size zero gradient per
    layer and sum 24 of them."""
    leaves, treedef = tree_flatten(params["blocks"])
    per_layer = [l.unbind(0) for l in leaves]
    return [tree_unflatten(treedef, [u[i] for u in per_layer])
            for i in range(n_layers)]


def _logits(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(x, params["lm_head"]).float()


def forward_with_aux(params, tokens, cfg: ModelConfig):
    """tokens:[B,S] -> (float32 logits [B,S,V], aux summed over the
    layers).  With ``cfg.remat`` each layer is recomputed in backward
    (``torch.utils.checkpoint``), the counterpart of the reference's
    ``jax.checkpoint`` on the layer body."""
    check_family(cfg)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _layers(params, cfg.n_layers):
        if remat:
            x, a = checkpoint(attn_block_fwd, bp, x, positions, cfg,
                              use_reentrant=False)
        else:
            x, a = attn_block_fwd(bp, x, positions, cfg)
        if a is not None:
            aux = aux + a
    return _logits(params, x, cfg), aux


def forward(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """tokens:[B,S] -> float32 logits [B,S,V]."""
    return forward_with_aux(params, tokens, cfg)[0]


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero cache at position 0, bfloat16 as the reference's
    ``init_kv_cache`` default."""
    check_family(cfg)
    return {"pos": 0, "attn": init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                            device=device)}


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """Processes the prompt tokens:[B,S]; returns ``(logits [B,1,V] of the
    last position, float32; cache)``.  The cache is in ``compute_dtype``,
    zero past the prompt, as the reference's ``place_kv`` builds it."""
    check_family(cfg)
    B, S = tokens.shape
    assert not cfg.sliding_window or S <= cfg.sliding_window, \
        "ring-buffer prefill not supported; window must cover the prompt"
    Sc = cache_len(cfg, max_len)
    if S > Sc:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{Sc} slots")
    cache = {"attn": init_kv_cache(cfg, B, max_len, cfg.n_layers,
                                   cfg.compute_dtype, device=tokens.device)}
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, device=tokens.device)
    for i, bp in enumerate(_layers(params, cfg.n_layers)):
        x, _, (k, v) = attn_block_fwd(bp, x, positions, cfg, return_kv=True)
        cache["attn"]["k"][i, :, :S] = k
        cache["attn"]["v"][i, :, :S] = v
        del k, v
    cache["pos"] = S
    return _logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One-token decode. tokens:[B,1] -> ``(logits [B,1,V] float32, cache)``
    with the cache written in place and ``pos`` advanced by one."""
    check_family(cfg)
    pos = cache["pos"]
    ck, cv = cache["attn"]["k"], cache["attn"]["v"]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for i, bp in enumerate(_layers(params, cfg.n_layers)):
        h, _, _ = decode_attention(bp["attn"],
                                   rms_norm(x, bp["ln1"], cfg.norm_eps),
                                   ck[i], cv[i], pos, cfg)
        x = x + h
        m, _ = _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg,
                    moe_forward_dense)
        x = x + m
    return _logits(params, x, cfg), {"pos": pos + 1, "attn": cache["attn"]}
