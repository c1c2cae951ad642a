"""Dense decoder stack, port of the dense family of
``repro/models/stack.py``.

Block parameters are **stacked** with a leading layer dim, as the reference
builds them, so the model is 12 parameter leaves (``blocks.attn.{wk,wo,wq,
wv}``, ``blocks.{ln1,ln2}``, ``blocks.mlp.{w_down,w_gate,w_up}``, ``embed``,
``final_norm``, ``lm_head``).  The wire quantizes per leaf, so the leaf set
is part of the algorithm: one module per layer would make it 219 leaves
with other radii.

The model is therefore a function of that pytree, as in the reference,
and not an ``nn.Module``: the engine differentiates, quantizes and updates
the pytree leaf by leaf, and a module would be a second registry of the
same 12 tensors that nothing reads.

Serving (``init_cache``, ``prefill``, ``decode_step``) runs the same
per-layer loop without gradients.  The cache is ``{"pos": int, "attn":
{"k", "v"}}`` with ``[L, B, Sc, KV, hd]`` tensors; ``decode_step`` writes
it in place and returns it with ``pos + 1`` (callers rebind to what the
step returns, as with the reference's donated cache).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_flatten, tree_unflatten
from .attention import (attention_forward, cache_len, decode_attention,
                        init_attention, init_kv_cache)
from .config import ModelConfig
from .layers import init_mlp, linear, normal_init, rms_norm, swiglu


def _check_dense(cfg: ModelConfig):
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.arch_type} models are not ported (ROADMAP.md queue 1: "
            "LM workload, MoE/Mamba2)")


def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``): same shapes, dtypes and scales as the reference's
    ``init_params``; the same distribution, not the same bits."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = cfg.param_dtype
    V, D, L = cfg.padded_vocab(), cfg.d_model, cfg.n_layers
    return {
        "embed": normal_init(gen, (V, D), 1.0, dtype, dev),
        "final_norm": torch.zeros(D, dtype=torch.float32, device=dev),
        "lm_head": normal_init(gen, (D, V), D ** -0.5, dtype, dev),
        "blocks": {
            "ln1": torch.zeros((L, D), dtype=torch.float32, device=dev),
            "ln2": torch.zeros((L, D), dtype=torch.float32, device=dev),
            "attn": init_attention(gen, cfg, dtype, dev, L),
            "mlp": init_mlp(gen, D, cfg.d_ff, dtype, dev, L),
        },
    }


def attn_block_fwd(bp, x, positions, cfg: ModelConfig, *, return_kv=False):
    """One block; with ``return_kv`` returns ``(x, (k, v))``."""
    h = attention_forward(bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                          positions, cfg, return_kv=return_kv)
    h, kv = h if return_kv else (h, None)
    x = x + h
    x = x + swiglu(rms_norm(x, bp["ln2"], cfg.norm_eps), **bp["mlp"])
    return (x, kv) if return_kv else x


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


def forward(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """tokens:[B,S] -> float32 logits [B,S,V].  With ``cfg.remat`` each
    layer is recomputed in backward (``torch.utils.checkpoint``), the
    counterpart of the reference's ``jax.checkpoint`` on the layer body."""
    _check_dense(cfg)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _layers(params, cfg.n_layers):
        if remat:
            x = checkpoint(attn_block_fwd, bp, x, positions, cfg,
                           use_reentrant=False)
        else:
            x = attn_block_fwd(bp, x, positions, cfg)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode (dense family)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero cache at position 0, bfloat16 as the reference's
    ``init_kv_cache`` default."""
    _check_dense(cfg)
    return {"pos": 0, "attn": init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                            device=device)}


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """Processes the prompt tokens:[B,S]; returns ``(logits [B,1,V] of the
    last position, float32; cache)``.  The cache is in ``compute_dtype``,
    zero past the prompt, as the reference's ``place_kv`` builds it."""
    _check_dense(cfg)
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
        x, (k, v) = attn_block_fwd(bp, x, positions, cfg, return_kv=True)
        cache["attn"]["k"][i, :, :S] = k
        cache["attn"]["v"][i, :, :S] = v
        del k, v
    cache["pos"] = S
    return _logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One-token decode. tokens:[B,1] -> ``(logits [B,1,V] float32, cache)``
    with the cache written in place and ``pos`` advanced by one."""
    _check_dense(cfg)
    pos = cache["pos"]
    ck, cv = cache["attn"]["k"], cache["attn"]["v"]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for i, bp in enumerate(_layers(params, cfg.n_layers)):
        h, _, _ = decode_attention(bp["attn"],
                                   rms_norm(x, bp["ln1"], cfg.norm_eps),
                                   ck[i], cv[i], pos, cfg)
        x = x + h
        x = x + swiglu(rms_norm(x, bp["ln2"], cfg.norm_eps), **bp["mlp"])
    return _logits(params, x, cfg), {"pos": pos + 1, "attn": cache["attn"]}

