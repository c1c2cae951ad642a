"""Decoder stack of every family, port of ``repro/models/stack.py``.
``vlm`` and ``audio`` run the dense stack over precomputed codebook ids,
as in the reference; ``moe`` swaps the block's SwiGLU for
``models/moe.py``; ``ssm`` stacks Mamba2 blocks (``models/mamba2.py``),
and ``hybrid`` (Zamba2) applies one *shared* attention + SwiGLU block (a
single weight set) after every ``attn_every``-th Mamba2 layer.

Block parameters are **stacked** with a leading layer dim, as the reference
builds them, so a dense model is 12 parameter leaves (``blocks.attn.{wk,wo,
wq,wv}``, ``blocks.{ln1,ln2}``, ``blocks.mlp.{w_down,w_gate,w_up}``,
``embed``, ``final_norm``, ``lm_head``), and a MoE model has
``blocks.moe.{router,w_down,w_gate,w_up}`` in place of the mlp (15 leaves
with qk-norm).  An ssm model is 20 leaves (``blocks.ln``, the 16
``blocks.mamba.*``, ``embed``, ``final_norm``, ``lm_head``), a hybrid 29
(plus the un-stacked ``shared_attn.attn.{wk,wo,wq,wv}``,
``shared_attn.{ln1,ln2}``, ``shared_attn.mlp.{w_down,w_gate,w_up}``).  The
wire quantizes per leaf, so the leaf set is part of the algorithm: one
module per layer would make it 219 leaves with other radii.

The model is therefore a function of that pytree, as in the reference,
and not an ``nn.Module``: the engine differentiates, quantizes and updates
the pytree leaf by leaf, and a module would be a second registry of the
same tensors that nothing reads.

Each attention block returns the MoE router's load-balance aux (0 for a
dense block); ``forward_with_aux`` sums it over the layers for
``lm_loss`` (0 for ssm and hybrid), and ``forward`` returns the logits
alone.  Under ``cfg.remat`` each block, and each application of the
shared block, is recomputed in backward; the shared block's gradient is
the sum over its applications.

Serving (``init_cache``, ``prefill``, ``decode_step``) runs the same
per-layer loop without gradients; decode takes the MoE's dense path.  The
cache is ``{"pos": int, "attn": {"k", "v"}}`` with ``[L, B, Sc, KV, hd]``
tensors for the attention families; ``{"pos", "mamba": {"ssm", "conv_x",
"conv_B", "conv_C"}}`` with ``[L, B, ...]`` tensors for ssm; and both for
hybrid, whose attention cache has one row per shared application
(``n_shared_applications``; application j follows layer ``(j + 1) *
attn_every - 1``).  ``decode_step`` writes it in place and returns it with
``pos + 1`` (callers rebind to what the step returns, as with the
reference's donated cache).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_flatten, tree_map, tree_unflatten
from .attention import (attention_forward, cache_len, decode_attention,
                        init_attention, init_kv_cache)
from .config import ATTENTION_FAMILIES, ModelConfig, check_family
from .layers import init_mlp, linear, normal_init, rms_norm, swiglu
from .mamba2 import (init_mamba2, init_mamba_cache, mamba2_decode,
                     mamba2_forward)
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
    # the draws' order fixes the weights of a seed: embed, lm_head, then
    # the blocks (attn and the feed-forward; or the Mamba2 blocks, then
    # the shared block)
    params = {
        "embed": normal_init(gen, (V, D), 1.0, dtype, dev),
        "final_norm": torch.zeros(D, dtype=torch.float32, device=dev),
        "lm_head": normal_init(gen, (D, V), D ** -0.5, dtype, dev),
    }
    if cfg.arch_type in ATTENTION_FAMILIES:
        params["blocks"] = init_attn_block(gen, cfg, dtype, dev, L)
        return params
    params["blocks"] = {
        "ln": torch.zeros((L, D), dtype=torch.float32, device=dev),
        "mamba": init_mamba2(gen, cfg, dtype, dev, L)}
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = tree_map(
            lambda a: a[0], init_attn_block(gen, cfg, dtype, dev, 1))
    return params


def init_attn_block(gen, cfg: ModelConfig, dtype, dev, n_layers: int):
    """Stacked ``[n_layers, ...]`` attention blocks: norms, attention, and
    the MoE or the SwiGLU."""
    D = cfg.d_model
    p = {"ln1": torch.zeros((n_layers, D), dtype=torch.float32, device=dev),
         "ln2": torch.zeros((n_layers, D), dtype=torch.float32, device=dev),
         "attn": init_attention(gen, cfg, dtype, dev, n_layers)}
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg, dtype, dev, n_layers)
    else:
        p["mlp"] = init_mlp(gen, D, cfg.d_ff, dtype, dev, n_layers)
    return p


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``i``."""
    return cfg.arch_type == "hybrid" and (i + 1) % cfg.attn_every == 0


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


def mamba_block_fwd(bp, x, cfg: ModelConfig, *, return_state=False):
    """One Mamba2 block: ``x``, or ``(x, (state, tail))`` with
    ``return_state``."""
    h, state, tail = mamba2_forward(bp["mamba"],
                                    rms_norm(x, bp["ln"], cfg.norm_eps), cfg)
    return (x + h, (state, tail)) if return_state else x + h


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

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    for i, bp in enumerate(_layers(params, cfg.n_layers)):
        if cfg.arch_type in ATTENTION_FAMILIES:
            x, a = run(attn_block_fwd, bp, x, positions, cfg)
            if a is not None:
                aux = aux + a
            continue
        x = run(mamba_block_fwd, bp, x, cfg)
        if _shared_after(cfg, i):
            x = run(attn_block_fwd, params["shared_attn"], x, positions,
                    cfg)[0]
    return _logits(params, x, cfg), aux


def forward(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """tokens:[B,S] -> float32 logits [B,S,V]."""
    return forward_with_aux(params, tokens, cfg)[0]


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero cache at position 0: the KV cache in bfloat16 as the
    reference's ``init_kv_cache`` default, the Mamba2 state and conv tails
    in float32 as its ``init_mamba_cache`` default."""
    check_family(cfg)
    cache = {"pos": 0}
    if cfg.arch_type in ATTENTION_FAMILIES:
        cache["attn"] = init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                      device=device)
        return cache
    cache["mamba"] = init_mamba_cache(cfg, batch, cfg.n_layers, device=device)
    if cfg.arch_type == "hybrid":
        cache["attn"] = init_kv_cache(cfg, batch, max_len,
                                      n_shared_applications(cfg),
                                      device=device)
    return cache


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """Processes the prompt tokens:[B,S]; returns ``(logits [B,1,V] of the
    last position, float32; cache)``.  The KV cache is in
    ``compute_dtype``, zero past the prompt, as the reference's ``place_kv``
    builds it; the Mamba2 conv tails hold the prompt's last K-1
    compute-dtype projections, and ``ssm`` the float32 final state."""
    check_family(cfg)
    B, S = tokens.shape
    dev, cdt = tokens.device, cfg.compute_dtype
    cache = {}
    if cfg.has_attention:
        assert not cfg.sliding_window or S <= cfg.sliding_window, \
            "ring-buffer prefill not supported; window must cover the prompt"
        Sc = cache_len(cfg, max_len)
        if S > Sc:
            raise ValueError(f"a prompt of {S} tokens does not fit a cache "
                             f"of {Sc} slots")
        n_kv = (cfg.n_layers if cfg.arch_type in ATTENTION_FAMILIES
                else n_shared_applications(cfg))
        cache["attn"] = init_kv_cache(cfg, B, max_len, n_kv, cdt, device=dev)
    if cfg.is_recurrent:
        if S < cfg.ssm_conv - 1:
            raise ValueError(f"a prompt of {S} tokens is shorter than the "
                             f"conv tail of {cfg.ssm_conv - 1}")
        cache["mamba"] = init_mamba_cache(cfg, B, cfg.n_layers, cdt,
                                          device=dev)
    x = params["embed"][tokens].to(cdt)
    positions = torch.arange(S, device=dev)

    def place_kv(j, kv):
        cache["attn"]["k"][j, :, :S] = kv[0]
        cache["attn"]["v"][j, :, :S] = kv[1]

    for i, bp in enumerate(_layers(params, cfg.n_layers)):
        if cfg.arch_type in ATTENTION_FAMILIES:
            x, _, kv = attn_block_fwd(bp, x, positions, cfg, return_kv=True)
            place_kv(i, kv)
            del kv
            continue
        x, (state, tail) = mamba_block_fwd(bp, x, cfg, return_state=True)
        m = cache["mamba"]
        m["ssm"][i] = state
        for k in ("x", "B", "C"):
            m["conv_" + k][i] = tail[k]
        del state, tail
        if _shared_after(cfg, i):
            x, _, kv = attn_block_fwd(params["shared_attn"], x, positions,
                                      cfg, return_kv=True)
            place_kv(i // cfg.attn_every, kv)
            del kv
    cache["pos"] = S
    return _logits(params, x[:, -1:], cfg), cache


def _decode_attn_block(bp, x, ck, cv, pos: int, cfg: ModelConfig):
    """One attention block's decode step against its cache rows (written
    in place); the MoE takes its dense path."""
    h, _, _ = decode_attention(bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                               ck, cv, pos, cfg)
    x = x + h
    m, _ = _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg,
                moe_forward_dense)
    return x + m


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One-token decode. tokens:[B,1] -> ``(logits [B,1,V] float32, cache)``
    with the cache written in place and ``pos`` advanced by one."""
    check_family(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for i, bp in enumerate(_layers(params, cfg.n_layers)):
        if cfg.arch_type in ATTENTION_FAMILIES:
            x = _decode_attn_block(bp, x, cache["attn"]["k"][i],
                                   cache["attn"]["v"][i], pos, cfg)
            continue
        h, _ = mamba2_decode(bp["mamba"], rms_norm(x, bp["ln"], cfg.norm_eps),
                             {k: v[i] for k, v in cache["mamba"].items()},
                             cfg)
        x = x + h
        if _shared_after(cfg, i):
            j = i // cfg.attn_every
            x = _decode_attn_block(params["shared_attn"], x,
                                   cache["attn"]["k"][j],
                                   cache["attn"]["v"][j], pos, cfg)
    return _logits(params, x, cfg), dict(cache, pos=pos + 1)
