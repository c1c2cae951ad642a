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
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_flatten, tree_unflatten
from .attention import attention_forward, init_attention
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


def attn_block_fwd(bp, x, positions, cfg: ModelConfig):
    x = x + attention_forward(bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                              positions, cfg)
    return x + swiglu(rms_norm(x, bp["ln2"], cfg.norm_eps), **bp["mlp"])


def forward(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """tokens:[B,S] -> float32 logits [B,S,V].  With ``cfg.remat`` each
    layer is recomputed in backward (``torch.utils.checkpoint``), the
    counterpart of the reference's ``jax.checkpoint`` on the layer body."""
    _check_dense(cfg)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    # one unbind per stacked leaf: its backward stacks the per-layer
    # gradients once, where indexing a[i] would build a full-size zero
    # gradient per layer and sum 24 of them
    leaves, treedef = tree_flatten(params["blocks"])
    per_layer = [l.unbind(0) for l in leaves]
    for i in range(cfg.n_layers):
        bp = tree_unflatten(treedef, [u[i] for u in per_layer])
        if remat:
            x = checkpoint(attn_block_fwd, bp, x, positions, cfg,
                           use_reentrant=False)
        else:
            x = attn_block_fwd(bp, x, positions, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(x, params["lm_head"]).float()

