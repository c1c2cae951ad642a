"""Top-level model API: loss, the federated worker objective and the
serving calls (port of ``repro/models/model.py``, every family)."""
from __future__ import annotations

import torch

from . import stack
from .config import ModelConfig

AUX_LOSS_WEIGHT = 0.01


def lm_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross entropy (token mean) plus ``AUX_LOSS_WEIGHT`` times
    the MoE load-balance aux (0 for the other families: dense, vlm, audio,
    ssm and hybrid, which leaves their loss unchanged).

    The target logit is taken with ``gather``; the reference contracts a
    one-hot over the vocab (which shards better under GSPMD).  Same value,
    without a ``[B, S, V]`` one-hot.
    """
    logits, aux = stack.forward_with_aux(params, batch["tokens"], cfg)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"][..., None])[..., 0]
    return (lse - tgt).mean() + AUX_LOSS_WEIGHT * aux


def lm_worker_loss(cfg: ModelConfig, n_workers: int):
    """One worker's local objective ``lm_loss / W``, so the engine's global
    objective ``sum_m f_m`` is the global mean token cross-entropy."""
    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg) / n_workers

    return loss_fn


init_params = stack.init_params
forward = stack.forward
forward_with_aux = stack.forward_with_aux
init_cache = stack.init_cache
prefill = stack.prefill
decode_step = stack.decode_step
