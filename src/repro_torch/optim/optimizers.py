"""Optimizers on parameter pytrees, port of ``repro/optim/optimizers.py``.

The LAQ strategies produce an aggregated gradient; these optimizers
consume it.  The paper's own method is plain GD (``sgd``); ``adamw`` keeps
a float32 master copy of bfloat16 parameters.

Bit-identity with the reference, which runs under ``jit``: XLA contracts
each multiply-add of these updates into one fused multiply-add (measured
with jax 0.9.0 on the CPU: ``p - lr * g``, ``beta * m + g``, ``b1 * m +
(1 - b1) * g`` with the first product fused, ``w - lr * (u + wd * w)``).
The port rounds each of those once with :func:`fma_f32`, so ``sgd`` and
``momentum`` equal the reference bit for bit.  ``adamw`` also takes a
float32 power and square root, which the two libraries may round in
another ulp.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.quantize import fma_f32
from ..tree import tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable      # params -> opt_state
    update: Callable    # (grads, opt_state, params, lr) -> (new_params, new_state)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A Python float or a 0-d tensor as a float32 scalar on ``like``'s
    device (a Python float rounds to float32 first, as JAX's weak types
    do)."""
    return torch.as_tensor(x, dtype=F32).to(like.device)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = tree_map(lambda p, g: fma_f32(-_f32(lr, p), g.to(F32),
                                            p.to(F32)).to(p.dtype),
                       params, grads)
        return new, state
    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device), params)

    def update(grads, state, params, lr):
        new_m = tree_map(lambda m, g: fma_f32(beta, m, g.to(F32)), state,
                         grads)
        new_p = tree_map(lambda p, m: fma_f32(-_f32(lr, p), m,
                                              p.to(F32)).to(p.dtype),
                         params, new_m)
        return new_p, new_m
    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: object
    nu: object
    master: object      # float32 master weights
    count: torch.Tensor  # int32 0-d


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return AdamState(mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params),
                         master=tree_map(lambda p: p.to(F32), params),
                         count=torch.zeros((), dtype=torch.int32))

    def update(grads, state, params, lr):
        c = state.count + 1
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32), c.to(F32))
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32), c.to(F32))
        mu = tree_map(lambda m, g: fma_f32(b1, m, _f32(1 - b1, g) * g.to(F32)),
                      state.mu, grads)
        nu = tree_map(lambda v, g: fma_f32(
            b2, v, _f32(1 - b2, g) * torch.square(g.to(F32))), state.nu, grads)

        def step(w, m, v):
            upd = (m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device))
                                             + _f32(eps, v))
            return fma_f32(-_f32(lr, w), fma_f32(weight_decay, w, upd), w)
        master = tree_map(step, state.master, mu, nu)
        new_params = tree_map(lambda w, p: w.to(p.dtype), master, params)
        return new_params, AdamState(mu, nu, master, c)
    return Optimizer(init, update)
