"""Shared substrate of the port's paper tables, port of
``benchmarks/common.py``: the paper's two models (regularized logistic
regression; a 784 -> 200 -> 10 ReLU network) on the synthetic MNIST-like
mixture, M = 10 workers, the paper's hyperparameters.

The data and the NN's initial weights are the reference's bit for bit
(:mod:`repro_torch.random`).  The losses are plain functions on tensors
for the port's engine, which differentiates them with autograd.  The
reference's losses run under ``jit``, where XLA turns the division by the
constant ``n_total`` into a product with its float32 reciprocal; the port
writes that product.
"""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.core.criterion import CriterionConfig
from repro_torch.data.synthetic import classification_dataset, split_workers
from repro_torch.device import resolve_device

M_WORKERS = 10
LAMBDA = 0.01
PAPER_CRITERION = CriterionConfig(D=10, xi=0.8 / 10, t_bar=100)
F32 = torch.float32


def make_dataset(n_per_class=60, seed=0, heterogeneity=0.0, *,
                 device="cuda"):
    """``((Xw, Yw), (X, Y))``: the mixture drawn from ``PRNGKey(seed)`` on
    ``device`` and its split over ``M_WORKERS`` workers."""
    key = random.PRNGKey(seed, device=resolve_device(device))
    X, Y = classification_dataset(key, n_per_class=n_per_class)
    Xw, Yw = split_workers(X, Y, M_WORKERS, heterogeneity=heterogeneity)
    return (Xw, Yw), (X, Y)


def _inv(n_total: int) -> float:
    return float(torch.tensor(1.0 / n_total, dtype=F32))


def logreg_loss(n_total):
    inv = _inv(n_total)

    def loss_fn(params, data):
        x, y = data
        w = params["w"]
        ce = -torch.sum(y * torch.log_softmax(x @ w.T, -1))
        return (ce + 0.5 * LAMBDA * torch.sum(w * w)) * inv
    return loss_fn


def logreg_init(*, device="cuda"):
    return {"w": torch.zeros((10, 784), dtype=F32,
                             device=resolve_device(device))}


def nn_loss(n_total):
    """784 -> 200 ReLU -> 10, regularized (paper Sec. G)."""
    inv = _inv(n_total)

    def loss_fn(params, data):
        x, y = data
        h = torch.relu(x @ params["w1"] + params["b1"])
        logits = h @ params["w2"] + params["b2"]
        ce = -torch.sum(y * torch.log_softmax(logits, -1))
        reg = 0.5 * LAMBDA * (torch.sum(params["w1"] * params["w1"])
                              + torch.sum(params["w2"] * params["w2"]))
        return (ce + reg) * inv
    return loss_fn


def nn_init(seed=0, *, device="cuda"):
    """The reference's ``nn_init``: ``normal`` draws from the two halves of
    ``split(PRNGKey(seed))``, scaled by ``fan_in ** -0.5`` (a float32
    product, as eager JAX rounds it), zero biases."""
    dev = resolve_device(device)
    k1, k2 = random.split(random.PRNGKey(seed, device=dev))
    return {
        "w1": random.normal(k1, (784, 200)) * (784 ** -0.5),
        "b1": torch.zeros((200,), dtype=F32, device=dev),
        "w2": random.normal(k2, (200, 10)) * (200 ** -0.5),
        "b2": torch.zeros((10,), dtype=F32, device=dev),
    }


def _accuracy(logits, Y) -> float:
    """The share of rows whose argmax is the label's, as the reference's
    ``jnp.mean`` computes it under ``jit``: the float32 count times
    ``f32(1 / N)``."""
    hits = (torch.argmax(logits, -1) == torch.argmax(Y, -1)).to(F32).sum()
    return float(hits * _inv(Y.shape[0]))


@torch.no_grad()
def accuracy_logreg(params, X, Y):
    return _accuracy(X @ params["w"].T, Y)


@torch.no_grad()
def accuracy_nn(params, X, Y):
    h = torch.relu(X @ params["w1"] + params["b1"])
    return _accuracy(h @ params["w2"] + params["b2"], Y)
