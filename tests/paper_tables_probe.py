"""Measurements behind the paper tables' port, on the CPU (not a test):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/paper_tables_probe.py

1. ``normal``: over 200,000 draws of ``jax.random.normal(PRNGKey(0))``,
   the share of float32 values that other ways of computing
   ``sqrt(2) * erf_inv(u)`` from the same uniform ``u`` give bit for bit:
   ``torch.erfinv``; chlo's polynomial (FMA Horner steps) on
   ``torch.log1p``; the port's ``random.normal``.  And the share of the
   draws' ``log1p`` arguments where XLA's jitted CPU ``log1p`` equals the
   correctly rounded one (float64 ``log1p`` rounded once).
2. The share of the NN's gradient (``benchmarks/common.py`` ``nn_loss`` at
   ``nn_init``, worker 0's rows) that the port's autograd gives bit for
   bit against ``jax.grad`` under ``jit``, leaf by leaf.
3. Torch calls per round of each row of both tables on the fused wire,
   counted with a dispatch mode over 2 rounds (on the card each is a
   launch or a host-side step).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import benchmarks.common as jcommon
import benchmarks_torch.common as tcommon
from benchmarks_torch import table2_gradient as t2
from benchmarks_torch import table3_stochastic as t3
from repro_torch import random as R
from repro_torch.core.quantize import fma_f32
from repro_torch.core.simulated import run_gradient_based, run_stochastic
from repro_torch.core.strategy import StrategyConfig

N_DRAWS = 200_000


def _share(a, b) -> float:
    a = np.asarray(a, dtype=np.float32).view(np.int32)
    b = np.asarray(b, dtype=np.float32).view(np.int32)
    return float((a == b).mean())


def normal_shares() -> dict:
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N_DRAWS,)))
    u = R.uniform(R.PRNGKey(0, device="cpu"), (N_DRAWS,),
                  minval=R._NORMAL_MINVAL, maxval=1.0)
    w = -torch.log1p(-(u * u))
    lt5 = w < 5.0
    t = torch.where(lt5, w - 2.5, w.double().sqrt().float() - 3.0)
    p = torch.where(lt5, torch.full_like(u, R._ERFINV_LT5[0]),
                    torch.full_like(u, R._ERFINV_GE5[0]))
    for a, b in zip(R._ERFINV_LT5[1:], R._ERFINV_GE5[1:]):
        p = fma_f32(p, t, torch.where(lt5, torch.full_like(u, a),
                                      torch.full_like(u, b)))
    chlo_torch_log1p = (u * p) * R._SQRT2_F32
    x = -(u * u).numpy()
    xla = np.asarray(jax.jit(jnp.log1p)(x))
    exact = np.log1p(x.astype(np.float64)).astype(np.float32)
    return {
        "sqrt2_torch_erfinv": _share(torch.erfinv(u) * R._SQRT2_F32, want),
        "chlo_with_torch_log1p": _share(chlo_torch_log1p, want),
        "port_normal": _share(R.normal(R.PRNGKey(0, device="cpu"),
                                       (N_DRAWS,)), want),
        "xla_log1p_correctly_rounded": _share(xla, exact),
    }


def gradient_shares() -> dict:
    (jXw, jYw), _ = jcommon.make_dataset()
    (tXw, tYw), _ = tcommon.make_dataset(device="cpu")
    jg = jax.jit(jax.grad(jcommon.nn_loss(600)))(jcommon.nn_init(),
                                                 (jXw[0], jYw[0]))
    tp = {k: v.requires_grad_(True)
          for k, v in tcommon.nn_init(device="cpu").items()}
    tg = torch.autograd.grad(tcommon.nn_loss(600)(tp, (tXw[0], tYw[0])),
                             list(tp.values()))
    return {k: _share(g, jg[k]) for k, g in zip(tp, tg)}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def calls_per_round(rounds: int = 2) -> dict:
    workers, _ = tcommon.make_dataset(device="cpu")
    models = {"logistic": (tcommon.logreg_loss(600), tcommon.logreg_init),
              "nn": (tcommon.nn_loss(600), tcommon.nn_init)}
    out = {}
    for model, (loss, init) in models.items():
        bits = t2.BITS_LOGREG if model == "logistic" else t2.BITS_NN
        for kind in t2.KINDS:
            cfg = StrategyConfig(kind=kind, bits=bits,
                                 criterion=tcommon.PAPER_CRITERION,
                                 wire_backend="fused")
            with _Count() as c:
                run_gradient_based(loss, init(device="cpu"), workers, cfg,
                                   steps=rounds, alpha=t2.ALPHA,
                                   device="cpu")
            out[f"table2/{model}/{kind}"] = c.n // rounds
        bits = t3.BITS if model == "logistic" else t3.BITS_NN
        for kind in t3.KINDS:
            laq = StrategyConfig(kind="laq", bits=bits, criterion=t3.CRIT,
                                 wire_backend=t3.row_wire("fused", bits))
            with _Count() as c:
                run_stochastic(loss, init(device="cpu"), workers, kind,
                               steps=rounds, alpha=t3.ALPHA, batch=t3.BATCH,
                               bits=bits, density=0.1, laq_cfg=laq,
                               device="cpu")
            out[f"table3/{model}/{kind}"] = c.n // rounds
    return out


if __name__ == "__main__":
    print(json.dumps({"normal": normal_shares(),
                      "nn_gradient_bitwise": gradient_shares(),
                      "torch_calls_per_round": calls_per_round()},
                     indent=1))
