"""The port's optimizers (``repro_torch/optim/optimizers.py``) against the
reference's under ``jax.jit``, on numpy-made parameter and gradient trees
(float32 and bfloat16 leaves), three updates each.

``sgd`` and ``momentum`` are bitwise (tolerance 0): XLA contracts each of
their multiply-adds into one FMA, and the port rounds each once with
``fma_f32``.  ``adamw`` also takes a float32 power, division and square
root, which the two libraries may round in another ulp: rtol 1e-6,
measured differences 1 ulp on a few percent of the elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import momentum as jmomentum
from repro.optim import sgd as jsgd
from repro_torch.optim.optimizers import adamw, momentum, sgd
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

SHAPES = {"w": (300, 7), "b": (1000,), "s": (3,)}
OPTS = {"sgd": (jsgd, sgd, {}), "momentum": (jmomentum, momentum,
                                             dict(beta=0.9)),
        "adamw": (jadamw, adamw, dict(weight_decay=0.01))}


def _trees(seed, dtype):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    g = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in SHAPES.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
          for k, v in jp.items()}
    return jp, tp, g


@pytest.mark.parametrize("dtype", (jnp.float32, jnp.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("name", OPTS)
@pytest.mark.parametrize("lr", ("python", "tensor"))
def test_updates_match_reference(name, dtype, lr):
    jf, tf, kw = OPTS[name]
    jopt, topt = jf(**kw), tf(**kw)
    jp, tp, grads = _trees(3, dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    jupd = jax.jit(jopt.update)
    for k, g in enumerate(grads):
        rate = 1e-2 / (k + 1)
        jlr = rate if lr == "python" else jnp.float32(rate)
        tlr = rate if lr == "python" else torch.tensor(rate)
        jp, js = jupd(g, js, jp, jlr)
        tp, ts = topt.update({k_: torch.from_numpy(v) for k_, v in g.items()},
                             ts, tp, tlr)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == (torch.float32 if dtype == jnp.float32
                           else torch.bfloat16)
        got = a.float().numpy()
        want = np.asarray(b.astype(jnp.float32))
        if name == "adamw":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    if name == "momentum":
        for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if name == "adamw":
        assert int(ts.count) == int(js.count) == 3
        for field in ("mu", "nu"):
            for a, b in zip(tree_leaves(getattr(ts, field)),
                            jax.tree.leaves(getattr(js, field))):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
