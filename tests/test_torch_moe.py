"""The port's mixture of experts (``repro_torch/models/moe.py``) against the
JAX package's (``repro/models/moe.py``), on the CPU in float32.

Both sides take the reference's parameters (through numpy) and the same
inputs, drawn with numpy from a seed.  Layer cases use the reference's
``tests/test_models.py`` MoE layer (d_model 32, 4 experts of width 16,
top-2); model cases the smoke variants of qwen3-moe-30b-a3b and
phi3.5-moe-42b-a6.6b.

- Router: the top-k ids exactly; weights and aux to rtol 1e-5 (float32
  softmax and means, summed in other orders).  Planted ties (a zero
  router; two equal router columns) must go to the lower expert index.
- Capacity path, both combines, at capacity_factor 1.25, 0.25 (tokens
  drop) and 4.0 (none drop): the slot map ``src`` and ``keep`` exactly (the
  reference's ``src`` is read where it enters its dispatch), the output to
  atol 1e-5; at 4.0 the port's capacity path equals its dense path to
  atol 1e-5, as the reference's do (``tests/test_models.py:150-194``).
- The dense (decode) path to atol 1e-5.
- ``lm_loss`` and its gradient on both smoke models to rtol 1e-4 and
  atol 1e-5 (measured: loss 2e-7 relative, gradients 5e-8 absolute).
- The aux reaches the router through ``accumulate_loss_grads``, with the
  reference's router gradient to rtol 1e-4, atol 1e-7.
- Deterministic LAQ rounds of smoke qwen3-moe through ``RoundEngine``
  against JAX's live engine (``tests/test_torch_lm.py``'s settings at
  alpha = 0.02): uploads and bits exact every round, loss to rtol 1e-4 as
  in that file, and the
  final parameters to rtol 1e-4, atol 5e-4 (``tests/test_torch_train.py``'s
  bound: a gradient that differs at the ulp can move a code on its
  rounding boundary by one grid step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import (CriterionConfig as JCriterion, EtaSchedule as JEta,
                        RoundEngine as JEngine, StrategyConfig as JStrategy)
from repro.core.engine import AccumulatingSource as JSource
from repro.core.engine import accumulate_loss_grads as jax_accumulate
from repro.data import lm_worker_corpus as jax_corpus
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_worker_loss as jax_worker_loss
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import AUX_LOSS_WEIGHT as JAX_AUX_WEIGHT
from repro.models.model import lm_loss as jax_lm_loss
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.adaptive import EtaSchedule
from repro_torch.core.criterion import CriterionConfig
from repro_torch.core.engine import (AccumulatingSource, RoundEngine,
                                     accumulate_loss_grads, value_and_grad)
from repro_torch.core.strategy import StrategyConfig
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (AUX_LOSS_WEIGHT, forward_with_aux,
                                      lm_loss, lm_worker_loss)
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

LAYER = dict(name="t", arch_type="moe", n_layers=1, d_model=32, vocab=64,
             n_heads=2, n_kv_heads=2, head_dim=16, n_experts=4, top_k=2,
             moe_d_ff=16)
MOE_ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")


def _layer(**kw):
    cj = JModelConfig(**LAYER, param_dtype=jnp.float32,
                      compute_dtype=jnp.float32, **kw)
    ct = ModelConfig(**LAYER, param_dtype=torch.float32,
                     compute_dtype=torch.float32, **kw)
    pj = jmoe.init_moe(jax.random.PRNGKey(0), cj, jnp.float32)
    return cj, ct, pj, params_from_numpy(jax.tree.map(np.asarray, pj),
                                         device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _router_both(cj, ct, pj, pt, x):
    wj, idj, auxj = jax.jit(lambda p, x: jmoe._router(p, x, cj))(pj, x)
    wt, idt, auxt = moe.router(pt, torch.from_numpy(x), ct)
    return (np.asarray(wj), np.asarray(idj), float(auxj)), (
        wt.numpy(), idt.numpy(), float(auxt))


def test_router_matches_reference():
    cj, ct, pj, pt = _layer()
    (wj, idj, auxj), (wt, idt, auxt) = _router_both(cj, ct, pj, pt,
                                                    _x((2, 16, 32)))
    np.testing.assert_array_equal(idt, idj)
    np.testing.assert_allclose(wt, wj, rtol=1e-5)
    np.testing.assert_allclose(auxt, auxj, rtol=1e-5)


@pytest.mark.parametrize("plant", ["zero_router", "equal_columns"])
def test_router_ties_go_to_the_lower_index(plant):
    cj, ct, pj, pt = _layer()
    r = np.asarray(pj["router"]).copy()
    if plant == "zero_router":
        r[:] = 0.0                  # every probability 1/4: ids (0, 1)
    else:
        r[:, 3] = r[:, 1] = 2.0 * np.abs(r[:, 1])   # experts 1 and 3 tie
    pj = dict(pj, router=jnp.asarray(r))
    pt = dict(pt, router=torch.from_numpy(r))
    (wj, idj, auxj), (wt, idt, auxt) = _router_both(cj, ct, pj, pt,
                                                    _x((2, 16, 32)))
    np.testing.assert_array_equal(idt, idj)
    np.testing.assert_allclose(wt, wj, rtol=1e-5)
    np.testing.assert_allclose(auxt, auxj, rtol=1e-5)
    if plant == "zero_router":
        assert (idt == np.array([0, 1])).all()
    else:
        has1, has3 = (idt == 1).any(-1), (idt == 3).any(-1)
        assert has1.any() and not (has3 & ~has1).any()
        both = has1 & has3
        assert both.any()
        assert (np.argmax(idt == 1, -1) < np.argmax(idt == 3, -1))[both].all()


def _reference_capacity(cj, pj, x):
    """The reference's capacity path, eagerly, with the ``src`` it hands
    its dispatch."""
    seen = {}
    dispatch = jmoe._dispatch

    def record(x, src):
        seen["src"] = np.asarray(src)
        return dispatch(x, src)

    jmoe._dispatch = record
    try:
        y, aux = jmoe.moe_forward_capacity(pj, jnp.asarray(x), cj)
    finally:
        jmoe._dispatch = dispatch
    return np.asarray(y), float(aux), seen["src"]


@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("cf", [1.25, 0.25, 4.0])
def test_capacity_path_matches_reference(cf, combine):
    cj, ct, pj, pt = _layer(capacity_factor=cf, moe_combine=combine)
    x = _x((2, 16, 32))
    yj, auxj, src_j = _reference_capacity(cj, pj, x)
    xt = torch.from_numpy(x)
    yt, auxt = moe.moe_forward_capacity(pt, xt, ct)
    _, ids, _ = moe.router(pt, xt, ct)
    C = moe.capacity(16, ct)
    assert C == src_j.shape[-1] == min(max(1, int(16 * 2 / 4 * cf)), 16)
    _, keep, src_t = moe.slots(ids, C, 4)
    np.testing.assert_array_equal(src_t.numpy(), src_j)
    # the reference's keep: token s sits in a slot of each kept expert
    ids = ids.numpy()
    s_of = np.arange(16)[None, :, None]
    keep_j = (src_j[np.arange(2)[:, None, None], ids]
              == s_of[..., None]).any(-1)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    assert keep_j.all() == (cf == 4.0)
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(auxt), auxj, rtol=1e-5)
    if cf == 4.0:                 # nothing drops: the capacity path is dense
        yd, auxd = moe.moe_forward_dense(pt, xt, ct)
        np.testing.assert_allclose(yt.detach().numpy(), yd.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(auxd), float(auxt), rtol=1e-5)


@pytest.mark.parametrize("S", [1, 16])
def test_dense_path_matches_reference(S):
    cj, ct, pj, pt = _layer()
    x = _x((3, S, 32))
    yj, auxj = jax.jit(lambda p, x: jmoe.moe_forward_dense(p, x, cj))(pj, x)
    yt, auxt = moe.moe_forward_dense(pt, torch.from_numpy(x), ct)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    yf, _ = moe.moe_forward(pt, torch.from_numpy(x), ct)
    want = yt if S == 1 else moe.moe_forward_capacity(
        pt, torch.from_numpy(x), ct)[0]
    assert torch.equal(yf, want)


def _smoke(arch):
    cj = dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                             param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(smoke_config(get_config(arch)),
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    return cj, ct, pj, params_from_numpy(jax.tree.map(np.asarray, pj),
                                         device="cpu")


def _batch(vocab, shape=(2, 64), seed=0):
    tok = np.random.default_rng(seed).integers(0, vocab, shape[:-1]
                                               + (shape[-1] + 1,))
    return {"tokens": tok[..., :-1].astype(np.int32),
            "targets": tok[..., 1:].astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_and_gradient_match_reference(arch):
    cj, ct, pj, pt = _smoke(arch)
    batch = _batch(cj.vocab)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, b, cj)))(pj, batch)
    lt, gt = value_and_grad(lambda p, b: lm_loss(p, b, ct), pt,
                            _torch_batch(batch))
    assert AUX_LOSS_WEIGHT == JAX_AUX_WEIGHT
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    assert len(names) == 15 if cj.qk_norm else 13
    assert any("router" in n for n in names)
    for n, a, b in zip(names, jax.tree.leaves(gj), tree_leaves(gt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    _, auxj = jax.jit(lambda p, t: jax_forward(p, t, cj))(pj, batch["tokens"])
    _, auxt = forward_with_aux(pt, _torch_batch(batch)["tokens"], ct)
    assert float(auxt) > 0
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)


def test_aux_reaches_the_router_through_accumulation():
    """An aux-only objective folded over microbatches gives the router a
    nonzero gradient, the reference's; the full objective stays finite."""
    cfg = dict(LAYER, q_chunk=16, kv_chunk=8)
    cj = JModelConfig(**cfg, param_dtype=jnp.float32,
                      compute_dtype=jnp.float32)
    ct = ModelConfig(**cfg, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    mbs = _batch(cj.vocab, (4, 2, 16), seed=1)

    def aux_j(p, b):
        return JAX_AUX_WEIGHT * jax_forward(p, b["tokens"], cj)[1]

    def aux_t(p, b):
        return AUX_LOSS_WEIGHT * forward_with_aux(p, b["tokens"], ct)[1]

    lj, gj = jax_accumulate(aux_j, pj, mbs)
    lt, gt = accumulate_loss_grads(aux_t, pt, _torch_batch(mbs))
    assert float(lt) > 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    router = gt["blocks"]["moe"]["router"]
    assert float(router.abs().max()) > 0
    np.testing.assert_allclose(router.numpy(),
                               np.asarray(gj["blocks"]["moe"]["router"]),
                               rtol=1e-4, atol=1e-7)
    full, _ = accumulate_loss_grads(lambda p, b: lm_loss(p, b, ct), pt,
                                    _torch_batch(mbs))
    assert np.isfinite(float(full))


W, N_LOCAL, SEQ, ACCUM, ROUNDS, ALPHA = 4, 2, 32, 2, 12, 0.02


def test_laq_rounds_match_reference_engine():
    """12 deterministic LAQ rounds (b=8, per-leaf radii, fused wire,
    lm_frontier's criterion and 1/t stepsize) of smoke qwen3-moe at
    alpha = 0.02: the workers upload 4, 4, 0, 3, 1, 3, 0, 0, 1, 0, 0, 0
    times.  At ``tests/test_torch_lm.py``'s alpha = 0.05 the smoke MoE's
    loss oscillates (2.6-4.1 from round 3) and the two trajectories part
    as that file describes, by 2.8e-4 relative in round 12 (the counts
    equal); at 0.02 the loss falls from 6.87 to 2.74 and they stay within
    2.4e-7 (measured on the CPU, jax 0.9.0, torch 2.13)."""
    cj, ct, pj, pt = _smoke("qwen3-moe-30b-a3b")
    corpus_j = jax_corpus(0, W, N_LOCAL, SEQ, cj.vocab)
    corpus_t = {k: torch.from_numpy(np.array(v)).long()
                for k, v in corpus_j.items()}
    crit, eta = dict(D=10, xi=0.08, t_bar=100), dict(kind="inv_t", t0=30.0)
    strat = dict(kind="laq", bits=8, per_leaf_radius=True,
                 wire_backend="fused")
    je = JEngine(JSource(jax_worker_loss(cj, W), corpus_j,
                         deterministic=True, accum=ACCUM, scale=1.0),
                 JStrategy(**strat, criterion=JCriterion(**crit),
                           eta_schedule=JEta(**eta)), alpha=ALPHA)
    jcarry, want = je.run_from(je.init_carry(pj), ROUNDS)
    te = RoundEngine(AccumulatingSource(lm_worker_loss(ct, W), corpus_t,
                                        deterministic=True, accum=ACCUM,
                                        scale=1.0),
                     StrategyConfig(**strat, criterion=CriterionConfig(**crit),
                                    eta_schedule=EtaSchedule(**eta)),
                     alpha=ALPHA)
    tcarry, got = te.run_from(te.init_carry(pt, device="cpu"), ROUNDS)

    np.testing.assert_array_equal(got.cum_uploads.numpy(),
                                  np.asarray(want.cum_uploads))
    np.testing.assert_array_equal(got.cum_bits.numpy(),
                                  np.asarray(want.cum_bits))
    assert int(got.cum_uploads[0]) == W
    assert int(got.cum_uploads[-1]) < W * ROUNDS
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)
    final_t = tree_leaves(params_to_numpy(tcarry[0]))
    final_j = jax.tree.leaves(jcarry[0])
    assert len(final_t) == len(final_j) == 15
    for a, b in zip(final_t, final_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=5e-4)
