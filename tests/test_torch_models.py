"""The port's architecture registry and the attention families' stack
(``repro_torch/configs``, ``repro_torch/models``) against the JAX package's,
on the CPU.

- Every config of the reference is registered and equals the reference's
  field by field.  The one field the port lacks is ``scan_layers`` (a JAX
  compile switch); it holds its default in every config.
- ``n_params`` and ``n_active_params`` equal the reference's at the
  published widths, and the leaf sizes of the reference's ``init_params``
  (its abstract shapes: no 30 B parameters are drawn); at smoke size the
  port's own ``init_params`` has the reference's leaf shapes, in JAX's leaf
  order, and ``n_params`` elements.
- Smoke forward, prefill and 3 greedy decode steps (teacher-forced with
  the reference's ids) of each config registered since PR 18 (the
  Mamba2 families among them) from the reference's parameters, float32
  params and compute: logits to atol 2e-5 (``tests/test_torch_serve.py``'s
  float32 bound; measured at most 3.1e-6),
  and the prefill's last position equal to the port's own forward there to
  the same bound (the analogue of ``tests/test_models.py``'s
  ``test_arch_smoke_serve``).
- ``convert`` carries the MoE leaves into the port and back bitwise, in
  JAX's leaf order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import n_active_params as jax_n_active_params
from repro.models.config import n_params as jax_n_params
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.config import ModelConfig, n_active_params, n_params
from repro_torch.models.model import (decode_step, forward, init_params,
                                      prefill)
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

NEW_ARCHS = ("qwen3-8b", "yi-6b", "yi-9b", "chameleon-34b",
             "musicgen-medium", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
             "mamba2-130m", "zamba2-2.7b")
NOT_PORTED_FIELDS = {"scan_layers"}
DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
ATOL = 2e-5


def test_registry_has_the_attention_families():
    """Every family of the reference, the Mamba2 ones included; an unknown
    id raises ``KeyError`` on both sides."""
    assert set(ARCH_IDS) == set(NEW_ARCHS) | {"stablelm-1.6b"}
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    for get in (get_config, jax_get_config):
        with pytest.raises(KeyError):
            get("mamba3-1b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference_field_by_field(arch):
    got, want = get_config(arch), jax_get_config(arch)
    ours = {f.name for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name for f in dataclasses.fields(JModelConfig)}
    assert theirs - ours == NOT_PORTED_FIELDS and not ours - theirs
    for f in ours:
        a, b = getattr(got, f), getattr(want, f)
        if f in ("param_dtype", "compute_dtype"):
            a = DTYPES[a]
        assert a == b, (f, a, b)
    defaults = JModelConfig(name="d", arch_type="dense", n_layers=1,
                            d_model=1, vocab=1)
    for f in NOT_PORTED_FIELDS:
        assert getattr(want, f) == getattr(defaults, f), f
    smoke, jsmoke = smoke_config(got), jax_smoke_config(want)
    for f in ours - {"param_dtype", "compute_dtype"}:
        assert getattr(smoke, f) == getattr(jsmoke, f), f


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    abstract = jax.eval_shape(
        lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
    assert n_params(cfg) == jax_n_params(jcfg) == sum(
        l.size for l in jax.tree.leaves(abstract))
    assert n_active_params(cfg) == jax_n_active_params(jcfg)
    jsmoke = jax_smoke_config(jcfg)
    smoke = smoke_config(cfg)
    params = init_params(0, smoke, device="cpu")
    shapes = [tuple(l.shape) for l in tree_leaves(params)]
    want = jax.eval_shape(
        lambda: jax_init_params(jax.random.PRNGKey(0), jsmoke))
    assert shapes == [l.shape for l in jax.tree.leaves(want)]
    assert sum(l.numel() for l in tree_leaves(params)) == n_params(smoke)


def test_published_sizes():
    moe = get_config("qwen3-moe-30b-a3b")
    assert n_params(moe) == 30_532_122_624
    assert n_params(dataclasses.replace(moe, n_layers=1)) == 1_245_452_544
    assert len(tree_leaves(init_params(
        0, smoke_config(moe), device="cpu"))) == 15
    hybrid, ssm = get_config("zamba2-2.7b"), get_config("mamba2-130m")
    assert n_params(hybrid) == 2_422_670_240
    assert n_params(dataclasses.replace(hybrid, n_layers=24)) == 1_226_023_040
    assert n_params(ssm) == 167_610_816
    for cfg, leaves in ((hybrid, 29), (ssm, 20)):
        assert len(tree_leaves(init_params(
            0, smoke_config(cfg), device="cpu"))) == leaves
    assert (hybrid.d_inner, hybrid.ssm_heads, hybrid.conv_channels) == (
        5120, 80, 5248)
    assert hybrid.has_attention and hybrid.is_recurrent
    assert not ssm.has_attention and ssm.is_recurrent


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_mamba_families_are_refused(family):
    """Since the Mamba2 families are ported, only a family name that the
    port does not know is refused: a misspelling of each raises
    ``ValueError`` naming the families."""
    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")),
                              arch_type=family.upper())
    for fn in (lambda: n_params(cfg),
               lambda: init_params(0, cfg, device="cpu"),
               lambda: forward({}, torch.zeros((1, 4), dtype=torch.int64),
                               cfg)):
        with pytest.raises(ValueError, match=f"unknown arch_type.*'{family}'"):
            fn()


@pytest.fixture(scope="module", params=NEW_ARCHS)
def served(request):
    """Both packages on the smoke config: forward over the prompt, prefill,
    and 3 decode steps fed the reference's greedy ids."""
    arch = request.param
    cj = dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                             param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(smoke_config(get_config(arch)),
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    pj = jax_init_params(jax.random.PRNGKey(1), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    B, S, max_len = 2, 32, 40
    prompts = np.random.default_rng(1).integers(0, cj.vocab, (B, S))
    tok_t = torch.from_numpy(prompts)
    out = {"forward": (jax.jit(lambda p, t: jax_forward(p, t, cj)[0])(
        pj, prompts.astype(np.int32)), forward(pt, tok_t, ct))}
    lj, cache_j = jax.jit(lambda p, t: jax_prefill(p, t, cj, max_len))(
        pj, prompts.astype(np.int32))
    lt, cache_t = prefill(pt, tok_t, ct, max_len)
    out["prefill"] = (lj, lt)
    dj = jax.jit(lambda p, c, t: jax_decode_step(p, c, t, cj))
    out["decode"] = []
    for _ in range(3):
        tok = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
        lj, cache_j = dj(pj, cache_j, tok)
        lt, cache_t = decode_step(pt, cache_t,
                                  torch.from_numpy(tok.astype(np.int64)), ct)
        out["decode"].append((lj, lt))
    assert cache_t["pos"] == S + 3
    return out


def test_smoke_forward_matches_reference(served):
    lj, lt = served["forward"]
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)


def test_smoke_prefill_and_decode_match_reference(served):
    (lj, lt), (_, full) = served["prefill"], served["forward"]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].detach().numpy(),
                               rtol=0, atol=ATOL)
    for lj, lt in served["decode"]:
        assert tuple(lt.shape) == lj.shape
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"])
def test_moe_params_cross_the_packages(arch):
    """``convert`` carries the MoE leaves both ways, in JAX's sorted-key
    order (``blocks.moe.{router,w_down,w_gate,w_up}``), bitwise."""
    from repro_torch.convert import params_to_numpy
    cj = jax_smoke_config(jax_get_config(arch))
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    assert sorted(pt["blocks"]["moe"]) == ["router", "w_down", "w_gate",
                                           "w_up"]
    assert pt["blocks"]["moe"]["router"].dtype == torch.float32
    assert pt["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    back = params_to_numpy(pt)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(pj)[0]]
    assert paths == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(back)[0]]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
