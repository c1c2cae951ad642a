"""The port's Mamba2 block (``repro_torch/models/mamba2.py``) and the ssm
and hybrid stacks against the JAX package's, on the CPU.

The same numpy-seeded inputs (and the reference's parameters, carried
over with ``convert.params_from_numpy``) go through both.  Tolerances,
absolute, measured on the CPU with jax 0.9.0 and torch 2.13:

- ``ssd_chunked`` in float32 at chunk 8 and chunk = S: 1e-5 on y of
  magnitude 9.6 and on the final state (measured 3.3e-6 and 9.5e-7; the
  frameworks order their sums differently), and 1e-4 against the naive
  per-step recurrence in float64 of ``tests/test_models.py``.
- ``mamba2_forward`` and ``mamba2_decode`` in float32: 1e-5 (measured
  9.5e-7 on outputs of magnitude 4.1); in bfloat16: 0.0625 on the
  outputs, four bf16 ulps at their magnitude 2-4 (measured 0.0234), and
  8e-3 on the float32 state of magnitude 0.46, four ulps of its bf16
  inputs there (measured 1.9e-3).  The conv tails are the projections
  themselves and are compared at the same bounds.
- One block's gradient in float32, each leaf to 1e-4 of its largest
  magnitude, also at a step ``dt`` of about 3 (``dt_bias`` 3), where the
  chunk's log-decays above the diagonal reach 7 x 3 x 8 = 168: without the
  clamp before the exponential they overflow, and the backward of the
  mask makes 0 * inf = NaN in torch as in JAX.  At that step the
  ``A_log`` gradient is a sum of cancelling terms: both frameworks lie
  within 1.1e-5 of its scale of each other and within 7.1e-6 of a
  float64 run of the port (at ``dt`` 20 they part from it by twice the
  gradient's scale, and no float32 comparison is meaningful there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import mamba2 as jm
from repro.models import prefill as jax_prefill
from repro.models.config import ModelConfig as JModelConfig
from repro.models.stack import mamba_block_fwd as jax_block_fwd
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import mamba2 as tm
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_cache, prefill
from repro_torch.models.stack import mamba_block_fwd
from repro_torch.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.0625, 8e-3)}  # (out, state)
BLOCK = dict(name="m", arch_type="ssm", n_layers=1, d_model=64, vocab=64,
             ssm_state=16, ssm_head_dim=16, ssm_chunk=8)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def _ssd_inputs(B=2, S=32, H=3, P=8, N=5):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _naive(x, dt, A, Bm, Cm):
    """The per-step recurrence of ``tests/test_models.py``, in float64."""
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in (x, dt, A, Bm, Cm))
    B, S, H, P = x.shape
    s = np.zeros((B, H, Bm.shape[-1], P))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        outer = np.einsum("bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        s = s * np.exp(dt[:, t] * A)[..., None, None] + outer
        ys[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], s)
    return ys, np.transpose(s, (0, 1, 3, 2))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    inputs = _ssd_inputs()
    yj, sj = jax.jit(jm.ssd_chunked, static_argnums=5)(*inputs, chunk)
    yt, st = tm.ssd_chunked(*map(torch.from_numpy, inputs), chunk)
    assert yt.dtype == torch.float32 and tuple(st.shape) == sj.shape
    np.testing.assert_allclose(_t(yt), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_t(st), np.asarray(sj), rtol=0, atol=1e-5)
    yn, sn = _naive(*inputs)
    np.testing.assert_allclose(_t(yt), yn, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_t(st), sn, rtol=0, atol=1e-4)


def _block(dtype):
    jd, td = DTYPES[dtype]
    cj = JModelConfig(**BLOCK, param_dtype=jd, compute_dtype=jd)
    ct = ModelConfig(**BLOCK, param_dtype=td, compute_dtype=td)
    pj = jm.init_mamba2(jax.random.PRNGKey(0), cj, jd)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_decode_match_reference(dtype):
    """``mamba2_forward`` over 32 tokens (4 chunks of 8), then one
    ``mamba2_decode`` step from the forward's state and tails; the decode
    writes the port's cache in place, with the reference's dtypes."""
    jd, td = DTYPES[dtype]
    out_tol, state_tol = TOL[dtype]
    cj, ct, pj, pt = _block(dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    oj, sj, tj = jax.jit(lambda p, x: jm.mamba2_forward(p, x, cj))(
        pj, jnp.asarray(x, jd))
    ot, st, tt = tm.mamba2_forward(pt, torch.from_numpy(x).to(td), ct)
    assert ot.dtype == td and st.dtype == torch.float32
    np.testing.assert_allclose(_t(ot), _np(oj), rtol=0, atol=out_tol)
    np.testing.assert_allclose(_t(st), _np(sj), rtol=0, atol=state_tol)
    for k in ("x", "B", "C"):
        assert tt[k].dtype == td and tuple(tt[k].shape) == tj[k].shape
        np.testing.assert_allclose(_t(tt[k]), _np(tj[k]), rtol=0,
                                   atol=out_tol)

    cache_j = {"ssm": sj, "conv_x": tj["x"], "conv_B": tj["B"],
               "conv_C": tj["C"]}
    cache_t = {"ssm": st.contiguous(), **{f"conv_{k}": tt[k].clone()
                                          for k in ("x", "B", "C")}}
    views = dict(cache_t)
    xn = rng.standard_normal((2, 1, 64)).astype(np.float32)
    dj, nj = jax.jit(lambda p, x, c: jm.mamba2_decode(p, x, c, cj))(
        pj, jnp.asarray(xn, jd), cache_j)
    dtk, nt = tm.mamba2_decode(pt, torch.from_numpy(xn).to(td), cache_t, ct)
    np.testing.assert_allclose(_t(dtk), _np(dj), rtol=0, atol=out_tol)
    for k, v in nt.items():
        assert v is views[k]                       # written in place
        assert str(v.dtype).split(".")[-1] == str(nj[k].dtype), k
        np.testing.assert_allclose(_t(v), _np(nj[k]), rtol=0,
                                   atol=state_tol if k == "ssm" else out_tol)


@pytest.mark.parametrize("dt_bias", [None, 3.0], ids=["init", "large_dt"])
def test_block_gradient_matches_jax_grad(dt_bias):
    """The gradient of one Mamba block (norm, projections, convs, SSD,
    gate) against ``jax.grad`` of the reference's block, float32."""
    cj, ct, pj, _ = _block("float32")
    bp = {"ln": jnp.zeros((64,), jnp.float32), "mamba": pj}
    if dt_bias is not None:
        bp["mamba"] = dict(pj, dt_bias=jnp.full_like(pj["dt_bias"], dt_bias))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    w = rng.standard_normal((2, 32, 64)).astype(np.float32)

    def loss_j(p, x):
        y, _ = jax_block_fwd(p, x, cj)
        return jnp.sum(y * w)

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(bp, x)
    bt = params_from_numpy(jax.tree.map(np.asarray, bp), device="cpu")
    for leaf in tree_leaves(bt):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (mamba_block_fwd(bt, xt, ct) * torch.from_numpy(w)).sum().backward()
    got = tree_leaves(bt) + [xt]
    want = jax.tree.leaves(gj[0]) + [gj[1]]
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gj[0])[0]] + ["x"]
    for n, a, b in zip(names, got, want):
        assert np.isfinite(_t(a.grad)).all(), n
        b = np.asarray(b)
        np.testing.assert_allclose(_t(a.grad), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=n)


def _smoke(arch, dtype=torch.float32):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    cj = dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                             param_dtype=jd, compute_dtype=jd)
    ct = dataclasses.replace(smoke_config(get_config(arch)),
                             param_dtype=dtype, compute_dtype=dtype)
    return cj, ct


@pytest.mark.parametrize("S", [130, 2])
def test_prompt_lengths_the_chunk_and_the_tail_refuse(S):
    """A prompt longer than ``ssm_chunk`` (128) must be a multiple of it,
    and a prompt must cover the conv tail (K - 1 = 3): the reference
    asserts the first (``AssertionError``); the port raises ``ValueError``
    for both and pads nothing."""
    cj, ct = _smoke("mamba2-130m")
    tokens = np.zeros((1, S), np.int64)
    if S > 128:
        pj = jax_init_params(jax.random.PRNGKey(0), cj)
        with pytest.raises(AssertionError):
            jax_prefill(pj, jnp.asarray(tokens, jnp.int32), cj, S + 4)
    pt = params_from_numpy(jax.tree.map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), cj)), device="cpu")
    with pytest.raises(ValueError, match="chunk|tail"):
        prefill(pt, torch.from_numpy(tokens), ct, S + 4)
    if S > 128:
        with pytest.raises(ValueError, match="chunk"):
            forward(pt, torch.from_numpy(tokens), ct)
    ok = torch.zeros((1, 128 if S > 128 else 3), dtype=torch.int64)
    assert prefill(pt, ok, ct, 132)[1]["pos"] == ok.shape[1]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_cache_shapes_and_dtypes_match_reference(arch):
    """bf16 params and compute: ``init_cache`` holds the float32 SSM state
    and conv tails (and the bf16 KV cache of the hybrid's shared
    applications); after ``prefill`` the tails are the compute-dtype
    projections, the state float32, the KV rows compute-dtype, each
    leaf with the reference's shape and dtype."""
    cj, ct = _smoke(arch, torch.bfloat16)
    B, S, max_len = 2, 12, 20

    def spec(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): (tuple(np.shape(v)),
                                          str(v.dtype).split(".")[-1])
                for p, v in leaves if not np.isscalar(v) and np.ndim(v)}

    def tspec(cache):
        out = {}
        for group in ("attn", "mamba"):
            for k, v in cache.get(group, {}).items():
                out[f"['{group}']['{k}']"] = (tuple(v.shape),
                                              str(v.dtype).split(".")[-1])
        return out

    assert tspec(init_cache(ct, B, max_len, device="cpu")) == spec(
        jax_init_cache(cj, B, max_len))
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    tokens = np.random.default_rng(3).integers(0, cj.vocab, (B, S))
    _, cache_j = jax_prefill(pj, jnp.asarray(tokens, jnp.int32), cj, max_len)
    _, cache_t = prefill(pt, torch.from_numpy(tokens), ct, max_len)
    assert tspec(cache_t) == spec(cache_j)
    assert cache_t["pos"] == int(cache_j["pos"]) == S
    if arch == "zamba2-2.7b":
        assert cache_t["attn"]["k"].shape[0] == 1     # 2 layers // every 2


def test_hybrid_params_cross_the_packages():
    """``convert`` carries smoke zamba2's 29 leaves both ways, in JAX's
    sorted-key order (capitals first), bitwise; ``A_log``, ``Dp``,
    ``dt_bias`` and the norms other than ``gate_norm`` are float32 at bf16
    ``param_dtype``."""
    cj = jax_smoke_config(jax_get_config("zamba2-2.7b"))
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    paths = [jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in jax.tree_util.tree_flatten_with_path(pj)[0]]
    mamba = ["A_log", "Dp", "conv_B", "conv_B_b", "conv_C", "conv_C_b",
             "conv_x", "conv_x_b", "dt_bias", "gate_norm", "out_proj", "w_B",
             "w_C", "w_dt", "w_x", "w_z"]
    assert paths == (["blocks.ln"] + [f"blocks.mamba.{k}" for k in mamba]
                     + ["embed", "final_norm", "lm_head"]
                     + [f"shared_attn.attn.{k}" for k in ("wk", "wo", "wq",
                                                          "wv")]
                     + ["shared_attn.ln1", "shared_attn.ln2"]
                     + [f"shared_attn.mlp.{k}" for k in ("w_down", "w_gate",
                                                         "w_up")])
    f32 = {"blocks.ln", "blocks.mamba.A_log", "blocks.mamba.Dp",
           "blocks.mamba.dt_bias", "final_norm", "shared_attn.ln1",
           "shared_attn.ln2"}
    for name, leaf in zip(paths, tree_leaves(pt)):
        assert leaf.dtype == (torch.float32 if name in f32
                              else torch.bfloat16), name
    back = params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
