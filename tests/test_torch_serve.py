"""The port's serving path (``repro_torch/models/stack.py`` ``prefill`` and
``decode_step``, ``launch/serve.py``) against the JAX package's, on the
CPU.

Both sides start from the reference's parameters (through numpy) and the
same prompts.  The prefill logits of the last position and the cache over
its valid slots are compared, then each decode step's logits with teacher
forcing: both decoders are fed the JAX package's greedy token, and the
port's greedy id must equal it.  Configurations: smoke stablelm at float32
params and compute, and at bfloat16 params and compute (the reference
cannot run float32 params under bfloat16 compute: its layer scan's carry
changes dtype); and a small GQA model (4 heads over 2 kv heads, qk-norm,
``sliding_window`` 16) decoded past the window, so that the ring wraps.

Tolerances, absolute, on logits of magnitude about 3.4-3.7 (measured on
the CPU with jax 0.9.0 and torch 2.13, over prefill, every decode step and
the cache): float32 2e-5 (measured at most 2.9e-6; the frameworks order
their sums differently); bfloat16 0.0625, four bf16 ulps at that
magnitude (measured 0.03125, two ulps: every activation is rounded to 8
bits of mantissa, along paths whose sums run in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import jit_serve as jax_jit_serve
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import jit_serve, make_decode_step
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      prefill)

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 0.0625}
GQA = dict(name="gqa-window", arch_type="dense", n_layers=2, d_model=64,
           vocab=128, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
           qk_norm=True, sliding_window=16, q_chunk=8, kv_chunk=4)
# (config, dtype, batch, prompt length, max_len, decode steps)
CASES = {
    "stablelm_f32": ("stablelm", jnp.float32, 2, 24, 40, 12),
    "stablelm_bf16": ("stablelm", jnp.bfloat16, 2, 24, 40, 12),
    "gqa_window_wraps": ("gqa", jnp.float32, 2, 12, 40, 20),
}


def _configs(which, dtype):
    if which == "stablelm":
        cj = jax_smoke_config(jax_get_config("stablelm-1.6b"))
        ct = smoke_config(get_config("stablelm-1.6b"))
    else:
        cj, ct = JModelConfig(**GQA), ModelConfig(**GQA)
    cj = dataclasses.replace(cj, param_dtype=dtype, compute_dtype=dtype)
    ct = dataclasses.replace(ct, param_dtype=TORCH_DTYPE[dtype],
                             compute_dtype=TORCH_DTYPE[dtype])
    return cj, ct


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=CASES)
def served(request):
    """Both packages' prefill and teacher-forced decode on one case."""
    which, dtype, B, S, max_len, steps = CASES[request.param]
    cj, ct = _configs(which, dtype)
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                            cj.vocab))
    lj, cache_j = jax.jit(lambda p, t: jax_prefill(p, t, cj, max_len))(
        pj, prompts)
    lt, cache_t = prefill(pt, torch.from_numpy(prompts.astype(np.int64)), ct,
                          max_len)
    out = dict(cfg=(cj, ct), dtype=dtype, S=S, prefill=(lj, lt),
               prefill_cache=(cache_j, {k: v.clone() for k, v in
                                        cache_t["attn"].items()}),
               prefill_pos=cache_t["pos"], decode=[])
    dj = jax.jit(lambda p, c, t: jax_decode_step(p, c, t, cj))
    tok = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32) % cj.vocab
    for _ in range(steps):
        lj, cache_j = dj(pj, cache_j, tok)
        lt, cache_t = decode_step(pt, cache_t, torch.from_numpy(tok), ct)
        nxt = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
        out["decode"].append((lj, lt, nxt % cj.vocab))
        tok = nxt % cj.vocab
    out["cache"] = (cache_j, cache_t)
    return out


def test_prefill_logits_match_jax(served):
    lj, lt = served["prefill"]
    assert lt.shape == lj.shape and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0,
                               atol=TOL[served["dtype"]])


def test_prefill_cache_is_in_compute_dtype_and_matches_jax(served):
    cache_j, cache_t = served["prefill_cache"]
    cj, ct = served["cfg"]
    S = served["S"]
    assert served["prefill_pos"] == S
    for name in ("k", "v"):
        t, j = cache_t[name], cache_j["attn"][name]
        assert t.dtype == ct.compute_dtype and tuple(t.shape) == j.shape
        np.testing.assert_allclose(t[:, :, :S].float().numpy(),
                                   _np(j)[:, :, :S], rtol=0,
                                   atol=TOL[served["dtype"]])
        assert not t[:, :, S:].any()


def test_teacher_forced_decode_matches_jax(served):
    for k, (lj, lt, want_ids) in enumerate(served["decode"]):
        np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0,
                                   atol=TOL[served["dtype"]], err_msg=str(k))
        ids = (torch.argmax(lt[:, -1:], dim=-1) % served["cfg"][1].vocab)
        np.testing.assert_array_equal(ids.numpy(), want_ids, err_msg=str(k))


def test_decoded_cache_matches_jax(served):
    cache_j, cache_t = served["cache"]
    n_valid = min(cache_t["pos"], cache_t["attn"]["k"].shape[2])
    assert cache_t["pos"] == int(cache_j["pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache_t["attn"][name][:, :, :n_valid].float().numpy(),
            _np(cache_j["attn"][name])[:, :, :n_valid], rtol=0,
            atol=TOL[served["dtype"]])


def test_window_ring_wraps():
    cj, ct = _configs("gqa", jnp.float32)
    which, _, B, S, max_len, steps = CASES["gqa_window_wraps"]
    assert S + steps > ct.sliding_window
    cache = init_kv_cache(ct, B, max_len, ct.n_layers, device="cpu")
    assert cache["k"].shape[2] == ct.sliding_window
    assert cache["k"].dtype == torch.bfloat16
    with pytest.raises(AssertionError, match="window"):
        prefill(params_from_numpy(jax.tree.map(
            np.asarray, jax_init_params(jax.random.PRNGKey(0), cj)),
            device="cpu"), torch.zeros((1, 17), dtype=torch.int64), ct, 40)


def test_greedy_serve_loop_matches_jax():
    """The greedy pair of ``jit_serve`` free-running: the same int32 ids as
    the reference's ``jit_serve`` at every step, the argmax on the
    device."""
    cj, ct = _configs("stablelm", jnp.float32)
    pj = jax_init_params(jax.random.PRNGKey(2), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (3, 16), 0,
                                            cj.vocab))
    jpre, jdec = jax_jit_serve(cj, 28)
    tpre, tdec = jit_serve(ct, 28)
    tj, cache_j = jpre(pj, prompts)
    tt, cache_t = tpre(pt, torch.from_numpy(prompts.astype(np.int64)))
    for _ in range(12):
        assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        tj, cache_j = jdec(pj, cache_j, tj)
        tt, cache_t = tdec(pt, cache_t, tt)


def test_decode_matches_forward_over_the_whole_sequence():
    """The port against itself: one prefill and one decode step equal the
    training forward over prompt + token at the last position (float32)."""
    _, ct = _configs("gqa", jnp.float32)
    ct = dataclasses.replace(ct, sliding_window=0)
    cj = JModelConfig(**dict(GQA, sliding_window=0))
    pt = params_from_numpy(jax.tree.map(
        np.asarray, jax_init_params(jax.random.PRNGKey(4), cj)), device="cpu")
    tokens = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(5), (2, 9), 0, ct.vocab)).astype(np.int64))
    _, cache = prefill(pt, tokens[:, :8], ct, 16)
    logits, cache = make_decode_step(ct)(pt, cache, tokens[:, 8:])
    with torch.no_grad():
        want = forward(pt, tokens, ct)[:, -1:]
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)
    assert cache["pos"] == 9


def test_other_families_refuse_serving():
    """Every family of the reference serves (the Mamba2 ones in
    ``tests/test_torch_models.py``); a family the port does not know is
    refused with ``ValueError`` before anything is allocated."""
    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              arch_type="rwkv")
    with pytest.raises(ValueError, match="unknown arch_type 'rwkv'"):
        init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown arch_type 'rwkv'"):
        prefill({}, torch.zeros((1, 4), dtype=torch.int64), cfg, 8)
    with pytest.raises(ValueError, match="unknown arch_type 'rwkv'"):
        decode_step({}, {"pos": 0}, torch.zeros((1, 1), dtype=torch.int64),
                    cfg)
