"""Sparsifying compressor, error-feedback memory (EF-LAQ) and the dense
baselines of paper Table 3, port of the parts of
``repro/core/compressors.py`` that the engine runs: support selection
(top-k, and rand-k from :mod:`repro_torch.random`), the sign-magnitude grid
on the survivors, the per-worker residual, and ``qsgd_compress`` /
``ssgd_compress``.

The pipeline stage classes (``TopKSparsifier``, ``UniformQuantizer``,
``CodePacker``, ``CompressorPipeline``) are not ported: no engine path
uses them.

Bit-identity with the reference under jit:

* top-k keeps ``jax.lax.top_k``'s support: NaN ranks above +inf, and
  ties at the k-th largest |d| (NaNs among them) go to the lowest index.
  ``torch.topk`` promises no order among ties, so only its values are
  used, on the non-NaN magnitudes, to find the k-th largest.
* XLA rewrites ``(hi - lo) / L`` (a constant divisor) as ``(hi - lo) *
  f32(1 / L)`` and contracts ``lo + mag * step`` into one FMA; the grid
  here does the same (:func:`repro_torch.core.quantize.fma_f32`).
* rand-k keeps the k largest of p uniform scores drawn with the worker's
  key, ties to the lowest index, as top-k does.
* The b=1 grid's mean ``sum(|v|) / k`` is XLA's CPU reduction
  (:func:`xla_cpu_sum`) times ``f32(1 / k)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import random
from ..tree import tree_flatten, tree_map, tree_unflatten
from .quantize import fma_f32

F32 = torch.float32
COMPRESSORS = ("none", "topk", "randk")
_REDUCE_WINDOW = 32     # XLA CPU's tree-reduction window


def _flat(tree):
    """``(flat, meta)``: the leaves concatenated into one new float32
    vector (a copy even for one leaf, so callers may update it in place)."""
    leaves, treedef = tree_flatten(tree)
    dev = leaves[0].device if leaves else None
    flat = torch.cat([l.reshape(-1).to(F32) for l in leaves]
                     or [torch.zeros(0, dtype=F32, device=dev)])
    return flat, (treedef, [tuple(l.shape) for l in leaves],
                  [l.numel() for l in leaves])


def _unflat(flat, meta):
    """The pytree of ``meta`` as views into ``flat`` (no copy)."""
    treedef, shapes, sizes = meta
    out, off = [], 0
    for sh, sz in zip(shapes, sizes):
        out.append(flat[off:off + sz].reshape(sh))
        off += sz
    return tree_unflatten(treedef, out)


def static_k(k_frac: float, p: int) -> int:
    """Survivor count ``round(k_frac * p)`` clipped to [0, p] (Python's
    round, as the reference's)."""
    if not 0.0 <= k_frac <= 1.0:
        raise ValueError(f"k_frac must lie in [0, 1], got {k_frac}")
    return min(p, max(0, int(round(k_frac * p))))


def compressor_keys(seed: int, step: int, n_workers: int, *,
                    device="cuda") -> torch.Tensor:
    """``[W, 2]`` rand-k selection keys of round ``step``:
    ``fold_in(fold_in(PRNGKey(seed), step), m)`` for worker m."""
    ks = random.fold_in(random.PRNGKey(seed, device=device), step)
    return torch.stack([random.fold_in(ks, m) for m in range(n_workers)])


class SparseSelection(NamedTuple):
    """A sparsifier's output: ``idx`` ascending (int64, torch's index
    type; the reference's is int32), ``vals`` the survivors in that
    order."""
    idx: torch.Tensor
    vals: torch.Tensor


def _topk_support(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Ascending indices of the k largest |flat| in ``jax.lax.top_k``'s
    order: NaN above every number, and ties (NaNs among them) to the
    lowest index.  So the NaN coordinates go first, lowest index first, and
    the places left are filled from the rest.  The survivors are counted
    by ``nonzero``: a sum over the 1-byte mask would first cast it to
    int64, 8 bytes a coordinate."""
    a = flat.abs()
    nan_idx = torch.nonzero(torch.isnan(a)).reshape(-1)
    n_nan = nan_idx.numel()
    if n_nan >= k:
        return nan_idx[:k]
    if n_nan:
        a[nan_idx] = -1.0       # below every |d|: never selected below
        k -= n_nan
    kth = torch.topk(a, k, sorted=False).values.min()
    idx = torch.nonzero(a >= kth).reshape(-1)
    extra = idx.numel() - k
    if extra > 0:
        # more ties at the k-th value than places: drop the highest indices
        a[torch.nonzero(a == kth).reshape(-1)[-extra:]] = -1.0
        idx = torch.nonzero(a >= kth).reshape(-1)
    del a
    if n_nan:
        idx = torch.sort(torch.cat([nan_idx, idx])).values
    return idx


def select_support(mode: str, flat: torch.Tensor, k: int, key=None):
    """Support selection of the sparse wire: ``topk`` keeps the k
    largest-|.| coordinates, ``randk`` the k largest of p uniform scores
    drawn with ``key``, both with ``jax.lax.top_k``'s tie rule; indices
    ascending."""
    p = flat.shape[0]
    if mode not in COMPRESSORS[1:]:
        raise ValueError(f"unknown sparsifier {mode!r}; have {COMPRESSORS[1:]}")
    if mode == "randk" and key is None:
        raise ValueError("randk needs a selection key")
    if k <= 0:
        return SparseSelection(
            torch.zeros(0, dtype=torch.int64, device=flat.device),
            torch.zeros(0, dtype=F32, device=flat.device))
    if k >= p:
        return SparseSelection(torch.arange(p, device=flat.device), flat)
    scores = flat if mode == "topk" else random.uniform(key, (p,))
    idx = _topk_support(scores, k)
    del scores
    return SparseSelection(idx, flat[idx])


def scatter_selection(sel: SparseSelection, vals, p: int) -> torch.Tensor:
    """Dense flat vector with ``vals`` at ``sel.idx``, zeros elsewhere."""
    out = torch.zeros(p, dtype=F32, device=vals.device)
    out[sel.idx] = vals
    return out


def xla_cpu_sum(a: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the 1-D ``a`` in the order of XLA's CPU backend
    under jit (jax 0.9.0), on any device.  A reduction longer than 32 is
    rewritten as a ``reduce-window`` of 32, the input padded by half the
    missing length on each side, each window summed in order from 0, and
    the partial sums reduced again; 32 or fewer are summed in order from 0.
    The padding here is -0.0, which leaves every sum as it is."""
    w = _REDUCE_WINDOW
    while a.shape[0] > w:
        n = a.shape[0]
        pad = -(-n // w) * w - n
        cols = torch.nn.functional.pad(a, (pad // 2, pad - pad // 2),
                                       value=-0.0).reshape(-1, w)
        a = torch.zeros(cols.shape[0], dtype=F32, device=a.device)
        for j in range(w):
            a = a + cols[:, j]
    s = torch.zeros((), dtype=F32, device=a.device)
    for x in a:
        s = s + x
    return s


def sparse_grid(vals: torch.Tensor, bits: int):
    """``(lo, hi)``, the sign-magnitude grid's endpoints (float32 0-d, the
    two wire sidecars): min and max of |v|, or both the mean |v| at b=1,
    whose sum runs in XLA's order (:func:`xla_cpu_sum`) and whose division
    by the constant k is a product with ``f32(1 / k)``, as under jit."""
    if vals.numel() == 0:
        z = torch.zeros((), dtype=F32, device=vals.device)
        return z, z
    a = vals.to(F32).abs()
    if bits == 1:
        mu = xla_cpu_sum(a) * float(torch.tensor(1.0 / a.numel(), dtype=F32))
        return mu, mu
    return a.amin(), a.amax()


def grid_step(lo, hi, bits: int) -> torch.Tensor:
    """``(hi - lo) * f32(1 / max(L, 1))`` with ``L = 2^(b-1) - 1``: the
    reference's ``(hi - lo) / max(L, 1)`` as XLA evaluates it under jit."""
    return (hi - lo) * inv_levels(bits)


def inv_levels(bits: int) -> float:
    """``f32(1 / max(L, 1))``, folded in double and rounded once."""
    L = 2 ** (bits - 1) - 1
    return float(torch.tensor(1.0 / max(L, 1), dtype=F32))


def reference_sparse_quantize(vals, lo, hi, bits: int):
    """``(codes, deq)`` on the survivors: ``codes = (neg << (b-1)) | mag``
    with ``mag = clip(floor((|v| - lo) / step + 1/2), 0, L)`` (0 where
    ``step <= 0``, and where it is NaN) and ``deq = +-fma(mag, step,
    lo)``."""
    L = 2 ** (bits - 1) - 1
    v = vals.to(F32)
    a = v.abs()
    neg = v < 0
    step = grid_step(lo, hi, bits)
    live = step > 0
    safe = torch.where(live, step, torch.ones_like(step))
    mag = torch.floor((a - lo) / safe + 0.5).clamp(0, L)
    # a NaN mag (an infinite step, or a NaN survivor) is 0, as XLA's
    # float-to-uint8 convert writes it, and deq reads the integer mag
    mag = torch.where(live & ~torch.isnan(mag), mag, torch.zeros_like(mag))
    codes = (neg.to(torch.uint8) << (bits - 1)) | mag.to(torch.uint8)
    x = fma_f32(mag, step, lo)
    return codes, torch.where(neg, -x, x)


def sparse_dequantize(codes, lo, hi, bits: int) -> torch.Tensor:
    """Receiver-side inverse of the code map (uint8 codes to float32)."""
    L = 2 ** (bits - 1) - 1
    mag = (codes & L).to(F32)
    neg = (codes >> (bits - 1)).to(F32)
    x = fma_f32(mag, grid_step(lo, hi, bits), lo)
    return (1.0 - 2.0 * neg) * x


class ErrorState(NamedTuple):
    """Per-worker error-feedback residual ``e_m``: a list of W pytrees, or
    ``None`` unless ``StrategyConfig.error_feedback``."""
    residual: Optional[list]


def empty_error_state() -> ErrorState:
    return ErrorState(None)


def init_error_state(error_feedback: bool, grad_template,
                     n_workers: int) -> ErrorState:
    """Zero residual per worker, on the template's device."""
    if not error_feedback:
        return ErrorState(None)
    return ErrorState([tree_map(lambda l: torch.zeros(l.shape, dtype=F32,
                                                      device=l.device),
                                grad_template) for _ in range(n_workers)])


# ---------------------------------------------------------------------------
# Unbiased dense baselines (paper Table 3).
# ---------------------------------------------------------------------------

def qsgd_compress(key, grad, bits: int):
    """QSGD (Alistarh et al., 2017): random b-bit quantization of ``|v| /
    ||v||`` onto ``s = 2^b - 1`` levels, unbiased.  Returns
    ``(compressed_grad, wire_bits)``; the wire carries the norm and b bits
    plus a sign per coordinate.  ``* norm / s`` is ``* norm * f32(1 / s)``
    (XLA rewrites a division by a constant so under jit); the norm is a
    float32 sum of squares in torch's order."""
    v, meta = _flat(grad)
    s = 2.0 ** bits - 1.0
    norm = torch.linalg.vector_norm(v)
    if bool(norm > 0):
        scaled = v.abs() / norm * s
    else:
        scaled = torch.zeros_like(v)
    lo = torch.floor(scaled)
    prob = scaled - lo
    del scaled
    level = lo + (random.uniform(key, v.shape) < prob).to(F32)
    del lo, prob
    out = torch.sign(v) * level * norm * float(torch.tensor(1.0 / s,
                                                            dtype=F32))
    wire_bits = 32.0 + (bits + 1) * v.numel()
    return _unflat(out, meta), torch.tensor(wire_bits, dtype=F32)


def ssgd_compress(key, grad, density: float):
    """SSGD (Wangni et al., 2018): keep coordinate i with probability
    ``min(1, k |v_i| / sum |v|)``, k = density * p, and rescale the kept
    ones by 1/prob (unbiased).  The wire carries a 32-bit value and a
    ``ceil(log2 p)``-bit index per survivor."""
    v, meta = _flat(grad)
    p = v.numel()
    absv = v.abs()
    denom = absv.sum()
    k = float(torch.tensor(density * p, dtype=F32))
    if bool(denom > 0):
        probs = torch.clamp_max(k * absv / denom, 1.0)
    else:
        probs = torch.zeros_like(v)
    del absv
    keep = random.uniform(key, v.shape) < probs
    out = torch.where(keep, v / torch.clamp_min(probs, 1e-12),
                      torch.zeros_like(v))
    nnz = keep.to(F32).sum()
    idx_bits = max(1, int(math.ceil(math.log2(p))))
    return _unflat(out, meta), nnz.cpu() * (32.0 + idx_bits)
