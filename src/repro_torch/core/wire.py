"""Wire backends: port of ``repro/core/wire.py``.

* ``reference`` -- the staged path of :mod:`repro_torch.core.quantize` and
  :mod:`repro_torch.core.adaptive`.
* ``fused`` -- the two-pass pipeline: pass 1 reduces each leaf's radius
  with :func:`repro_torch.kernels.ops.absmax`, pass 2 emits codes, the
  packed payload, delta, q_new and both criterion moments in one sweep
  with :func:`repro_torch.kernels.ops.quantize_pack_fused`, or at a width
  chosen per round with :func:`~repro_torch.kernels.ops.quantize_pack_adaptive`.
  The dispatch layer picks the CUDA kernel or its plain version by the
  tensors' device, so the backend has no lowering option of its own.

The per-leaf primitives of the streamed sharded wire
(``launch/train.py`` ``_packed_aggregate``) are ``leaf_absmax``,
``leaf_quantize`` and ``leaf_quantize_adaptive``: their base-class bodies
are the reference expressions, and the fused backend swaps in kernels 1,
5 and 6 (:func:`~repro_torch.kernels.ops.absmax`,
:func:`~repro_torch.kernels.ops.quantize_codes_fused`,
:func:`~repro_torch.kernels.ops.quantize_codes_adaptive`).  The receive
side ``dequant_acc`` decodes ``[W, nbytes]`` packed payloads and sums them:
the reference backend in the reference's order (the workers from 0, then
``acc + sum``), the fused backend through
:func:`~repro_torch.kernels.ops.dequant_acc` in the Pallas kernel's order
(``acc`` first, then worker by worker).  Without ``acc`` the two are
bitwise equal; with it they agree to float32 rounding.

The sparse wire (EF-LAQ, :func:`sparse_roundtrip`) shares its selection,
grid, scatter and payload code between the backends; only the quantize
map on the survivors goes through the backend
(:func:`~repro_torch.kernels.ops.sparse_quantize_pack` on the fused one).

Contract (as in the reference): codes, radii, delta and q_new are
bit-identical across backends; the moments agree to float32 reduction
accuracy.  Payload layout: ``docs/wire-format.md``; the fused payload is
``ceil(n b / 8)`` bytes per leaf with midpoint-padded tail lanes, the same
bytes the reference backend emits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.ref import dequant_acc_ref
from ..tree import tree_flatten, tree_leaves, tree_unflatten
from .adaptive import (dequantize_dynamic, quantize_dynamic,
                       staged_adaptive_pass)
from .compressors import (_flat, _unflat, reference_sparse_quantize,
                          scatter_selection, select_support, sparse_grid)
from .quantize import (dequantize_leaf, innovation, pack_codes, pad_codes,
                       quantize_codes, roundtrip_parts, tree_sq_norm,
                       two_tau_f32)

F32 = torch.float32


class WireRoundtrip(NamedTuple):
    """Everything one round's quantize step produces for one worker."""
    q_new: object           # Q_m(theta^k) = qhat + delta
    delta: object           # dequantized innovation deltaQ_m^k
    R_tree: object          # per-leaf radii (global R replicated if not per-leaf)
    R_max: torch.Tensor     # max leaf radius (paper Fig. 3 diagnostic)
    err_sq: torch.Tensor    # ||grad - q_new||^2  (criterion eps term)
    innovation_sq: torch.Tensor  # ||delta||^2    (criterion LHS)
    payload: Optional[list]  # per-leaf packed uint8 codes (with_payload only)


class WireBackend:
    """Interface: radius reduction, the dense quantize roundtrip at a fixed
    or a per-round width, the per-leaf primitives of the streamed sharded
    wire, the receive side and the sparse wire's quantize map.

    The per-leaf primitives' base-class bodies ARE the reference
    expressions, so every backend inherits bit-identical wire content;
    the fused backend overrides them only to launch the kernels."""

    name = "?"

    def innovation(self, grad, qhat, per_leaf: bool = False):
        """``(diff, R_tree, R_max)``, same contract as quantize.innovation
        (the fused backend returns ``diff=None``: nothing of it reads the
        diff)."""
        raise NotImplementedError

    def roundtrip(self, grad, qhat, bits: int, per_leaf: bool = False,
                  with_payload: bool = False, R_tree=None) -> WireRoundtrip:
        """The dense quantize step.  ``R_tree``: per-leaf radii that a
        pass 1 of this backend already reduced (``per_leaf`` only); the
        fused backend then skips its own pass 1, the reference backend
        reduces them again, to the same values."""
        raise NotImplementedError

    def adaptive_roundtrip(self, grad, qhat, diff, R_tree, grid, onehot):
        """Dynamic-width roundtrip ``(q_new, delta, err_sq, innovation_sq)``
        at the width ``onehot`` selects from the static ``grid``; ``diff``
        and ``R_tree`` come from this backend's :meth:`innovation`."""
        raise NotImplementedError

    def sparse_quantize(self, vals, lo, hi, bits: int):
        """``(codes uint8 [k], deq f32 [k])`` on the gathered survivors."""
        raise NotImplementedError

    def leaf_absmax(self, g, qh):
        """Scalar ``||g - qh||_inf`` for one leaf (f32): the radius
        pre-pass of the streamed wire; an empty leaf gives 0."""
        if not g.numel():
            return torch.zeros((), dtype=F32, device=g.device)
        return (g.to(F32) - qh.to(F32)).abs().amax()

    def leaf_quantize(self, g, qh, R, bits: int):
        """``(codes, delta)`` of one leaf at one width, both leaf-shaped
        (codes uint8, delta f32): the send-side sweep of the streamed
        wire, whose axis codec packs the codes along the last dim."""
        codes = quantize_codes(g.to(F32) - qh.to(F32), R, bits)
        return codes, dequantize_leaf(codes, R, bits)

    def leaf_quantize_adaptive(self, g, qh, R, grid, onehot, t_sel):
        """:meth:`leaf_quantize` at the width ``onehot`` selects from the
        ascending ``grid``; ``t_sel`` is ``tau_of_selection(grid,
        onehot)``, computed once per round by the caller."""
        codes = quantize_dynamic(g.to(F32) - qh.to(F32), R, grid, onehot)
        return codes, dequantize_dynamic(codes, R, t_sel)

    def dequant_acc(self, packed, R, keep, bits: int, n: int, acc=None):
        """Server side: ``(acc +) sum_w keep_w * dequant(packed_w, R_w)``,
        float32 ``[n]``, from uint8 ``[W, nbytes]`` payloads."""
        raise NotImplementedError


class ReferenceWire(WireBackend):
    """The staged path of core/quantize.py (the tests' ground truth)."""

    name = "reference"

    def innovation(self, grad, qhat, per_leaf=False):
        return innovation(grad, qhat, per_leaf)

    def roundtrip(self, grad, qhat, bits, per_leaf=False, with_payload=False,
                  R_tree=None):
        qints, R_tree, delta, q_new, R_max, err_sq = roundtrip_parts(
            grad, qhat, bits, per_leaf)
        innovation_sq = tree_sq_norm(delta)
        payload = None
        if with_payload:
            payload = [pack_codes(pad_codes(q.reshape(-1), bits), bits)
                       for q in tree_leaves(qints)]
        return WireRoundtrip(q_new, delta, R_tree, R_max, err_sq,
                             innovation_sq, payload)

    def adaptive_roundtrip(self, grad, qhat, diff, R_tree, grid, onehot):
        return staged_adaptive_pass(grad, qhat, diff, R_tree, grid, onehot)

    def sparse_quantize(self, vals, lo, hi, bits):
        return reference_sparse_quantize(vals, lo, hi, bits)

    def dequant_acc(self, packed, R, keep, bits, n, acc=None):
        """The reference's order: the workers summed from 0, then ``acc``
        added to the sum (the fused backend adds ``acc`` first)."""
        out = dequant_acc_ref(packed, R.to(F32), keep.to(F32), bits, n)
        return out if acc is None else acc.reshape(-1).to(F32) + out


class FusedWire(WireBackend):
    """The two-pass pipeline through the kernel dispatch layer."""

    name = "fused"

    def leaf_absmax(self, g, qh):
        """Scalar ``||g - qh||_inf`` for one leaf (f32); 0 for an empty
        leaf."""
        return ops.absmax(g, qh)

    def _radii(self, g_leaves, q_leaves, per_leaf):
        maxes = [self.leaf_absmax(g, qh) for g, qh in zip(g_leaves, q_leaves)]
        R = torch.stack(maxes).amax()    # an empty leaf's 0 changes no max
        return (maxes if per_leaf else [R for _ in g_leaves]), R

    def innovation(self, grad, qhat, per_leaf=False):
        """Radius via the pass-1 reduction, and ``diff=None``: pass 2
        recomputes ``g - qh`` inside its sweep, so the diff is never
        materialized (a full model copy per worker)."""
        g_leaves, treedef = tree_flatten(grad)
        R_leaves, R_max = self._radii(g_leaves, tree_leaves(qhat), per_leaf)
        return None, tree_unflatten(treedef, R_leaves), R_max

    def roundtrip(self, grad, qhat, bits, per_leaf=False, with_payload=False,
                  R_tree=None):
        if bits not in (1, 2, 4, 8):
            raise ValueError("the fused wire backend covers the packed-width "
                             f"grid (1, 2, 4, 8), got bits={bits}")
        g_leaves, treedef = tree_flatten(grad)
        q_leaves = tree_leaves(qhat)
        if R_tree is None:
            R_leaves, R_max = self._radii(g_leaves, q_leaves, per_leaf)
        else:
            if not per_leaf:
                raise ValueError("R_tree carries per-leaf radii")
            R_leaves = tree_leaves(R_tree)
            R_max = torch.stack(R_leaves).amax()

        delta_leaves, qnew_leaves, payload = [], [], []
        err_parts, inn_parts = [], []
        for g, qh, R in zip(g_leaves, q_leaves, R_leaves):
            pk, dl, qn, esq, isq = ops.quantize_pack_fused(g, qh, R, bits)
            delta_leaves.append(dl.reshape(g.shape))
            qnew_leaves.append(qn.reshape(g.shape))
            err_parts.append(esq)
            inn_parts.append(isq)
            # drop each leaf's payload at once unless asked for: all 12
            # stablelm-1.6b payloads together are 1.6 GB at b=8
            payload.append(pk if with_payload else None)

        err_sq = torch.stack(err_parts).sum()
        inn_sq = torch.stack(inn_parts).sum()
        return WireRoundtrip(
            q_new=tree_unflatten(treedef, qnew_leaves),
            delta=tree_unflatten(treedef, delta_leaves),
            R_tree=tree_unflatten(treedef, R_leaves),
            R_max=R_max, err_sq=err_sq, innovation_sq=inn_sq,
            payload=payload if with_payload else None)

    def adaptive_roundtrip(self, grad, qhat, diff, R_tree, grid, onehot):
        """Adaptive pass 2 as one sweep per leaf; ``diff`` is unused."""
        grid = tuple(grid)
        g_leaves, treedef = tree_flatten(grad)
        delta_leaves, qnew_leaves, err_parts, inn_parts = [], [], [], []
        for g, qh, R in zip(g_leaves, tree_leaves(qhat), tree_leaves(R_tree)):
            _, dl, qn, esq, isq = ops.quantize_pack_adaptive(g, qh, R, onehot,
                                                             grid)
            delta_leaves.append(dl.reshape(g.shape))
            qnew_leaves.append(qn.reshape(g.shape))
            err_parts.append(esq)
            inn_parts.append(isq)
        return (tree_unflatten(treedef, qnew_leaves),
                tree_unflatten(treedef, delta_leaves),
                torch.stack(err_parts).sum(), torch.stack(inn_parts).sum())

    def leaf_quantize(self, g, qh, R, bits):
        if not g.numel():
            return super().leaf_quantize(g, qh, R, bits)
        codes, delta = ops.quantize_codes_fused(g, qh, R, bits)
        return codes.reshape(g.shape), delta.reshape(g.shape)

    def leaf_quantize_adaptive(self, g, qh, R, grid, onehot, t_sel):
        if not g.numel():
            return super().leaf_quantize_adaptive(g, qh, R, grid, onehot,
                                                  t_sel)
        codes, delta = ops.quantize_codes_adaptive(g, qh, R, onehot,
                                                   tuple(grid))
        return codes.reshape(g.shape), delta.reshape(g.shape)

    def dequant_acc(self, packed, R, keep, bits, n, acc=None):
        """:func:`repro_torch.kernels.ops.dequant_acc` on either device:
        ``acc`` first, then worker by worker."""
        return ops.dequant_acc(packed, R.to(F32), keep.to(F32), bits, n, acc)

    def sparse_quantize(self, vals, lo, hi, bits):
        _, codes, deq = ops.sparse_quantize_pack(vals, lo, hi, bits)
        return codes, deq


_BACKENDS = {
    "reference": ReferenceWire(),
    "fused": FusedWire(),
}


def get_backend(name) -> WireBackend:
    """Resolve a backend by name (a WireBackend instance passes through)."""
    if isinstance(name, WireBackend):
        return name
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire backend {name!r}; have {sorted(_BACKENDS)}") from None


class SparseRoundtrip(NamedTuple):
    """One worker's sparse quantize step."""
    q_new: object           # qhat + delta (views into one flat vector)
    delta: object           # sparse-valued dequantized innovation (views)
    lo: torch.Tensor        # grid floor sidecar (f32 0-d)
    R: torch.Tensor         # grid ceiling sidecar, max |survivor|
    err_sq: torch.Tensor    # support-restricted quantization error
    innovation_sq: torch.Tensor  # ||delta||^2
    idx: torch.Tensor       # [k] ascending support (the index payload)
    codes: torch.Tensor     # uint8 [k] b-bit codes
    payload: Optional[torch.Tensor]  # packed code bytes (with_payload only)


def sparse_roundtrip(backend, grad, qhat, bits: int, k: int, mode: str,
                     with_payload: bool = False, *,
                     key=None) -> SparseRoundtrip:
    """Sparsify-then-quantize over the flattened innovation ``grad -
    qhat`` (``grad`` is the EF-corrected gradient): k coordinates survive
    (``mode="topk"``, or ``"randk"`` with the worker's selection ``key``),
    are quantized on the sign-magnitude b-bit grid over
    their ``[lo, hi]``, and are scattered back into a dense delta.

    ``err_sq`` is the support-restricted error ``sum_S (d_i - deq_i)^2``
    (the dropped tail is the residual's, not wire noise) and
    ``innovation_sq`` is ``||deq||^2``, which equals ``||delta||^2``.

    Memory: the innovation is formed in place in the flat copy of
    ``grad`` and dropped once the survivors are gathered; q_new is formed
    in place in the flat copy of ``qhat``.  So at its peak the roundtrip
    holds two flat copies, |d| and a mask, and returns q_new and delta as
    views of two flat vectors.
    """
    backend = get_backend(backend)
    d, meta = _flat(grad)
    q_new, _ = _flat(qhat)
    d.sub_(q_new)                       # the innovation, in place
    sel = select_support(mode, d, k, key)
    p = d.shape[0]
    del d
    lo, hi = sparse_grid(sel.vals, bits)
    codes, deq = backend.sparse_quantize(sel.vals, lo, hi, bits)
    delta = scatter_selection(sel, deq, p)
    q_new.add_(delta)                   # qhat + delta, in place
    err = sel.vals - deq
    payload = (pack_codes(pad_codes(codes, bits), bits) if with_payload
               else None)
    return SparseRoundtrip(q_new=_unflat(q_new, meta),
                           delta=_unflat(delta, meta), lo=lo, R=hi,
                           err_sq=(err * err).sum(),
                           innovation_sq=(deq * deq).sum(), idx=sel.idx,
                           codes=codes, payload=payload)


def codes_of_delta(delta: torch.Tensor, R, bits: int) -> torch.Tensor:
    """Inverse of the dequantization on one leaf: the uint8 codes of
    ``delta``, ``round((delta + R) / (2 tau R))`` clipped to the grid, and
    the midpoint code where ``R == 0``.  The rounding is half to even, as
    ``jnp.round`` (the kernels' ``floor(x + 1/2)`` is the forward map's),
    and the division a true float32 division, as XLA keeps it for a
    runtime divisor.  Exact on the dequantization's own output: its
    rounding noise is far below the half step the round absorbs."""
    R = torch.as_tensor(R, dtype=F32, device=delta.device)
    levels = 2**bits - 1
    live = R > 0
    denom = torch.where(live, two_tau_f32(bits, R.device) * R,
                        torch.ones_like(R))
    q = torch.round((delta.to(F32) + R) / denom).clamp_(0, levels)
    q = torch.where(live, q, torch.full_like(q, (levels + 1) // 2))
    return q.to(torch.uint8)


def delta_of_codes(codes: torch.Tensor, R, bits: int) -> torch.Tensor:
    """Re-emit the dequantized leaf from (possibly edited) codes: the
    expression of quantize.dequantize_innovation, per leaf, rounded once
    as XLA contracts it under jit (see :func:`delta_of_codes_eager`)."""
    return dequantize_leaf(codes, torch.as_tensor(R, dtype=F32,
                                                  device=codes.device), bits)


def delta_of_codes_eager(codes: torch.Tensor, R, bits: int) -> torch.Tensor:
    """The same dequantization as eager (un-jitted) JAX rounds it:
    ``(f32(2 tau) R) q - R`` with the product and the difference each
    rounded on their own, 0 where ``R == 0``.

    There are two forms because the reference evaluates the one expression
    in two ways.  The engine and the sharded step run under ``jit``, where
    XLA contracts it into one FMA: :func:`delta_of_codes`.  The publisher
    and the replica (``core/replica.py``) run eagerly, between rounds, and
    eager JAX does not contract: this form, which the two use on both
    sides of the wire.  On the same codes they differ in the last bit on
    nearly half the elements."""
    R = torch.as_tensor(R, dtype=F32, device=codes.device)
    d = two_tau_f32(bits, R.device) * R * codes.to(F32) - R
    return torch.where(R > 0, d, torch.zeros_like(d))


# ---------------------------------------------------------------------------
# The axis-packed payload of the sharded wire: 8/b codes per byte ALONG THE
# LAST DIM, little-end-first (docs/wire-format.md, section 3).  A leaf whose
# last dim 8/b does not divide, and every leaf at b=8, ships raw codes.
# ---------------------------------------------------------------------------

def axis_packable(q: torch.Tensor, bits: int) -> bool:
    cpb = 8 // bits
    return cpb > 1 and q.dim() >= 1 and q.shape[-1] % cpb == 0


def pack_codes_along_axis(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack 8/b codes per byte along the last dim (raw uint8 codes where
    :func:`axis_packable` is False)."""
    if not axis_packable(q, bits):
        return q
    cpb = 8 // bits
    parts = q.reshape(q.shape[:-1] + (q.shape[-1] // cpb, cpb))
    acc = parts[..., 0].clone()
    for j in range(1, cpb):
        acc |= parts[..., j] << (bits * j)
    return acc


def unpack_codes_along_axis(payload: torch.Tensor, bits: int,
                            orig) -> torch.Tensor:
    """Inverse of :func:`pack_codes_along_axis`; ``orig`` (the leaf, or
    anything with its ``shape`` and ``dim()``) gives the unpacked shape and
    whether packing applied."""
    if not axis_packable(orig, bits):
        return payload
    cpb = 8 // bits
    shifts = torch.arange(cpb, dtype=torch.uint8,
                          device=payload.device) * bits
    parts = (payload[..., None] >> shifts) & ((1 << bits) - 1)
    return parts.reshape(orig.shape)
