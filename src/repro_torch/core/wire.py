"""Wire backends, dense part: port of ``repro/core/wire.py``.

* ``reference`` -- the staged path of :mod:`repro_torch.core.quantize`.
* ``fused`` -- the two-pass pipeline: pass 1 reduces each leaf's radius
  with :func:`repro_torch.kernels.ops.absmax`, pass 2 emits codes, the
  packed payload, delta, q_new and both criterion moments in one sweep
  with :func:`repro_torch.kernels.ops.quantize_pack_fused`.  The dispatch
  layer picks the CUDA kernel or its plain version by the tensors' device,
  so the backend has no lowering option of its own.

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
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .quantize import (innovation, pack_codes, pad_codes, roundtrip_parts,
                       tree_sq_norm)

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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1: {item})")


class WireBackend:
    """Interface: radius reduction and the quantize roundtrip.  The
    adaptive, sparse, per-leaf streamed and receive-side methods of the
    reference interface raise until their ROADMAP items land."""

    name = "?"

    def innovation(self, grad, qhat, per_leaf: bool = False):
        """``(diff, R_tree, R_max)``, same contract as quantize.innovation."""
        raise NotImplementedError

    def roundtrip(self, grad, qhat, bits: int, per_leaf: bool = False,
                  with_payload: bool = False) -> WireRoundtrip:
        raise NotImplementedError

    def leaf_quantize(self, g, qh, R, bits: int):
        _not_ported("the streamed sharded wire", "Sharded step")

    def leaf_quantize_adaptive(self, g, qh, R, grid, onehot, t_sel):
        _not_ported("the adaptive streamed wire", "Adaptive width")

    def adaptive_roundtrip(self, grad, qhat, diff, R_tree, grid, onehot):
        _not_ported("the adaptive roundtrip", "Adaptive width")

    def dequant_acc(self, packed, R, keep, bits: int, n: int, acc=None):
        _not_ported("the receive side (dequant_acc)", "Receive side of the wire")

    def sparse_quantize(self, vals, lo, hi, bits: int):
        _not_ported("the sparse wire", "Compressors and EF-LAQ")


class ReferenceWire(WireBackend):
    """The staged path of core/quantize.py (the tests' ground truth)."""

    name = "reference"

    def innovation(self, grad, qhat, per_leaf=False):
        return innovation(grad, qhat, per_leaf)

    def roundtrip(self, grad, qhat, bits, per_leaf=False, with_payload=False):
        qints, R_tree, delta, q_new, R_max, err_sq = roundtrip_parts(
            grad, qhat, bits, per_leaf)
        innovation_sq = tree_sq_norm(delta)
        payload = None
        if with_payload:
            payload = [pack_codes(pad_codes(q.reshape(-1), bits), bits)
                       for q in tree_leaves(qints)]
        return WireRoundtrip(q_new, delta, R_tree, R_max, err_sq,
                             innovation_sq, payload)


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
        """Radius via the pass-1 reduction; the diff is materialized here
        (the reference keeps it a lazy expression for the adaptive
        quantizer, which is not ported yet)."""
        diff = tree_map(lambda g, q: g.to(F32) - q.to(F32), grad, qhat)
        g_leaves, treedef = tree_flatten(grad)
        R_leaves, R_max = self._radii(g_leaves, tree_leaves(qhat), per_leaf)
        return diff, tree_unflatten(treedef, R_leaves), R_max

    def roundtrip(self, grad, qhat, bits, per_leaf=False, with_payload=False):
        if bits not in (1, 2, 4, 8):
            raise ValueError("the fused wire backend covers the packed-width "
                             f"grid (1, 2, 4, 8), got bits={bits}")
        g_leaves, treedef = tree_flatten(grad)
        q_leaves = tree_leaves(qhat)
        R_leaves, R_max = self._radii(g_leaves, q_leaves, per_leaf)

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
