"""Adaptive bit-width selection (A-LAQ) and the per-round stepsize, port of
``repro/core/adaptive.py``.

Each worker picks its width ``b_m^k`` from a small ascending grid each
round: ``kind="radius"`` thresholds the innovation radius (absolute radii,
or with ``threshold_mode="rel"`` fractions of a per-worker decaying peak
envelope of R, the anchor); ``kind="budget"`` also caps the width by a
cumulative per-worker bit budget.  ``kind="constant"`` routes to the
fixed-width path.

The selection runs on the host, on 0-d float32 CPU tensors, with the
reference's float32 operations in its order: a width that flips at a
threshold changes the wire bits, so it has to be exact.  The quantizer
evaluates the grid and selects by mask, as the reference does, so a pinned
selection equals the fixed-width path bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree import tree_map
from .quantize import (dequantize_leaf, fma_f32, innovation, quantize_codes,
                       tau, tree_sq_norm, upload_bits)

F32 = torch.float32


class BitSchedule(NamedTuple):
    kind: str = "constant"          # constant | radius | budget
    bits: int = 4                   # constant-mode width
    grid: tuple = (2, 4, 8)         # ascending candidate widths
    # radius schedule: len(grid)-1 ascending thresholds on R_m^k
    thresholds: tuple = (0.05, 0.5)
    # "abs": absolute radii; "rel": fractions of the worker's anchor radius
    threshold_mode: str = "abs"
    anchor_decay: float = 1.0       # rel only: peak-envelope decay per round
    # budget controller: total per-worker wire bits spread over horizon rounds
    total_bits: float = 0.0
    horizon: int = 0

    @property
    def adaptive(self) -> bool:
        return self.kind != "constant"

    def validate(self):
        def need(ok, what):
            if not ok:
                raise ValueError(f"{what}: {self}")

        need(self.kind in ("constant", "radius", "budget"), "unknown kind")
        need(tuple(sorted(self.grid)) == tuple(self.grid), "grid not ascending")
        need(all(b in (2, 4, 8) for b in self.grid), "grid widths not in (2, 4, 8)")
        need(self.threshold_mode in ("abs", "rel"), "unknown threshold mode")
        if self.adaptive:
            need(len(self.thresholds) == len(self.grid) - 1,
                 "needs len(grid) - 1 thresholds")
            need(tuple(sorted(self.thresholds)) == tuple(self.thresholds),
                 "thresholds not ascending")
        if self.threshold_mode == "rel":
            need(all(t > 0.0 for t in self.thresholds),
                 "rel thresholds are fractions of the anchor radius")
            need(0.0 < self.anchor_decay <= 1.0, "anchor_decay not in (0, 1]")
        if self.kind == "budget":
            need(self.total_bits > 0 and self.horizon > 0,
                 "budget needs total_bits > 0 and horizon > 0")
        return self


class EtaSchedule(NamedTuple):
    """Stepsize schedule ``alpha_k = eta_at(schedule, alpha0, k)``:

    * ``"constant"`` -- ``alpha_k = alpha0``;
    * ``"inv_t"``    -- ``alpha_k = alpha0 * t0 / (t0 + k)``;
    * ``"halving"``  -- ``alpha_k = alpha0 * 0.5^(k // halve_every)``.

    The schedule feeds both the update and eq. 7a's ``1/(alpha^2 M^2)``.
    """
    kind: str = "constant"          # constant | inv_t | halving
    t0: float = 100.0               # inv_t: decay timescale in rounds
    halve_every: int = 100          # halving: stage length in rounds

    @property
    def scheduled(self) -> bool:
        return self.kind != "constant"

    def validate(self):
        if self.kind not in ("constant", "inv_t", "halving"):
            raise ValueError(f"unknown eta schedule {self.kind!r}")
        if self.kind == "inv_t" and not self.t0 > 0:
            raise ValueError(f"inv_t needs t0 > 0: {self}")
        if self.kind == "halving" and self.halve_every < 1:
            raise ValueError(f"halving needs halve_every >= 1: {self}")
        return self


def eta_at(schedule: EtaSchedule, alpha0, step):
    """Stepsize of round ``step`` (0-based).

    The constant path returns ``alpha0`` itself, a Python float, as the
    reference does: downstream ``alpha**2`` then stays double until it
    meets a float32 tensor.  The scheduled paths return a float32 0-d CPU
    tensor computed with the reference's float32 operations.
    """
    schedule.validate()
    if schedule.kind == "constant":
        return alpha0
    k = torch.tensor(float(step), dtype=torch.float32)
    if schedule.kind == "inv_t":
        # alpha0 * t0 is Python (double) arithmetic in the reference too
        return (torch.tensor(alpha0 * schedule.t0, dtype=torch.float32)
                / (torch.tensor(schedule.t0, dtype=torch.float32) + k))
    return alpha0 * torch.pow(torch.tensor(0.5, dtype=torch.float32),
                              torch.floor(k / schedule.halve_every))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32).cpu()


def grid_costs(schedule: BitSchedule, p: int, n_radii: int = 1) -> torch.Tensor:
    """Per-upload wire cost of each grid width (codes + R/b sidecars), the
    integers rounded to float32 as ``jnp.asarray(..., float32)`` does."""
    return torch.tensor([float(upload_bits(p, b, n_radii=n_radii,
                                           bit_sidecar=True))
                         for b in schedule.grid], dtype=F32)


def select_bits(schedule: BitSchedule, R, bits_spent, step, p: int,
                n_radii: int = 1, R_anchor=None, *, eager: bool = False):
    """This worker's width for the round: ``(b_sel, onehot, anchor_new)``,
    float32 CPU tensors (0-d, [G], 0-d).  ``R`` is the innovation radius,
    ``bits_spent`` the worker's cumulative wire bits, ``step`` the round
    index, ``R_anchor`` the worker's anchor (``None`` means 0).

    Same float32 operations as the reference under jit, in its order:
    ``th = f32(thresholds) * anchor_new`` with ``anchor_new = max(R,
    f32(decay) * anchor_prev)`` in "rel" mode; ``idx = sum(R > th)``; the
    budget's ``allowance = f32(rate) * (step + 1) + cost[-1] - spent``,
    whose multiply and add XLA contracts into one FMA.  ``eager=True``
    rounds that product and sum on their own, as the reference does when
    it is called outside ``jit`` (the publisher, ``core/replica.py``).
    """
    schedule.validate()
    G = len(schedule.grid)
    R = _f32(R)
    th = torch.tensor(schedule.thresholds, dtype=F32)
    anchor_prev = _f32(0.0 if R_anchor is None else R_anchor)
    if schedule.threshold_mode == "rel":
        anchor_new = torch.maximum(R, _f32(schedule.anchor_decay) * anchor_prev)
        th = th * anchor_new
    else:
        anchor_new = anchor_prev
    idx = int((R > th).sum())
    if schedule.kind == "budget":
        costs = grid_costs(schedule, p, n_radii)
        rate = float(schedule.total_bits) / float(schedule.horizon)
        rounds = _f32(float(step)) + 1.0
        pro_rata = (_f32(rate) * rounds + costs[-1] if eager
                    else fma_f32(_f32(rate), rounds, costs[-1]))
        allowance = pro_rata - _f32(bits_spent)
        fits = (costs <= allowance).nonzero().reshape(-1)
        idx = min(idx, int(fits.max()) if fits.numel() else 0)
    onehot = torch.zeros(G, dtype=F32)
    onehot[idx] = 1.0
    b_sel = (onehot * torch.tensor(schedule.grid, dtype=F32)).sum()
    return b_sel, onehot, anchor_new


def quantize_dynamic(diff, R_tree, grid, onehot):
    """Codes for the selected width: every grid width evaluated, then
    selected by mask (the reference's staged form)."""
    def leaf(d, R):
        out = None
        for i, b in enumerate(grid):
            q = quantize_codes(d, R, b)
            out = q if out is None else torch.where(onehot[i] > 0, q, out)
        return out
    return tree_map(leaf, diff, R_tree)


def tau_of_selection(grid, onehot) -> torch.Tensor:
    """``tau(b_sel)`` selected from the per-grid float32 constants."""
    taus = torch.tensor([tau(b) for b in grid], dtype=F32)
    return (taus * onehot.to(F32).cpu()).sum()


def tau_of_width(grid, b) -> torch.Tensor:
    """Per-worker tau looked up from a width sidecar ``b`` (any shape); a
    table lookup, so it matches :func:`tau_of_selection` bit for bit."""
    b = torch.as_tensor(b, dtype=F32)
    grid_arr = torch.tensor(grid, dtype=F32, device=b.device)
    taus = torch.tensor([tau(g) for g in grid], dtype=F32, device=b.device)
    return torch.where(grid_arr == b[..., None], taus,
                       torch.zeros_like(taus)).sum(-1)


def dequantize_dynamic(codes, R_tree, t_sel):
    """``delta = 2 tau(b_sel) R q - R``, rounded once (one FMA, as XLA
    contracts it); 0 where ``R == 0``.  ``2 * t_sel`` is exact, so this is
    the fixed-width dequantization at the selected width."""
    two_tau = 2.0 * t_sel
    return tree_map(lambda q, R: dequantize_leaf(q, R, two_tau=two_tau),
                    codes, R_tree)


def staged_adaptive_pass(grad, qhat, diff, R_tree, grid, onehot):
    """The staged quantize step at the width ``onehot`` selects, given the
    innovation: ``(q_new, delta, err_sq, innovation_sq)``."""
    codes = quantize_dynamic(diff, R_tree, grid, onehot)
    delta = dequantize_dynamic(codes, R_tree, tau_of_selection(grid, onehot))
    q_new = tree_map(lambda q, d: q.to(F32) + d, qhat, delta)
    err_sq = tree_sq_norm(tree_map(lambda g, qn: g.to(F32) - qn, grad, q_new))
    return q_new, delta, err_sq, tree_sq_norm(delta)


def adaptive_roundtrip(grad, qhat, grid, onehot, per_leaf: bool = False):
    """Dynamic-width analogue of the fixed roundtrip: ``(q_new, delta,
    R_max, err_sq)`` for the width encoded in ``onehot``."""
    diff, R_tree, R_max = innovation(grad, qhat, per_leaf)
    q_new, delta, err_sq, _ = staged_adaptive_pass(grad, qhat, diff, R_tree,
                                                   grid, onehot)
    return q_new, delta, R_max, err_sq
