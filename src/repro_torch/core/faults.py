"""Fault injection: corrupt, crashed and Byzantine workers, port of
``repro/core/faults.py`` (:mod:`repro_torch.core.defense` holds the
countermeasures).

A :class:`FaultConfig` rides in ``StrategyConfig.faults`` and the engine
applies it each round.  Every fault is a pure function of ``(fault_seed,
stream, step, worker)`` through ``fold_in`` (:mod:`repro_torch.random`,
the ``jax.random`` draws bit for bit), independent of the batch,
compressor and participation streams, so a faulty run replays exactly,
which the watchdog's rollback relies on.

Three families, drawn per worker and round:

* payload corruption (``corrupt_p``, ``corrupt_kind``): ``"nan"`` /
  ``"inf"`` poison, ``"sign_flip"``, ``"scale"`` (times ``corrupt_scale``)
  on the outgoing gradient, or ``"bitflip"``: MSB flips on a
  ``bitflip_frac`` fraction of the wire codes inside ``worker_update``
  (:func:`flip_wire_codes`, through the exact inverse maps of
  :mod:`repro_torch.core.wire`).
* crash-restart (``crash_p``): the worker loses its per-worker state and
  restarts its clock at ``t_bar``, so its next reachable round re-uploads
  densely (:func:`apply_crashes`).  A reconciling server subtracts the
  stale ``qhat_m`` from its aggregate.
* Markov churn lives with the participation models
  (:mod:`repro_torch.core.engine`).

The port's worker axis is a list: the masks are ``[W]`` bool CPU tensors,
:func:`corrupt_grad` damages one worker's gradient, and
:func:`apply_crashes` resets the per-worker lists of a ``CommState`` in
place, leaf by leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import random
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .wire import codes_of_delta, delta_of_codes

F32 = torch.float32
CORRUPT_KINDS = ("nan", "inf", "sign_flip", "scale", "bitflip")

# fold_in stream ids under PRNGKey(fault_seed), disjoint by construction
_STREAM_CORRUPT = 0
_STREAM_CRASH = 1
_STREAM_BITFLIP = 2


class FaultConfig(NamedTuple):
    """Fault-injection knobs (``StrategyConfig.faults``).  All-zero
    probabilities (the default) switch every fault path off."""
    corrupt_p: float = 0.0      # per-worker per-round payload-corruption prob
    corrupt_kind: str = "nan"   # one of CORRUPT_KINDS
    corrupt_scale: float = 50.0  # multiplier of the "scale" Byzantine fault
    bitflip_frac: float = 0.05  # fraction of wire codes MSB-flipped per
                                # corrupted upload ("bitflip" kind)
    crash_p: float = 0.0        # per-worker per-round crash-restart prob
    fault_seed: int = 0         # seed of the fault streams

    @property
    def active(self) -> bool:
        return self.corrupt_p > 0.0 or self.crash_p > 0.0

    @property
    def grad_faulty(self) -> bool:
        """Gradient-level corruption (applied by the engine before encode)."""
        return self.corrupt_p > 0.0 and self.corrupt_kind != "bitflip"

    @property
    def wire_faulty(self) -> bool:
        """Code-level corruption (applied inside ``worker_update``)."""
        return self.corrupt_p > 0.0 and self.corrupt_kind == "bitflip"

    @property
    def crashy(self) -> bool:
        return self.crash_p > 0.0


def _stream_key(fc: FaultConfig, stream: int, step: int):
    return random.fold_in(random.fold_in(
        random.PRNGKey(fc.fault_seed, device="cpu"), stream), int(step))


def corruption_mask(fc: FaultConfig, step: int, n_workers: int):
    """[W] bool: which workers emit a corrupted payload this round."""
    return random.bernoulli(_stream_key(fc, _STREAM_CORRUPT, step),
                            fc.corrupt_p, (n_workers,))


def crash_mask(fc: FaultConfig, step: int, n_workers: int):
    """[W] bool: which workers crash-restart at the start of this round."""
    return random.bernoulli(_stream_key(fc, _STREAM_CRASH, step),
                            fc.crash_p, (n_workers,))


def bitflip_keys(fc: FaultConfig, step: int, n_workers: int):
    """``[W, 2]`` per-worker keys of the wire-code flip positions."""
    ks = _stream_key(fc, _STREAM_BITFLIP, step)
    return torch.stack([random.fold_in(ks, m) for m in range(n_workers)])


def corrupt_grad(grad_m, fc: FaultConfig, *, inplace: bool = False):
    """One corrupted worker's gradient, as float32: the whole gradient is
    damaged (a faulty sender, not a faulty coordinate).  ``inplace``
    overwrites float32 leaves the caller owns."""
    kind = fc.corrupt_kind
    if kind not in CORRUPT_KINDS or kind == "bitflip":
        raise ValueError(f"corrupt_grad covers the gradient kinds, got "
                         f"{kind!r}")

    def leaf(g):
        g = g.to(F32)
        if not inplace:
            g = g.clone()
        if kind == "nan":
            return g.fill_(math.nan)
        if kind == "inf":
            return g.fill_(math.inf)
        if kind == "sign_flip":
            return g.neg_()
        return g.mul_(torch.tensor(fc.corrupt_scale, dtype=F32,
                                   device=g.device))

    return tree_map(leaf, grad_m)


def corrupt_grads(grads: list, mask, fc: FaultConfig) -> list:
    """The reference's ``corrupt_grads`` over the port's worker list: the
    masked workers' gradients damaged, every gradient as float32."""
    return [corrupt_grad(g, fc) if bool(mask[m])
            else tree_map(lambda l: l.to(F32), g)
            for m, g in enumerate(grads)]


def flip_wire_codes(delta, R_tree, bits: int, key, frac: float):
    """MSB-flip a ``frac`` fraction of one worker's wire codes: the codes of
    ``delta`` (:func:`repro_torch.core.wire.codes_of_delta`), their top bit
    XORed where ``uniform(fold_in(key, i), leaf.shape) < frac`` (i the leaf
    index in JAX's order), re-emitted as a dequantized delta.  A flip moves
    its coordinate by half the code range.  The draws are made on the
    leaves' device."""
    leaves, treedef = tree_flatten(delta)
    r_leaves = tree_leaves(R_tree)
    msb = 1 << (bits - 1)
    out = []
    for i, (d, R) in enumerate(zip(leaves, r_leaves)):
        if not d.numel():
            out.append(d)
            continue
        q = codes_of_delta(d, R, bits)
        u = random.uniform(random.fold_in(key.to(d.device), i),
                           tuple(d.shape))
        hit = u < torch.tensor(frac, dtype=F32, device=d.device)
        del u
        q = torch.where(hit, q ^ msb, q)
        del hit
        out.append(delta_of_codes(q, R, bits))
    return tree_unflatten(treedef, out)


def apply_crashes(cst, mask, params, cfg, *, reconcile: bool = True):
    """Reset the per-worker state of the crashed workers (round start).

    ``mask`` is the [W] bool crash mask; ``params`` the current iterate
    (the restarted worker's fresh snapshots); ``cfg`` the
    ``StrategyConfig`` (for ``criterion.t_bar``).  A crashed worker loses
    ``qhat``, ``eps_hat_sq``, its ``LazyState``, ``SvrgState`` and
    ``ErrorState`` slices and ``R_anchor``, and restarts its clock at
    ``t_bar``.  The restarted SVRG ``mu`` is this round's gradient, which
    does not exist yet at round start: the crashed workers'
    ``svrg.mu_anchor`` entries are left empty and the engine sets them in
    its worker loop, where each gradient is taken (the reference's
    ``grads`` argument).  Server-side ledgers (bits, totals, the defense
    state) are kept.

    With ``reconcile`` the server subtracts ``sum_m fm_m * qhat_m`` over
    all W workers from ``server_agg``, as the reference computes it: in
    worker order from 0, one leaf at a time, so that ``0 * nan`` poisons
    the sum as it does there.  The per-worker lists and ``server_agg`` are
    updated in place (the crashed ``qhat`` and EF residuals are zeroed in
    place); the returned state carries new bookkeeping tensors.
    """
    crashed = [bool(c) for c in mask]
    if not any(crashed) and not reconcile:
        return cst
    W = len(cst.qhat)
    if reconcile:
        fm = [torch.tensor(float(c), dtype=F32) for c in crashed]
        for i, a in enumerate(tree_leaves(cst.server_agg)):
            if not a.numel():
                continue
            s = torch.zeros(a.shape, dtype=F32, device=a.device)
            for m in range(W):
                q = tree_leaves(cst.qhat[m])[i]
                s.add_(q.to(F32) * fm[m].to(q.device))
            a.sub_(s)
            del s
    if not any(crashed):
        return cst
    mb = torch.tensor(crashed)

    def wsel(reset, old):
        return torch.where(mb, torch.as_tensor(reset, dtype=old.dtype), old)

    t_bar = cfg.criterion.t_bar
    snapshot = tree_map(lambda p: p.to(F32), params)
    lz, sv, er = cst.lazy, cst.svrg, cst.error
    for m in (m for m in range(W) if crashed[m]):
        for leaf in tree_leaves(cst.qhat[m]):
            leaf.zero_()
        if lz.grad_ema is not None:
            for leaf in tree_leaves(lz.grad_ema[m]):
                leaf.zero_()
        if lz.theta_last is not None:
            lz.theta_last[m] = snapshot
        if sv.theta_anchor is not None:
            sv.theta_anchor[m] = snapshot
            sv.mu_anchor[m] = None
        if er.residual is not None:
            for leaf in tree_leaves(er.residual[m]):
                leaf.zero_()
    return cst._replace(
        eps_hat_sq=wsel(0.0, cst.eps_hat_sq),
        clocks=wsel(t_bar, cst.clocks),
        R_anchor=wsel(0.0, cst.R_anchor),
        lazy=lz._replace(stat_ema=wsel(0.0, lz.stat_ema),
                         stat_count=wsel(0.0, lz.stat_count),
                         sigma_hat_sq=wsel(0.0, lz.sigma_hat_sq)))
