"""Variance-aware lazy-aggregation skip rules (LASG; Chen et al., 2020),
port of ``repro/core/lazy_rules.py``.

With minibatch gradients the paper's criterion (7a) compares two noisy
gradients, so it skips and uploads on noise.  The LASG rules change the
left-hand side of the comparison; all share the right-hand side of
:mod:`repro_torch.core.criterion` and the (7b) staleness bound:

``lasg_wk``  ``||dQ||^2 + c_var (sigma^2 + sigma_hat^2)``: the innovation
    plus the worker's minibatch variance (a debiased EMA estimate, and the
    one frozen at its last upload).
``lasg_wk2`` ``c_wk2 ||g(theta; xi) - g(theta_hat; xi)||^2``: the current
    minibatch re-evaluated at the iterate of the last upload (a second
    backprop the engine threads in as ``grad_stale_m``), so the noise
    cancels.  Forced to upload until the worker's first upload.
``lasg_ps``  ``c_ps Lhat^2 ||theta - theta_hat||^2``: parameter drift scaled
    by an online EMA of the observed innovation/drift ratios; infinite
    (an upload) until the first ratio is observed.
``laq7a``    the paper's rule, :func:`repro_torch.core.criterion.should_skip`.

The port keeps the per-worker state as the strategy keeps ``qhat``: the
pytree fields (``grad_ema``, ``theta_last``) are lists of W pytrees on the
parameters' device, the scalars ``[W]`` float32 CPU tensors, and the rule
is decided on the host.  ``theta_last`` holds references to the iterate
of each worker's last upload, not copies: the engine never updates a
parameter tensor in place, so W workers that uploaded at the same round
share one tensor.

Bit-identity with the reference under jit (measured with jax 0.9 on the
CPU):

* ``d ** count`` is the float64 power of ``f32(d)``, rounded once to
  float32 (a float32 ``pow`` differs at some counts, 31 and 37 among
  them).
* Each EMA ``d * m + (1 - d) * g`` is one FMA, ``fma(d, m, (1 - d) * g)``
  (:func:`repro_torch.core.quantize.fma_f32`), with ``1 - d`` folded in
  double and rounded to float32 as the reference's Python floats are; so
  is WK's ``innovation + c_var * (sigma^2 + sigma_hat^2)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..tree import SharedIterates, tree_leaves, tree_map
from .criterion import CriterionConfig, rhs_threshold
from .quantize import fma_f32, tree_sq_norm, tree_sq_norm_diff

F32 = torch.float32
LAZY_RULES = ("laq7a", "lasg_wk", "lasg_wk2", "lasg_ps")

# rules whose LazyState carries the stale-iterate snapshot ``theta_last``
_THETA_LAST_RULES = ("lasg_wk2", "lasg_ps")


class LasgConfig(NamedTuple):
    """Constants of the LASG rules: ``c_var`` weighs the WK variance term,
    ``c_wk2`` the WK2 same-sample difference, ``c_ps`` the PS drift
    trigger; ``var_decay`` is the decay of both EMAs."""
    c_var: float = 1.0
    c_wk2: float = 1.0
    c_ps: float = 1.0
    var_decay: float = 0.9


class LazyState(NamedTuple):
    """Per-worker estimator state.  In a ``CommState`` the pytree fields are
    lists of W pytrees (or ``None`` for rules that do not use them) and the
    scalars ``[W]`` tensors; a worker's slice (:func:`worker_slice`) holds
    one pytree and 0-d tensors."""
    grad_ema: Optional[list]    # WK: EMA first moment of minibatch grads
    stat_ema: torch.Tensor      # WK: EMA of squared deviations (sigma^2)
                                # PS: EMA of innovation/drift ratios (Lhat^2)
    stat_count: torch.Tensor    # debias counter; WK2: upload counter
    sigma_hat_sq: torch.Tensor  # WK: variance estimate at the last upload
    theta_last: Optional[list]  # PS/WK2: iterate at the last upload


def empty_lazy_state() -> LazyState:
    z = torch.zeros((), dtype=F32)
    return LazyState(None, z, z, z, None)


def init_lazy_state(rule: str, grad_template, n_workers: int) -> LazyState:
    """Zero EMAs; ``theta_last`` starts at the template's values (the
    initial iterate: the engine passes ``params0``), as W references to one
    float32 tree."""
    if rule not in LAZY_RULES:
        raise ValueError(f"unknown lazy rule {rule!r}; have {LAZY_RULES}")

    def zeros(l):
        return torch.zeros(l.shape, dtype=F32, device=l.device)

    snapshot = tree_map(lambda l: l.to(F32), grad_template)
    return LazyState(
        grad_ema=([tree_map(zeros, grad_template) for _ in range(n_workers)]
                  if rule == "lasg_wk" else None),
        stat_ema=torch.zeros(n_workers, dtype=F32),
        stat_count=torch.zeros(n_workers, dtype=F32),
        sigma_hat_sq=torch.zeros(n_workers, dtype=F32),
        theta_last=(SharedIterates([snapshot] * n_workers)
                    if rule in _THETA_LAST_RULES else None),
    )


def worker_slice(lazy: LazyState, m: int) -> LazyState:
    """Worker m's slice of the per-worker state."""
    return LazyState(
        None if lazy.grad_ema is None else lazy.grad_ema[m],
        lazy.stat_ema[m], lazy.stat_count[m], lazy.sigma_hat_sq[m],
        None if lazy.theta_last is None else lazy.theta_last[m])


def store_slice(lazy: LazyState, m: int, lazy_m: LazyState):
    """Write worker m's slice back in place (the lists and the scalar
    tensors of ``lazy``)."""
    if lazy.grad_ema is not None:
        lazy.grad_ema[m] = lazy_m.grad_ema
    if lazy.theta_last is not None:
        lazy.theta_last[m] = lazy_m.theta_last
    lazy.stat_ema[m] = lazy_m.stat_ema
    lazy.stat_count[m] = lazy_m.stat_count
    lazy.sigma_hat_sq[m] = lazy_m.sigma_hat_sq


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def decay_pow(d: float, count) -> torch.Tensor:
    """``d ** count`` as XLA evaluates it under jit: the float64 power of
    ``f32(d)``, rounded once to float32."""
    return _f32(math.pow(float(_f32(d)), float(count)))


def _ema(d: float, m, g):
    """``d * m + (1 - d) * g``, one FMA over ``(1 - d) * g``."""
    return fma_f32(d, m, _f32(1.0 - d).to(g.device) * g)


def variance_update(lazy_m: LazyState, grad_m, cfg: LasgConfig):
    """One EMA step of the WK variance estimator: returns the debiased
    ``sigma_sq`` and the slice with the new ``(stat_ema, stat_count)``;
    ``grad_ema``'s leaves are updated in place.  With no history the
    deviation is ``||g||^2``."""
    d = cfg.var_decay
    count = lazy_m.stat_count
    denom = (_f32(1.0) - decay_pow(d, count)) if float(count) > 0 else _f32(1.0)
    dev_sq = tree_sq_norm(tree_map(
        lambda g, m: g.to(F32) - m / denom.to(m.device),
        grad_m, lazy_m.grad_ema)).cpu()
    stat_new = _ema(d, lazy_m.stat_ema, dev_sq)
    count_new = count + 1.0
    sigma_sq = stat_new / (_f32(1.0) - decay_pow(d, count_new))
    # the new mean in place, leaf by leaf, so one leaf is transient at a time
    for m, g in zip(tree_leaves(lazy_m.grad_ema), tree_leaves(grad_m)):
        m.copy_(_ema(d, m, g.to(F32)))
    return sigma_sq, lazy_m._replace(stat_ema=stat_new, stat_count=count_new)


def smoothness_sq(lazy_m: LazyState, cfg: LasgConfig) -> torch.Tensor:
    """PS: the debiased ``Lhat^2`` of the ratio EMA; +inf before the first
    observed ratio, which forces an upload."""
    if not float(lazy_m.stat_count) > 0:
        return _f32(math.inf)
    scale = torch.clamp_min(
        _f32(1.0) - decay_pow(cfg.var_decay, lazy_m.stat_count), 1e-12)
    return lazy_m.stat_ema / scale


def rule_lhs(rule: str, lasg: LasgConfig, *, innovation_sq=None,
             sigma_sq=None, sigma_hat_sq=None, drift_sq=None, L_sq=None,
             same_diff_sq=None):
    """Left-hand side of the skip comparison for ``rule`` (float32 0-d)."""
    if rule == "laq7a":
        return innovation_sq
    if rule == "lasg_wk":
        # one FMA under jit, as the EMAs
        return fma_f32(lasg.c_var, sigma_sq + sigma_hat_sq, innovation_sq)
    if rule == "lasg_wk2":
        return lasg.c_wk2 * same_diff_sq
    if rule == "lasg_ps":
        # before the first ratio L_sq is +inf and drift may be 0: force the
        # upload rather than rely on inf * 0 = nan in the comparison
        if not bool(torch.isfinite(L_sq)):
            return _f32(math.inf)
        return lasg.c_ps * L_sq * drift_sq
    raise ValueError(f"unknown lazy rule {rule!r}; have {LAZY_RULES}")


def should_skip_rule(rule: str, lasg: LasgConfig, crit: CriterionConfig, *,
                     theta_hist, alpha, M: int, eps_sq, eps_hat_sq, clock,
                     innovation_sq=None, sigma_sq=None, sigma_hat_sq=None,
                     drift_sq=None, L_sq=None, same_diff_sq=None) -> bool:
    """The skip decision for one worker under any of the four rules."""
    lhs = rule_lhs(rule, lasg, innovation_sq=innovation_sq, sigma_sq=sigma_sq,
                   sigma_hat_sq=sigma_hat_sq, drift_sq=drift_sq, L_sq=L_sq,
                   same_diff_sq=same_diff_sq)
    rhs = rhs_threshold(theta_hist, alpha, M, eps_sq, eps_hat_sq, crit)
    return bool(lhs <= rhs) and int(clock) < crit.t_bar


def wk2_same_diff_sq(lazy_m: LazyState, grad_m, grad_stale_m) -> torch.Tensor:
    """WK2's ``||g(theta; xi) - g(theta_hat; xi)||^2``, one leaf's
    difference live at a time.  +inf until the worker's first upload: the
    bootstrap guard (``theta_last`` is then the current iterate and the
    difference zero), which forces the upload."""
    if not float(lazy_m.stat_count) > 0:
        return _f32(math.inf)
    return tree_sq_norm_diff(grad_m, grad_stale_m).cpu()


def lazy_rule_step(rule: str, lasg: LasgConfig, crit: CriterionConfig, *,
                   grad_m, params, lazy_m: LazyState, innovation_sq, err_sq,
                   eps_hat_sq_m, clock_m, theta_hist, alpha, n_workers: int,
                   same_diff_sq=None):
    """Evaluate ``rule`` for one worker.  Returns ``(skip, lazy_pre,
    stats)``: the decision, the slice with the fields that update every
    round, and the scalars :func:`commit_upload` needs.  ``lasg_wk2``
    takes ``same_diff_sq``, the :func:`wk2_same_diff_sq` of ``grad_m``
    and the current minibatch's gradient at the stale iterate."""
    sigma_sq = drift_sq = _f32(0.0)
    lazy_pre = lazy_m
    if rule == "lasg_wk":
        if lazy_m.grad_ema is None:
            raise ValueError("lazy_rule='lasg_wk' needs LazyState.grad_ema; "
                             "allocate it with init_comm_state")
        sigma_sq, lazy_pre = variance_update(lazy_m, grad_m, lasg)
    elif rule == "lasg_wk2":
        if params is None or same_diff_sq is None:
            raise ValueError("lazy_rule='lasg_wk2' needs the current params "
                             "and same_diff_sq, wk2_same_diff_sq of the "
                             "gradient and grad_stale_m, the current "
                             "minibatch's gradient at the stale iterate")
        if lazy_m.theta_last is None:
            raise ValueError("lazy_rule='lasg_wk2' needs LazyState.theta_last; "
                             "allocate it with init_comm_state")
    elif rule == "lasg_ps":
        if params is None:
            raise ValueError("lazy_rule='lasg_ps' needs the current params")
        if lazy_m.theta_last is None:
            raise ValueError("lazy_rule='lasg_ps' needs LazyState.theta_last; "
                             "allocate it with init_comm_state")
        drift_sq = tree_sq_norm_diff(params, lazy_m.theta_last).cpu()
    skip = should_skip_rule(
        rule, lasg, crit, theta_hist=theta_hist, alpha=alpha, M=n_workers,
        eps_sq=err_sq, eps_hat_sq=eps_hat_sq_m, clock=clock_m,
        innovation_sq=innovation_sq, sigma_sq=sigma_sq,
        sigma_hat_sq=lazy_m.sigma_hat_sq, drift_sq=drift_sq,
        L_sq=smoothness_sq(lazy_m, lasg) if rule == "lasg_ps" else None,
        same_diff_sq=same_diff_sq)
    return skip, lazy_pre, {"sigma_sq": sigma_sq, "drift_sq": drift_sq}


def commit_upload(rule: str, lasg: LasgConfig, lazy_pre: LazyState,
                  uploaded: bool, stats, *, params,
                  innovation_sq) -> LazyState:
    """Refresh the fields frozen at an upload: WK's ``sigma_hat_sq``; WK2's
    ``theta_last`` and upload counter; PS's ``theta_last`` and, when the
    drift is nonzero, the ratio EMA."""
    out = lazy_pre
    snapshot = (tree_map(lambda p: p.to(F32), params)
                if uploaded and rule in _THETA_LAST_RULES else None)
    if rule == "lasg_wk" and uploaded:
        out = out._replace(sigma_hat_sq=stats["sigma_sq"])
    elif rule == "lasg_wk2" and uploaded:
        out = out._replace(theta_last=snapshot,
                           stat_count=lazy_pre.stat_count + 1.0)
    elif rule == "lasg_ps" and uploaded:
        drift_sq = stats["drift_sq"]
        if bool(drift_sq > 1e-20):
            ratio = innovation_sq / torch.clamp_min(drift_sq, 1e-20)
            out = out._replace(
                stat_ema=_ema(lasg.var_decay, lazy_pre.stat_ema, ratio),
                stat_count=lazy_pre.stat_count + 1.0)
        out = out._replace(theta_last=snapshot)
    return out
