"""Fault-tolerant aggregation, port of ``repro/core/defense.py`` (the
defense half of the robustness layer; :mod:`repro_torch.core.faults` is
the injection half).

* Upload validation (:class:`DefenseConfig` ``validate`` / ``gate_mult``):
  a finite check and a norm gate on the decoded payload's innovation
  energy against an EMA of the worker's own accepted uploads.  A rejected
  upload is masked exactly like a lazy skip (no commit, the clock grows),
  and its wire bits are still paid.
* Norm clipping (``clip_mult``): an over-norm innovation is scaled down
  to ``sqrt(clip_mult * ema)`` before it commits; the same scaled delta
  updates ``server_agg`` and the worker's ``qhat``.
* Robust aggregation (``StrategyConfig.aggregator``): a coordinate-wise
  trimmed mean or median of the committed deltas, rescaled by the
  committed count (:func:`robust_aggregate`).
* The divergence watchdog (:func:`run_with_watchdog`): chunks of rounds,
  a checkpoint after each healthy chunk, rollback and optional escalation
  after an unhealthy one.

Validation and clipping are per worker, so the same code runs per rank in
the sharded step.  The port keeps the state as the strategy keeps its
other bookkeeping: ``[W]`` CPU tensors, decided on the host.

Bit-identity with the reference under jit (jax 0.9 on the CPU): the
debias power ``d ** count`` is the float64 power of ``f32(d)`` rounded
once, and the EMA ``d * ema + (1 - d) * inn`` one FMA, as in
:mod:`repro_torch.core.lazy_rules`.  The robust combination sorts with a
stable sort in which NaN sorts last and ``-0 == +0``, as ``jnp.sort``
does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import load_checkpoint, save_checkpoint
from ..tree import tree_flatten, tree_leaves, tree_unflatten
from .lazy_rules import _ema, decay_pow
from .quantize import fma_f32

F32 = torch.float32
AGGREGATORS = ("sum", "trimmed_mean", "median")
_BIG = 3.0e38           # sentinel of the non-committed lanes
_SORT_CHUNK = 1 << 22   # coordinates per sort (its int64 indices included)


class DefenseConfig(NamedTuple):
    """Server-side defense knobs (``StrategyConfig.defense``); all off by
    default."""
    validate: bool = False      # finite-check decoded payloads
    gate_mult: float = 0.0      # > 0: reject an innovation energy above
                                # gate_mult x the worker's accepted-upload
                                # EMA (the first accepted upload is only
                                # finite-checked)
    gate_decay: float = 0.9     # EMA decay of the per-worker norm estimate
    clip_mult: float = 0.0      # > 0: scale over-norm innovations down to
                                # sqrt(clip_mult x ema) before committing
    reconcile_crashes: bool = True  # subtract a crashed worker's stale qhat
                                # from server_agg

    @property
    def active(self) -> bool:
        """True iff any per-upload defense state is needed."""
        return self.validate or self.gate_mult > 0.0 or self.clip_mult > 0.0


class DefenseState(NamedTuple):
    """Per-worker validation state (a ``CommState`` field): ``[W]`` CPU
    tensors, or a worker's slice of 0-d tensors; all ``None`` when the
    defense is off."""
    norm_ema: Optional[torch.Tensor]    # raw EMA of accepted ||deltaQ_m||^2
    norm_count: Optional[torch.Tensor]  # debias counter (0 = warm-up)
    rejects: Optional[torch.Tensor]     # cumulative rejected uploads (int32)


def empty_defense_state() -> DefenseState:
    return DefenseState(None, None, None)


def init_defense_state(dc: DefenseConfig, n_workers: int) -> DefenseState:
    if not dc.active:
        return empty_defense_state()
    return DefenseState(norm_ema=torch.zeros(n_workers, dtype=F32),
                        norm_count=torch.zeros(n_workers, dtype=F32),
                        rejects=torch.zeros(n_workers, dtype=torch.int32))


def defense_slice(ds: DefenseState, m: int) -> DefenseState:
    """Worker m's slice (``None`` fields stay ``None``)."""
    return DefenseState(*(None if x is None else x[m] for x in ds))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def defense_step(dc: DefenseConfig, ds_m: DefenseState, innovation_sq,
                 err_sq, uploaded: bool):
    """One worker's upload validation and clip decision.

    ``innovation_sq`` is the decoded payload's energy (after wire faults:
    what the server received) and ``err_sq`` the upload's quantization
    error moment; both are finite-checked under ``validate`` (a NaN
    gradient quantizes to a zero delta, so its poison rides in
    ``err_sq``).  ``uploaded`` is the transmission bit.  Returns
    ``(accept, scale, ds_new)``: the acceptance bit, the clip factor in
    (0, 1] (a float32 0-d tensor) and the new slice.  The EMA advances only
    on a committed upload, with the post-clip energy; the reject counter
    only on a rejected transmission.
    """
    if not dc.active or ds_m.norm_ema is None:
        raise ValueError("defense_step needs an active DefenseConfig and an "
                         "allocated DefenseState (init_defense_state)")
    inn, err = _f32(innovation_sq), _f32(err_sq)
    d = dc.gate_decay
    count = ds_m.norm_count
    warm = bool(count > 0)
    ema = ds_m.norm_ema / ((_f32(1.0) - decay_pow(d, count)) if warm
                           else _f32(1.0))
    accept = True
    if dc.validate:
        accept = bool(torch.isfinite(inn)) and bool(torch.isfinite(err))
    if dc.gate_mult > 0.0:
        # warm-up accepts anything finite; a NaN/Inf energy fails the <=
        gate_ok = (bool(inn <= _f32(dc.gate_mult) * ema) if warm
                   else bool(torch.isfinite(inn)))
        accept = accept and gate_ok
    scale = _f32(1.0)
    if dc.clip_mult > 0.0:
        cap = _f32(dc.clip_mult) * ema
        if warm and bool(inn > cap):
            # correctly rounded: the double sqrt of a float32 rounds once
            # more to the same float32 (torch's CPU sqrt is 0.5 ulp)
            scale = torch.sqrt((cap / torch.clamp_min(inn, 1e-30)).double()
                               ).to(F32)
    committed = uploaded and accept
    rejected = uploaded and not accept
    if committed:
        inn_c = inn * scale * scale
        if dc.clip_mult > 0.0 and not dc.validate and dc.gate_mult == 0.0:
            norm_ema = _ema(d, ds_m.norm_ema, inn_c)
        else:
            # the gates' selects change which product XLA fuses
            norm_ema = fma_f32(_f32(1.0 - d), inn_c, _f32(d) * ds_m.norm_ema)
        norm_count = count + 1.0
    else:
        norm_ema, norm_count = ds_m.norm_ema, count
    return accept, scale, DefenseState(
        norm_ema=norm_ema, norm_count=norm_count,
        rejects=ds_m.rejects + int(rejected))


# ---------------------------------------------------------------------------
# Robust aggregation over the per-worker dequantized deltas.
# ---------------------------------------------------------------------------

def robust_aggregate(aggregator: str, deltas: list, committed,
                     trim_frac: float, *, template=None, into=None):
    """Coordinate-wise robust combination of the committed deltas.

    ``deltas`` is the list of the W workers' dequantized deltas (pytrees;
    a non-committed worker's entry may be ``None``), ``committed`` their
    [W] commit bits and ``template`` a pytree of the leaf shapes (needed
    only when no delta is given).  Non-committed lanes are set to the
    sentinel 3e38 before a per-coordinate stable sort, so the ``n``
    committed values occupy the sorted prefix (NaNs among them sort last,
    as the largest).  The result is rescaled by ``n`` to stay on the plain
    sum's scale.

    ``trimmed_mean`` drops the ``t = max(1, floor(trim_frac * W))``
    smallest and largest committed values; with ``n <= 2t`` it falls back
    to the plain masked sum in worker order.  ``median`` is ``0.5 *
    (xs[(n-1)//2] + xs[n//2])`` (not ``torch.median``, the lower middle),
    zero when nothing committed.  The sort runs leaf by leaf in chunks of
    coordinates, so its transient (values and int64 indices) stays small.

    With ``into`` (the server aggregate, float32) the combination is added
    into its leaves in place and ``into`` is returned: the rescale ``mean
    * n`` (``med * n``) and that addition are one FMA, as XLA contracts the
    reference's ``server_agg + robust`` under jit (measured on the CPU with
    jax 0.9: without the contraction the engine's ``server_agg`` parts
    from the reference's in round 2 of a trimmed-mean or median run).
    """
    if aggregator not in ("trimmed_mean", "median"):
        raise ValueError(f"robust_aggregate covers trimmed_mean / median, "
                         f"got {aggregator!r}")
    comm = [bool(c) for c in committed]
    W = len(comm)
    n = sum(comm)
    t = max(1, int(math.floor(trim_frac * W)))
    if template is None:
        template = next((d for d in deltas if d is not None), None)
    if template is None:
        raise ValueError("robust_aggregate needs a delta or a template for "
                         "the leaf shapes")
    t_leaves, treedef = tree_flatten(template)
    w_leaves = [None if d is None or not comm[m] else tree_leaves(d)
                for m, d in enumerate(deltas)]
    nf = torch.tensor(float(n), dtype=F32)
    out = []
    into_leaves = None if into is None else tree_leaves(into)
    for i, tl in enumerate(t_leaves):
        dev = tl.device
        res = torch.zeros(tl.shape, dtype=F32, device=dev)
        if into_leaves is None:
            out.append(res)
        if n == 0 or not tl.numel():
            # median of nothing and the empty leaf: zeros
            if into_leaves is not None:
                into_leaves[i].add_(res)
            continue
        if aggregator == "trimmed_mean" and n <= 2 * t:
            # nothing left to average: the plain masked sum, worker order
            for wl in w_leaves:
                if wl is not None:
                    res.add_(wl[i].to(F32))
            if into_leaves is not None:
                into_leaves[i].add_(res)
            continue
        flat = res.reshape(-1)
        acc_flat = (None if into_leaves is None
                    else into_leaves[i].view(-1))
        cols = [None if wl is None else wl[i].reshape(-1) for wl in w_leaves]
        big = torch.tensor(_BIG, dtype=F32, device=dev)
        cnt = torch.tensor(float(n - 2 * t), dtype=F32, device=dev)
        nfd = nf.to(dev)
        for s in range(0, flat.numel(), _SORT_CHUNK):
            e = min(s + _SORT_CHUNK, flat.numel())
            x = torch.stack([big.expand(e - s) if c is None else c[s:e].to(F32)
                             for c in cols])
            xs = torch.sort(x, dim=0, stable=True).values
            del x
            if aggregator == "median":
                mean = (xs[(n - 1) // 2] + xs[n // 2]) * 0.5
            else:
                acc = torch.zeros(e - s, dtype=F32, device=dev)
                for j in range(t, n - t):
                    acc.add_(xs[j])
                mean = acc / cnt
            del xs
            if acc_flat is None:
                flat[s:e] = mean * nfd
            else:
                acc_flat[s:e] = fma_f32(mean, nfd, acc_flat[s:e])
    return into if into is not None else tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Divergence watchdog: snapshot / detect / rollback / escalate.
# ---------------------------------------------------------------------------

class WatchdogConfig(NamedTuple):
    chunk: int = 25             # rounds per segment between health checks
    explode_mult: float = 25.0  # loss > mult x best healthy loss => explosion
    max_rollbacks: int = 8      # give up (flagged in the log) after this many


def _same_shape(o, f) -> bool:
    lo, to = tree_flatten(o)
    lf, tf = tree_flatten(f)
    return to == tf and all(
        getattr(a, "shape", None) == getattr(b, "shape", None)
        for a, b in zip(lo, lf))


def migrate_carry(old_carry, fresh_carry):
    """Graft a rolled-back carry onto a freshly initialized one, field by
    field over the ``CommState``: a field whose structure and shapes
    survived the escalation keeps its rolled-back value, one the
    escalation (re)allocated (a newly enabled ``DefenseState``) keeps its
    fresh value; likewise the participation state."""
    params_old, cst_old, ps_old = old_carry
    _, cst_fresh, ps_fresh = fresh_carry
    cst = type(cst_fresh)(*(o if _same_shape(o, f) else f
                            for o, f in zip(cst_old, cst_fresh)))
    return params_old, cst, (ps_old if _same_shape(ps_old, ps_fresh)
                             else ps_fresh)


def run_with_watchdog(engine, params0, steps: int, *, ckpt_path: str,
                      wd: WatchdogConfig = WatchdogConfig(), escalate=None,
                      device="cuda"):
    """Run ``engine`` for ``steps`` rounds under divergence supervision.

    ``wd.chunk`` rounds at a time through ``engine.run_from``; after each
    chunk the host checks the losses.  A healthy chunk advances the run
    and snapshots the carry to ``ckpt_path``
    (:func:`repro_torch.checkpoint.save_checkpoint`); an unhealthy one
    (a non-finite loss, or a loss above ``explode_mult`` x the best healthy
    loss) rolls the carry back to the last snapshot.  The port's carry is
    updated in place by its rounds, so the rollback always restores from
    the file, never from the carry object of before the chunk.
    ``escalate(engine) -> engine`` is applied on every rollback (fault
    streams replay deterministically, so a plain replay hits the same
    fault).  ``device`` is where the carry lives.

    Returns ``(result, log, final_carry)``: the concatenated healthy
    :class:`~repro_torch.core.engine.RunResult`, a dict with
    ``rollbacks`` / ``wasted_rounds`` / ``wasted_bits`` / ``gave_up``, and
    the final carry.
    """
    from .engine import RunResult
    carry = engine.init_carry(params0, device=device)
    save_checkpoint(ckpt_path, carry, 0)
    good, best = 0, math.inf
    chunks = []
    log = {"rollbacks": [], "wasted_rounds": 0, "wasted_bits": 0.0,
           "gave_up": False}
    while good < steps:
        n = min(wd.chunk, steps - good)
        start_bits = float(carry[1].total_bits)
        carry2, rr = engine.run_from(carry, n)
        loss = rr.loss.numpy()
        finite = bool(np.all(np.isfinite(loss)))
        with np.errstate(invalid="ignore"):
            low = float(np.nanmin(loss)) if not np.all(np.isnan(loss)) \
                else math.nan
        exploded = math.isfinite(best) and low > wd.explode_mult * best
        if finite and not exploded:
            carry = carry2
            chunks.append(rr)
            good += n
            best = min(best, float(loss.min()))
            save_checkpoint(ckpt_path, carry, good)
            continue
        log["wasted_rounds"] += n
        log["wasted_bits"] += float(carry2[1].total_bits) - start_bits
        log["rollbacks"].append({
            "round": good,
            "reason": "nonfinite-loss" if not finite else "loss-explosion"})
        if len(log["rollbacks"]) > wd.max_rollbacks:
            log["gave_up"] = True
            break
        carry, _ = load_checkpoint(ckpt_path, carry2)
        del carry2
        if escalate is not None:
            engine = escalate(engine)
            carry = migrate_carry(carry, engine.init_carry(
                carry[0], device=tree_leaves(carry[0])[0].device))
            # re-snapshot so a second rollback restores the escalated
            # state structure
            save_checkpoint(ckpt_path, carry, good)

    def cat(field):
        vals = [getattr(c, field) for c in chunks]
        if not chunks or vals[0] is None:
            return None
        return torch.cat(vals)

    result = RunResult(params=carry[0], loss=cat("loss"),
                       grad_norm_sq=cat("grad_norm_sq"),
                       cum_uploads=cat("cum_uploads"),
                       cum_bits=cat("cum_bits"), quant_err=cat("quant_err"),
                       mean_bits=cat("mean_bits"))
    return result, log, carry
