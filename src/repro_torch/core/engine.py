"""The LAQ communication round, port of ``repro/core/engine.py``
(deterministic slice).

``RoundEngine.round`` is one round: per-worker gradients -> quantize the
innovation -> skip rule 7a/7b -> server recursion -> update.  The
reference runs it as a ``lax.scan`` body over a vmapped worker axis; here
``run_from`` is a Python loop and the workers run one at a time inside
:func:`repro_torch.core.strategy.aggregate`, so one round of a model with
P parameters and W workers holds about (W + 7) float32 copies of P at its
peak: theta, W qhat, the server aggregate, the running sum of the
gradients (for ``grad_norm_sq``), the running sum of the committed deltas,
and the worker in hand's gradient, delta and q_new.  Error feedback adds
the W residuals and, for the worker in hand, the corrected gradient and
the sparse wire's flat copies (about 2W + 10 copies in all).

Gradient sources: :class:`FullBatchSource` (paper Table 2) and
:class:`AccumulatingSource` in ``deterministic=True`` mode (the LM worker,
full local corpus through the gradient-accumulation fold).  The stochastic
sources wait for RNG parity with ``jax.random`` (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .adaptive import eta_at
from .quantize import tree_sq_norm
from .strategy import (StrategyConfig, aggregate, check_supported,
                       finalize_step, init_comm_state)

F32 = torch.float32


class RunResult(NamedTuple):
    """Per-round trajectory of a run (float32 / int64 CPU tensors of [K])."""
    params: object
    loss: torch.Tensor          # [K] global loss per round (before its update)
    grad_norm_sq: torch.Tensor  # [K]
    cum_uploads: torch.Tensor   # [K] cumulative uploads
    cum_bits: torch.Tensor      # [K] cumulative wire bits
    quant_err: torch.Tensor     # [K] max_m R_m (paper Fig. 3)
    mean_bits: Optional[torch.Tensor] = None


def broadcast_w(tree, n_workers: int) -> list:
    """The replicated pytree once per worker, as float32: a list of W
    references, not W copies (the port's worker axis is a list)."""
    t = tree_map(lambda l: l.to(F32), tree)
    return [t] * n_workers


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` by autograd; grads
    have the parameters' dtypes and zeros where a leaf is unused."""
    leaves, treedef = tree_flatten(params)
    req = [l.detach().requires_grad_(True) for l in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def _worker_slice(tree, m: int):
    return tree_map(lambda x: x[m], tree)


def _sum_workers(values) -> torch.Tensor:
    return torch.stack([v.to(F32) for v in values]).sum()


class FullBatchSource:
    """Deterministic full-gradient source (paper Table 2 methods).

    ``loss_fn(params, data_shard) -> scalar`` is one worker's local loss;
    ``worker_data`` carries a leading worker axis W; the global objective
    is ``sum_m f_m`` (paper eq. 1).
    """
    stochastic = False

    def __init__(self, loss_fn, worker_data):
        self.loss_fn = loss_fn
        self.worker_data = worker_data
        self.n_workers = tree_leaves(worker_data)[0].shape[0]

    def sample(self, step):
        return None

    def grad_at(self, params, batches, m: int):
        """Worker m's full local gradient at ``params``."""
        return value_and_grad(self.loss_fn, params,
                              _worker_slice(self.worker_data, m))[1]

    @torch.no_grad()
    def global_loss(self, params):
        return _sum_workers(self.loss_fn(params, _worker_slice(self.worker_data, m))
                            for m in range(self.n_workers))


def accumulate_loss_grads(loss_fn, params, microbatches):
    """Fold ``(loss, grad)`` over a leading microbatch axis with a float32
    running mean (``acc + x / n``), so the peak activation memory is one
    microbatch's backprop.  ``loss_fn`` must be mean-convention."""
    n = tree_leaves(microbatches)[0].shape[0]
    dev = tree_leaves(params)[0].device
    div = torch.tensor(float(n), dtype=F32, device=dev)
    loss_acc = torch.zeros((), dtype=F32, device=dev)
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=dev),
                     params)
    for i in range(n):
        l, g = value_and_grad(loss_fn, params, _worker_slice(microbatches, i))
        for a, x in zip(tree_leaves(g_acc), tree_leaves(g)):
            a.add_(x.to(F32) / div)
        del g
        loss_acc = loss_acc + l.to(F32) / div
    return loss_acc, g_acc


class AccumulatingSource:
    """Gradient-accumulating source, the LM-scale worker.  Only the
    ``deterministic=True`` mode is ported: every round streams each
    worker's whole local corpus through :func:`accumulate_loss_grads` in
    ``accum`` microbatches (full-batch LAQ at the accumulation memory
    profile).  ``scale`` multiplies the folded gradient (LM losses carry
    their ``1/W`` already: pass ``scale=1.0``)."""

    def __init__(self, loss_fn, worker_data, *, accum: int = 1,
                 deterministic: bool = False, scale: Optional[float] = None):
        if not deterministic:
            raise NotImplementedError(
                "stochastic AccumulatingSource needs jax.random parity "
                "(ROADMAP.md queue 1: RNG parity, Stochastic slice)")
        self.loss_fn = loss_fn
        self.worker_data = worker_data
        leaves = tree_leaves(worker_data)
        self.n_workers = leaves[0].shape[0]
        self.n_local = leaves[0].shape[1]
        if self.n_local % accum:
            raise ValueError(f"batch {self.n_local} % accum {accum}")
        self.accum = accum
        self.micro = self.n_local // accum
        self.stochastic = False
        self.scale = 1.0 if scale is None else scale

    def sample(self, step):
        """[W, accum, micro, ...] microbatches of the whole corpus."""
        return tree_map(lambda x: x.reshape((x.shape[0], self.accum, self.micro)
                                            + tuple(x.shape[2:])),
                        self.worker_data)

    def grad_at(self, params, batches, m: int):
        """Worker m's accumulated gradient at ``params``, float32 and
        ``scale``-multiplied (a scale of 1.0 is the identity and is
        skipped)."""
        mbs = _worker_slice(batches, m)
        if self.accum == 1:
            g = value_and_grad(self.loss_fn, params, _worker_slice(mbs, 0))[1]
            g = tree_map(lambda x: x.to(F32), g)
        else:
            _, g = accumulate_loss_grads(self.loss_fn, params, mbs)
        if self.scale != 1.0:
            g = tree_map(lambda x: x * self.scale, g)
        return g

    @torch.no_grad()
    def global_loss(self, params):
        """Sum over workers of the mean microbatch loss, in the
        microbatches of :meth:`sample`."""
        batches = self.sample(None)

        def worker_loss(m):
            mbs = _worker_slice(batches, m)
            acc = torch.zeros((), dtype=F32)
            for i in range(self.accum):
                l = self.loss_fn(params, _worker_slice(mbs, i)).to(F32).cpu()
                acc = acc + l / self.accum
            return acc

        return _sum_workers(worker_loss(m) for m in range(self.n_workers))


class FullParticipation:
    """Every worker reachable every round (the paper's setting)."""

    def init(self, params0):
        return None

    def begin_round(self, pstate, step, params):
        """``(avail, thetas_w, pstate)``: all available, current params."""
        return None, None, pstate


class RoundEngine:
    """One LAQ communication round, sources and state machine plugged in
    (full participation: the other participation models are not ported)."""

    def __init__(self, source, cfg: StrategyConfig, *, alpha):
        if source.stochastic:
            raise NotImplementedError(
                "stochastic sources need jax.random parity (ROADMAP.md "
                "queue 1: RNG parity, Stochastic slice)")
        check_supported(cfg)
        self.source = source
        self.cfg = cfg
        self.alpha = alpha
        self.n_workers = source.n_workers
        self.participation = FullParticipation()

    def init_carry(self, params0, *, device="cuda"):
        """``(params, CommState, participation state)`` on ``device``."""
        dev = resolve_device(device)
        params = tree_map(lambda l: l.to(dev), params0)
        return (params, init_comm_state(params, self.n_workers, self.cfg),
                self.participation.init(params))

    def round(self, carry):
        """One communication round.  Returns the new carry and the record
        ``(loss, grad_norm_sq, total_uploads, total_bits, quant_err,
        mean_bits)``.  The carry's ``qhat`` list and ``server_agg`` are
        updated in place (see :func:`aggregate`)."""
        cfg, source = self.cfg, self.source
        params, cst, pstate = carry
        alpha_k = eta_at(cfg.eta_schedule, self.alpha, cst.step)
        _, _, pstate = self.participation.begin_round(pstate, cst.step,
                                                      params)
        loss = source.global_loss(params)
        batches = source.sample(cst.step)
        gsum = tree_map(lambda l: torch.zeros(l.shape, dtype=F32,
                                              device=l.device), params)

        def grad_of(m):
            g = source.grad_at(params, batches, m)
            for a, x in zip(tree_leaves(gsum), tree_leaves(g)):
                a.add_(x)
            return g

        agg, cst, metrics = aggregate(cst, grad_of, alpha_k, cfg)
        # the summed full local gradients ARE the global gradient
        gnorm = tree_sq_norm(gsum).cpu()
        del gsum

        step = (torch.tensor(alpha_k, dtype=F32) if isinstance(alpha_k, float)
                else alpha_k)
        new_leaves, dsq_parts = [], []
        leaves, treedef = tree_flatten(params)
        for t, a in zip(leaves, tree_leaves(agg)):
            nt = t - step.to(t.device) * a
            if nt.numel():
                dsq_parts.append((nt - t).square().sum())
            new_leaves.append(nt)
        new_params = tree_unflatten(treedef, new_leaves)
        dsq = (torch.stack(dsq_parts).sum().cpu() if dsq_parts
               else torch.zeros((), dtype=F32))
        cst = finalize_step(cst, dsq)
        rec = (loss.cpu(), gnorm, cst.total_uploads, cst.total_bits.clone(),
               metrics.radius_max, metrics.mean_bits)
        return (new_params, cst, pstate), rec

    def run_from(self, carry, steps: int):
        """``steps`` rounds from an arbitrary carry.  Returns
        ``(carry, RunResult)``."""
        recs = []
        for _ in range(steps):
            carry, rec = self.round(carry)
            recs.append(rec)
        loss, gn, cu, cb, qe, mb = zip(*recs)
        return carry, RunResult(
            carry[0], torch.stack(loss), torch.stack(gn),
            torch.tensor(cu, dtype=torch.int64), torch.stack(cb),
            torch.stack(qe), torch.stack(mb))

    def run(self, params0, steps: int, *, device="cuda") -> RunResult:
        _, result = self.run_from(self.init_carry(params0, device=device),
                                  steps)
        return result

