"""The LAQ communication round, port of ``repro/core/engine.py``.

``RoundEngine.round`` is one round: per-worker gradients -> SVRG
correction -> WK2 stale side -> quantize the innovation -> skip rule ->
server recursion -> update, or, for the dense baselines of paper Table 3
(``baseline="sgd" | "qsgd" | "ssgd"``), per-worker compression and a plain
sum.  The reference runs it as a ``lax.scan`` body over a vmapped worker
axis; here ``run_from`` is a Python loop and the workers run one at a time
inside :func:`repro_torch.core.strategy.aggregate`, so one round of a
model with P parameters and W workers holds about (W + 7) float32 copies
of P at its peak: theta, W qhat, the server aggregate, the running sum of
the gradients (deterministic sources, for ``grad_norm_sq``), the running
sum of the committed deltas, and the worker in hand's gradient, delta and
q_new.  Error feedback adds the W residuals and, for the worker in hand,
the corrected gradient and the sparse wire's flat copies (about 2W + 10
copies in all).  A stochastic source has no gradient sum: its
``grad_norm_sq`` is a full-data gradient taken after the workers'
gradients are freed.  ``lasg_wk`` adds W gradient EMAs; ``lasg_wk2`` and
``lasg_ps`` up to W stale iterates (``theta_last`` references the iterate
of each worker's last upload); SVRG W full local gradients ``mu`` and the
anchor iterate, which the W workers share; the worker in hand then also
holds its correction and, under ``lasg_wk2``, its stale gradient.

Participation models (:func:`make_participation`): ``full``, ``bernoulli``
and ``fixed_k`` client sampling (:func:`participation_mask`), ``markov``
churn (a per-worker on/off chain) and ``delay`` (worker m computes at the
iterate of ``m mod (max_delay + 1)`` rounds ago; the ring holds references
to earlier iterates, which the engine never updates in place, not copies).
An unreachable worker still computes its gradient and its wire, as the
reference's vmap does, and is masked like a lazy skip.  The robustness
layer (:mod:`repro_torch.core.faults`, :mod:`repro_torch.core.defense`)
runs in the reference's order: crash-restart before the SVRG and WK2
stages, gradient corruption after them (the worker's honest gradient
enters ``grad_norm_sq`` first), wire bit flips and the defense inside
``worker_update``.  Crash reconciliation adds one leaf-sized transient; a
robust aggregator holds the W committed deltas in place of the running
sum.

bfloat16 state (``StrategyConfig.state_bf16``) is refused here, as the
reference's engine cannot run it: its ``aggregate`` adds a float32 delta
sum to the bfloat16 ``server_agg`` (``repro/core/strategy.py:647-649``),
so the round's ``server_agg`` comes out float32, and the ``lax.scan`` of
``RoundEngine.run`` (``repro/core/engine.py:781``) rejects a carry whose
dtype changes.  The sharded step (``launch/train.py``) runs it.

Gradient sources: :class:`FullBatchSource` (paper Table 2),
:class:`MinibatchSource` (paper Table 3) and :class:`AccumulatingSource`
(the LM worker, stochastic or ``deterministic=True``).  Their minibatches
are drawn with :mod:`repro_torch.random`, the ``jax.random`` draws bit for
bit, from ``fold_in`` keys of ``(seed, stream, round, worker)``: stream 0
draws the batch indices, stream 1 the baselines' compressor randomness.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import random
from ..device import resolve_device
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .adaptive import eta_at
from .compressors import qsgd_compress, ssgd_compress
from .faults import (apply_crashes, bitflip_keys, corrupt_grad,
                     corruption_mask, crash_mask)
from .quantize import dense_bits, fma_f32, tree_sq_norm
from .strategy import (PARTICIPATION, CommState, StrategyConfig, SvrgState,
                       aggregate, check_supported, finalize_step,
                       init_comm_state)

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


class _StochasticStream:
    """The reference's functional key stream: every key is
    ``fold_in(fold_in(fold_in(PRNGKey(seed), stream), step), worker)``, so
    the batch indices do not depend on the method, and each worker's
    stream is its own."""

    def _init_stream(self, seed: int, device):
        # the stream's keys and indices are a few words a worker: they are
        # drawn on the CPU (:mod:`repro_torch.random` hashes them in numpy)
        # and copied to ``device`` without waiting for its queue
        self._key0 = random.PRNGKey(seed, device="cpu")
        self._device = device

    def _host_keys(self, stream: int, step: int) -> torch.Tensor:
        ks = random.fold_in(random.fold_in(self._key0, stream), step)
        return torch.stack([random.fold_in(ks, m)
                            for m in range(self.n_workers)])

    def stream_keys(self, stream: int, step: int) -> torch.Tensor:
        """``[W, 2]`` keys of ``stream`` at round ``step``, on the data's
        device."""
        return self._host_keys(stream, step).to(self._device,
                                                non_blocking=True)

    def indices(self, step: int) -> torch.Tensor:
        """``[W, batch]`` int64 local indices this round's minibatches take:
        ``randint(key_m, (batch,), 0, n_local)`` per worker, on the data's
        device."""
        keys = self._host_keys(0, step)
        return torch.stack([random.randint(keys[m], (self.batch,), 0,
                                           self.n_local)
                            for m in range(self.n_workers)]).long().to(
            self._device, non_blocking=True)

    def _gather(self, idx):
        """The rows ``idx`` ([W, ...] local indices) of each worker's data."""
        rows = torch.arange(self.n_workers, device=idx.device).reshape(
            (-1,) + (1,) * (idx.dim() - 1))
        return tree_map(lambda x: x[rows, idx], self.worker_data)


class MinibatchSource(_StochasticStream):
    """Minibatch gradient source (paper Table 3 methods): each round worker
    m draws ``batch`` of its ``n_local`` examples with replacement, and its
    gradient is scaled by ``n_local / batch`` so that ``sum_m E[g_m]`` is
    the gradient of the global loss ``sum_m f_m``."""
    stochastic = True

    def __init__(self, loss_fn, worker_data, *, batch: int, seed: int):
        self.loss_fn = loss_fn
        self.worker_data = worker_data
        leaves = tree_leaves(worker_data)
        self.n_workers = leaves[0].shape[0]
        self.n_local = leaves[0].shape[1]
        self.batch = batch
        self.scale = self.n_local / batch
        self._init_stream(seed, leaves[0].device)

    def sample(self, step):
        return self._gather(self.indices(step))

    def grad_at(self, params, batches, m: int, *, scaled: bool = True):
        """Worker m's minibatch gradient at ``params`` (the current iterate,
        its stale iterate or its SVRG anchor), float32, times ``scale``
        unless ``scaled=False``."""
        g = value_and_grad(self.loss_fn, params, _worker_slice(batches, m))[1]
        if not scaled:
            return tree_map(lambda x: x.to(F32), g)
        return tree_map(lambda x: x.to(F32) * self.scale, g)

    def full_local_grads(self, params, m: int):
        """Worker m's exact full local gradient (the SVRG anchor's mu)."""
        g = value_and_grad(self.loss_fn, params,
                           _worker_slice(self.worker_data, m))[1]
        return tree_map(lambda x: x.to(F32), g)

    global_loss = FullBatchSource.global_loss

    def grad_norm_sq(self, params) -> torch.Tensor:
        """``||grad sum_m f_m||^2``: the true gradient, one full-data
        backprop (the round's minibatch gradients are noisy)."""
        def total(p, _):
            return torch.stack([self.loss_fn(p, _worker_slice(self.worker_data, m))
                                for m in range(self.n_workers)]).sum()

        return tree_sq_norm(value_and_grad(total, params, None)[1]).cpu()


class AccumulatingSource(_StochasticStream):
    """Gradient-accumulating source, the LM-scale worker.

    Stochastic mode: each round worker m draws ``batch`` local examples
    from the same key stream as :class:`MinibatchSource` (identical
    indices for identical ``(seed, batch)``) and folds loss and gradient
    over ``accum`` sequential microbatches of ``batch / accum`` examples
    (:func:`accumulate_loss_grads`).  ``deterministic=True`` streams the whole local corpus
    through the fold every round (full-batch LAQ at the accumulation
    memory profile).  ``scale`` multiplies the folded gradient; the
    default ``n_local / batch`` matches ``MinibatchSource``, and LM losses
    that carry their ``1/W`` already take ``scale=1.0``."""

    def __init__(self, loss_fn, worker_data, *, batch: Optional[int] = None,
                 seed: int = 0, accum: int = 1, deterministic: bool = False,
                 scale: Optional[float] = None):
        self.loss_fn = loss_fn
        self.worker_data = worker_data
        leaves = tree_leaves(worker_data)
        self.n_workers = leaves[0].shape[0]
        self.n_local = leaves[0].shape[1]
        if deterministic:
            batch = self.n_local
        if batch is None:
            raise ValueError("batch is required for the stochastic mode")
        if batch % accum:
            raise ValueError(f"batch {batch} % accum {accum}")
        self.batch = batch
        self.accum = accum
        self.micro = batch // accum
        self.deterministic = deterministic
        self.stochastic = not deterministic
        self.scale = (self.n_local / batch) if scale is None else scale
        self._init_stream(seed, leaves[0].device)

    def sample(self, step):
        """[W, accum, micro, ...] microbatches: this round's draw, the
        ``(batch,)`` indices reshaped, or the whole corpus in order."""
        if self.deterministic:
            return tree_map(lambda x: x.reshape(
                (x.shape[0], self.accum, self.micro) + tuple(x.shape[2:])),
                self.worker_data)
        idx = self.indices(step)
        return self._gather(idx.reshape(self.n_workers, self.accum,
                                        self.micro))

    def grad_at(self, params, batches, m: int, *, scaled: bool = True):
        """Worker m's accumulated gradient at ``params``, float32 and, unless
        ``scaled=False``, ``scale``-multiplied (a scale of 1.0 is the
        identity and is skipped).  One microbatch is evaluated directly,
        as the reference does."""
        mbs = _worker_slice(batches, m)
        if self.accum == 1:
            g = value_and_grad(self.loss_fn, params, _worker_slice(mbs, 0))[1]
            g = tree_map(lambda x: x.to(F32), g)
        else:
            _, g = accumulate_loss_grads(self.loss_fn, params, mbs)
        if scaled and self.scale != 1.0:
            g = tree_map(lambda x: x * self.scale, g)
        return g

    def _chunk_full(self, data_m):
        """Worker m's whole corpus in chunks of ``micro`` examples (one
        chunk when ``micro`` does not divide it)."""
        c = self.micro if self.n_local % self.micro == 0 else self.n_local
        return tree_map(lambda x: x.reshape((self.n_local // c, c)
                                            + tuple(x.shape[1:])), data_m)

    def full_local_grads(self, params, m: int):
        """Worker m's exact full local gradient (the SVRG anchor's mu),
        accumulated over the corpus chunks, unscaled."""
        return accumulate_loss_grads(
            self.loss_fn, params,
            self._chunk_full(_worker_slice(self.worker_data, m)))[1]

    @torch.no_grad()
    def global_loss(self, params):
        """Sum over workers of the mean chunk loss."""
        def worker_loss(m):
            chunks = self._chunk_full(_worker_slice(self.worker_data, m))
            n = tree_leaves(chunks)[0].shape[0]
            acc = torch.zeros((), dtype=F32)
            for i in range(n):
                l = self.loss_fn(params, _worker_slice(chunks, i))
                acc = acc + l.to(F32).cpu() / n
            return acc

        return _sum_workers(worker_loss(m) for m in range(self.n_workers))

    def grad_norm_sq(self, params) -> torch.Tensor:
        """``||grad global_loss||^2``, one backprop per corpus chunk folded
        into a float32 sum (the stochastic mode's record; a deterministic
        round sums its workers' gradients instead)."""
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                             device=p.device), params)
        for m in range(self.n_workers):
            chunks = self._chunk_full(_worker_slice(self.worker_data, m))
            n = tree_leaves(chunks)[0].shape[0]
            for i in range(n):
                g = value_and_grad(self.loss_fn, params,
                                   _worker_slice(chunks, i))[1]
                for a, x in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(x.to(F32) / n)
                del g
        return tree_sq_norm(acc).cpu()


# ---------------------------------------------------------------------------
# Shared round stages: the SVRG correction and the WK2 stale side, for the
# worker in hand.
# ---------------------------------------------------------------------------

def _scale_add(scale: float, g, c):
    """``scale * g + c`` leaf by leaf, one FMA as XLA contracts the source's
    scaling into the next addition under jit (a plain add at scale 1)."""
    if scale == 1.0:
        for a, x in zip(tree_leaves(g), tree_leaves(c)):
            a.add_(x)
        return g
    return tree_map(lambda a, x: fma_f32(scale, a, x), g, c)


def apply_svrg_exact(sv: SvrgState, params, grad_raw, grad_at_raw,
                     full_local_grads, m: int, refresh: bool, scale: float):
    """Worker m's SVRG correction with an exact periodic anchor.  On a
    refresh round the anchor snaps to ``params`` (one tree the W workers
    share) and ``mu`` to the worker's full local gradient there.  Then
    ``corr = mu - scale * g(theta_anchor; xi)`` and the corrected gradient
    ``scale * g(theta; xi) + corr``, each one FMA.  ``grad_raw`` and
    ``grad_at_raw(theta)`` are this round's minibatch gradients of worker
    m before the source's ``scale``.  Returns ``(grad, corr)``; ``corr``
    also corrects the WK2 stale side, so that anchor and mu cancel in the
    same-sample difference."""
    if refresh:
        sv.theta_anchor[m] = tree_map(lambda p: p.to(F32), params)
        sv.mu_anchor[m] = None
        sv.mu_anchor[m] = tree_map(lambda g: g.to(F32),
                                   full_local_grads(params, m))
    g_anchor = grad_at_raw(sv.theta_anchor[m])
    corr = tree_map(lambda mu, ga: fma_f32(-scale, ga, mu),
                    sv.mu_anchor[m], g_anchor)
    del g_anchor
    return _scale_add(scale, grad_raw, corr), corr


def apply_svrg_streaming(sv: SvrgState, params, grads, grad_at, step: int,
                         cfg: StrategyConfig):
    """SVRG correction with a streaming one-batch anchor (the sharded
    step's): one worker's slice, ``sv`` holding one tree per field (no
    worker list).  Every ``cfg.svrg_period`` steps the anchor snaps to
    ``params`` and ``mu`` to this batch's ``grads``; the anchor backprop
    ``grad_at(theta_anchor)`` runs every step.

    The refresh is the reference's arithmetic ``r·p + (1−r)·t`` with
    ``r`` in {0., 1.}, not a select: ``0·inf`` is NaN, and ``−0 + 0`` is
    +0, so a non-finite or negatively signed zero entry of the side not
    taken still shows.  Both products are exact, so an FMA contraction
    rounds alike.  ``mu_anchor`` may be None before the first refresh (the
    reference's zeros: ``(1−r)·0 = +0``).  ``corr = mu − g_anchor`` and
    ``grads + corr`` are plain float32 operations.

    To hold memory at one copy per field, the new anchor and ``mu`` are
    written into ``sv``'s buffers (which must not alias ``params`` or
    another tree), ``corr`` into the anchor gradient's (``grad_at``
    returns float32 trees), and ``grads`` (float32, the caller's) is
    corrected in place.  Returns ``(grads, corr, sv_new)``."""
    r = 1.0 if step % cfg.svrg_period == 0 else 0.0

    def blend(new, old):
        x = new.to(F32) * r
        if old is None:
            if r != 1.0:
                raise ValueError("mu_anchor is unset on a step that does not "
                                 "refresh the SVRG anchor")
            return x.add_(0.0)
        return torch.add(x, old.mul_(1.0 - r), out=old)

    if sv.mu_anchor is None:
        mu = tree_map(lambda g: blend(g, None), grads)
    else:
        mu = tree_map(blend, grads, sv.mu_anchor)
    theta_anchor = tree_map(blend, params, sv.theta_anchor)
    corr = grad_at(theta_anchor)
    for c, m, g in zip(tree_leaves(corr), tree_leaves(mu),
                       tree_leaves(grads)):
        torch.sub(m, c, out=c)
        g.add_(c)
    return grads, corr, SvrgState(theta_anchor, mu)


def stale_side_grads(grad_at_raw, theta_last_m, corr_m, scale: float):
    """The WK2 second backprop: this round's minibatch at the worker's
    stale iterate, scaled, with its SVRG correction (if any) added."""
    gs = grad_at_raw(theta_last_m)
    if corr_m is not None:
        return _scale_add(scale, gs, corr_m)
    if scale == 1.0:
        return gs
    return tree_map(lambda x: x * scale, gs)


def participation_mask(cfg: StrategyConfig, step: int, n_workers: int):
    """[W] bool CPU availability mask of round ``step``, or ``None`` for
    the modes that never mask (``full``, ``delay``).

    Deterministic in ``(participation_seed, step)`` and independent of the
    batch and compressor streams, so the engine and every rank of the
    sharded step draw the same cohort.  ``bernoulli`` keeps each worker
    with probability ``participation_p``; ``fixed_k`` keeps exactly
    ``max(1, round(p * W))``: the k lowest of W uniform scores."""
    if cfg.participation in ("full", "delay"):
        return None
    key = random.fold_in(random.PRNGKey(cfg.participation_seed,
                                        device="cpu"), int(step))
    if cfg.participation == "bernoulli":
        return random.bernoulli(key, cfg.participation_p, (n_workers,))
    if cfg.participation == "fixed_k":
        k = max(1, int(round(cfg.participation_p * n_workers)))
        scores = random.uniform(key, (n_workers,))
        return scores <= torch.sort(scores).values[k - 1]
    if cfg.participation == "markov":
        raise ValueError(
            "markov churn is stateful (the chain carries the on/off state "
            "between rounds) -- it has no stateless mask; use "
            "MarkovParticipation via make_participation (simulated engine "
            "only)")
    raise ValueError(f"unknown participation {cfg.participation!r}; "
                     f"have {PARTICIPATION}")


class FullParticipation:
    """Every worker reachable every round (the paper's setting)."""

    def init(self, params0):
        return None

    def begin_round(self, pstate, step, params):
        """``(avail, thetas_w, pstate)``: ``avail`` the [W] bool mask (None:
        all available), ``thetas_w`` the W evaluation iterates (None: the
        current params)."""
        return None, None, pstate


class SampledParticipation:
    """Bernoulli / fixed-k client sampling (:func:`participation_mask`)."""

    def __init__(self, cfg: StrategyConfig, n_workers: int):
        if not 0.0 < cfg.participation_p <= 1.0:
            raise ValueError(f"participation_p {cfg.participation_p} not in "
                             f"(0, 1]")
        self.cfg = cfg
        self.n_workers = n_workers

    def init(self, params0):
        return None

    def begin_round(self, pstate, step, params):
        return participation_mask(self.cfg, step, self.n_workers), None, pstate


class MarkovParticipation:
    """Bursty on/off availability: a per-worker two-state Markov chain with
    ``P(on -> off) = 1 / sojourn`` and ``P(off -> on) = p_down p / (1 -
    p)``, so the stationary availability is ``participation_p`` and the
    mean ON streak ``markov_sojourn`` rounds.  The initial state is drawn
    from the stationary law on stream 1 of ``PRNGKey(participation_seed)``,
    the transitions on stream 0.  ``p_down`` and ``p_up`` are doubles
    compared with float32 uniforms in float32, as JAX's weak types
    compare them.  The state is a [W] bool CPU tensor."""

    def __init__(self, cfg: StrategyConfig, n_workers: int):
        p = cfg.participation_p
        if not 0.0 < p < 1.0:
            raise ValueError(f"markov participation_p {p} not in (0, 1)")
        if not cfg.markov_sojourn >= 1.0:
            raise ValueError(f"markov_sojourn {cfg.markov_sojourn} < 1")
        self.p = p
        self.p_down = min(1.0, 1.0 / cfg.markov_sojourn)
        self.p_up = min(1.0, self.p_down * p / (1.0 - p))
        self.n_workers = n_workers
        self._key0 = random.PRNGKey(cfg.participation_seed, device="cpu")

    def init(self, params0):
        return random.bernoulli(random.fold_in(self._key0, 1), self.p,
                                (self.n_workers,))

    def begin_round(self, on, step, params):
        u = random.uniform(random.fold_in(random.fold_in(self._key0, 0),
                                          int(step)), (self.n_workers,))
        on = torch.where(on, u >= torch.tensor(self.p_down, dtype=F32),
                         u < torch.tensor(self.p_up, dtype=F32))
        return on, None, on


class DelayedParticipation:
    """Bounded-delay asynchronous workers: worker m has the staleness
    ``d_m = m mod (max_delay + 1)`` and computes this round's gradient at
    ``theta^{k - d_m}``.  The state is a ring of ``max_delay + 1`` iterates
    (references: the engine never updates an iterate in place), pushed at
    round start; every worker stays reachable."""

    def __init__(self, max_delay: int, n_workers: int):
        if max_delay < 1:
            raise ValueError("use participation='full' for max_delay=0")
        self.length = max_delay + 1
        self.delays = [m % self.length for m in range(n_workers)]

    def init(self, params0):
        return [params0] * self.length

    def begin_round(self, hist, step, params):
        # hist[d] = theta^{k-d} after the push (index 0 = current round)
        hist = [params] + list(hist[:-1])
        return None, [hist[d] for d in self.delays], hist


def make_participation(cfg: StrategyConfig, n_workers: int):
    """Participation model for ``cfg``, normalizing the degenerate knobs as
    the reference does: ``delay`` with ``max_delay=0``, ``bernoulli`` and
    ``markov`` with ``p >= 1`` and a ``fixed_k`` cohort of all W workers
    are full participation."""
    if cfg.participation not in PARTICIPATION:
        raise ValueError(f"unknown participation {cfg.participation!r}; "
                         f"have {PARTICIPATION}")
    if cfg.participation == "delay":
        if cfg.max_delay < 0:
            raise ValueError(f"max_delay {cfg.max_delay} < 0")
        if cfg.max_delay == 0:
            return FullParticipation()
        return DelayedParticipation(cfg.max_delay, n_workers)
    if cfg.participation in ("bernoulli", "fixed_k"):
        if cfg.participation_p >= 1.0 and cfg.participation != "fixed_k":
            return FullParticipation()
        if cfg.participation == "fixed_k" and \
                max(1, int(round(cfg.participation_p * n_workers))) == n_workers:
            return FullParticipation()
        return SampledParticipation(cfg, n_workers)
    if cfg.participation == "markov":
        if cfg.participation_p >= 1.0:
            return FullParticipation()
        return MarkovParticipation(cfg, n_workers)
    return FullParticipation()


class RoundEngine:
    """One communication round, sources, participation and the state
    machine plugged in.

    ``baseline`` selects a dense baseline of paper Table 3 instead of the
    LAQ state machine: ``"sgd"``, ``"qsgd"`` at ``bits`` or ``"ssgd"`` at
    ``density`` (``CommState`` is then bookkeeping only; a stochastic
    source is required, whose stream 1 keys the compressors, and the
    criterion's ``theta_hist`` is not kept).  ``participation`` overrides
    the model :func:`make_participation` builds from ``cfg``."""

    def __init__(self, source, cfg: StrategyConfig, *, alpha,
                 baseline: Optional[str] = None, bits: int = 3,
                 density: float = 0.1, participation=None):
        if baseline not in (None, "sgd", "qsgd", "ssgd"):
            raise ValueError(f"unknown baseline {baseline!r}")
        if baseline is not None and not source.stochastic:
            raise ValueError("dense baselines need a stochastic source "
                             "(their compressor keys come from its stream 1)")
        if baseline is not None and cfg.faults.active:
            raise ValueError("fault injection targets the LAQ state machine "
                             "(qhat / clocks / estimator state); the dense "
                             "baselines carry none of it -- run them with "
                             "faults off")
        check_supported(cfg)
        if cfg.state_bf16:
            raise ValueError(
                "state_bf16 runs in the sharded step (launch/train.py), not "
                "in RoundEngine: the reference's engine cannot run it -- its "
                "aggregate returns a float32 server_agg from the bfloat16 "
                "one, and the lax.scan of RoundEngine.run rejects the "
                "carry's dtype change")
        self.source = source
        self.cfg = cfg
        self.alpha = alpha
        self.baseline = baseline
        self.bits = bits
        self.density = density
        self.n_workers = source.n_workers
        self.participation = (participation if participation is not None
                              else make_participation(cfg, self.n_workers))
        self.wk2 = (baseline is None and cfg.lazy
                    and cfg.lazy_rule == "lasg_wk2")

    def init_carry(self, params0, *, device="cuda"):
        """``(params, CommState, participation state)`` on ``device``."""
        dev = resolve_device(device)
        params = tree_map(lambda l: l.to(dev), params0)
        return (params, init_comm_state(params, self.n_workers, self.cfg),
                self.participation.init(params))

    def round(self, carry):
        """One communication round.  Returns the new carry and the record
        ``(loss, grad_norm_sq, total_uploads, total_bits, quant_err,
        mean_bits)``.  The carry's per-worker lists and ``server_agg`` are
        updated in place (see :func:`aggregate`)."""
        cfg, source, W = self.cfg, self.source, self.n_workers
        params, cst, pstate = carry
        alpha_k = eta_at(cfg.eta_schedule, self.alpha, cst.step)
        avail, thetas_w, pstate = self.participation.begin_round(
            pstate, cst.step, params)
        loss = source.global_loss(params)
        batches = source.sample(cst.step)
        flt = cfg.faults
        crashed = None
        if flt.crashy:
            # crash-restart before the svrg / wk2 stages: the restarted
            # worker's fresh anchors are what this round computes against
            crashed = crash_mask(flt, cst.step, W)
            cst = apply_crashes(cst, crashed, params, cfg,
                                reconcile=cfg.defense.reconcile_crashes)
        corrupt = (corruption_mask(flt, cst.step, W) if flt.grad_faulty
                   else None)
        fault_flip = fault_keys = None
        if flt.wire_faulty:
            fault_flip = corruption_mask(flt, cst.step, W)
            fault_keys = bitflip_keys(flt, cst.step, W)
        gsum = (None if source.stochastic else
                tree_map(lambda l: torch.zeros(l.shape, dtype=F32,
                                               device=l.device), params))
        svrg = source.stochastic and cfg.variance_reduced
        refresh = svrg and cst.step % cfg.svrg_period == 0
        corr = {}

        def grad_at_raw(m):
            return lambda theta: source.grad_at(theta, batches, m,
                                                scaled=False)

        def grad_of(m):
            theta_m = params if thetas_w is None else thetas_w[m]
            if svrg:
                raw = grad_at_raw(m)(theta_m)
                if crashed is not None and bool(crashed[m]) and not refresh:
                    # the restarted anchor's mu: this round's gradient
                    cst.svrg.mu_anchor[m] = tree_map(
                        lambda x: (x * source.scale if source.scale != 1.0
                                   else x.clone()), raw)
                g, c = apply_svrg_exact(
                    cst.svrg, params, raw, grad_at_raw(m),
                    source.full_local_grads, m, refresh, source.scale)
                del raw
                if self.wk2:
                    corr[m] = c
            else:
                g = source.grad_at(theta_m, batches, m)
            if gsum is not None:
                # the record takes the honest gradient, before corruption
                for a, x in zip(tree_leaves(gsum), tree_leaves(g)):
                    a.add_(x)
            if corrupt is not None:
                # payload corruption after the svrg / wk2 stages: the fault
                # hits what the worker ships, not its local computation
                g = (corrupt_grad(g, flt, inplace=True) if bool(corrupt[m])
                     else tree_map(lambda x: x.to(F32), g))
            return g

        def stale_of(m):
            return stale_side_grads(grad_at_raw(m), cst.lazy.theta_last[m],
                                    corr.pop(m, None), source.scale)

        if self.baseline is None:
            agg, cst, metrics = aggregate(
                cst, grad_of, alpha_k, cfg, params=params,
                stale_of=stale_of if self.wk2 else None, avail=avail,
                fault_flip=fault_flip, fault_keys=fault_keys)
            qe, mb = metrics.radius_max, metrics.mean_bits
        else:
            agg, cst, qe, mb = self._baseline_round(
                cst, grad_of, sum(l.numel() for l in tree_leaves(params)),
                avail)
        # the summed full local gradients ARE the global gradient; a
        # stochastic source takes its own full-data backprop, now that the
        # workers' gradients are freed
        gnorm = (source.grad_norm_sq(params) if gsum is None
                 else tree_sq_norm(gsum).cpu())
        del gsum

        step = (torch.tensor(alpha_k, dtype=F32) if isinstance(alpha_k, float)
                else alpha_k)
        new_leaves, dsq_parts = [], []
        leaves, treedef = tree_flatten(params)
        for t, a in zip(leaves, tree_leaves(agg)):
            # theta - alpha * agg, one FMA as XLA contracts it under jit
            nt = fma_f32(-step.to(t.device), a, t)
            if self.baseline is None and nt.numel():
                dsq_parts.append((nt - t).square().sum())
            new_leaves.append(nt)
        new_params = tree_unflatten(treedef, new_leaves)
        if self.baseline is None:
            dsq = (torch.stack(dsq_parts).sum().cpu() if dsq_parts
                   else torch.zeros((), dtype=F32))
            cst = finalize_step(cst, dsq)
        rec = (loss.cpu(), gnorm, cst.total_uploads, cst.total_bits.clone(),
               qe, mb)
        return (new_params, cst, pstate), rec

    def _baseline_round(self, cst: CommState, grad_of, p: int, avail):
        """Dense-baseline aggregation: every available worker uploads its
        compressed gradient, summed in worker order; no server recursion,
        no skip state.  ``mean_bits`` is the mean wire bits per coordinate
        over the available workers."""
        keys = self.source.stream_keys(1, cst.step)
        agg, bits_m = None, []
        for m in range(self.n_workers):
            g = grad_of(m)
            if self.baseline == "sgd":
                c, b = g, torch.tensor(float(dense_bits(p)), dtype=F32)
            elif self.baseline == "qsgd":
                c, b = qsgd_compress(keys[m], g, self.bits)
            else:
                c, b = ssgd_compress(keys[m], g, self.density)
            del g
            if agg is None:
                agg = tree_map(torch.zeros_like, c)
            keep = avail is None or bool(avail[m])
            if keep:
                # an absent worker's masked upload adds an exact zero
                for a, x in zip(tree_leaves(agg), tree_leaves(c)):
                    a.add_(x)
            del c
            bits_m.append(b.to(F32) if keep else torch.zeros((), dtype=F32))
        bits_m = torch.stack(bits_m)
        if avail is None:
            n_up = self.n_workers
            # jnp.mean(bits) / p under jit: XLA multiplies by the product
            # of the two reciprocals, folded in float32
            inv = (torch.tensor(1.0 / self.n_workers, dtype=F32)
                   * torch.tensor(1.0 / p, dtype=F32))
            mb = bits_m.sum() * inv
        else:
            n_up = int(sum(bool(a) for a in avail))
            # sum(bits) / max(sum(keep), 1) / p: two true divisions under
            # jit (XLA folds a reciprocal only for a constant divisor)
            mb = (bits_m.sum() / torch.tensor(float(max(n_up, 1)), dtype=F32)
                  / torch.tensor(float(p), dtype=F32))
        cst = cst._replace(total_bits=cst.total_bits + bits_m.sum(),
                           total_uploads=cst.total_uploads + n_up,
                           step=cst.step + 1)
        return agg, cst, torch.zeros((), dtype=F32), mb

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

