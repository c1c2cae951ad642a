"""Communication strategies GD / QGD / LAG / LAQ and their stochastic
variants, port of ``repro/core/strategy.py``.

    quantize?  lazy-skip?
GD     no         no        theta^{k+1} = theta^k - alpha * sum_m grad_m
QGD    yes        no        paper eq. (3)
LAG    no         yes       Chen et al. 2018 (paper ref [6])
LAQ    yes        yes       paper eq. (4) + criterion (7a/7b)

The reference vmaps ``worker_update`` over a leading worker axis.  The port
runs the workers one at a time: per-worker state (``qhat``) is a list of W
pytrees, and :func:`aggregate` pulls each worker's gradient, updates it and
commits it before the next gradient exists, so a round holds one worker's
gradient, delta and q_new at a time.  The skip decision is taken on the
host (one sync per worker), and a skipped worker's buffers are simply not
committed instead of being selected against zeros.

Ported branches of ``worker_update``: dense (gd/lag), fixed-width
quantized, adaptive width (A-LAQ, ``bit_schedule``), the sparse top-k and
rand-k wires (``compressor``), error feedback (``error_feedback``), the
four skip rules (``lazy_rule``: the paper's 7a and the LASG rules of
:mod:`repro_torch.core.lazy_rules`, whose per-worker state rides in
``CommState.lazy``), participation (``avail_m``: an unreachable worker is
masked like a lazy skip), wire-code bit flips (``flip_m``) and the
server-side defense (``defense_m``: validation, norm gate and clip; a
rejected upload is masked like a skip and still pays its bits).
``CommState.svrg`` holds the SVRG anchors that the engine corrects
stochastic gradients with (``grad_mode="svrg"``), ``CommState.defense``
the defense's per-worker state, and :func:`aggregate` combines the
committed deltas by the paper's sum or a robust aggregator
(:func:`repro_torch.core.defense.robust_aggregate`).

bfloat16 state (``state_bf16``): ``qhat`` and ``server_agg`` are stored in
bfloat16 and read as float32 (the wire kernels get each leaf cast,
``kernels/ops.py``); a committed ``q_new`` is rounded to bfloat16 (to
nearest even, as ``astype`` rounds) only when it is stored.  The sharded
step (``launch/train.py``) runs it.  ``RoundEngine`` refuses it, as the
reference's engine cannot run it (``core/engine.py``).

An unreachable worker still computes its gradient and its wire, as in the
reference (whose vmap runs every lane): its radius enters
``radius_max``.  Its skip rule is not evaluated (the reference discards
that decision and holds the rule's state), so the in-place estimator
updates of ``lasg_wk`` do not touch a held worker.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..tree import (SharedIterates, tree_flatten, tree_leaves, tree_map,
                    tree_unflatten)
from .adaptive import BitSchedule, EtaSchedule, select_bits
from .compressors import (COMPRESSORS, ErrorState, compressor_keys,
                          init_error_state, static_k)
from .criterion import CriterionConfig, push_history, should_skip
from .defense import (AGGREGATORS, DefenseConfig, DefenseState,
                      defense_slice, defense_step, empty_defense_state,
                      init_defense_state, robust_aggregate)
from .faults import CORRUPT_KINDS, FaultConfig, flip_wire_codes
from .lazy_rules import (LAZY_RULES, LasgConfig, LazyState, commit_upload,
                         empty_lazy_state, init_lazy_state, lazy_rule_step,
                         store_slice, wk2_same_diff_sq, worker_slice)
from .quantize import (dense_bits, fma_f32, sparse_upload_bits, tree_size,
                       tree_sq_norm, upload_bits)
from .wire import get_backend, sparse_roundtrip

F32 = torch.float32
KINDS = ("gd", "qgd", "lag", "laq")
PARTICIPATION = ("full", "bernoulli", "fixed_k", "markov", "delay")
_SQ_CHUNK = 1 << 24     # elements per pass of _sq_norm_diff


class StrategyConfig(NamedTuple):
    """Every field of the reference ``StrategyConfig``, with its
    defaults."""
    kind: str = "laq"               # one of KINDS
    bits: int = 4                   # quantization bits per coordinate
    criterion: CriterionConfig = CriterionConfig()
    per_leaf_radius: bool = False   # paper: one global R; True = bucketed
    first_round_upload: bool = True  # init clocks at t_bar: round 1 is dense
    state_bf16: bool = False        # qhat/server_agg stored in bf16 (the
                                    # sharded step; RoundEngine refuses it)
    bit_schedule: Optional[BitSchedule] = None  # adaptive widths (A-LAQ)
    wire_backend: str = "reference"  # "reference" | "fused" (core/wire.py)
    lazy_rule: str = "laq7a"        # skip rule, one of LAZY_RULES
    lasg: LasgConfig = LasgConfig()  # constants of the LASG rules
    grad_mode: str = "sgd"          # "svrg": variance-reduced stochastic
                                    # gradients (CommState.svrg anchors)
    svrg_period: int = 20           # rounds between svrg anchor refreshes
    eta_schedule: EtaSchedule = EtaSchedule()  # per-round stepsize alpha_k
    participation: str = "full"     # one of PARTICIPATION (core/engine.py):
                                    # "bernoulli" / "fixed_k" sampling,
                                    # "markov" churn, "delay" staleness
    participation_p: float = 1.0    # keep probability / cohort fraction
    max_delay: int = 0              # "delay": worker m at theta^{k - m mod
                                    # (D + 1)}
    participation_seed: int = 0     # seed of the availability stream
    compressor: str = "none"        # "topk" / "randk" sparse wire
    compressor_k: float = 0.25      # kept fraction, k = static_k(frac, p)
    error_feedback: bool = False    # EF-LAQ residual in CommState.error
    ef_damping: float = 0.5         # g_eff = g + eta * e
    compressor_seed: int = 0
    markov_sojourn: float = 8.0     # "markov": mean ON-streak in rounds
    faults: FaultConfig = FaultConfig()  # fault injection (core/faults.py)
    defense: DefenseConfig = DefenseConfig()  # validation / gate / clip /
                                    # crash reconciliation (core/defense.py)
    aggregator: str = "sum"         # one of AGGREGATORS: the paper's sum or
                                    # a coordinate-wise trimmed mean / median
    trim_frac: float = 0.1          # "trimmed_mean": fraction trimmed at
                                    # each end (t = floor(f * W), min 1)

    @property
    def quantized(self) -> bool:
        return self.kind in ("qgd", "laq")

    @property
    def variance_reduced(self) -> bool:
        return self.grad_mode == "svrg"

    @property
    def lazy(self) -> bool:
        return self.kind in ("lag", "laq")

    @property
    def adaptive(self) -> bool:
        return (self.quantized and self.bit_schedule is not None
                and self.bit_schedule.adaptive)

    @property
    def compressed(self) -> bool:
        return self.compressor != "none"

    @property
    def effective_bits(self) -> int:
        """Width of the fixed-width path (a constant schedule routes here,
        so it is bit-exact with fixed-width LAQ)."""
        if self.bit_schedule is not None and not self.bit_schedule.adaptive:
            return self.bit_schedule.bits
        return self.bits


def check_supported(cfg: StrategyConfig):
    """Raise for a configuration this slice of the port cannot run."""
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown kind {cfg.kind!r}; have {KINDS}")
    if cfg.compressor not in COMPRESSORS:
        raise ValueError(f"unknown compressor {cfg.compressor!r}; have "
                         f"{COMPRESSORS}")
    if (cfg.compressed or cfg.error_feedback) and not (
            cfg.quantized and not cfg.adaptive):
        raise ValueError("the compressor pipeline / error feedback require "
                         "a fixed-bit quantized kind (qgd / laq)")
    if cfg.lazy_rule not in LAZY_RULES:
        raise ValueError(f"unknown lazy rule {cfg.lazy_rule!r}; have "
                         f"{LAZY_RULES}")
    if cfg.grad_mode not in ("sgd", "svrg"):
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
    if cfg.participation not in PARTICIPATION:
        raise ValueError(f"unknown participation {cfg.participation!r}; "
                         f"have {PARTICIPATION}")
    if cfg.aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {cfg.aggregator!r}; have "
                         f"{AGGREGATORS}")
    if cfg.faults.corrupt_kind not in CORRUPT_KINDS:
        raise ValueError(f"unknown corrupt_kind {cfg.faults.corrupt_kind!r}; "
                         f"have {CORRUPT_KINDS}")
    if cfg.faults.wire_faulty and not (cfg.quantized and not cfg.adaptive
                                       and not cfg.compressed):
        raise ValueError("wire-code bit-flips model the packed fixed-bit "
                         "payload: they need a fixed-bit quantized kind (qgd "
                         "/ laq) without the sparse compressor pipeline")


class SvrgState(NamedTuple):
    """Per-worker SVRG anchor (``grad_mode="svrg"``): ``theta_anchor`` the
    iterate at the last refresh and ``mu_anchor`` the worker's full local
    gradient there, each a list of W pytrees, or both ``None``.  Between
    refreshes the engine feeds ``g(theta; xi) - g(theta_anchor; xi) + mu``
    to the rule and the quantizer (``core/engine.py``)."""
    theta_anchor: Optional[list]
    mu_anchor: Optional[list]


def init_svrg_state(grad_mode: str, grad_template,
                    n_workers: int) -> SvrgState:
    """The template's values (the initial iterate) as the anchor, shared by
    the W workers, and no ``mu`` yet: every run starts at step 0, whose
    refresh sets both before they are read."""
    if grad_mode not in ("sgd", "svrg"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    if grad_mode != "svrg":
        return SvrgState(None, None)
    snapshot = tree_map(lambda l: l.to(F32), grad_template)
    return SvrgState(theta_anchor=SharedIterates([snapshot] * n_workers),
                     mu_anchor=[None] * n_workers)


class CommState(NamedTuple):
    """LAQ state.  ``qhat`` (and ``error.residual`` under error feedback,
    the LASG pytrees of ``lazy`` and the SVRG anchors of ``svrg``) is a
    list of W per-worker pytrees on the parameters' device, ``server_agg``
    one pytree there, both float32, or bfloat16 under ``state_bf16``; the
    small bookkeeping lives on the host as float32/int CPU tensors and
    ints.

    :func:`aggregate` updates the per-worker lists and ``server_agg`` in
    place to hold memory at one copy each.
    """
    qhat: list              # [W] last uploaded quantized gradient Q_m(theta_hat)
    server_agg: object      # server aggregate agg^{k-1}
    eps_hat_sq: torch.Tensor  # [W] ||eps_hat_m||^2 at last upload
    clocks: torch.Tensor    # [W] int32 t_m
    bits_spent: torch.Tensor  # [W] cumulative wire bits per worker
    theta_hist: torch.Tensor  # [D] ||theta^{k+1-d} - theta^{k-d}||^2 ring
    total_bits: torch.Tensor  # float32, as in the reference
    total_uploads: int
    step: int
    lazy: LazyState         # per-worker LASG estimator state
    R_anchor: torch.Tensor  # [W] anchor radius of the "rel" adaptive thresholds
    svrg: SvrgState         # per-worker SVRG anchors (grad_mode="svrg")
    error: ErrorState = ErrorState(None)  # [W] EF residuals (error_feedback)
    defense: DefenseState = DefenseState(None, None, None)  # [W] validation
                            # state and reject ledger (DefenseConfig.active)


class RoundMetrics(NamedTuple):
    uploads: int            # |M^k| this round
    bits: torch.Tensor      # wire bits this round (float32)
    mean_skip: float        # fraction of workers skipping
    radius_max: torch.Tensor  # max_m R_m^k (0 for unquantized)
    mean_bits: torch.Tensor  # mean width over uploading workers
    rejections: int = 0     # transmissions the server refused to commit


def init_comm_state(grad_template, n_workers: int,
                    cfg: StrategyConfig) -> CommState:
    """Zero state; ``grad_template`` gives one worker's leaf shapes and the
    device the per-worker buffers live on."""
    check_supported(cfg)
    sdtype = torch.bfloat16 if cfg.state_bf16 else F32

    def zeros(l):
        return torch.zeros(l.shape, dtype=F32, device=l.device)

    def zeros_s(l):
        return torch.zeros(l.shape, dtype=sdtype, device=l.device)

    # clocks start at t_bar when first_round_upload: criterion (7b) then
    # forces a dense first round, bootstrapping qhat / the server aggregate
    clock0 = cfg.criterion.t_bar if (cfg.lazy and cfg.first_round_upload) else 0
    lazy_rule = cfg.lazy_rule if cfg.lazy else "laq7a"
    return CommState(
        qhat=[tree_map(zeros_s, grad_template) for _ in range(n_workers)],
        server_agg=tree_map(zeros_s, grad_template),
        eps_hat_sq=torch.zeros(n_workers, dtype=F32),
        clocks=torch.full((n_workers,), clock0, dtype=torch.int32),
        bits_spent=torch.zeros(n_workers, dtype=F32),
        theta_hist=torch.zeros(cfg.criterion.D, dtype=F32),
        total_bits=torch.zeros((), dtype=F32),
        total_uploads=0,
        step=0,
        lazy=init_lazy_state(lazy_rule, grad_template, n_workers),
        R_anchor=torch.zeros(n_workers, dtype=F32),
        svrg=init_svrg_state(cfg.grad_mode, grad_template, n_workers),
        error=init_error_state(cfg.error_feedback, grad_template, n_workers),
        defense=init_defense_state(cfg.defense, n_workers),
    )


class WorkerOut(NamedTuple):
    """Result of :func:`worker_update`.  ``delta_masked`` is ``None`` when
    the worker did not commit (the reference's all-zero contribution), and
    so is ``error_new`` then or without error feedback."""
    delta_masked: object
    qhat_new: object
    eps_hat_sq_new: torch.Tensor
    clock_new: int
    uploaded: bool          # the worker sent a payload (pays bits)
    bits_m: torch.Tensor    # float32 wire bits of this worker this round
    R: torch.Tensor         # max leaf radius (0 for unquantized)
    width_m: float          # width this round, 32 for dense uploads
    committed: bool         # the server applied the payload (uploaded and
                            # not rejected by the defense)
    R_anchor_new: torch.Tensor  # updated "rel" threshold anchor
    error_new: object = None    # the new EF residual, when committed
    lazy_new: Optional[LazyState] = None  # the worker's new LASG slice
    defense_new: DefenseState = DefenseState(None, None, None)


def _sq_norm_diff(a_tree, b_tree) -> torch.Tensor:
    """``||a - b||^2`` over two pytrees, float32, in chunks, so that one
    chunk's difference is the only transient."""
    parts = []
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        fa, fb = a.reshape(-1), b.reshape(-1)
        for s in range(0, fa.numel(), _SQ_CHUNK):
            d = fa[s:s + _SQ_CHUNK].to(F32) - fb[s:s + _SQ_CHUNK].to(F32)
            parts.append(d.square_().sum())
    if not parts:
        return torch.zeros((), dtype=F32)
    return torch.stack(parts).sum()


def _qhat_plus(q_new, qhat_m, delta):
    """``q_new = qhat + delta`` again, into ``q_new``'s buffers."""
    for qn, qh, d in zip(tree_leaves(q_new), tree_leaves(qhat_m),
                         tree_leaves(delta)):
        torch.add(qh.to(F32), d, out=qn)


def worker_update(grad_m, qhat_m, eps_hat_sq_m, clock_m, theta_hist, alpha,
                  n_workers: int, cfg: StrategyConfig, *, bits_spent_m=0.0,
                  step: int = 0, R_anchor_m=None, error_m=None,
                  lazy_m: Optional[LazyState] = None, params=None,
                  grad_stale_m=None, ckey_m=None, avail_m=None,
                  defense_m: Optional[DefenseState] = None, flip_m=None,
                  fkey_m=None) -> WorkerOut:
    """One worker's width selection + quantize + skip decision + commit
    (dense, fixed-width, adaptive, sparse and error-feedback branches of
    the reference, under any of its four skip rules).  ``error_m`` is the
    worker's residual pytree (error feedback only); the new residual
    ``g_eff - q_new`` is formed in place in ``g_eff``, which this function
    owns.  ``lazy_m`` is the worker's LASG slice, ``params`` the current
    iterate (``lasg_wk2``/``lasg_ps``), ``grad_stale_m`` the WK2 second
    backprop and ``ckey_m`` the worker's rand-k key.

    ``avail_m`` is the worker's participation bit (``None``: reachable).
    ``flip_m`` / ``fkey_m`` are its wire-fault bit and flip key
    (``corrupt_kind="bitflip"``): the codes are flipped after the honest
    skip decision and the moments recomputed from the corrupted payload,
    so the defense sees what the server sees.  ``defense_m`` is its
    :class:`~repro_torch.core.defense.DefenseState` slice (required when
    ``cfg.defense.active``).

    Two bits gate the commits, as in the reference: ``uploaded`` (the
    rule said upload and the worker was reachable) pays the bits;
    ``committed`` (uploaded and accepted by the defense) commits qhat,
    eps_hat, the clock reset, the estimator snapshots and the EF residual.
    A skip, an absence and a rejection all leave that state as it was.
    """
    check_supported(cfg)
    if lazy_m is None:
        lazy_m = empty_lazy_state()
    available = avail_m is None or bool(avail_m)
    same_diff_sq = None
    if cfg.lazy and cfg.lazy_rule == "lasg_wk2" and grad_stale_m is not None:
        # the same-sample difference first, so that the stale gradient is
        # freed (when the caller holds no other reference) before the
        # quantizer's buffers exist
        same_diff_sq = wk2_same_diff_sq(lazy_m, grad_m, grad_stale_m)
    del grad_stale_m
    p = tree_size(grad_m)
    n_sidecars = len(tree_leaves(grad_m)) if cfg.per_leaf_radius else 1
    R_anchor_in = (torch.zeros((), dtype=F32) if R_anchor_m is None
                   else R_anchor_m)
    R_anchor_new = R_anchor_in
    R_tree = None
    if cfg.error_feedback:
        # g_eff = g + eta e, one FMA as XLA contracts it
        g_eff = tree_map(lambda g, e: fma_f32(cfg.ef_damping, e, g.to(F32)),
                         grad_m, error_m)
        if cfg.lazy_rule != "lasg_wk":
            grad_m = None   # the branches below read g_eff only
    else:
        g_eff = grad_m
    backend = get_backend(cfg.wire_backend)
    if cfg.adaptive:
        sched = cfg.bit_schedule
        # pass 1: the radii (the fused backend materializes no diff), then
        # the width on the host, then pass 2 at that width
        diff, R_tree, R = backend.innovation(grad_m, qhat_m,
                                             cfg.per_leaf_radius)
        width, onehot, R_anchor_new = select_bits(
            sched, R.cpu(), bits_spent_m, step, p, n_radii=n_sidecars,
            R_anchor=R_anchor_in)
        q_new, delta, err_sq, innovation_sq = backend.adaptive_roundtrip(
            grad_m, qhat_m, diff, R_tree, sched.grid, onehot)
        del diff
        bits_if_upload = upload_bits(p, width, n_radii=n_sidecars,
                                     bit_sidecar=True)
        width_m = float(width)
    elif cfg.compressed:
        k = static_k(cfg.compressor_k, p)
        srt = sparse_roundtrip(backend, g_eff, qhat_m, cfg.effective_bits, k,
                               cfg.compressor, key=ckey_m)
        q_new, delta, R = srt.q_new, srt.delta, srt.R
        err_sq, innovation_sq = srt.err_sq, srt.innovation_sq
        del srt
        # two f32 sidecars: the (lo, hi) grid endpoints
        bits_if_upload = float(sparse_upload_bits(p, k, cfg.effective_bits,
                                                  n_radii=2))
        width_m = float(cfg.effective_bits)
    elif cfg.quantized:
        rt = backend.roundtrip(g_eff, qhat_m, cfg.effective_bits,
                               cfg.per_leaf_radius)
        q_new, delta, R, R_tree = rt.q_new, rt.delta, rt.R_max, rt.R_tree
        err_sq, innovation_sq = rt.err_sq, rt.innovation_sq
        del rt
        bits_if_upload = float(upload_bits(p, cfg.effective_bits,
                                           n_radii=n_sidecars))
        width_m = float(cfg.effective_bits)
    else:
        # q_new is the gradient itself; a copy where the clip rewrites it
        clip = cfg.defense.clip_mult > 0.0
        q_new = tree_map(lambda g: g.to(F32).clone() if clip else g.to(F32),
                         grad_m)
        delta = tree_map(lambda g, q: g - q.to(F32), q_new, qhat_m)
        R = torch.zeros((), dtype=F32)
        err_sq = torch.zeros((), dtype=F32)
        innovation_sq = tree_sq_norm(delta)
        bits_if_upload = float(dense_bits(p))
        width_m = 32.0

    err_sq, innovation_sq = err_sq.cpu(), innovation_sq.cpu()
    lazy_pre, stats = lazy_m, None
    if not cfg.lazy:
        skip = False
    elif not available:
        # the reference evaluates the rule and discards it: an unreachable
        # worker uploads nothing and its estimator state is held
        skip = True
    elif cfg.lazy_rule == "laq7a":
        skip = bool(should_skip(innovation_sq, theta_hist, alpha, n_workers,
                                err_sq, eps_hat_sq_m, clock_m, cfg.criterion))
    else:
        skip, lazy_pre, stats = lazy_rule_step(
            cfg.lazy_rule, cfg.lasg, cfg.criterion, grad_m=grad_m,
            params=params, lazy_m=lazy_m, innovation_sq=innovation_sq,
            err_sq=err_sq, eps_hat_sq_m=eps_hat_sq_m, clock_m=clock_m,
            theta_hist=theta_hist, alpha=alpha, n_workers=n_workers,
            same_diff_sq=same_diff_sq)
    del grad_m
    uploaded = (not skip) and available

    if cfg.faults.wire_faulty and flip_m is not None and uploaded:
        # MSB flips on the payload after the honest skip decision; both
        # moments are recomputed from what the server receives (for every
        # uploading worker, as the reference does)
        if bool(flip_m):
            delta = flip_wire_codes(delta, R_tree, cfg.effective_bits,
                                    fkey_m, cfg.faults.bitflip_frac)
            _qhat_plus(q_new, qhat_m, delta)
        err_sq = _sq_norm_diff(g_eff, q_new).cpu()
        innovation_sq = tree_sq_norm(delta).cpu()

    if cfg.defense.active:
        if defense_m is None or defense_m.norm_ema is None:
            raise ValueError("cfg.defense.active needs the worker's "
                             "DefenseState slice (init_comm_state)")
        accept, clip_scale, defense_new = defense_step(
            cfg.defense, defense_m, innovation_sq, err_sq, uploaded)
        committed = uploaded and accept
        if committed and cfg.defense.clip_mult > 0.0:
            # the SAME scaled delta commits to server_agg and qhat
            if float(clip_scale) != 1.0:
                for d in tree_leaves(delta):
                    d.mul_(clip_scale.to(d.device))
                _qhat_plus(q_new, qhat_m, delta)
            innovation_sq = innovation_sq * clip_scale * clip_scale
            if cfg.compressed:
                # support-restricted err_sq: rescaled, exact at scale 1
                err_sq = err_sq * clip_scale * clip_scale
            else:
                err_sq = _sq_norm_diff(g_eff, q_new).cpu()
    else:
        committed = uploaded
        defense_new = (defense_m if defense_m is not None
                       else empty_defense_state())

    bits_m = (torch.tensor(float(uploaded), dtype=F32)
              * torch.as_tensor(bits_if_upload, dtype=F32))
    lazy_new = (lazy_pre if stats is None else
                commit_upload(cfg.lazy_rule, cfg.lasg, lazy_pre, committed,
                              stats, params=params,
                              innovation_sq=innovation_sq))
    if not available:
        # an unreachable worker ran no local computation: hold its
        # estimator state and its adaptive threshold anchor
        lazy_new, R_anchor_new = lazy_m, R_anchor_in
    error_new = None
    if cfg.error_feedback and committed:
        # e_new = g_eff - q_new: the mass this round's compress dropped
        error_new = tree_map(lambda g, qn: g.sub_(qn), g_eff, q_new)
    del g_eff
    if committed:
        # the commit rounds q_new into qhat's dtype (to nearest even, as
        # the reference's qn.astype(qh.dtype)): a no-op for float32 state
        q_leaves, treedef = tree_flatten(q_new)
        del q_new
        q_new = tree_unflatten(treedef, [
            q_leaves.pop(0).to(qh.dtype) for qh in tree_leaves(qhat_m)])
    return WorkerOut(
        delta_masked=delta if committed else None,
        qhat_new=q_new if committed else qhat_m,
        eps_hat_sq_new=err_sq if committed else eps_hat_sq_m,
        clock_new=0 if committed else int(clock_m) + 1,
        uploaded=uploaded, bits_m=bits_m, R=R.cpu(), width_m=width_m,
        committed=committed, R_anchor_new=R_anchor_new, error_new=error_new,
        lazy_new=lazy_new, defense_new=defense_new)


def _add_(acc, tree):
    for a, x in zip(tree_leaves(acc), tree_leaves(tree)):
        a.add_(x)


def aggregate(state: CommState, grad_of: Callable[[int], object], alpha,
              cfg: StrategyConfig, *, params=None,
              stale_of: Optional[Callable[[int], object]] = None,
              avail=None, fault_flip=None, fault_keys=None):
    """Aggregate the workers' gradients into the LAQ gradient.

    ``grad_of(m)`` returns worker m's gradient pytree; it is called once
    per worker, in order, and each gradient is dropped once its worker is
    committed.  ``stale_of(m)``, the stale side of the reference (the WK2
    second backprop, ``lasg_wk2`` only), is called right after it, so only
    the worker in hand's stale gradient is live.  ``params`` is the
    current iterate (``lasg_wk2``/``lasg_ps``).  ``avail`` ([W] bool) is
    the round's participation mask, ``fault_flip`` / ``fault_keys`` the
    wire-fault mask and keys (``core/faults.py``).  Returns ``(agg_grad,
    new_state, metrics)``; ``agg_grad`` is the new server aggregate.  The
    caller applies ``theta <- theta - alpha * agg_grad`` and then
    :func:`finalize_step`.

    With the paper's sum the committed deltas are summed as they come;
    a robust aggregator holds the W committed deltas until the last
    worker and combines them coordinate-wise
    (:func:`~repro_torch.core.defense.robust_aggregate`).

    ``state.qhat``, ``state.error.residual``, the pytree lists of
    ``state.lazy`` and ``state.server_agg`` are updated in place.
    """
    n_workers = len(state.qhat)
    ckeys = (compressor_keys(cfg.compressor_seed, state.step, n_workers,
                             device=tree_leaves(state.server_agg)[0].device)
             if cfg.compressor == "randk" else None)
    lazy = state.lazy._replace(stat_ema=state.lazy.stat_ema.clone(),
                               stat_count=state.lazy.stat_count.clone(),
                               sigma_hat_sq=state.lazy.sigma_hat_sq.clone())
    defense = DefenseState(*(None if x is None else x.clone()
                             for x in state.defense))
    robust = cfg.aggregator != "sum"
    # sum_m delta_masked first, then agg + sum, as the reference's
    # a + jnp.sum(d, axis=0): the zero-started running sum repeats its
    # additions in worker order (a skipped worker adds an exact zero)
    dsum = None if robust else tree_map(torch.zeros_like, state.server_agg)
    held = [None] * n_workers
    eps, clocks = state.eps_hat_sq.clone(), state.clocks.clone()
    anchors = state.R_anchor.clone()
    residual = state.error.residual
    bits_m, radii, widths, ups, comms = [], [], [], [], []
    for m in range(n_workers):
        wo = worker_update(
            grad_of(m), state.qhat[m], state.eps_hat_sq[m], state.clocks[m],
            state.theta_hist, alpha, n_workers, cfg,
            bits_spent_m=state.bits_spent[m], step=state.step,
            R_anchor_m=state.R_anchor[m],
            error_m=None if residual is None else residual[m],
            lazy_m=worker_slice(lazy, m), params=params,
            grad_stale_m=None if stale_of is None else stale_of(m),
            ckey_m=None if ckeys is None else ckeys[m],
            avail_m=None if avail is None else bool(avail[m]),
            defense_m=(defense_slice(defense, m) if cfg.defense.active
                       else None),
            flip_m=None if fault_flip is None else bool(fault_flip[m]),
            fkey_m=None if fault_keys is None else fault_keys[m])
        store_slice(lazy, m, wo.lazy_new)
        if cfg.defense.active:
            for field, x in zip(defense, wo.defense_new):
                field[m] = x
        if wo.committed:
            if robust:
                held[m] = wo.delta_masked
            else:
                _add_(dsum, wo.delta_masked)
            state.qhat[m] = wo.qhat_new
        if wo.error_new is not None:
            residual[m] = wo.error_new
        anchors[m] = wo.R_anchor_new
        eps[m] = wo.eps_hat_sq_new
        clocks[m] = wo.clock_new
        bits_m.append(wo.bits_m)
        radii.append(wo.R)
        widths.append(wo.width_m)
        ups.append(wo.uploaded)
        comms.append(wo.committed)
        del wo
    if robust:
        # added into server_agg, the rescale contracted into the addition
        robust_aggregate(cfg.aggregator, held, comms, cfg.trim_frac,
                         template=state.server_agg, into=state.server_agg)
        del held
    else:
        _add_(state.server_agg, dsum)
    del dsum

    bits_m = torch.stack(bits_m)
    uploads = sum(ups)
    bits = bits_m.sum()
    fup = torch.tensor([float(u) for u in ups], dtype=F32)
    mean_bits = ((torch.tensor(widths, dtype=F32) * fup).sum()
                 / torch.clamp_min(fup.sum(), 1.0))
    metrics = RoundMetrics(uploads=uploads, bits=bits,
                           mean_skip=1.0 - uploads / n_workers,
                           radius_max=torch.stack(radii).amax(),
                           mean_bits=mean_bits,
                           rejections=sum(u and not c
                                          for u, c in zip(ups, comms)))
    new_state = state._replace(
        eps_hat_sq=eps, clocks=clocks, R_anchor=anchors, lazy=lazy,
        bits_spent=state.bits_spent + bits_m,
        total_bits=state.total_bits + bits,
        total_uploads=state.total_uploads + uploads,
        step=state.step + 1, defense=defense)
    return state.server_agg, new_state, metrics


def finalize_step(state: CommState, theta_diff_sq) -> CommState:
    """Push ||theta^{k+1}-theta^k||^2 into the criterion's history ring."""
    return state._replace(
        theta_hist=push_history(state.theta_hist, theta_diff_sq))
