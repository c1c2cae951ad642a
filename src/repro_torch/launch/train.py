"""The data-parallel sharded LAQ training step, port of
``repro/launch/train.py``.

The reference runs the step as one SPMD program inside ``shard_map``,
manual over the worker axis ``data``: each worker computes its local
gradient, runs the LAQ state machine (``worker_update``) on it, and the
aggregation is an explicit collective.  The port runs one process per
worker on ``torch.distributed`` (:mod:`repro_torch.launch.mesh`), and the
reference's collectives over the worker axis become the worker group's:

* ``wire="float"``: the skip-masked dequantized innovations are summed
  over the workers (the reference's ``psum``).
* ``wire="packed"``: per leaf, the b-bit codes packed into uint8 along the
  leaf's last dim are exchanged (``all_gather``, or the peer swap of a
  two-worker group), with the radii, the skip bit and, for A-LAQ, the
  selected width as sidecars; every worker decodes and sums the W
  payloads (the replica of the paper's server).  Streamed one leaf at a
  time: one leaf's codes, payload and delta are live at a time.

**Summation order.**  The reference's ``psum`` on its CPU devices and its
``jnp.sum(axis=0)`` over a gathered ``[W, ...]`` both add the workers in
order from 0, which is why its packed and float wires give bitwise-equal
parameters.  ``dist.all_reduce`` promises no order: gloo's and NCCL's ring
and tree algorithms add in chunk-dependent orders.  So every cross-worker
sum here (the float wire's deltas, the packed wire's decoded payloads,
the bits, uploads and losses) gathers the W terms and adds them in worker
order, starting from 0.  The float and packed wires then give
bitwise-equal parameters, as in the reference.

State: each rank holds a one-worker slice of the per-worker ``CommState``
fields (``qhat``, and the pytrees of ``lazy``, ``svrg`` and ``error``, in
lists of one; ``eps_hat_sq``, ``clocks``, ``bits_spent``, ``R_anchor`` and
the ``lazy`` scalars of shape [1], as the reference's ``_squeeze0`` sees
them) and the replicated fields (``server_agg``, ``theta_hist``,
``total_bits``, ``total_uploads``, ``step``).  The step consumes the
state it is given: it updates ``server_agg``, the SVRG anchor and ``mu``,
the LASG state and the EF residual in place, so that each is held once.

Ported: ``wire`` float and packed, fixed width b in {2, 4, 8} and the
adaptive ``BitSchedule`` over the {2, 4, 8} grid, per-leaf or global
radius, ``microbatch >= 1``, ``eta_schedule``, ``bernoulli`` / ``fixed_k``
participation (each worker reads its slot of the cohort mask every
worker draws alike) and the per-worker defense: validation and the norm
gate on both wires, where a rejected upload is masked off the packed
wire exactly like a skip, and the clip on the float wire.  Every lazy
rule (``laq7a``, ``lasg_wk``, ``lasg_wk2``, ``lasg_ps``) and SVRG's
streaming anchor (:func:`repro_torch.core.engine.apply_svrg_streaming`)
on both wires: the anchor's and WK2's stale-iterate backprops go through
the same microbatch fold as the primal one.  The top-k and rand-k
compressors, with and without error feedback, on the float wire, with
the engine's analytic bit accounting (each worker's rand-k key is its
slot of the step's keys).  What the reference refuses (``delay`` /
``markov`` participation, fault injection, a robust aggregator, the clip
on the packed wire, a compressor or error feedback on the packed wire)
raises ``ValueError`` with its reason; pods and a model axis > 1 raise
``NotImplementedError`` naming their ROADMAP item.  ``state_bf16`` on both
wires: ``qhat`` and ``server_agg`` are stored in bfloat16, read as
float32, and the optimizer reads the float32 ``agg`` of the server
recursion (:func:`_server_update`).
The reference's ``train_state_specs``, ``batch_specs`` and
``_match_param_spec`` place arrays on a TPU mesh (PartitionSpecs) and have
no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.adaptive import eta_at, tau_of_selection
from ..core.compressors import compressor_keys
from ..core.criterion import push_history
from ..core.defense import DefenseState, defense_slice
from ..core.engine import (accumulate_loss_grads, apply_svrg_streaming,
                           participation_mask, stale_side_grads,
                           value_and_grad)
from ..core.lazy_rules import store_slice, worker_slice
from ..core.quantize import (dequantize_leaf, tree_sq_norm, tree_sq_norm_diff,
                             two_tau_f32)
from ..core.strategy import (CommState, StrategyConfig, SvrgState,
                             check_supported, init_comm_state, worker_update)
from ..core.wire import (get_backend, pack_codes_along_axis,
                         unpack_codes_along_axis)
from ..models.config import ModelConfig
from ..models.model import lm_loss
from ..optim.optimizers import Optimizer
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .mesh import WorkerGroup, n_workers_of

F32 = torch.float32


class TrainState(NamedTuple):
    params: object
    opt_state: object
    comm: CommState         # this worker's slice (see the module docstring)
    step: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor      # global loss, sum of the workers' lm_loss / W
    uploads: int            # workers that uploaded this step
    bits: torch.Tensor      # wire bits of this step, all workers (float32)
    grad_sq: torch.Tensor   # ||agg||^2 of the new server aggregate


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the sharded step yet (ROADMAP.md queue 1: "
        f"{item})")


def exchange_mode(n_workers: int) -> str:
    """Which collective carries the packed payload: ``"permute"`` (a peer
    swap) for two workers, ``"gather"`` (every worker's payload to every
    worker) otherwise, one worker included.  The reference's third mode,
    ``"local_decode_psum"``, is its jax-0.4 shim and is not ported."""
    return "permute" if n_workers == 2 else "gather"


def _sum_in_order(values) -> torch.Tensor:
    """``((0 + v_0) + v_1) + ...``: the reference's cross-worker sum."""
    acc = None
    for v in values:
        acc = torch.zeros_like(v) + v if acc is None else acc + v
    return acc


def _decode(payload, R, keep, two_tau, provision, orig):
    """One worker's dequantized, skip-masked delta of one leaf:
    ``where(R > 0, 2 tau R q - R, 0) * keep``, the dequantization rounded
    once as XLA's FMA rounds it."""
    codes = unpack_codes_along_axis(payload, provision, orig)
    return dequantize_leaf(codes, R, two_tau=two_tau).mul_(keep)


def _packed_aggregate(grads, qhat, skip: bool, strategy: StrategyConfig,
                      workers: WorkerGroup, width=None,
                      with_q_new: bool = True):
    """The packed uint8 wire, streamed one leaf at a time: per leaf,
    innovation -> codes (kernel 5, or kernel 6 at the selected width) ->
    pack along the last dim -> exchange -> decode and sum over the workers
    in worker order, plus the leaf's own ``q_new = qhat + delta``.
    Returns ``(sum_of_innovations, q_new)`` as pytrees; ``q_new`` is None
    unless ``with_q_new``.

    The radii come first, one scalar per leaf (kernel 1), maxed into one
    global radius unless ``per_leaf_radius``.  ``width`` (this worker's
    selected width, a float32 0-d tensor) switches on the adaptive wire:
    codes at the selected width in lanes of ``max(grid)`` bits, and the
    width travels as a sidecar so each receiver decodes with the sender's
    ``tau``.  The sidecars (skip bit, width, radii) are exchanged once per
    call, before the leaves.
    """
    per_leaf = strategy.per_leaf_radius
    adaptive = width is not None
    backend = get_backend(strategy.wire_backend)
    if adaptive:
        grid = tuple(strategy.bit_schedule.grid)
        onehot = (torch.tensor(grid, dtype=F32) == width.cpu()).to(F32)
        provision = max(grid)
        t_sel = tau_of_selection(grid, onehot)
    else:
        provision = strategy.effective_bits
    mode = exchange_mode(n_workers_of(workers))

    g_leaves, treedef = tree_flatten(grads)
    qh_leaves = tree_leaves(qhat)
    dev = g_leaves[0].device
    absmax = [backend.leaf_absmax(g, qh) for g, qh in zip(g_leaves, qh_leaves)]
    if per_leaf:
        r_leaves = absmax
    else:
        R_glob = torch.stack(absmax).amax()
        r_leaves = [R_glob] * len(g_leaves)

    # the per-call sidecars, one exchange: [keep, width, R_0, ..., R_{L-1}]
    side = torch.stack([torch.tensor(0.0 if skip else 1.0, device=dev),
                        torch.tensor(float(width if adaptive else provision),
                                     device=dev)]
                       + [r.to(dev).reshape(()) for r in r_leaves])
    side_w = [s.to(dev) for s in workers.all_gather(side)]
    two_tau_w = [two_tau_f32(int(s[1]), dev) for s in side_w]

    def gather_dequant_sum(pl, i, orig):
        acc = torch.zeros(orig.shape, dtype=F32, device=dev)
        for s, tt, p in zip(side_w, two_tau_w, workers.all_gather(pl)):
            acc += _decode(p.to(dev), s[2 + i], s[0], tt, provision, orig)
        return acc

    def permute_dequant_sum(pl, i, orig):
        me, peer = side_w[workers.rank], side_w[1 - workers.rank]
        own = _decode(pl, me[2 + i], me[0], two_tau_w[workers.rank],
                      provision, orig)
        return own + _decode(workers.permute(pl).to(dev), peer[2 + i],
                             peer[0], two_tau_w[1 - workers.rank], provision,
                             orig)

    leaf_fn = {"gather": gather_dequant_sum,
               "permute": permute_dequant_sum}[mode]
    agg_leaves, qnew_leaves = [], []
    for i, (g, qh, R) in enumerate(zip(g_leaves, qh_leaves, r_leaves)):
        if adaptive:
            q, delta_local = backend.leaf_quantize_adaptive(g, qh, R, grid,
                                                            onehot, t_sel)
        else:
            q, delta_local = backend.leaf_quantize(g, qh, R, provision)
        if g.numel():
            pl = pack_codes_along_axis(q, provision)
            del q
            agg_leaves.append(leaf_fn(pl, i, g))
            del pl
        else:       # every worker holds the same shapes: none exchanges it
            agg_leaves.append(torch.zeros(g.shape, dtype=F32, device=dev))
        if with_q_new:
            qnew_leaves.append(qh.to(F32) + delta_local)
        del delta_local
    return (tree_unflatten(treedef, agg_leaves),
            tree_unflatten(treedef, qnew_leaves) if with_q_new else None)


def _float_aggregate(delta_masked, template, workers: WorkerGroup):
    """The float wire: the W workers' skip-masked deltas summed leaf by
    leaf in worker order (a skipped worker sends zeros)."""
    leaves, treedef = tree_flatten(template)
    deltas = (tree_leaves(delta_masked) if delta_masked is not None
              else [None] * len(leaves))
    out = []
    for t, d in zip(leaves, deltas):
        if d is None:
            d = torch.zeros(t.shape, dtype=F32, device=t.device)
        acc = torch.zeros(t.shape, dtype=F32, device=t.device)
        if t.numel():
            for x in workers.all_gather(d):
                acc += x.to(t.device)
        out.append(acc)
    return tree_unflatten(treedef, out)


def _server_update(optimizer: Optimizer, server_agg, handed: list,
                   opt_state, params, lr):
    """The server recursion ``agg^k = agg^{k-1} + sum_m delta_m`` and the
    update; returns ``(new_params, new_opt_state, ||agg||^2)``.

    The optimizer and ``||agg||^2`` read a float32 ``agg``.  Float32 state
    is updated in place and is that ``agg``.  Under ``state_bf16`` (the
    reference's ``agg = server_agg.astype(f32) + agg_delta``, ``agg_store =
    agg.astype(bf16)``) the float32 ``agg`` is formed leaf by leaf in the
    buffers of ``sum_m delta_m``, and only the stored copy is rounded, into
    ``server_agg``'s: rounding before the update would be another
    algorithm.  ``handed`` holds ``sum_m delta_m``, the only reference to
    it, which is consumed."""
    s_leaves, treedef = tree_flatten(server_agg)
    agg = []
    for s, d in zip(s_leaves, tree_leaves(handed.pop())):
        if s.dtype == F32:
            agg.append(s.add_(d))
        else:
            agg.append(d.add_(s))   # f32(stored) + delta: IEEE add commutes
            s.copy_(d)              # the stored copy, rounded to nearest even
    agg = tree_unflatten(treedef, agg)
    new_params, new_opt = optimizer.update(agg, opt_state, params, lr)
    return new_params, new_opt, tree_sq_norm(agg)


def _check_step_supported(strategy: StrategyConfig, wire: str, worker_axes,
                          hierarchical: bool, model_parallel: int):
    if wire not in ("float", "packed"):
        raise ValueError(f"wire must be 'float' or 'packed', got {wire!r}")
    check_supported(strategy)
    # the reference's refusals (repro/launch/train.py), with its reasons
    if strategy.participation not in ("full", "bernoulli", "fixed_k"):
        raise ValueError(
            "delay/markov participation is simulated-engine-only: 'delay' "
            "would need a replicated params-history ring of max_delay+1 "
            "full parameter copies, and 'markov' carries a stateful "
            "per-worker on/off chain")
    if strategy.max_delay != 0:
        raise ValueError("max_delay needs participation='delay'")
    if strategy.faults.active:
        raise ValueError(
            "fault injection is simulated-engine-only: the corruption / "
            "crash stages live in RoundEngine.round, not the sharded step -- "
            "the launch path is the defended deployment target")
    if strategy.aggregator != "sum":
        raise ValueError(
            "trimmed_mean/median aggregation is simulated-engine-only: the "
            "coordinate-wise sort needs every worker's dequantized delta in "
            "one place; the sharded defenses are validation + norm-gate + "
            "clip, which are per-worker-local")
    if wire == "packed" and strategy.defense.clip_mult != 0.0:
        raise ValueError(
            "norm-clipping on the packed wire would need a per-worker f32 "
            "scale sidecar (codes are integers); clip rides the float wire, "
            "validate/gate work on both (a reject is one mask bit)")
    if wire == "packed" and (strategy.compressed or strategy.error_feedback):
        raise ValueError(
            "compressor / error_feedback strategies require wire='float': "
            "the packed wire re-quantizes the raw gradients itself (dense "
            "per-leaf codes), and the sparse pipeline's index+code payload "
            "has no byte layout in the exchange; the compressor path rides "
            "the float wire with analytic bit accounting")
    if hierarchical or tuple(worker_axes) != ("data",):
        _not_ported(f"worker axes {tuple(worker_axes)} (hierarchical="
                    f"{hierarchical})", "Pods and hierarchical workers")
    if model_parallel != 1:
        _not_ported(f"a model axis of {model_parallel}", "Tensor parallelism")
    if wire == "packed":
        if not strategy.quantized:
            raise ValueError("the packed wire requires a quantized strategy")
        widths = (strategy.bit_schedule.grid if strategy.adaptive
                  else (strategy.effective_bits,))
        if not all(b in (2, 4, 8) for b in widths):
            raise ValueError(f"the packed wire covers the widths (2, 4, 8), "
                             f"got {tuple(widths)}")


def make_train_step(cfg: ModelConfig, workers: WorkerGroup,
                    strategy: StrategyConfig, optimizer: Optimizer, *,
                    lr: float, worker_axes=("data",), wire: str = "float",
                    hierarchical: bool = False, model_parallel: int = 1,
                    microbatch: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)`` for this worker;
    every worker of the group calls it once per step with its own rows of
    the global batch (:func:`repro_torch.launch.mesh.worker_batch`).

    ``microbatch > 1`` splits the worker's rows into that many sequential
    microbatches with a float32 running mean of the gradients (the LAQ
    state machine still sees the full-batch gradient).  ``worker_axes``
    other than ``("data",)``, ``hierarchical`` and ``model_parallel > 1``
    are the reference's pod and tensor-parallel meshes, not ported.
    """
    _check_step_supported(strategy, wire, worker_axes, hierarchical,
                          model_parallel)
    W = n_workers_of(workers)

    def loss_fn(p, b):
        return lm_loss(p, b, cfg) / W          # sum_m loss_m == global mean

    def loss_and_grads(params, batch):
        """Loss and float32 gradients at an iterate: the current params,
        the WK2 stale iterate or the SVRG anchor (float32 trees, whose
        weights ``layers.linear`` casts to the activations' dtype), each
        through the same microbatch fold.  The wire kernels take float32;
        the reference's wire casts each leaf itself."""
        if microbatch == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            return loss, tree_map(lambda g: g.to(F32), grads)
        mb = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                           + tuple(v.shape[1:])) for k, v in batch.items()}
        return accumulate_loss_grads(loss_fn, params, mb)

    def step(state: TrainState, batch):
        params, comm = state.params, state.comm
        qhat = comm.qhat[0]
        dev = tree_leaves(params)[0].device
        loss, grads = loss_and_grads(params, batch)
        lr_k = eta_at(strategy.eta_schedule, lr, comm.step)

        def grad_at(theta):
            return loss_and_grads(theta, batch)[1]

        corr = None
        if strategy.variance_reduced:
            # the streaming anchor, refreshed in its own buffers; its
            # backprop runs every step through the same microbatch fold
            grads, corr, sv = apply_svrg_streaming(
                SvrgState(comm.svrg.theta_anchor[0], comm.svrg.mu_anchor[0]),
                params, grads, grad_at, comm.step, strategy)
            comm.svrg.theta_anchor[0], comm.svrg.mu_anchor[0] = sv
            del sv
        lazy_m = worker_slice(comm.lazy, 0)
        # the WK2 stale side, the same batch at the iterate of the last
        # upload with the SVRG correction, so that anchor and mu cancel
        stale = [stale_side_grads(grad_at, lazy_m.theta_last, corr, 1.0)
                 if strategy.lazy and strategy.lazy_rule == "lasg_wk2"
                 else None]
        del corr
        # this worker's slot of the round's cohort and of the rand-k keys:
        # every worker draws the same [W] mask and keys from the step
        mask = participation_mask(strategy, comm.step, W)
        ckey = (compressor_keys(strategy.compressor_seed, comm.step, W,
                                device=dev)[workers.rank]
                if strategy.compressor == "randk" else None)
        error = comm.error.residual
        # handed over, not held here: worker_update drops the stale side,
        # and on the float wire the gradient, once its rule has read them
        handed = [grads]
        if wire == "float":
            del grads
        wu = worker_update(handed.pop(), qhat, comm.eps_hat_sq[0],
                           comm.clocks[0], comm.theta_hist, lr_k, W, strategy,
                           bits_spent_m=comm.bits_spent[0], step=comm.step,
                           R_anchor_m=comm.R_anchor[0],
                           error_m=None if error is None else error[0],
                           lazy_m=lazy_m, params=params,
                           grad_stale_m=stale.pop(), ckey_m=ckey,
                           avail_m=None if mask is None
                           else bool(mask[workers.rank]),
                           defense_m=(defense_slice(comm.defense, 0)
                                      if strategy.defense.active else None))
        del lazy_m
        # the new LASG slice and EF residual into the state, in place, as
        # the engine's aggregate stores them: a replaced theta_last or
        # residual is freed here, not after the wire and the update
        store_slice(comm.lazy, 0, wu.lazy_new)
        if wu.error_new is not None:
            comm.error.residual[0] = wu.error_new
        delta_masked = wu.delta_masked
        wu = wu._replace(delta_masked=None, lazy_new=None, error_new=None)
        if wire == "float":
            agg_delta = _float_aggregate(delta_masked, params, workers)
            del delta_masked
        else:
            # a rejected upload is masked off the wire exactly like a skip
            # (its bits_m still pay: the payload was sent)
            del delta_masked
            agg_delta, _ = _packed_aggregate(
                grads, qhat, not wu.committed, strategy, workers,
                width=(torch.tensor(wu.width_m, dtype=F32)
                       if strategy.adaptive else None),
                with_q_new=False)
            del grads

        handed = [agg_delta]
        del agg_delta
        new_params, new_opt, grad_sq = _server_update(
            optimizer, comm.server_agg, handed, state.opt_state, params, lr_k)
        dtheta_sq = tree_sq_norm_diff(new_params, params).cpu()
        del params

        mine = torch.stack([loss.to(F32).reshape(()).to(dev),
                            torch.tensor(float(wu.uploaded), device=dev),
                            wu.bits_m.to(dev)])
        every = [x.to("cpu") for x in workers.all_gather(mine)]
        loss_sum = _sum_in_order(x[0] for x in every)
        bits_sum = _sum_in_order(x[2] for x in every)
        uploads = sum(int(x[1]) for x in every)
        new_comm = comm._replace(
            qhat=[wu.qhat_new],
            eps_hat_sq=wu.eps_hat_sq_new.reshape(1).to(F32),
            clocks=torch.tensor([wu.clock_new], dtype=torch.int32),
            bits_spent=comm.bits_spent + wu.bits_m,
            theta_hist=push_history(comm.theta_hist, dtheta_sq),
            total_bits=comm.total_bits + bits_sum,
            total_uploads=comm.total_uploads + uploads,
            step=comm.step + 1,
            R_anchor=wu.R_anchor_new.reshape(1).to(F32),
            defense=DefenseState(*(None if x is None else x.reshape(1)
                                   for x in wu.defense_new)))
        metrics = StepMetrics(loss=loss_sum, uploads=uploads, bits=bits_sum,
                              grad_sq=grad_sq.cpu())
        return TrainState(new_params, new_opt, new_comm,
                          state.step + 1), metrics

    return step


def init_train_state(params, workers: WorkerGroup, strategy: StrategyConfig,
                     optimizer: Optimizer) -> TrainState:
    """This worker's initial state around the parameters the caller gives
    (the same on every worker; :mod:`repro_torch.convert` carries the
    reference's over).  ``qhat`` and ``server_agg`` are zeros on the
    parameters' device, float32, or bfloat16 under ``state_bf16`` (the
    reference's ``init_comm_state``); ``theta_last`` (``lasg_wk2``,
    ``lasg_ps``) references the float32 parameters, and the SVRG anchor is
    a float32 copy of them, since the step refreshes it in place."""
    comm = init_comm_state(params, 1, strategy)
    if strategy.variance_reduced:
        comm = comm._replace(svrg=SvrgState(
            [tree_map(lambda l: l.to(F32, copy=True), params)], [None]))
    return TrainState(params, optimizer.init(params), comm, 0)
