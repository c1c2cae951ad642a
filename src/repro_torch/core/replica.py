"""Lazy-replica publishing, port of ``repro/core/replica.py``: the LAQ wire
pushing quantized parameter deltas from a trainer to a fleet of inference
replicas (protocol: ``docs/serving.md``; bytes: ``docs/wire-format.md``).

The publisher tracks ``theta_pub``, the fleet's dequantize-accumulated view
of the parameters.  Each round it reduces the innovation radius ``R =
max_leaf ||theta - theta_pub||_inf`` (pass 1 of the wire backend: kernel 1
on the fused wire) and, by the lazy rule, either skips, pushes the b-bit
codes of ``theta - theta_pub`` (pass 2: kernel 2, from pass 1's radii), or,
after ``max_staleness`` skipped rounds, sends a full-precision resync.
``R == 0`` skips without ever resyncing.  The push test ``R > threshold *
A`` against the decaying peak envelope ``A`` is made in Python doubles, as
in the reference.  With ``bit_schedule`` set, ``select_bits`` picks the
width of each push from the same anchor.

Bitwise contract, as in the reference: a replica that applies every
message equals ``theta_pub`` bit for bit, and a resync makes it equal to
the trainer's parameters.  The reference runs the publisher and the
replica eagerly, outside ``jit``, so the port rounds as eager JAX does:
``theta_pub`` and the replica add ``wire.delta_of_codes_eager`` of the
codes unpacked from the payload (the product and the difference each
rounded, not kernel 2's one FMA), and ``select_bits`` runs with
``eager=True``.  A message cut by either package applies in the other
(``tests/test_torch_replica.py``).

In place, unlike the reference: ``publish`` adds each push into
``state.theta_pub`` and ``apply_message`` into ``replica.params``.  So
nothing aliases: ``init_publisher``, ``init_replica``, a resync's
``theta_pub`` and ``ResyncMsg.params`` are clones, and no replica shares
storage with the trainer, the publisher or another replica.  A caller that
keeps an old view clones it.

Everything runs per leaf (one leaf's payload and transients at a time),
where the parameters are; messages may come from another device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_map
from .adaptive import BitSchedule, select_bits
from .quantize import dense_bits, tree_size, unpack_codes, upload_bits
from .wire import delta_of_codes_eager, get_backend

F32 = torch.float32


class PublishConfig(NamedTuple):
    """Publisher-side knobs (see the module docstring)."""
    bits: int = 4                   # quantized-push width (fixed mode)
    threshold: float = 0.25         # push iff R > threshold * anchor; 0 = always
    anchor_decay: float = 0.9       # peak-envelope decay per round (fixed mode)
    max_staleness: int = 8          # skipped rounds tolerated before a resync
    wire_backend: object = "reference"   # name or WireBackend instance
    bit_schedule: Optional[BitSchedule] = None  # rel-mode schedule: adaptive width

    def validate(self) -> "PublishConfig":
        assert self.bits in (1, 2, 4, 8), self.bits
        assert self.threshold >= 0.0, self.threshold
        assert 0.0 < self.anchor_decay <= 1.0, self.anchor_decay
        assert self.max_staleness >= 0, self.max_staleness
        if self.bit_schedule is not None:
            self.bit_schedule.validate()
            assert self.bit_schedule.adaptive, \
                "constant schedules belong in PublishConfig.bits"
            assert self.bit_schedule.threshold_mode == "rel", \
                "the publisher anchor is the rel-mode anchor; abs-threshold " \
                "schedules have no shared anchor to reuse"
        return self


class PublisherState(NamedTuple):
    """Trainer-side publishing state."""
    theta_pub: object           # the fleet's view (f32, updated in place)
    R_anchor: torch.Tensor      # decaying peak envelope A^k (f32 0-d, CPU)
    rounds_behind: int = 0      # consecutive rounds since the last message
    seq: int = 0                # publisher round counter
    n_pushes: int = 0           # quantized delta pushes sent
    n_resyncs: int = 0          # full-precision resyncs sent
    bits_sent: float = 0.0      # cumulative wire bits (analytic accounting)


class DeltaMsg(NamedTuple):
    """One quantized parameter-delta push (per-leaf packed payload)."""
    seq: int                    # publisher round this delta was cut at
    width: int                  # quantization bits b (the width sidecar)
    bits: float                 # analytic wire cost of this message
    payloads: list              # per-leaf packed uint8 codes (wire spec §3)
    radii: list                 # per-leaf f32 0-d radii (wire spec §1)


class ResyncMsg(NamedTuple):
    """Full-precision resync: a float32 copy of the parameters."""
    seq: int
    bits: float
    params: object


class ReplicaState(NamedTuple):
    """One inference replica's serving weights and freshness bookkeeping."""
    params: object              # serving weights (f32, updated in place)
    rounds_behind: int = 0      # rounds since the last applied message
    seq: int = -1               # seq of the last applied message
    n_applied: int = 0
    n_resyncs: int = 0


def _f32_copy(tree):
    """A float32 copy that shares no storage with ``tree``."""
    return tree_map(lambda l: l.to(F32, copy=True), tree)


def init_publisher(params, cfg: PublishConfig) -> PublisherState:
    """Publisher with the fleet bootstrapped at a copy of ``params``; the
    initial sync is accounted at ``dense_bits(p)``."""
    cfg.validate()
    return PublisherState(theta_pub=_f32_copy(params),
                          R_anchor=torch.zeros((), dtype=F32),
                          bits_sent=float(dense_bits(tree_size(params))))


def init_replica(snapshot) -> ReplicaState:
    """Replica joining the fleet from a copy of a full-precision
    ``snapshot``."""
    return ReplicaState(params=_f32_copy(snapshot))


def _push(backend, g_leaves, q_leaves, radii, width: int):
    """Pass 2, leaf by leaf: the payload of ``g - q`` at ``width`` from
    pass 1's radius, then ``q += delta_of_codes_eager`` of its codes."""
    payloads = []
    for g, q, R in zip(g_leaves, q_leaves, radii):
        if not g.numel():
            payloads.append(torch.zeros((0,), dtype=torch.uint8,
                                        device=g.device))
            continue
        rt = backend.roundtrip(g.to(F32), q, width, per_leaf=True,
                               with_payload=True, R_tree=R)
        payload = rt.payload[0]
        del rt
        codes = unpack_codes(payload, width)[:g.numel()]
        q.add_(delta_of_codes_eager(codes, R, width).reshape(q.shape))
        payloads.append(payload)
    return payloads


def publish(cfg: PublishConfig, state: PublisherState, params):
    """One publisher round against the trainer's ``params``.

    Returns ``(msg, new_state)``, ``msg`` being ``None`` (lazy skip), a
    :class:`DeltaMsg` or a :class:`ResyncMsg`.  Decision order:

    1. ``R == 0``: skip, and never resync.
    2. ``threshold == 0`` or ``R > threshold * A``: quantized push.
    3. ``rounds_behind + 1 > max_staleness``: full resync.
    4. otherwise skip (``rounds_behind`` grows).
    """
    cfg.validate()
    backend = get_backend(cfg.wire_backend)
    g_leaves = tree_leaves(params)
    q_leaves = tree_leaves(state.theta_pub)
    # pass 1, one leaf at a time: the backend's own radius reduction
    radii = [backend.innovation(g.to(F32), q, per_leaf=True)[2] if g.numel()
             else torch.zeros((), dtype=F32, device=g.device)
             for g, q in zip(g_leaves, q_leaves)]
    R_max = (torch.stack(radii).amax().cpu() if radii
             else torch.zeros((), dtype=F32))
    p = tree_size(params)
    n_leaves = len(g_leaves)

    if cfg.bit_schedule is not None:
        # the reference calls select_bits outside jit: eager roundings
        b_sel, _, anchor_new = select_bits(
            cfg.bit_schedule, R_max, state.bits_sent, state.seq, p,
            n_radii=n_leaves, R_anchor=state.R_anchor, eager=True)
        width = int(b_sel)
    else:
        width = cfg.bits
        anchor_new = torch.maximum(
            R_max, torch.tensor(cfg.anchor_decay, dtype=F32) * state.R_anchor)

    Rm, A = float(R_max), float(anchor_new)
    base = state._replace(R_anchor=anchor_new, seq=state.seq + 1)

    if Rm == 0.0:
        return None, base._replace(rounds_behind=state.rounds_behind + 1)

    if cfg.threshold == 0.0 or Rm > cfg.threshold * A:
        payloads = _push(backend, g_leaves, q_leaves, radii, width)
        bits = float(upload_bits(p, width, n_radii=n_leaves,
                                 bit_sidecar=cfg.bit_schedule is not None))
        msg = DeltaMsg(seq=state.seq, width=width, bits=bits,
                       payloads=payloads, radii=radii)
        return msg, base._replace(rounds_behind=0,
                                  n_pushes=state.n_pushes + 1,
                                  bits_sent=state.bits_sent + bits)

    if state.rounds_behind + 1 > cfg.max_staleness:
        bits = float(dense_bits(p))
        msg = ResyncMsg(seq=state.seq, bits=bits, params=_f32_copy(params))
        return msg, base._replace(
            theta_pub=_f32_copy(params), rounds_behind=0,
            n_resyncs=state.n_resyncs + 1, bits_sent=state.bits_sent + bits)

    return None, base._replace(rounds_behind=state.rounds_behind + 1)


def apply_message(state: ReplicaState, msg, cfg: PublishConfig = None
                  ) -> ReplicaState:
    """Replica side: add a :class:`DeltaMsg` into the serving weights, leaf
    by leaf and in place (bitwise the publisher's ``theta_pub``), install a
    copy of a :class:`ResyncMsg`'s parameters, or age one round on
    ``None``.  ``cfg`` is unused, as in the reference."""
    if msg is None:
        return state._replace(rounds_behind=state.rounds_behind + 1)
    if isinstance(msg, ResyncMsg):
        return ReplicaState(params=_f32_copy(msg.params), rounds_behind=0,
                            seq=msg.seq, n_applied=state.n_applied + 1,
                            n_resyncs=state.n_resyncs + 1)
    for leaf, payload, R in zip(tree_leaves(state.params), msg.payloads,
                                msg.radii):
        if not leaf.numel():
            continue
        # payloads may be pad-extended (cpb / 4096-element blocks); the
        # codes are in order, so the first numel are the leaf's
        codes = unpack_codes(payload.to(leaf.device), msg.width)[:leaf.numel()]
        R = torch.as_tensor(R, dtype=F32).to(leaf.device)
        leaf.add_(delta_of_codes_eager(codes, R, msg.width).reshape(leaf.shape))
    return state._replace(rounds_behind=0, seq=msg.seq,
                          n_applied=state.n_applied + 1)


def staleness_drift(params, replica: ReplicaState) -> float:
    """Serving-freshness diagnostic ``||theta - replica||_inf``."""
    return max((float((g.to(F32) - r).abs().amax()) if g.numel() else 0.0
                for g, r in zip(tree_leaves(params),
                                tree_leaves(replica.params))), default=0.0)
