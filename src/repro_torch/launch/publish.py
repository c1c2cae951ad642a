"""The trainer-to-fleet loop, port of ``repro/launch/publish.py``: a
``RoundEngine`` trainer feeding a fleet of replicas through
:mod:`repro_torch.core.replica`.

The fleet models pull-side delay as the engine's ``delay`` participation
does (``d_r = r mod (max_delay + 1)``): replica ``r`` applies at round
``k`` the message the publisher cut at round ``k - d_r``, from a ring of
the last ``max_delay + 1`` messages; a message that has not arrived ages
the replica like a lazy skip.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

from ..core.replica import (PublishConfig, PublisherState, apply_message,
                            init_replica, publish, staleness_drift)


class ReplicaFleet:
    """``n_replicas`` bounded-staleness subscribers of one publisher, each
    with its own copy of the weights (``max_delay=0``: every replica
    applies each message the round it is cut)."""

    def __init__(self, params0, n_replicas: int, cfg: PublishConfig, *,
                 max_delay: int = 0):
        assert n_replicas >= 1 and max_delay >= 0
        self.cfg = cfg
        self.delays = [r % (max_delay + 1) for r in range(n_replicas)]
        self.replicas = [init_replica(params0) for _ in range(n_replicas)]
        # index -1-d of the ring is the message of d rounds ago
        self._ring = deque([None] * (max_delay + 1), maxlen=max_delay + 1)

    def deliver(self, msg) -> None:
        """One fleet round: enqueue the fresh ``msg`` (may be None) and let
        every replica apply the message its delay entitles it to."""
        self._ring.append(msg)
        ring = list(self._ring)
        for r, d in enumerate(self.delays):
            arrived = ring[-1 - d] if d < len(ring) else None
            self.replicas[r] = apply_message(self.replicas[r], arrived,
                                             self.cfg)

    def freshness(self):
        """Per-replica ``rounds_behind`` (transport delay + laziness)."""
        return [st.rounds_behind for st in self.replicas]

    def max_drift(self, params) -> float:
        return max(staleness_drift(params, st) for st in self.replicas)


def trainer_rounds(engine, params0, steps: int, *, device="cuda") -> Iterable:
    """Yield the trainer's parameters after each of ``steps`` rounds of
    ``engine`` (the port's rounds run eagerly; each yields new tensors)."""
    carry = engine.init_carry(params0, device=device)
    for _ in range(steps):
        carry, _ = engine.round(carry)
        yield carry[0]


def publish_trajectory(params_iter: Iterable, cfg: PublishConfig,
                       state: PublisherState, *,
                       fleet: Optional[ReplicaFleet] = None):
    """Run the publisher over a parameter trajectory.  Returns
    ``(final_state, rows)``, one dict per round: what was sent (``kind``
    push / resync / skip), the cumulative bits and counts, and with a
    ``fleet`` its freshness and worst drift against the trainer."""
    rows = []
    for params in params_iter:
        msg, state = publish(cfg, state, params)
        kind = ("skip" if msg is None
                else "push" if hasattr(msg, "payloads") else "resync")
        row = {"round": state.seq, "kind": kind,
               "bits_sent": state.bits_sent, "n_pushes": state.n_pushes,
               "n_resyncs": state.n_resyncs,
               "pub_rounds_behind": state.rounds_behind}
        if fleet is not None:
            fleet.deliver(msg)
            row["fleet_max_behind"] = max(fleet.freshness())
            row["fleet_max_drift"] = fleet.max_drift(params)
        rows.append(row)
    return state, rows
