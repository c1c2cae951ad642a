"""Per-round stepsize schedule, the part of ``repro/core/adaptive.py`` that
``RoundEngine.round`` calls on every kind.  The adaptive bit-width
controllers (``BitSchedule`` / ``select_bits``) are not ported yet
(ROADMAP queue 1, "Adaptive width")."""
from __future__ import annotations

from typing import NamedTuple

import torch


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
