"""Lazy-aggregation skip criterion (paper eq. 7a / 7b), port of
``repro/core/criterion.py``.

Worker m skips its upload at iteration k iff

    ||Q_m(theta_hat^{k-1}) - Q_m(theta^k)||^2
        <= 1/(alpha^2 M^2) * sum_d xi_d ||theta^{k+1-d} - theta^{k-d}||^2
           + 3 (||eps_m^k||^2 + ||eps_hat_m^{k-1}||^2)                 (7a)
    and  t_m <= t_bar                                                  (7b)

The port evaluates it on the host, on float32 CPU tensors: the decision
gates which buffers the round commits, so it is needed there anyway.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CriterionConfig(NamedTuple):
    D: int = 10                 # history depth
    xi: float = 0.8 / 10        # xi_d (constant across d, paper Sec. 4)
    t_bar: int = 100            # staleness bound
    include_quant_error: bool = True  # the 3(eps^2 + eps_hat^2) slack term


def history_threshold(theta_diff_hist: torch.Tensor, alpha, M: int,
                      cfg: CriterionConfig):
    """``1/(alpha^2 M^2) * sum_d xi_d ||theta^{k+1-d} - theta^{k-d}||^2``
    with ``theta_diff_hist[d-1] = ||theta^{k+1-d} - theta^{k-d}||^2``."""
    xi = torch.full((cfg.D,), cfg.xi, dtype=torch.float32,
                    device=theta_diff_hist.device)
    return torch.dot(xi, theta_diff_hist) / (alpha**2 * M**2)


def rhs_threshold(theta_diff_hist: torch.Tensor, alpha, M: int,
                  eps_sq, eps_hat_sq, cfg: CriterionConfig):
    """Right-hand side of (7a): history term + quantization-error slack."""
    hist_term = history_threshold(theta_diff_hist, alpha, M, cfg)
    err_term = 3.0 * (eps_sq + eps_hat_sq) if cfg.include_quant_error else 0.0
    return hist_term + err_term


def should_skip(innovation_sq, theta_diff_hist, alpha, M: int,
                eps_sq, eps_hat_sq, clock, cfg: CriterionConfig):
    """Boolean skip decision for one worker."""
    ok_7a = innovation_sq <= rhs_threshold(theta_diff_hist, alpha, M,
                                           eps_sq, eps_hat_sq, cfg)
    ok_7b = clock < cfg.t_bar
    return torch.logical_and(torch.as_tensor(ok_7a), torch.as_tensor(ok_7b))


def push_history(theta_diff_hist: torch.Tensor, new_sq) -> torch.Tensor:
    """Ring-push the newest ||theta^{k+1} - theta^k||^2 (index 0 = most
    recent)."""
    new = torch.as_tensor(new_sq).reshape(1).to(theta_diff_hist)
    return torch.cat([new, theta_diff_hist[:-1]])
