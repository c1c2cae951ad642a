"""Simulated M-worker cluster, port of ``repro/core/simulated.py``
(deterministic runner only; ``run_stochastic`` waits for RNG parity)."""
from __future__ import annotations

from typing import Callable

from ..device import resolve_device
from ..tree import tree_map
from .engine import FullBatchSource, RoundEngine, RunResult
from .strategy import StrategyConfig

__all__ = ["RunResult", "run_gradient_based"]


def run_gradient_based(loss_fn: Callable, params0, worker_data,
                       cfg: StrategyConfig, *, steps: int, alpha: float,
                       device="cuda") -> RunResult:
    """Deterministic full-gradient methods: GD / QGD / LAG / LAQ.

    ``loss_fn(params, data_shard) -> scalar`` is one worker's local loss
    f_m; ``worker_data`` has a leading worker axis W.  Global objective is
    ``sum_m f_m`` (paper eq. 1).  Params and data are moved to ``device``.
    """
    dev = resolve_device(device)
    source = FullBatchSource(loss_fn, tree_map(lambda x: x.to(dev),
                                               worker_data))
    return RoundEngine(source, cfg, alpha=alpha).run(params0, steps,
                                                     device=dev)
