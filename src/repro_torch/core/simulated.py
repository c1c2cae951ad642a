"""Simulated M-worker cluster, port of ``repro/core/simulated.py``: thin
wrappers over :class:`repro_torch.core.engine.RoundEngine`."""
from __future__ import annotations

from typing import Callable, Optional

from ..device import resolve_device
from ..tree import tree_map
from .engine import FullBatchSource, MinibatchSource, RoundEngine, RunResult
from .strategy import StrategyConfig

__all__ = ["RunResult", "run_gradient_based", "run_stochastic"]

# kind -> forced lazy_rule for the stochastic LAQ family (None = as given)
_SLAQ_RULES = {"slaq": None, "slaq_wk": "lasg_wk", "slaq_wk2": "lasg_wk2",
               "slaq_ps": "lasg_ps"}


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


def run_stochastic(loss_fn: Callable, params0, worker_data, kind: str, *,
                   steps: int, alpha: float, batch: int, bits: int = 3,
                   density: float = 0.1, seed: int = 0,
                   laq_cfg: Optional[StrategyConfig] = None,
                   device="cuda") -> RunResult:
    """Minibatch methods of paper Table 3: SGD / QSGD / SSGD / SLAQ.

    Each worker samples ``batch`` local examples per round
    (:class:`MinibatchSource`, keyed by ``seed``).  The SLAQ family runs the
    LAQ state machine on the stochastic gradients: ``"slaq"`` with
    ``laq_cfg`` as given (default: kind laq at ``bits``, rule 7a),
    ``"slaq_wk"`` / ``"slaq_wk2"`` / ``"slaq_ps"`` with the rule forced to
    ``lasg_wk`` / ``lasg_wk2`` / ``lasg_ps``.  ``"sgd"``, ``"qsgd"`` (at
    ``bits``) and ``"ssgd"`` (at ``density``) are the dense baselines, which
    inherit ``grad_mode``, ``svrg_period``, ``eta_schedule`` and the
    participation fields from ``laq_cfg`` so that comparisons stay matched.
    Params and data are moved to ``device``.
    """
    if kind in _SLAQ_RULES:
        scfg = laq_cfg or StrategyConfig(kind="laq", bits=bits)
        if _SLAQ_RULES[kind] is not None:
            scfg = scfg._replace(lazy_rule=_SLAQ_RULES[kind])
        baseline = None
    elif kind in ("sgd", "qsgd", "ssgd"):
        src = laq_cfg or StrategyConfig()
        scfg = StrategyConfig(kind="gd", grad_mode=src.grad_mode,
                              svrg_period=src.svrg_period,
                              eta_schedule=src.eta_schedule,
                              participation=src.participation,
                              participation_p=src.participation_p,
                              max_delay=src.max_delay,
                              participation_seed=src.participation_seed)
        baseline = kind
    else:
        raise ValueError(f"unknown stochastic kind {kind!r}")
    dev = resolve_device(device)
    source = MinibatchSource(loss_fn, tree_map(lambda x: x.to(dev),
                                               worker_data),
                             batch=batch, seed=seed)
    engine = RoundEngine(source, scfg, alpha=alpha, baseline=baseline,
                         bits=bits, density=density)
    return engine.run(params0, steps, device=dev)
