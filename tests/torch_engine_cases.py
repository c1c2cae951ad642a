"""Shared problems of the port's engine-level tests against the JAX package
(``test_torch_participation.py``, ``test_torch_faults.py``,
``test_torch_checkpoint.py``): the quadratic of ``test_engine_parity.py``
(M=10 workers, p=20) and its linear regression (M=6 workers of 12
examples, p=8), drawn with numpy from a seed, and runners that put the
same configuration through both engines.

Configurations are written once, as keyword dicts (nested configs as
dicts too) and built into each package's own classes."""
from __future__ import annotations

import numpy as np
import torch

M, P = 10, 20
RM, R_LOCAL, RP = 6, 12, 8
CRIT = dict(D=10, xi=0.08, t_bar=20)
NESTED = ("criterion", "faults", "defense", "lasg", "bit_schedule",
          "eta_schedule")


def quadratic_data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((M, P)).astype(np.float32)
    scales = (0.5 + rng.uniform(size=(M, P))).astype(np.float32)
    return centers, scales


def regression_data(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((RM, R_LOCAL, RP)).astype(np.float32)
    Y = (X @ np.linspace(-1.0, 1.0, RP, dtype=np.float32)
         + 0.3 * rng.standard_normal((RM, R_LOCAL))).astype(np.float32)
    return X, Y


def t_quadratic(params, data):
    c, a = data
    return 0.5 * torch.sum(a * torch.square(params["x"] - c)) / M


def j_quadratic(params, data):
    import jax.numpy as jnp
    c, a = data
    return 0.5 * jnp.sum(a * jnp.square(params["x"] - c)) / M


def t_regression(params, data):
    x, y = data
    return 0.5 * torch.sum(torch.square(x @ params["w"] - y)) / (RM * R_LOCAL)


def j_regression(params, data):
    import jax.numpy as jnp
    x, y = data
    return 0.5 * jnp.sum(jnp.square(x @ params["w"] - y)) / (RM * R_LOCAL)


def _classes(port: bool):
    if port:
        from repro_torch.core import adaptive, criterion, defense, faults
        from repro_torch.core import lazy_rules, strategy
    else:
        from repro.core import adaptive, criterion, defense, faults
        from repro.core import lazy_rules, strategy
    return {"StrategyConfig": strategy.StrategyConfig,
            "criterion": criterion.CriterionConfig,
            "faults": faults.FaultConfig, "defense": defense.DefenseConfig,
            "lasg": lazy_rules.LasgConfig,
            "bit_schedule": adaptive.BitSchedule,
            "eta_schedule": adaptive.EtaSchedule}


def strategy(port: bool, **kw):
    """The StrategyConfig of ``kw`` in the port (``port=True``) or the
    reference; nested configs given as dicts."""
    cls = _classes(port)
    kw = dict(kw)
    kw.setdefault("criterion", CRIT)
    for k in NESTED:
        if k in kw and isinstance(kw[k], dict):
            kw[k] = cls[k](**kw[k])
    return cls["StrategyConfig"](**kw)


def quadratic_engines(kw, alpha=0.3, **engine_kw):
    """``(jax_engine, port_engine, jax_params0, port_params0)`` of the
    quadratic under ``kw`` (port on the CPU)."""
    from repro.core.engine import FullBatchSource as JSource
    from repro.core.engine import RoundEngine as JEngine
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    c, a = quadratic_data()
    je = JEngine(JSource(j_quadratic, (c, a)), strategy(False, **kw),
                 alpha=alpha, **engine_kw)
    te = RoundEngine(FullBatchSource(t_quadratic, (torch.from_numpy(c),
                                                   torch.from_numpy(a))),
                     strategy(True, **kw), alpha=alpha, **engine_kw)
    return je, te, {"x": np.zeros(P, np.float32)}, {"x": torch.zeros(P)}


def regression_engines(kw, alpha=0.3, batch=4, seed=2, **engine_kw):
    """The same for the linear regression with minibatch sources."""
    from repro.core.engine import MinibatchSource as JSource
    from repro.core.engine import RoundEngine as JEngine
    from repro_torch.core.engine import MinibatchSource, RoundEngine
    X, Y = regression_data()
    je = JEngine(JSource(j_regression, (X, Y), batch=batch, seed=seed),
                 strategy(False, **kw), alpha=alpha, **engine_kw)
    te = RoundEngine(MinibatchSource(t_regression,
                                     (torch.from_numpy(X),
                                      torch.from_numpy(Y)),
                                     batch=batch, seed=seed),
                     strategy(True, **kw), alpha=alpha, **engine_kw)
    return je, te, {"w": np.zeros(RP, np.float32)}, {"w": torch.zeros(RP)}


def run_both(engines, steps):
    """Both engines from their initial carries for ``steps`` rounds:
    ``((jax_carry, jax_result), (port_carry, port_result))``."""
    je, te, jp, tp = engines
    return (je.run_from(je.init_carry(jp), steps),
            te.run_from(te.init_carry(tp, device="cpu"), steps))


EXACT = ("cum_uploads", "cum_bits", "mean_bits")
CLOSE = ("loss", "grad_norm_sq", "quant_err")


def assert_runs_match(want, got, rtol=1e-5, atol=1e-5, param_atol=None):
    """Counts exact, floats to the tolerance (the final parameters to
    ``param_atol`` if given); NaN where the reference has NaN."""
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in CLOSE:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   np.asarray(want.params[k]), rtol=rtol,
                                   atol=atol if param_atol is None
                                   else param_atol, err_msg=k)


def rejects(carry):
    """The per-worker reject ledger of a carry (either package), or None."""
    r = carry[1].defense.rejects
    return None if r is None else np.asarray(r)
