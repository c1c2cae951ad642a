"""How far the minibatch gradient's float32 order alone moves the LASG
frontier's order-sensitive runs, and how far planted faults move them,
the port on a card against the reference's numbers (not a test):

    PYTHONPATH=src:. python tests/lasg_order_witness.py \\
        [--device cuda|cpu] [--orders N] [--steps S] [--procs P] [OUT.json]

The reference's numbers are ``chip_smoke.py``'s (``JAX_STOCH_FRONTIERS``,
``JAX_STOCH_FRONTIER_ROWS``, ``JAX_STOCH_PREFIX``); this script imports
no JAX.

1. SLAQ-WK, SLAQ-PS and SLAQ-VR of ``benchmarks_torch/lasg_frontier.py``
   with each worker's minibatch rows in the order ``row_order(k)`` for
   k = 0 (the drawn order) to N: the same minibatch, summed in another
   order.  For each run its first round whose uploads part from the
   reference's (within ``JAX_STOCH_PREFIX``), its final uploads, bits and
   loss and its rounds and bits to the target, each also relative to the
   reference's.
2. The same runs in the drawn order with one planted fault each
   (``FAULTS``), and with every gradient computed in float64 and rounded
   to float32 (``float64_gradient``), the report as in 1.
3. SLAQ-VR on ``--device`` and on the CPU in lockstep, and on the CPU
   with float64 gradients against the plain CPU: per round the relative
   gap of the loss, of the iterate and of the SVRG anchor's full
   gradient, and the number of b = 3 codes (entries of ``qhat``) that
   differ by more than a thousandth of the worker's largest entry.

4. With ``--replay STATES.npz`` (the reference's state before chosen
   rounds of SLAQ-WK and SLAQ-PS and the uploads it then made, written by
   ``tests/stochastic_frontiers_probe.py --orders-only``): the port's
   round on ``--device`` from each of those states, with its own
   gradients; which workers upload against the reference's, and the
   smallest margin ``lhs / rhs - 1`` of the round.

The runs go to ``--procs`` processes.  ``tests/stochastic_frontiers_probe.py``
runs the reference in the same row orders on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER_RUNS = ("slaq_wk", "slaq_ps", "slaq_vr")
# a planted fault of each run's rule: WK's variance estimate not debiased
# (sigma^2 = the raw EMA), WK's sigma_hat^2 never refreshed at an upload,
# PS's Lhat^2 not debiased, SLAQ-VR's anchor never refreshed after round 0
FAULTS = {"slaq_wk": ("wk_raw_variance", "wk_frozen_sigma_hat"),
          "slaq_ps": ("ps_raw_smoothness",),
          "slaq_vr": ("vr_stale_anchor",)}
FLIP_FRACTION = 1e-3
# the lazy rule of each LAQ-family run of the LASG frontier
RULES = {"slaq_7a": "laq7a", "slaq_wk": "lasg_wk", "slaq_wk2": "lasg_wk2",
         "slaq_ps": "lasg_ps", "slaq_vr": "laq7a"}
FLOAT64 = "float64_gradient"


def row_order(k: int, batch: int = 10) -> np.ndarray:
    """The k-th order of a minibatch's ``batch`` rows: 0 is the drawn
    order, k > 0 a permutation from ``numpy.random.default_rng(k)``."""
    if k == 0:
        return np.arange(batch)
    return np.random.default_rng(k).permutation(batch)


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def rows_in_order(perm):
    """The port's minibatch source with each worker's rows in ``perm``'s
    order."""
    import torch
    from repro_torch.core import engine
    from repro_torch.tree import tree_map
    sample = engine.MinibatchSource.sample

    def permuted(self, step):
        idx = torch.as_tensor(perm, device=self._device)
        return tree_map(lambda x: x[:, idx], sample(self, step))

    with patched(engine.MinibatchSource, "sample", permuted):
        yield


@contextlib.contextmanager
def fault(name):
    """The port with the planted fault ``name`` (``FAULTS``), or with
    every minibatch and full local gradient computed in float64 and
    rounded to float32 (``FLOAT64``)."""
    from repro_torch.core import engine, lazy_rules, strategy
    if name == FLOAT64:
        from repro_torch.tree import tree_map
        value_and_grad = engine.value_and_grad

        def in_float64(loss_fn, params, batch):
            if batch is None:       # the true gradient's norm, not decided on
                return value_and_grad(loss_fn, params, batch)
            loss, g = value_and_grad(
                loss_fn, tree_map(lambda p: p.double(), params),
                tree_map(lambda x: x.double() if x.is_floating_point()
                         else x, batch))
            return loss.float(), tree_map(lambda x: x.float(), g)
        with patched(engine, "value_and_grad", in_float64):
            yield
    elif name == "wk_raw_variance":
        update = lazy_rules.variance_update

        def raw(lazy_m, grad_m, cfg):
            _, out = update(lazy_m, grad_m, cfg)
            return out.stat_ema, out
        with patched(lazy_rules, "variance_update", raw):
            yield
    elif name == "wk_frozen_sigma_hat":
        commit = strategy.commit_upload

        def frozen(rule, lasg, lazy_pre, uploaded, stats, **kw):
            return commit(rule, lasg, lazy_pre,
                          uploaded and rule != "lasg_wk", stats, **kw)
        with patched(strategy, "commit_upload", frozen):
            yield
    elif name == "ps_raw_smoothness":
        import math

        def raw_l(lazy_m, cfg):
            if not float(lazy_m.stat_count) > 0:
                return lazy_rules._f32(math.inf)
            return lazy_m.stat_ema
        with patched(lazy_rules, "smoothness_sq", raw_l):
            yield
    elif name == "vr_stale_anchor":
        apply = engine.apply_svrg_exact

        def once(sv, params, grad_raw, grad_at_raw, full_local_grads, m,
                 refresh, scale):
            refresh = refresh and sv.mu_anchor[m] is None
            return apply(sv, params, grad_raw, grad_at_raw,
                         full_local_grads, m, refresh, scale)
        with patched(engine, "apply_svrg_exact", once):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}")


# the fields of the port's CommState (and, as "lazy.<name>", of its
# LazyState) that the LASG rules carry from round to round
STATE_FIELDS = ("qhat", "server_agg", "eps_hat_sq", "clocks", "bits_spent",
                "theta_hist", "total_bits", "total_uploads", "step",
                "R_anchor", "lazy.grad_ema", "lazy.stat_ema",
                "lazy.stat_count", "lazy.sigma_hat_sq", "lazy.theta_last")
PER_WORKER = ("qhat", "lazy.grad_ema", "lazy.theta_last")


def port_state(cst, arrays):
    """The port's ``CommState`` ``cst`` with each field of
    ``STATE_FIELDS`` found in ``arrays`` (numpy, by name; the per-worker
    pytrees ``[W, ...]``) put in its place, on the device and in the dtype
    of the field it replaces."""
    import torch
    fields, lazy = {}, {}
    for name in STATE_FIELDS:
        if name not in arrays:
            continue
        a = np.asarray(arrays[name])
        owner, key = ((cst.lazy, name[5:]) if name.startswith("lazy.")
                      else (cst, name))
        like = getattr(owner, key)
        if name in PER_WORKER:
            dev = (like[0]["w"] if like is not None else cst.qhat[0]["w"])
            value = [{"w": torch.from_numpy(w.copy()).to(dev.device)}
                     for w in a]
        elif isinstance(like, dict):
            value = {"w": torch.from_numpy(a.copy()).to(like["w"].device,
                                                        like["w"].dtype)}
        elif isinstance(like, torch.Tensor):
            value = torch.from_numpy(a.copy()).to(like.device, like.dtype)
        else:
            value = type(like)(a)
        (lazy if owner is cst.lazy else fields)[key] = value
    return cst._replace(lazy=cst.lazy._replace(**lazy), **fields)


@contextlib.contextmanager
def margins_of_rule(margins):
    """Append ``lhs / rhs - 1`` of each evaluation of a lazy rule to
    ``margins``."""
    from repro_torch.core import lazy_rules
    decide = lazy_rules.should_skip_rule

    def spy(rule, lasg, crit, **kw):
        lhs = lazy_rules.rule_lhs(rule, lasg, **{
            f: kw.get(f) for f in ("innovation_sq", "sigma_sq",
                                   "sigma_hat_sq", "drift_sq", "L_sq",
                                   "same_diff_sq")})
        rhs = lazy_rules.rhs_threshold(kw["theta_hist"], kw["alpha"],
                                       kw["M"], kw["eps_sq"],
                                       kw["eps_hat_sq"], crit)
        margins.append(float(lhs) / float(rhs) - 1.0)
        return decide(rule, lasg, crit, **kw)

    with patched(lazy_rules, "should_skip_rule", spy):
        yield


def lasg_engine(run, device):
    """The port's engine of the LASG run ``run`` (a key of ``RULES``) as
    ``lasg_frontier.run_methods`` builds it, on ``device``."""
    from benchmarks_torch import common, lasg_frontier as TL
    from repro_torch.core import engine
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.tree import tree_map
    workers, full = common.make_dataset(device=device)
    cfg = StrategyConfig(kind="laq", bits=TL.BITS,
                         criterion=common.PAPER_CRITERION,
                         lazy_rule=RULES[run])
    if run == "slaq_vr":
        cfg = cfg._replace(grad_mode="svrg", svrg_period=TL.SVRG_PERIOD)
    src = engine.MinibatchSource(common.logreg_loss(full[0].shape[0]),
                                 tree_map(lambda x: x.to(device), workers),
                                 batch=TL.BATCH, seed=TL.SEED)
    return engine.RoundEngine(src, cfg, alpha=TL.ALPHA, bits=TL.BITS)


def replay_round(eng, arrays, device):
    """The port's round from the state ``arrays`` (``STATE_FIELDS`` and
    ``params``): ``(uploaded by worker, margins)``."""
    import torch
    from benchmarks_torch import common
    params, cst, pstate = eng.init_carry(common.logreg_init(device=device),
                                         device=device)
    cst = port_state(cst, arrays)
    params = {"w": torch.from_numpy(np.asarray(arrays["params"]).copy()).to(
        params["w"].device)}
    margins = []
    with margins_of_rule(margins):
        (_, new, _), _ = eng.round((params, cst, pstate))
    # a worker whose clock is 0 after the round uploaded in it
    return (new.clocks.cpu().numpy() == 0).tolist(), margins


def replay_states(job):
    """Job ``(path, device)``: the port's round from each state saved in
    ``path`` against the reference's uploads there."""
    _setup()
    path, device = job
    data = np.load(path)
    rounds = sorted({tuple(k.split("/")[:2]) for k in data.files},
                    key=lambda rk: (rk[0], int(rk[1])))
    engines, out = {}, []
    for run, k in rounds:
        eng = engines.setdefault(run, lasg_engine(run, device))
        arrays = {key.split("/", 2)[2]: data[key] for key in data.files
                  if key.startswith(f"{run}/{k}/")}
        uploaded, margins = replay_round(eng, arrays, device)
        want = arrays["uploaded"].tolist()
        out.append(dict(run=run, round=int(k), equal=uploaded == want,
                        uploaded=uploaded, reference=want,
                        least_margin=min(margins, key=abs)))
    return out


def _setup():
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)


def rel_gap(got, want):
    """``got / want - 1``; 0 when both are None (no crossing), inf when
    one is."""
    if want is None or got is None:
        return 0.0 if got == want else float("inf")
    return (got - want) / want


def one_run(job):
    """Job ``(run, order, fault, device, steps)``: the run's report."""
    _setup()
    import chip_smoke as cs
    from benchmarks_torch import common, lasg_frontier as TL
    run, order, planted, device, steps = job
    t0 = time.perf_counter()
    full = TL.STEPS
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(TL, "STEPS", steps))
        stack.enter_context(rows_in_order(row_order(order, TL.BATCH)))
        if planted:
            stack.enter_context(fault(planted))
        r = TL.run_methods([run], device=device)[run]
    key = f"lasg_frontier/{run}"
    ups = np.asarray(r.cum_uploads)
    want_ups = np.cumsum([int(c, 16)
                          for c in cs.JAX_STOCH_PREFIX.get(key, "")])
    n = min(len(ups), len(want_ups))
    part = np.nonzero(ups[:n] != want_ups[:n])[0]
    final = (int(ups[-1]), float(r.cum_bits[-1]), float(r.loss[-1]))
    out = dict(run=run, order=order, fault=planted, steps=steps,
               first_part=int(part[0]) + 1 if len(part) else None,
               prefix=n, final=final)
    if steps == full:
        want = cs.JAX_STOCH_FRONTIERS[key]
        target = cs.JAX_STOCH_FRONTIER_TARGETS["lasg_frontier"]
        at = common.first_reach(r, target["target_loss"])
        rows = dict(rounds_to_target=None if at is None else at[0],
                    bits_to_target=None if at is None else at[1])
        want_rows = cs.JAX_STOCH_FRONTIER_ROWS[key]
        out.update(rows=rows, rel=dict(
            uploads=rel_gap(final[0], want[0]),
            bits=rel_gap(final[1], want[1]), loss=rel_gap(final[2], want[2]),
            **{k: rel_gap(v, want_rows[k]) for k, v in rows.items()}))
    out["seconds"] = time.perf_counter() - t0
    return out


def lockstep(job):
    """Job ``(device, variant, steps)``: SLAQ-VR on ``device`` (with
    ``fault(variant)`` when given) and plain on the CPU, round by
    round."""
    _setup()
    from benchmarks_torch import common
    device, variant, steps = job
    engines = [lasg_engine("slaq_vr", dev) for dev in (device, "cpu")]
    carries = [eng.init_carry(common.logreg_init(device=dev), device=dev)
               for eng, dev in zip(engines, (device, "cpu"))]

    def rel(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    per_round = []
    for k in range(steps):
        recs = []
        for i, eng in enumerate(engines):
            with (fault(variant) if variant and i == 0
                  else contextlib.nullcontext()):
                carries[i], rec = eng.round(carries[i])
            recs.append(rec)
        (pd, cd, _), (ph, ch, _) = carries
        flips = 0
        for qd, qh in zip(cd.qhat, ch.qhat):
            a, b = qd["w"].cpu(), qh["w"]
            flips += int(((a - b).abs()
                          > FLIP_FRACTION * b.abs().max()).sum())
        mu = max(rel(a["w"], b["w"])
                 for a, b in zip(cd.svrg.mu_anchor, ch.svrg.mu_anchor))
        per_round.append(dict(
            round=k + 1, loss=rel(recs[0][0], recs[1][0]),
            params=rel(pd["w"], ph["w"]), mu_anchor=mu, code_flips=flips,
            uploads=(int(recs[0][2]), int(recs[1][2]))))
    first = {f: next((r["round"] for r in per_round if r[f] > lim), None)
             for f, lim in (("loss", 1e-6), ("code_flips", 0))}
    return dict(device=device, variant=variant, steps=steps, first=first,
                rounds=per_round)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--orders", type=int, default=8)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--procs", type=int, default=8)
    p.add_argument("--replay", metavar="STATES.npz")
    p.add_argument("out", nargs="?")
    a = p.parse_args(argv)
    _setup()
    import torch
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    jobs = ([(run, k, None, a.device, a.steps) for run in ORDER_RUNS
             for k in range(a.orders + 1)]
            + [(run, 0, f, a.device, a.steps) for run in ORDER_RUNS
               for f in FAULTS[run] + (FLOAT64,)])
    report = {}
    with ProcessPoolExecutor(a.procs, mp_context=get_context("spawn")) as ex:
        locked = [ex.submit(lockstep, (dev, variant, a.steps))
                  for dev, variant in ((a.device, None), ("cpu", FLOAT64))]
        replayed = (ex.submit(replay_states, (a.replay, a.device))
                    if a.replay else None)
        for res in ex.map(one_run, jobs):
            print(json.dumps(res), flush=True)
            report.setdefault("runs", []).append(res)
        report["lockstep"] = [f.result() for f in locked]
        if replayed is not None:
            report["replay"] = replayed.result()
            for r in report["replay"]:
                print(json.dumps({k: v for k, v in r.items()
                                  if k not in ("uploaded", "reference")}),
                      flush=True)
    for lock in report["lockstep"]:
        print(json.dumps(dict(
            device=lock["device"], variant=lock["variant"],
            first=lock["first"], rounds=[
                r for r in lock["rounds"] if r["code_flips"] or r["round"]
                in (lock["first"]["loss"], a.steps)])), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
