"""The LASG and the participation frontier at full size, the port on the
CPU against the JAX modules (not a test):

    PYTHONPATH=src:.:tests JAX_PLATFORMS=cpu \\
        python tests/stochastic_frontiers_probe.py [OUT.json]

1. The JAX side: ``benchmarks/lasg_frontier.py`` and
   ``benchmarks/participation_frontier.py`` ``run`` at their own steps,
   each run's trajectory kept.  Prints each run's final uploads, bits and
   loss, the rows' entries that count uploads, rounds or bits, the
   targets and the claims: ``chip_smoke.py``'s ``JAX_STOCH_FRONTIERS``,
   ``JAX_STOCH_FRONTIER_ROWS``, ``JAX_STOCH_FRONTIER_TARGETS`` and
   ``JAX_STOCH_FRONTIER_CLAIMS``.
2. The port's two modules on the CPU, the participation frontier on the
   reference and the fused wire, the LASG frontier on the reference wire
   (its b = 3 keeps the fused wire off it): for each run the first round
   where its ``cum_uploads`` or ``cum_bits`` part from JAX's, its final
   counts, the largest relative gap of its loss over all rounds and over
   the rounds before it parts, and whether the rows and the claims agree.
3. Both frontiers once more on the reference wire with every gradient
   taken from JAX (``jax.grad`` of the reference's loss under ``jit`` and
   ``vmap``, at the port's own iterate, on the rows of the port's
   minibatch, which are ``jax.random``'s): the current, stale and
   SVRG-anchor minibatch gradients, the anchors' full local gradients and
   the full-batch gradients.  For each run the same report as in 2.
4. The JAX LASG frontier once more with each minibatch's rows in reversed
   order: the same gradient in another float32 summation order, on the
   reference itself.  For each run the same report as in 2, against the
   reference's own run.
5. For each LASG run that parts in 2: the reference's state after the
   round before it parts, loaded into the port, and the port's round from
   there (JAX's gradients): each worker's upload against the reference's,
   and its margin ``lhs / rhs - 1``.
6. The threshold of rule 7a under ``jit``: which float32 forms of the
   history term and of ``hist + 3 (eps^2 + eps_hat^2)`` equal the
   reference's, alone and vmapped over the workers, on 400 random inputs;
   then the port's LASG frontier with its threshold replaced by the
   vmapped form, the report as in 2.

7. The reference's SLAQ-WK, SLAQ-PS and SLAQ-VR once more in each of
   ``ORDERS`` row orders (``lasg_order_witness.row_order``; ``jax.random``
   draws the same rows): the spread that the float32 order alone gives
   the reference.  For each run and order the first round that parts from
   the drawn order's, the final counts and loss and the rows to the
   target, each relative to the drawn order's; the drawn order's uploads
   per round, one hexadecimal digit a round (``chip_smoke.py``'s
   ``JAX_STOCH_PREFIX``).
8. The port on the CPU with each planted fault of
   ``lasg_order_witness.FAULTS``, and with its gradients computed in
   float64 and rounded to float32: the same report against the
   reference.

9. For SLAQ-WK and SLAQ-PS: every round replayed in the port on the CPU
   from the reference's state before it (the reference stepped one
   round at a time), with JAX's gradients and with the port's own: the
   rounds where the port's uploads differ from the reference's, and the
   smallest margin ``lhs / rhs - 1`` of any worker in any round.  The
   states before the rounds of ``REPLAY_ROUNDS`` and before each round
   with a margin within ``NEAR_TIE`` go to ``REPLAY_NPZ``, for
   ``tests/lasg_order_witness.py --replay`` on a card.

``--orders-only`` runs 7 to 9 alone.  ``OUT.json``, when given, receives
it all.
"""
import contextlib
import json
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import benchmarks.common as jcommon
import benchmarks_torch.common as tcommon
import repro.core.simulated as jsimulated
import lasg_order_witness as witness
import test_torch_lasg_frontier as tl
import test_torch_participation_frontier as tp
from torch_frontier_cases import arrays
from repro.core import StrategyConfig as JaxStrategy
from repro.core import criterion as jcriterion
from repro.core import engine as jengine
from repro_torch.core import criterion, engine, lazy_rules
from repro_torch.core.quantize import fma_f32

MODULES = {"lasg_frontier": (tl, tl.TL.STEPS),
           "participation_frontier": (tp, tp.TP.STEPS)}
COUNTS = ("cum_uploads", "cum_bits")
COUNT_KEYS = ("total_uploads", "total_rounds", "total_bits",
              "uploads_to_target", "rounds_to_target", "bits_to_target",
              "bits_to_det_floor")
RULES = witness.RULES
F32 = torch.float32
ORDERS = 32
# the rounds in which some row order parts the reference from its own run
# (section 7), and every 25th
REPLAY_ROUNDS = {"slaq_wk": (98, 105, 112, 136) + tuple(range(25, 501, 25)),
                 "slaq_ps": (182, 199, 208, 228, 259, 343)
                 + tuple(range(25, 501, 25))}
REPLAY_NPZ = "_replay/lasg_states.npz"
NEAR_TIE = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not len(a):
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _first_part(g, w):
    """``(field, round)`` where the port's counts first part from JAX's
    (rounds from 1), or None."""
    for k in range(len(w["cum_uploads"])):
        for f in COUNTS:
            if g[f][k] != w[f][k]:
                return f, k + 1
    return None


def compare(got_tr, want_tr):
    out = {}
    for run, w in want_tr.items():
        g = got_tr[run]
        part = _first_part(g, w)
        n = len(w["loss"]) if part is None else part[1] - 1
        out[run] = dict(first_part=part,
                        finals=(int(g["cum_uploads"][-1]),
                                float(g["cum_bits"][-1]),
                                float(g["loss"][-1])),
                        jax_finals=(int(w["cum_uploads"][-1]),
                                    float(w["cum_bits"][-1]),
                                    float(w["loss"][-1])),
                        loss_rel=_rel(g["loss"], w["loss"]),
                        loss_rel_matched=_rel(g["loss"][:n], w["loss"][:n]))
    return out


def _counts(rows):
    return {row: {k: v for k, v in r.items() if k in COUNT_KEYS}
            for row, r in rows.items()}


@contextlib.contextmanager
def jax_gradients():
    """Every gradient of the port's sources taken from JAX, as the
    reference's sources take them inside its jitted round: ``jax.grad`` of
    the reference's logistic loss under ``jit`` and ``vmap`` over the W
    workers, at the port's iterate (broadcast to the W lanes, as
    ``broadcast_w`` does), on the same rows; the minibatch gradient
    multiplied by the source's scale inside the same program, the full
    local gradients at the unbatched iterate (``full_local_grads``, and
    ``FullBatchSource.eval_at`` without per-worker iterates)."""
    workers, full = tcommon.make_dataset(device="cpu")
    jgrad = jax.grad(jcommon.logreg_loss(full[0].shape[0]))
    W = tcommon.M_WORKERS
    lanes = jax.jit(jax.vmap(jgrad))
    at_params = jax.jit(lambda p, d: jax.vmap(lambda x: jgrad(p, x))(d))
    scaled_lanes = {}

    def j(x):
        return jnp.asarray(x.numpy())

    def data(tree):
        return tuple(j(x) for x in tree)

    def broadcast(params):
        return {"w": jnp.broadcast_to(j(params["w"]),
                                      (W,) + tuple(params["w"].shape))}

    def pick(g, m):
        return {"w": torch.from_numpy(np.array(g["w"][m]))}

    def full_grad_at(self, params, batches, m):
        return pick(at_params({"w": j(params["w"])}, data(self.worker_data)),
                    m)

    def mini_grad_at(self, params, batches, m, *, scaled=True):
        if not scaled:
            return pick(lanes(broadcast(params), data(batches)), m)
        s = self.scale
        if s not in scaled_lanes:
            scaled_lanes[s] = jax.jit(jax.vmap(lambda t, b: jax.tree.map(
                lambda g: g.astype(jnp.float32) * s, jgrad(t, b))))
        return pick(scaled_lanes[s](broadcast(params), data(batches)), m)

    def full_local_grads(self, params, m):
        return full_grad_at(self, params, None, m)

    saved = (engine.FullBatchSource.grad_at, engine.MinibatchSource.grad_at,
             engine.MinibatchSource.full_local_grads)
    engine.FullBatchSource.grad_at = full_grad_at
    engine.MinibatchSource.grad_at = mini_grad_at
    engine.MinibatchSource.full_local_grads = full_local_grads
    try:
        yield
    finally:
        (engine.FullBatchSource.grad_at, engine.MinibatchSource.grad_at,
         engine.MinibatchSource.full_local_grads) = saved


class PermutedRows(jsimulated.MinibatchSource):
    """The reference's minibatch source with each worker's sampled rows in
    the order ``perm``."""
    perm = None

    def sample(self, step):
        return jax.tree.map(lambda x: x[:, self.perm], super().sample(step))


def jax_reversed_rows(steps):
    """The JAX LASG frontier with each minibatch's rows in reversed order
    (``PermutedRows``) in place of its source."""
    PermutedRows.perm = np.arange(tl.JL.BATCH)[::-1]
    with witness.patched(jsimulated, "MinibatchSource", PermutedRows):
        return tl.jax_side(steps)


def jax_lasg_run(label, perm):
    """The reference's LASG run ``label`` (``slaq_wk``, ``slaq_ps`` or
    ``slaq_vr``) as ``benchmarks/lasg_frontier.py`` runs it, with
    ``PermutedRows(perm)`` in place of its source."""
    JL = tl.JL
    workers, full = jcommon.make_dataset()
    cfg = JaxStrategy(kind="laq", bits=JL.BITS,
                      criterion=jcommon.PAPER_CRITERION)
    if label == "slaq_vr":
        cfg = cfg._replace(grad_mode="svrg", svrg_period=JL.SVRG_PERIOD)
    PermutedRows.perm = perm
    with witness.patched(jsimulated, "MinibatchSource", PermutedRows):
        return jsimulated.run_stochastic(
            jcommon.logreg_loss(full[0].shape[0]), jcommon.logreg_init(),
            workers, "slaq" if label == "slaq_vr" else label,
            steps=JL.STEPS, alpha=JL.ALPHA, batch=JL.BATCH, bits=JL.BITS,
            seed=JL.SEED, laq_cfg=cfg)


def _spread(reports):
    """The least and the largest of each relative gap over ``reports``."""
    keys = reports[0]["rel"]
    return {k: (min(r["rel"][k] for r in reports),
                max(r["rel"][k] for r in reports)) for k in keys}


def order_spread(n=ORDERS):
    """Section 7: ``{run: report}``."""
    import chip_smoke as cs
    target = cs.JAX_STOCH_FRONTIER_TARGETS["lasg_frontier"]["target_loss"]
    out = {}
    for label in witness.ORDER_RUNS:
        runs = []
        for k in range(n + 1):
            r = arrays(jax_lasg_run(label, witness.row_order(k, tl.JL.BATCH)))
            at = tcommon.first_reach(SimpleNamespace(**r), target)
            runs.append(dict(order=k, trace=r, final=(
                int(r["cum_uploads"][-1]), float(r["cum_bits"][-1]),
                float(r["loss"][-1])), rows=dict(
                    rounds_to_target=None if at is None else at[0],
                    bits_to_target=None if at is None else at[1])))
        drawn = runs[0]
        for r in runs[1:]:
            part = _first_part(r["trace"], drawn["trace"])
            r["first_part"] = None if part is None else part[1]
            r["rel"] = {
                **{k: witness.rel_gap(r["final"][i], drawn["final"][i])
                   for i, k in enumerate(("uploads", "bits", "loss"))},
                **{k: witness.rel_gap(v, drawn["rows"][k])
                   for k, v in r["rows"].items()}}
        ups = np.diff(drawn["trace"]["cum_uploads"], prepend=0)
        out[label] = dict(
            drawn=dict(final=drawn["final"], rows=drawn["rows"],
                       uploads_per_round="".join(f"{int(u):x}" for u in ups)),
            orders=[{k: v for k, v in r.items() if k != "trace"}
                    for r in runs[1:]],
            earliest_part=min((r["first_part"] for r in runs[1:]
                               if r["first_part"]), default=None),
            spread=_spread(runs[1:]))
    return out


def port_faults():
    """Section 8: the port on the CPU with each planted fault."""
    return [witness.one_run((run, 0, f, "cpu", tl.TL.STEPS))
            for run in witness.ORDER_RUNS
            for f in witness.FAULTS[run] + (witness.FLOAT64,)]


def _lasg_engines(kind):
    """The reference's and the port's engines of the LASG run ``kind``,
    as ``run_stochastic`` builds them, on the CPU."""
    (jXw, jYw), jfull = jcommon.make_dataset()
    jcfg = JaxStrategy(kind="laq", bits=tl.TL.BITS,
                       criterion=jcommon.PAPER_CRITERION,
                       lazy_rule=RULES[kind])
    jeng = jengine.RoundEngine(
        jengine.MinibatchSource(jcommon.logreg_loss(jfull[0].shape[0]),
                                (jXw, jYw), batch=tl.TL.BATCH,
                                seed=tl.TL.SEED),
        jcfg, alpha=tl.TL.ALPHA, bits=tl.TL.BITS, track_history=True)
    return jeng, witness.lasg_engine(kind, "cpu")


def reference_arrays(carry):
    """The reference's carry ``(params, CommState, ...)`` as the arrays
    ``lasg_order_witness.replay_round`` takes."""
    jcst = carry[1]
    out = {"params": np.array(carry[0]["w"])}
    for name in witness.STATE_FIELDS:
        obj, key = ((jcst.lazy, name[5:]) if name.startswith("lazy.")
                    else (jcst, name))
        v = getattr(obj, key)
        if v is not None:
            out[name] = np.array(v["w"] if isinstance(v, dict) else v)
    return out


def replay(kind, k):
    """Round ``k`` (from 1) of the LASG run ``kind`` in the port, from the
    reference's state after round ``k - 1`` and with JAX's gradients:
    which workers upload in both, and the port's margins there."""
    jeng, teng = _lasg_engines(kind)
    carry = jeng.init_carry(jcommon.logreg_init())
    if k > 1:
        carry, _ = jax.jit(lambda c: jeng.run_from(c, k - 1))(carry)
    after, _ = jax.jit(lambda c: jeng.run_from(c, 1))(carry)
    with jax_gradients():
        uploaded, margins = witness.replay_round(
            teng, reference_arrays(carry), "cpu")
    # a worker whose clock is 0 after the round uploaded in it
    return dict(round=k, margins=margins,
                jax_uploaded=(np.asarray(after[1].clocks) == 0).tolist(),
                port_uploaded=uploaded)


def replay_all(kind, save_rounds=(), saved=None):
    """Section 9: each round of the reference's run ``kind`` replayed in
    the port on the CPU from the reference's state before it, once with
    JAX's gradients and once with the port's own: the rounds whose uploads
    differ from the reference's, and the smallest margin over all rounds.
    The reference's state before each round of ``save_rounds``, and its
    uploads in it, go to ``saved`` (``lasg_order_witness.py --replay``)."""
    jeng, teng = _lasg_engines(kind)
    step = jax.jit(lambda c: jeng.run_from(c, 1))
    steps = tl.JL.STEPS
    _, scanned = jax.jit(lambda c: jeng.run_from(c, steps))(
        jeng.init_carry(jcommon.logreg_init()))
    out = {}
    for grads in ("jax", "port"):
        ctx = (jax_gradients() if grads == "jax"
               else contextlib.nullcontext())
        carry = jeng.init_carry(jcommon.logreg_init())
        differ, least, looped, ties = [], None, [], []
        with ctx:
            for k in range(1, steps + 1):
                arrays = reference_arrays(carry)
                carry, _ = step(carry)
                want = (np.asarray(carry[1].clocks) == 0).tolist()
                looped.append(int(carry[1].total_uploads))
                got, margins = witness.replay_round(teng, arrays, "cpu")
                if got != want:
                    differ.append(dict(round=k, port=got, reference=want,
                                       margins=margins))
                m = min(margins, key=abs)
                if least is None or abs(m) < abs(least[1]):
                    least = (k, m)
                if abs(m) < NEAR_TIE:
                    ties.append((k, m))
                if saved is not None and grads == "port" and (
                        k in save_rounds or abs(m) < NEAR_TIE):
                    saved.update({f"{kind}/{k}/{f}": v
                                  for f, v in arrays.items()})
                    saved[f"{kind}/{k}/uploaded"] = np.array(want)
        out[grads] = dict(
            worker_rounds=steps * tcommon.M_WORKERS, differ=differ,
            least_margin=dict(round=least[0], margin=least[1]),
            near_ties=ties,
            loop_equals_scan=looped == np.asarray(
                scanned.cum_uploads).tolist())
    return out


def _fma(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def threshold_forms(n=400, seed=0):
    """The share of ``n`` random inputs on which each float32 form of the
    7a threshold equals the reference's under ``jit`` (alpha 0.5, M 10,
    the paper's criterion), alone and vmapped over ten workers that share
    the history.  The float64 ``_fma`` of float32 operands is exact up to
    its one rounding at these magnitudes."""
    cfg = jcriterion.CriterionConfig()
    rng = np.random.default_rng(seed)
    H = (rng.random((n, cfg.D))
         * 10 ** rng.uniform(-6, -2, (n, 1))).astype(np.float32)
    E, EH = ((rng.random(n) * 10 ** rng.uniform(-6, -2, n)).astype(np.float32)
             for _ in range(2))
    inv = np.float32(1.0 / (0.5 ** 2 * 10 ** 2))
    hist1 = jax.jit(lambda h: jcriterion.history_threshold(h, 0.5, 10, cfg))
    rhs1 = jax.jit(lambda h, e, eh: jcriterion.rhs_threshold(
        h, 0.5, 10, e, eh, cfg))
    rhsv = jax.jit(lambda h, e, eh: jax.vmap(
        lambda a, b: jcriterion.rhs_threshold(h, 0.5, 10, a, b, cfg))(e, eh))
    want_h = np.array([hist1(h) for h in H], np.float32)
    want_1 = np.array([rhs1(H[i], E[i], EH[i]) for i in range(n)], np.float32)
    want_v = np.array([rhsv(H[i], np.full(10, E[i], np.float32),
                            np.full(10, EH[i], np.float32))[0]
                       for i in range(n)], np.float32)
    chain = np.zeros(n, np.float32)
    for d in range(cfg.D):
        chain = np.array([_fma(np.float32(cfg.xi), H[i, d], chain[i])
                          for i in range(n)], np.float32)
    hist = chain * inv
    s = E + EH
    tcfg = criterion.CriterionConfig()
    port_h = np.array([float(criterion.history_threshold(
        torch.from_numpy(h), 0.5, 10, tcfg)) for h in H], np.float32)
    port_r = np.array([float(criterion.rhs_threshold(
        torch.from_numpy(H[i]), 0.5, 10, torch.tensor(E[i]),
        torch.tensor(EH[i]), tcfg)) for i in range(n)], np.float32)

    def share(got, want):
        return float(np.mean(got.view(np.int32) == want.view(np.int32)))

    forms = {"fma chain * f32(1/(a^2 M^2))": hist,
             "torch.dot / (a^2 M^2) (the port)": port_h}
    sums = {
        "hist + 3 s": hist + s * np.float32(3),
        "fma(s, 3, hist)": np.array([_fma(s[i], 3, hist[i])
                                     for i in range(n)], np.float32),
        "fma(chain, f32(1/(a^2 M^2)), 3 s)": np.array(
            [_fma(chain[i], inv, s[i] * np.float32(3)) for i in range(n)],
            np.float32),
        "the port": port_r,
    }
    return dict(history={k: share(v, want_h) for k, v in forms.items()},
                alone={k: share(v, want_1) for k, v in sums.items()},
                vmapped={k: share(v, want_v) for k, v in sums.items()})


@contextlib.contextmanager
def engine_threshold():
    """The port's 7a threshold replaced by the form the reference's engine
    computes (vmapped over the workers): the history term as a chain of
    FMAs from d = 0 times ``f32(1/(alpha^2 M^2))`` (a true division when
    alpha is a tensor), then ``fma(eps^2 + eps_hat^2, 3, hist)``."""
    def history_threshold(h, alpha, M, cfg):
        s = torch.zeros((), dtype=F32)
        for d in range(cfg.D):
            s = fma_f32(cfg.xi, h[d], s)
        den = alpha ** 2 * M ** 2
        if isinstance(den, float):
            return s * torch.tensor(1.0 / den, dtype=F32)
        return s / den

    def rhs_threshold(h, alpha, M, eps_sq, eps_hat_sq, cfg):
        hist = history_threshold(h, alpha, M, cfg)
        if not cfg.include_quant_error:
            return hist
        return fma_f32(torch.as_tensor(eps_sq, dtype=F32)
                       + torch.as_tensor(eps_hat_sq, dtype=F32), 3.0, hist)

    saved = (criterion.history_threshold, criterion.rhs_threshold,
             lazy_rules.rhs_threshold)
    criterion.history_threshold = history_threshold
    criterion.rhs_threshold = lazy_rules.rhs_threshold = rhs_threshold
    try:
        yield
    finally:
        (criterion.history_threshold, criterion.rhs_threshold,
         lazy_rules.rhs_threshold) = saved


def _emit(report, key, value):
    report[key] = value
    print(json.dumps({key: value}), flush=True)


def main(out=None, orders_only=False):
    torch.set_num_threads(1)
    report, jax_runs, parted = {}, {}, []
    if orders_only:
        _emit(report, "order_spread", order_spread())
        _emit(report, "port_faults", port_faults())
        saved = {}
        _emit(report, "replay_all", {
            kind: replay_all(kind, rounds, saved)
            for kind, rounds in REPLAY_ROUNDS.items()})
        import os
        os.makedirs(os.path.dirname(REPLAY_NPZ), exist_ok=True)
        np.savez_compressed(REPLAY_NPZ, **saved)
        if out:
            with open(out, "w") as f:
                json.dump(report, f, indent=1)
        return
    for module, (mod, steps) in MODULES.items():
        t0 = time.perf_counter()
        res, traces = mod.jax_side(steps)
        jax_runs[module] = res, traces
        rows = mod.want_rows(res)
        _emit(report, f"jax/{module}", dict(
            seconds=time.perf_counter() - t0,
            finals={run: (int(t["cum_uploads"][-1]), float(t["cum_bits"][-1]),
                          float(t["loss"][-1]))
                    for run, t in traces.items()},
            rows=_counts({r: v for r, v in rows.items()
                          if not r.endswith("/target")}),
            targets=rows[f"{module}/target"],
            claims=res[f"{module}/claims"]))
    for module, (mod, steps) in MODULES.items():
        want, want_tr = jax_runs[module]
        wires = (("reference", "fused") if module == "participation_frontier"
                 else ("reference",))
        for wire in wires:
            t0 = time.perf_counter()
            res, checks, traces = mod.port_side(wire, steps=steps)
            runs = compare(traces, want_tr)
            if module == "lasg_frontier":
                parted = [(run.split("/")[1], r["first_part"][1])
                          for run, r in runs.items() if r["first_part"]]
            _emit(report, f"port/{module}/{wire}", dict(
                seconds=time.perf_counter() - t0, runs=runs,
                rows_agree=_counts({r: res[r] for r in mod.want_rows(want)})
                == _counts(mod.want_rows(want)),
                claims_agree=checks == want[f"{module}/claims"],
                claims=checks))
    for module, (mod, steps) in MODULES.items():
        want, want_tr = jax_runs[module]
        t0 = time.perf_counter()
        with jax_gradients():
            res, checks, traces = mod.port_side("reference", steps=steps)
        _emit(report, f"with_jax_gradients/{module}", dict(
            seconds=time.perf_counter() - t0, runs=compare(traces, want_tr),
            claims_agree=checks == want[f"{module}/claims"]))
    want, want_tr = jax_runs["lasg_frontier"]
    steps = MODULES["lasg_frontier"][1]
    t0 = time.perf_counter()
    res, traces = jax_reversed_rows(steps)
    _emit(report, "jax_reversed_rows", dict(
        seconds=time.perf_counter() - t0, runs=compare(traces, want_tr),
        claims_agree=res["lasg_frontier/claims"]
        == want["lasg_frontier/claims"]))
    _emit(report, "replay", {kind: replay(kind, k) for kind, k in parted
                             if kind in RULES})
    _emit(report, "threshold_forms", threshold_forms())
    t0 = time.perf_counter()
    with engine_threshold():
        res, checks, traces = tl.port_side("reference", steps=steps)
    _emit(report, "with_engine_threshold", dict(
        seconds=time.perf_counter() - t0, runs=compare(traces, want_tr),
        claims_agree=checks == want["lasg_frontier/claims"]))
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    args = sys.argv[1:]
    only = "--orders-only" in args
    main(*[a for a in args if a != "--orders-only"][:1], orders_only=only)
