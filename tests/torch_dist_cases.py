"""Shared pieces of the port's distributed tests (``test_torch_sharded_wire.py``
and the sharded step's four ``test_torch_train*.py`` files): the cases'
inputs, made with numpy from seeds so that the JAX side and the port's
ranks build the same arrays on their own, both sides of each comparison,
and the checks that the sharded step's files share.

This module imports no JAX.  The JAX side runs in a subprocess with four
forced host devices; the port's side runs in gloo ranks spawned from the
test process, which import this module (by its path) and nothing of the
test files.  Rendezvous goes through a ``FileStore`` in the test's
temporary directory, never a fixed port, and every rank and subprocess is
joined with a timeout, so a hung rank fails its test instead of hanging
the run.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np

RANK_TIMEOUT = 240          # seconds for a group of spawned ranks
JAX_TIMEOUT = 600           # seconds for a JAX subprocess

# ---------------------------------------------------------------------------
# The streamed packed wire (_packed_aggregate): a small tree with a leaf
# whose last dim 8/b does not divide ("odd", shipped as raw codes), a
# ragged flat leaf and a 2-D leaf.
# ---------------------------------------------------------------------------

WIRE_SHAPES = {"w": (16, 24), "odd": (5, 3), "b": (40,), "tail": (4096 + 12,)}
GRID = (2, 4, 8)

# name -> (W, bits or "adaptive", per_leaf_radius, skip mask, widths)
WIRE_CASES = {
    "gather_b2_leaf_skip": (4, 2, True, (0, 1, 0, 0), None),
    "gather_b4_global": (4, 4, False, (0, 0, 0, 0), None),
    "gather_b8_leaf_skip": (4, 8, True, (1, 0, 0, 1), None),
    "gather_adaptive_leaf": (4, "adaptive", True, (0, 0, 1, 0), (2, 8, 4, 2)),
    "gather_adaptive_global": (4, "adaptive", False, (0, 0, 0, 0),
                               (8, 4, 4, 2)),
    "permute_b4_leaf_skip": (2, 4, True, (0, 1), None),
    "permute_b2_global": (2, 2, False, (0, 0), None),
    "permute_b8_leaf": (2, 8, True, (0, 0), None),
    "permute_adaptive_global": (2, "adaptive", False, (0, 0), (4, 2)),
}


def wire_case_inputs(name: str):
    """``(grads, qhat)``: per leaf a float32 ``[W, *shape]`` array, the
    workers' gradients differing in scale so their radii differ."""
    W = WIRE_CASES[name][0]
    rng = np.random.default_rng(_seed_of(name))
    grads, qhat = {}, {}
    for k, s in WIRE_SHAPES.items():
        scale = np.array([0.5 + m for m in range(W)], np.float32).reshape(
            (W,) + (1,) * len(s))
        grads[k] = (rng.standard_normal((W,) + s) * scale).astype(np.float32)
        qhat[k] = (rng.standard_normal((W,) + s) * 0.3).astype(np.float32)
    return grads, qhat


def _seed_of(name: str) -> int:
    return sum((i + 1) * ord(c) for i, c in enumerate(name))


def wire_strategy_kwargs(name: str) -> dict:
    """StrategyConfig fields of a wire case (the same on both sides)."""
    _, bits, per_leaf, _, _ = WIRE_CASES[name]
    return dict(kind="laq", bits=8 if bits == "adaptive" else bits,
                per_leaf_radius=per_leaf, wire_backend="fused")


# ---------------------------------------------------------------------------
# The sharded training step: smoke stablelm-1.6b in float32, W=4 workers of
# 2 rows each, the configurations below of 3 steps each.  The workers' rows
# draw their tokens from vocabularies of different sizes, so their
# gradients differ and the skip rule splits them after step 1.
# ---------------------------------------------------------------------------

TRAIN_W, TRAIN_ROWS, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2, 32, 3, 1e-2
TRAIN_MICROBATCH = 2
TRAIN_CRITERION = dict(D=10, xi=0.3, t_bar=100, include_quant_error=False)
# per-configuration criteria, each picked so that a step after the first
# holds both a skip and an upload (uploads per step in the comment; every
# other configuration splits at the default xi 0.3)
TRAIN_CRITERIA = {
    # smoke zamba2 at xi 0.3 uploads from every worker in step 2 and none
    # in step 3; at 0.5 two of the four skip in step 2
    "hybrid_packed": dict(TRAIN_CRITERION, xi=0.5),
    # WK2's same-sample difference is small against the drift history: at
    # xi >= 0.03 every worker skips after step 1; at 0.003, 4, 1, 1
    "lasg_wk2_packed": dict(TRAIN_CRITERION, xi=0.003),
    "wk2_svrg_float": dict(TRAIN_CRITERION, xi=0.003),
    "wk2_svrg_packed": dict(TRAIN_CRITERION, xi=0.003),
    # rand-k's innovations stay large: 4, 4, 4 at xi 0.3; at 0.5, 4, 4, 1
    "randk_float": dict(TRAIN_CRITERION, xi=0.5),
    # with error feedback 4, 4, 4 up to xi 0.5; at 1.0, 4, 4, 3
    "ef_randk_float": dict(TRAIN_CRITERION, xi=1.0),
}
TRAIN_ETA = dict(kind="inv_t", t0=30.0)
TRAIN_THRESHOLDS = (0.05, 0.07)     # absolute radius thresholds of A-LAQ
# the lazy rules, SVRG (its anchor refreshed in steps 1 and 3) and the
# compressors (float wire only), as StrategyConfig fields
TRAIN_RULES = {
    "lasg_wk_packed": dict(lazy_rule="lasg_wk"),
    "lasg_wk2_packed": dict(lazy_rule="lasg_wk2"),
    "lasg_ps_packed": dict(lazy_rule="lasg_ps"),
    "svrg_packed": dict(grad_mode="svrg", svrg_period=2),
    "wk2_svrg_float": dict(lazy_rule="lasg_wk2", grad_mode="svrg",
                           svrg_period=2),
    "wk2_svrg_packed": dict(lazy_rule="lasg_wk2", grad_mode="svrg",
                            svrg_period=2),
    "ef_topk_float": dict(compressor="topk", compressor_k=0.1,
                          error_feedback=True),
    "randk_float": dict(compressor="randk", compressor_k=0.1),
    "ef_randk_float": dict(compressor="randk", compressor_k=0.1,
                           error_feedback=True),
}
# bfloat16 state (state_bf16): each is its twin, the configuration named
# after "bf16_", with qhat and server_agg stored in bfloat16
TRAIN_BF16 = ("bf16_float", "bf16_packed", "bf16_packed_adaptive",
              "bf16_wk2_svrg_packed", "bf16_ef_topk_float")
# the wires, the adaptive schedule and the MoE and hybrid models
TRAIN_BASE = ("float", "packed", "packed_adaptive", "moe_packed",
              "hybrid_packed")
# pairs of configurations that differ only in the wire, beside ("float",
# "packed"): their parameters, losses, bits and ||agg||^2 must be bitwise
# equal
TRAIN_WIRE_PAIRS = (("wk2_svrg_float", "wk2_svrg_packed"),
                    ("bf16_float", "bf16_packed"))
# the model of each configuration (smoke variant, float32): stablelm unless
# named here
TRAIN_ARCHS = {"moe_packed": "qwen3-moe-30b-a3b",
               "hybrid_packed": "zamba2-2.7b"}
# bernoulli participation with validation and the norm gate, on both wires
TRAIN_DEFENDED = ("defended_float", "defended_packed")
TRAIN_PARTICIPATION = dict(participation="bernoulli", participation_p=0.5,
                           participation_seed=1)
TRAIN_DEFENSE = dict(validate=True, gate_mult=4.0)


TRAIN_STRATEGY = dict(kind="laq", bits=4, per_leaf_radius=True,
                      wire_backend="fused")


def train_twin(config: str) -> str:
    """The configuration whose model, schedule, criterion and rule
    ``config`` takes: itself, or the twin of a ``TRAIN_BF16`` one."""
    return config[len("bf16_"):] if config in TRAIN_BF16 else config


def train_fields(config: str) -> dict:
    """StrategyConfig fields of ``config`` beyond ``TRAIN_STRATEGY``, the
    schedule, the criterion and the defense: its rule, and
    ``state_bf16``."""
    fields = dict(TRAIN_RULES.get(train_twin(config), {}))
    if config in TRAIN_BF16:
        fields["state_bf16"] = True
    return fields


def numpy_params(shapes: dict, seed: int = 0) -> dict:
    """A parameter tree from flat ``{"a.b.c": shape}`` names: norms zero,
    the embedding N(0, 1), every other leaf N(0, 1/fan_in); drawn in sorted
    name order."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name in sorted(shapes):
        s = tuple(shapes[name])
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in leaf or leaf.startswith("ln"):
            a = np.zeros(s, np.float32)
        else:
            scale = 1.0 if leaf == "embed" else s[-2] ** -0.5
            a = (rng.standard_normal(s) * scale).astype(np.float32)
        node = tree
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = a
    return tree


def flat_names(tree, prefix="") -> dict:
    """``{"a.b.c": leaf}`` of a nested dict (sorted keys)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_names(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def train_batch(vocab: int) -> dict:
    """The global batch, ``[W * rows, seq]`` int64: worker m's rows draw
    tokens below 4, 32, 256 and ``vocab``."""
    rng = np.random.default_rng(7)
    tok = np.concatenate([rng.integers(0, hi, size=(TRAIN_ROWS, TRAIN_SEQ + 1))
                          for hi in (4, 32, 256, vocab)])
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


# ---------------------------------------------------------------------------
# Running the two sides.
# ---------------------------------------------------------------------------

def run_jax(script: str, out_dir: str, **env) -> subprocess.Popen:
    """Start the JAX side (``script``, run with this directory importable,
    ``OUT`` set to ``out_dir`` and the variables ``env`` set); the caller
    waits with :func:`finish`."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OUT=out_dir,
               TESTS_DIR=os.path.dirname(os.path.abspath(__file__)),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", **env)
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc: subprocess.Popen, what: str):
    try:
        out, err = proc.communicate(timeout=JAX_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no result in {JAX_TIMEOUT} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed ({proc.returncode}):\n"
                             f"{err[-4000:]}")


def spawn_ranks(target: str, world_size: int, out_dir: str, *args):
    """Run ``target(workers, out_dir, *args)`` (a function of this module)
    on ``world_size`` gloo ranks; raises if a rank fails or hangs."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, f"store_{target}_{world_size}")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world_size, store, out_dir, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError(f"{target}: ranks {hung} of {world_size} hung")
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        errs = [open(os.path.join(out_dir, f"{target}_{world_size}_{r}.err"))
                .read() for r in bad
                if os.path.exists(os.path.join(out_dir,
                                               f"{target}_{world_size}_{r}.err"))]
        raise AssertionError(f"{target}: ranks failed {bad}\n" + "\n".join(errs))


def _rank_main(target, rank, world_size, store_path, out_dir, args):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_workers
    torch.set_num_threads(1)
    try:
        workers = init_workers("gloo", world_size, rank,
                               dist.FileStore(store_path, world_size))
        globals()[target](workers, out_dir, *args)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{target}_{world_size}_{rank}.err"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise


def rank_packed_aggregate(workers, out_dir):
    """Every wire case of this group's size through the port's
    ``_packed_aggregate``; each rank saves its aggregate and q_new."""
    import torch
    from repro_torch.core.adaptive import BitSchedule
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.launch.train import _packed_aggregate
    m = workers.rank
    out = {}
    for name, (W, bits, _, skip, widths) in WIRE_CASES.items():
        if W != workers.size:
            continue
        grads, qhat = wire_case_inputs(name)
        sched = (BitSchedule(kind="radius", grid=GRID,
                             thresholds=(1e-3, 1e-2))
                 if bits == "adaptive" else None)
        strat = StrategyConfig(**wire_strategy_kwargs(name),
                               bit_schedule=sched)
        g = {k: torch.from_numpy(v[m].copy()) for k, v in grads.items()}
        q = {k: torch.from_numpy(v[m].copy()) for k, v in qhat.items()}
        width = (torch.tensor(float(widths[m])) if widths is not None
                 else None)
        agg, q_new = _packed_aggregate(g, q, bool(skip[m]), strat, workers,
                                       width=width)
        for k in WIRE_SHAPES:
            out[f"{name}/agg/{k}"] = agg[k].numpy()
            out[f"{name}/q_new/{k}"] = q_new[k].numpy()
    np.savez(os.path.join(out_dir, f"wire_{workers.size}_{m}.npz"), **out)


def rank_train(workers, out_dir, configs):
    """The step configurations ``configs`` (of TRAIN_BASE, TRAIN_RULES,
    TRAIN_BF16 and TRAIN_DEFENDED), 3 steps each, from the same parameters
    and batch; each rank saves its metrics, its bits and rejections, and
    the final parameters."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.adaptive import BitSchedule, EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.defense import DefenseConfig
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.launch.mesh import worker_batch
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd

    from repro_torch.tree import tree_leaves

    out = {}
    for config in configs:
        twin = train_twin(config)
        arch = TRAIN_ARCHS.get(twin, "stablelm-1.6b")
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
        shapes = {k: tuple(v.shape) for k, v in
                  flat_names(init_params(0, cfg, device="cpu")).items()}
        batch = worker_batch({k: torch.from_numpy(v)
                              for k, v in train_batch(cfg.vocab).items()},
                             workers)
        sched = (BitSchedule(kind="radius", grid=GRID,
                             thresholds=TRAIN_THRESHOLDS)
                 if twin == "packed_adaptive" else None)
        extra = (dict(TRAIN_PARTICIPATION,
                      defense=DefenseConfig(**TRAIN_DEFENSE))
                 if config in TRAIN_DEFENDED else {})
        strat = StrategyConfig(
            **TRAIN_STRATEGY, bit_schedule=sched,
            criterion=CriterionConfig(**TRAIN_CRITERIA.get(
                twin, TRAIN_CRITERION)),
            eta_schedule=EtaSchedule(**TRAIN_ETA), **extra,
            **train_fields(config))
        opt = sgd()
        params = params_from_numpy(numpy_params(shapes), device="cpu")
        state = init_train_state(params, workers, strat, opt)
        step = make_train_step(cfg, workers, strat, opt, lr=TRAIN_LR,
                               wire=("float" if config.endswith("float")
                                     else "packed"),
                               microbatch=TRAIN_MICROBATCH)
        rec = {"loss": [], "uploads": [], "bits": [], "grad_sq": [],
               "bits_spent": [], "rejects": [], "state_dtypes": []}
        for _ in range(TRAIN_STEPS):
            state, met = step(state, batch)
            rec["state_dtypes"].append(",".join(sorted({
                str(l.dtype).replace("torch.", "") for l in
                tree_leaves(state.comm.qhat)
                + tree_leaves(state.comm.server_agg)})))
            rec["loss"].append(float(met.loss))
            rec["uploads"].append(met.uploads)
            rec["bits"].append(float(met.bits))
            rec["grad_sq"].append(float(met.grad_sq))
            rec["bits_spent"].append(float(state.comm.bits_spent[0]))
            rej = state.comm.defense.rejects
            rec["rejects"].append(-1 if rej is None else int(rej[0]))
        for k, v in rec.items():
            out[f"{config}/{k}"] = np.asarray(v)
        out[f"{config}/total_uploads"] = np.asarray(state.comm.total_uploads)
        for k, v in flat_names(params_to_numpy(state.params)).items():
            out[f"{config}/params/{k}"] = v
    np.savez(os.path.join(out_dir, f"train_{workers.rank}.npz"), **out)


# ---------------------------------------------------------------------------
# The sharded step's two sides on a group of configurations, and the checks
# that the four test files of the groups share.
# ---------------------------------------------------------------------------

# The reference's side: the configurations named in ``CONFIGS`` (comma
# separated), 3 steps each, saved to ``OUT/train_jax.npz``.
TRAIN_JAX_SIDE = r'''
import os, sys
sys.path.insert(0, os.environ["TESTS_DIR"])
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch_dist_cases as C
from repro.configs import get_config, smoke_config
from repro.core.adaptive import BitSchedule, EtaSchedule
from repro.core.criterion import CriterionConfig
from repro.core.defense import DefenseConfig
from repro.core.strategy import StrategyConfig, init_comm_state
from repro.launch.train import (init_train_state, make_train_step,
                                train_state_specs)
from repro.models import init_params
from repro.optim import sgd

# jax.make_mesh gives Explicit axes on jax 0.9, under which the embedding
# gather of models/stack.py raises; a Mesh of Auto axes runs the step
mesh = Mesh(np.array(jax.devices()).reshape(C.TRAIN_W, 1), ("data", "model"))
out = {}
for config in os.environ["CONFIGS"].split(","):
    twin = C.train_twin(config)
    arch = C.TRAIN_ARCHS.get(twin, "stablelm-1.6b")
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype=jnp.float32,
                              compute_dtype=jnp.float32)
    abstract = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    names = {jax.tree_util.keystr(p, simple=True, separator="."): l.shape
             for p, l in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    params0 = C.numpy_params(names)
    batch = jax.device_put({k: jnp.asarray(v, jnp.int32)
                            for k, v in C.train_batch(cfg.vocab).items()},
                           NamedSharding(mesh, P("data", None)))
    sched = (BitSchedule(kind="radius", grid=C.GRID,
                         thresholds=C.TRAIN_THRESHOLDS)
             if twin == "packed_adaptive" else None)
    extra = (dict(C.TRAIN_PARTICIPATION,
                  defense=DefenseConfig(**C.TRAIN_DEFENSE))
             if config in C.TRAIN_DEFENDED else {})
    strat = StrategyConfig(**C.TRAIN_STRATEGY, bit_schedule=sched,
                           criterion=CriterionConfig(**C.TRAIN_CRITERIA.get(
                               twin, C.TRAIN_CRITERION)),
                           eta_schedule=EtaSchedule(**C.TRAIN_ETA), **extra,
                           **C.train_fields(config))
    opt = sgd()
    state = init_train_state(jax.random.PRNGKey(0), cfg, mesh, strat, opt,
                             ("data",))
    # the state around params0: lasg_ps and lasg_wk2 snapshot the
    # initial iterate as theta_last, SVRG as its anchor
    params = jax.tree.map(jnp.asarray, params0)
    state = state._replace(params=params, opt_state=opt.init(params),
                           comm=init_comm_state(params, C.TRAIN_W, strat))
    # the state in and out of the step in one layout, the reference's
    # (train_state_specs), so that the step compiles once: from
    # single-device inputs it compiled again for its own outputs' layout
    layout = jax.tree.map(lambda s: s.sharding, train_state_specs(
        cfg, mesh, strat, opt, ("data",)))
    state = jax.device_put(state, layout)
    step = jax.jit(make_train_step(
        cfg, mesh, strat, opt, lr=C.TRAIN_LR, worker_axes=("data",),
        wire="float" if config.endswith("float") else "packed",
        microbatch=C.TRAIN_MICROBATCH),
        in_shardings=(layout, NamedSharding(mesh, P("data", None))),
        out_shardings=(layout, NamedSharding(mesh, P())))
    rec = {"loss": [], "uploads": [], "bits": [], "grad_sq": [],
           "bits_spent": [], "rejects": [], "state_dtypes": []}
    for _ in range(C.TRAIN_STEPS):
        state, met = step(state, batch)
        rec["state_dtypes"].append(",".join(sorted({
            str(l.dtype) for l in jax.tree.leaves(state.comm.qhat)
            + jax.tree.leaves(state.comm.server_agg)})))
        rec["loss"].append(float(met.loss))
        rec["uploads"].append(int(met.uploads))
        rec["bits"].append(float(met.bits))
        rec["grad_sq"].append(float(met.grad_sq))
        rec["bits_spent"].append(np.asarray(state.comm.bits_spent))
        rej = state.comm.defense.rejects
        rec["rejects"].append(np.full(C.TRAIN_W, -1) if rej is None
                              else np.asarray(rej))
    for k, v in rec.items():
        out[f"{config}/{k}"] = np.asarray(v)
    out[f"{config}/total_uploads"] = np.asarray(state.comm.total_uploads)
    for k, v in C.flat_names(jax.tree.map(np.asarray, state.params)).items():
        out[f"{config}/params/{k}"] = v
np.savez(os.path.join(os.environ["OUT"], "train_jax.npz"), **out)
'''


def run_train(out_dir: str, configs) -> tuple:
    """Run ``configs`` through the reference's sharded step (one JAX
    subprocess) and the port's (``TRAIN_W`` gloo ranks) at once; return
    ``(want, got)``, the reference's npz and each rank's."""
    jax_side = run_jax(TRAIN_JAX_SIDE, out_dir, CONFIGS=",".join(configs))
    try:
        spawn_ranks("rank_train", TRAIN_W, out_dir, tuple(configs))
    finally:
        finish(jax_side, "the reference's sharded step")
    want = np.load(os.path.join(out_dir, "train_jax.npz"))
    got = [np.load(os.path.join(out_dir, f"train_{m}.npz"))
           for m in range(TRAIN_W)]
    return want, got


# leaves of each configuration's model: smoke stablelm unless named here
TRAIN_LEAVES = {"moe_packed": 15, "hybrid_packed": 29}


def params_of(npz, config) -> dict:
    pre = f"{config}/params/"
    return {k[len(pre):]: npz[k] for k in npz.files if k.startswith(pre)}


def check_uploads_bits_and_widths(runs, config):
    """Uploads and bits per step, each worker's cumulative bits (which fix
    its widths) and the total uploads equal the reference's; step 1
    uploads from every worker and a later step splits them."""
    want, got = runs
    ups = want[f"{config}/uploads"]
    assert ups[0] == TRAIN_W
    assert any(0 < u < TRAIN_W for u in ups[1:]), ups
    for m, g in enumerate(got):
        np.testing.assert_array_equal(g[f"{config}/uploads"], ups)
        np.testing.assert_array_equal(g[f"{config}/bits"],
                                      want[f"{config}/bits"])
        np.testing.assert_array_equal(g[f"{config}/bits_spent"],
                                      want[f"{config}/bits_spent"][:, m])
        assert int(g[f"{config}/total_uploads"]) == int(
            want[f"{config}/total_uploads"])


def check_loss_and_params(runs, config):
    """The loss to rtol 1e-4 and the parameters to rtol 1e-4, atol 5e-4
    (``test_torch_train.py`` says why)."""
    want, got = runs
    np.testing.assert_allclose(got[0][f"{config}/loss"],
                               want[f"{config}/loss"], rtol=1e-4)
    w, g = params_of(want, config), params_of(got[0], config)
    assert w.keys() == g.keys()
    assert len(w) == TRAIN_LEAVES.get(config, 12)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=5e-4,
                                   err_msg=k)


def check_state_dtypes(runs, config):
    """``qhat`` and ``server_agg`` are bfloat16 after every step under
    ``state_bf16``, float32 otherwise, on every rank and in the
    reference."""
    want, got = runs
    dtype = "bfloat16" if config in TRAIN_BF16 else "float32"
    np.testing.assert_array_equal(want[f"{config}/state_dtypes"],
                                  [dtype] * TRAIN_STEPS)
    for g in got:
        np.testing.assert_array_equal(g[f"{config}/state_dtypes"],
                                      [dtype] * TRAIN_STEPS)


def check_wires_bitwise(got, float_cfg, packed_cfg, fields):
    """On every rank the two configurations' parameters and ``fields``
    are bitwise equal."""
    for g in got:
        f, p = params_of(g, float_cfg), params_of(g, packed_cfg)
        assert f.keys() == p.keys()
        for k in f:
            np.testing.assert_array_equal(p[k], f[k], err_msg=k)
        for field in fields:
            np.testing.assert_array_equal(g[f"{packed_cfg}/{field}"],
                                          g[f"{float_cfg}/{field}"])


def check_every_rank_holds_the_same_params(runs, config):
    _, got = runs
    first = params_of(got[0], config)
    for g in got[1:]:
        for k, v in params_of(g, config).items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)
