"""Shared pieces of the port's distributed tests (``test_torch_sharded_wire.py``,
``test_torch_train.py``): the cases' inputs, made with numpy from seeds so
that the JAX side and the port's ranks build the same arrays on their own,
and the rank side of each comparison.

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
TRAIN_CONFIGS = ("float", "packed", "packed_adaptive", "moe_packed",
                 "hybrid_packed") + tuple(TRAIN_RULES) + TRAIN_BF16
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

def run_jax(script: str, out_dir: str) -> subprocess.Popen:
    """Start the JAX side (``script``, run with this directory importable
    and ``OUT`` set to ``out_dir``); the caller waits with :func:`finish`."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OUT=out_dir,
               TESTS_DIR=os.path.dirname(os.path.abspath(__file__)),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
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


def rank_train(workers, out_dir):
    """The step configurations (TRAIN_CONFIGS and TRAIN_DEFENDED), 3 steps
    each, from the same parameters and batch; each rank saves its metrics,
    its bits and rejections, and the final parameters."""
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
    for config in TRAIN_CONFIGS + TRAIN_DEFENDED:
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
