"""The port's sharded training step (``launch/train.py`` ``make_train_step``)
against the reference's, run live, on smoke stablelm-1.6b in float32 with
W=4 workers.

The reference runs in a subprocess on four forced host CPU devices, with a
mesh of Auto axes: ``jax.make_mesh`` gives Explicit axes on jax 0.9, under
which the embedding gather of ``models/stack.py`` raises, while
``jax.sharding.Mesh`` of the same devices runs the unchanged step.  The
port runs on four gloo ranks.  Both start from the same parameters (numpy,
carried into the port by ``repro_torch.convert``) and the same batch;
worker m takes rows [2m, 2m + 2), whose tokens come from vocabularies of
different sizes, so that the skip rule (xi = 0.3 without the quantization
slack; 0.5 on the hybrid, ``torch_dist_cases.TRAIN_CRITERIA``) keeps some
workers and not others after step 1.  Five
configurations of 3 steps: the float wire, the packed wire at b=4, the
packed wire with the adaptive schedule on the grid (2, 4, 8), whose
absolute thresholds give the workers different widths, and the packed
wire at b=4 on smoke qwen3-moe-30b-a3b (15 leaves; its router's aux enters
the loss and the gradient through ``lm_loss``) and on smoke zamba2-2.7b
(29 leaves: the Mamba2 blocks and the shared attention block); and both
wires
with bernoulli participation (p=0.5) and the defense's validation and
norm gate, where each worker reads its slot of the round's cohort and an
absent or rejected worker is masked off the wire like a skip.  All run
``microbatch=2`` and the 1/t stepsize.

Tolerances: uploads, bits and each worker's cumulative bits (which fix its
widths) exactly; the loss to rtol 1e-4 (the two frameworks reduce in other
orders, as in ``test_torch_lm.py``); the parameters to rtol 1e-4 and atol
5e-4.  A gradient that differs at the ulp moves a code sitting on a
rounding boundary by one grid step, which moves a parameter by
lr * 2 tau R <= 1e-2 * (2/3) * 0.07.  Such boundaries are common: a zero
innovation (an embedding row of a token the worker never saw) gives
(d + R) / (2 tau R) + 1/2 = 2^(b-1) up to the rounding of the division, on
the boundary of the two middle codes, so an ulp of difference in the
radius flips every such coordinate at once.
That moves ``||agg||^2`` by up to 1% at b=2 (the adaptive run), so it is
not compared with the reference.  Within the port, the packed and float
wires give bitwise-equal parameters, losses, bits and ``||agg||^2``, and
all four ranks hold the same parameters.
"""
import os

import numpy as np
import pytest

import torch_dist_cases as C
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.defense import DefenseConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.core.strategy import StrategyConfig
from repro_torch.launch.mesh import WorkerGroup
from repro_torch.launch.train import make_train_step
from repro_torch.optim.optimizers import sgd

JAX_SIDE = r'''
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
from repro.core.strategy import StrategyConfig
from repro.launch.train import init_train_state, make_train_step
from repro.models import init_params
from repro.optim import sgd

# jax.make_mesh gives Explicit axes on jax 0.9, under which the embedding
# gather of models/stack.py raises; a Mesh of Auto axes runs the step
mesh = Mesh(np.array(jax.devices()).reshape(C.TRAIN_W, 1), ("data", "model"))
out = {}
for config in C.TRAIN_CONFIGS + C.TRAIN_DEFENDED:
    arch = C.TRAIN_ARCHS.get(config, "stablelm-1.6b")
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
             if config == "packed_adaptive" else None)
    extra = (dict(C.TRAIN_PARTICIPATION,
                  defense=DefenseConfig(**C.TRAIN_DEFENSE))
             if config in C.TRAIN_DEFENDED else {})
    strat = StrategyConfig(**C.TRAIN_STRATEGY, bit_schedule=sched,
                           criterion=CriterionConfig(**C.TRAIN_CRITERIA.get(
                               config, C.TRAIN_CRITERION)),
                           eta_schedule=EtaSchedule(**C.TRAIN_ETA), **extra)
    opt = sgd()
    state = init_train_state(jax.random.PRNGKey(0), cfg, mesh, strat, opt,
                             ("data",))
    state = state._replace(params=jax.tree.map(jnp.asarray, params0),
                           opt_state=opt.init(params0))
    step = jax.jit(make_train_step(
        cfg, mesh, strat, opt, lr=C.TRAIN_LR, worker_axes=("data",),
        wire="float" if config.endswith("float") else "packed",
        microbatch=C.TRAIN_MICROBATCH))
    rec = {"loss": [], "uploads": [], "bits": [], "grad_sq": [],
           "bits_spent": [], "rejects": []}
    for _ in range(C.TRAIN_STEPS):
        state, met = step(state, batch)
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


LEAVES = {"moe_packed": 15, "hybrid_packed": 29}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_step"))
    jax_side = C.run_jax(JAX_SIDE, out)
    try:
        C.spawn_ranks("rank_train", C.TRAIN_W, out)
    finally:
        C.finish(jax_side, "the reference's sharded step")
    want = np.load(os.path.join(out, "train_jax.npz"))
    got = [np.load(os.path.join(out, f"train_{m}.npz"))
           for m in range(C.TRAIN_W)]
    return want, got


def _params(npz, config):
    pre = f"{config}/params/"
    return {k[len(pre):]: npz[k] for k in npz.files if k.startswith(pre)}


@pytest.mark.parametrize("config", C.TRAIN_CONFIGS)
def test_uploads_bits_and_widths_match_reference(runs, config):
    want, got = runs
    ups = want[f"{config}/uploads"]
    assert ups[0] == C.TRAIN_W
    assert any(0 < u < C.TRAIN_W for u in ups[1:]), ups
    for m, g in enumerate(got):
        np.testing.assert_array_equal(g[f"{config}/uploads"], ups)
        np.testing.assert_array_equal(g[f"{config}/bits"],
                                      want[f"{config}/bits"])
        np.testing.assert_array_equal(g[f"{config}/bits_spent"],
                                      want[f"{config}/bits_spent"][:, m])
        assert int(g[f"{config}/total_uploads"]) == int(
            want[f"{config}/total_uploads"])


def test_adaptive_workers_take_different_widths(runs):
    """Worker bits of the adaptive run's first step: 32 per radius + the
    width byte + b per coordinate, for more than one b."""
    want, _ = runs
    first = want["packed_adaptive/bits_spent"][0]
    assert len(set(first.tolist())) > 1, first


@pytest.mark.parametrize("config", C.TRAIN_CONFIGS)
def test_loss_and_params_match_reference(runs, config):
    want, got = runs
    np.testing.assert_allclose(got[0][f"{config}/loss"],
                               want[f"{config}/loss"], rtol=1e-4)
    w, g = _params(want, config), _params(got[0], config)
    assert w.keys() == g.keys()
    assert len(w) == LEAVES.get(config, 12)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=5e-4,
                                   err_msg=k)


def test_packed_and_float_wires_give_bitwise_equal_params(runs):
    _, got = runs
    for g in got:
        f, p = _params(g, "float"), _params(g, "packed")
        for k in f:
            np.testing.assert_array_equal(p[k], f[k], err_msg=k)
        for field in ("loss", "uploads", "bits", "grad_sq", "bits_spent"):
            np.testing.assert_array_equal(g[f"packed/{field}"],
                                          g[f"float/{field}"])


@pytest.mark.parametrize("config", C.TRAIN_CONFIGS)
def test_every_rank_holds_the_same_params(runs, config):
    _, got = runs
    first = _params(got[0], config)
    for g in got[1:]:
        for k, v in _params(g, config).items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("config", C.TRAIN_DEFENDED)
def test_participation_and_defense_match_reference(runs, config):
    """Bernoulli participation (p=0.5) with validation and the norm gate:
    each worker reads its slot of the cohort, and uploads, bits, every
    worker's bits and rejections equal the reference's; loss and
    parameters as above."""
    from repro_torch.core.engine import participation_mask
    want, got = runs
    strat = StrategyConfig(**C.TRAIN_PARTICIPATION)
    masks = [participation_mask(strat, k, C.TRAIN_W).numpy()
             for k in range(C.TRAIN_STEPS)]
    assert not all(m.all() for m in masks)       # a worker was absent
    ups = want[f"{config}/uploads"]
    assert ups[0] == masks[0].sum()
    for m, g in enumerate(got):
        for field in ("uploads", "bits"):
            np.testing.assert_array_equal(g[f"{config}/{field}"],
                                          want[f"{config}/{field}"])
        np.testing.assert_array_equal(g[f"{config}/bits_spent"],
                                      want[f"{config}/bits_spent"][:, m])
        np.testing.assert_array_equal(g[f"{config}/rejects"],
                                      want[f"{config}/rejects"][:, m])
        if not masks[0][m]:
            assert g[f"{config}/bits_spent"][0] == 0.0
    np.testing.assert_allclose(got[0][f"{config}/loss"],
                               want[f"{config}/loss"], rtol=1e-4)
    w, g = _params(want, config), _params(got[0], config)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=5e-4,
                                   err_msg=k)
    for other in got[1:]:
        for k, v in _params(other, config).items():
            np.testing.assert_array_equal(v, g[k], err_msg=k)


def test_defended_wires_give_bitwise_equal_params(runs):
    _, got = runs
    for g in got:
        f, p = _params(g, "defended_float"), _params(g, "defended_packed")
        for k in f:
            np.testing.assert_array_equal(p[k], f[k], err_msg=k)
        for field in ("loss", "uploads", "bits", "grad_sq", "bits_spent",
                      "rejects"):
            np.testing.assert_array_equal(g[f"defended_packed/{field}"],
                                          g[f"defended_float/{field}"])


# (make_train_step keywords, exception, message, id).  The first ten ids
# are the branches the sharded step lacked before participation and the
# defense were ported: "Participation" and the two "Robustness" cases are
# now the reference's own refusals (repro/launch/train.py), raised as
# ValueError with its reasons.
GATED = [
    (dict(strategy=dict(lazy_rule="lasg_wk")), NotImplementedError,
     "Lazy rules and SVRG", "Lazy rules and SVRG"),
    (dict(strategy=dict(grad_mode="svrg")), NotImplementedError,
     "Lazy rules and SVRG", "Lazy rules and SVRG"),
    (dict(strategy=dict(participation="delay", max_delay=2)), ValueError,
     "simulated-engine-only", "Participation"),
    (dict(strategy=dict(faults=FaultConfig(crash_p=0.1))), ValueError,
     "fault injection", "Robustness"),
    (dict(strategy=dict(aggregator="median")), ValueError,
     "trimmed_mean/median", "Robustness"),
    (dict(strategy=dict(compressor="topk")), NotImplementedError,
     "Sharded step: compressors and error feedback",
     "Sharded step: compressors and error feedback"),
    (dict(strategy=dict(error_feedback=True)), NotImplementedError,
     "Sharded step: compressors and error feedback",
     "Sharded step: compressors and error feedback"),
    (dict(hierarchical=True), NotImplementedError,
     "Pods and hierarchical workers", "Pods and hierarchical workers"),
    (dict(worker_axes=("pod", "data")), NotImplementedError,
     "Pods and hierarchical workers", "Pods and hierarchical workers"),
    (dict(model_parallel=2), NotImplementedError, "Tensor parallelism",
     "Tensor parallelism"),
    (dict(strategy=dict(participation="markov", participation_p=0.5)),
     ValueError, "simulated-engine-only", "markov"),
    (dict(strategy=dict(defense=DefenseConfig(clip_mult=4.0))), ValueError,
     "packed wire", "clip on the packed wire"),
    (dict(strategy=dict(faults=FaultConfig(corrupt_p=0.1,
                                           corrupt_kind="bitflip"))),
     ValueError, "fault injection", "bitflip"),
]


@pytest.mark.parametrize("kw,exc,match", [g[:3] for g in GATED],
                         ids=[g[3] for g in GATED])
def test_unported_branches_name_their_roadmap_item(kw, exc, match):
    """What the sharded step does not run raises: NotImplementedError
    naming the ROADMAP item of a branch not ported yet, ValueError with
    the reference's reason where the reference refuses it too."""
    cfg = smoke_config(get_config("stablelm-1.6b"))
    strat = StrategyConfig(kind="laq", bits=4, **kw.pop("strategy", {}))
    workers = WorkerGroup(None, 4, 0, "gloo")
    with pytest.raises(exc, match=match):
        make_train_step(cfg, workers, strat, sgd(), lr=1e-2, wire="packed",
                        **kw)


def test_the_float_wire_takes_the_clip():
    cfg = smoke_config(get_config("stablelm-1.6b"))
    strat = StrategyConfig(kind="laq", bits=4, participation="fixed_k",
                           participation_p=0.5,
                           defense=DefenseConfig(validate=True, gate_mult=4.0,
                                                 clip_mult=4.0))
    make_train_step(cfg, WorkerGroup(None, 4, 0, "gloo"), strat, sgd(),
                    lr=1e-2, wire="float")


@pytest.mark.parametrize("strategy,wire", [
    (dict(kind="gd"), "packed"), (dict(bits=1), "packed"),
    (dict(bits=4), "bytes")])
def test_invalid_wires_are_refused(strategy, wire):
    cfg = smoke_config(get_config("stablelm-1.6b"))
    with pytest.raises(ValueError):
        make_train_step(cfg, WorkerGroup(None, 4, 0, "gloo"),
                        StrategyConfig(**strategy), sgd(), lr=1e-2,
                        wire=wire)
