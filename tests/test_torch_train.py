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
slack) keeps some workers and not others after step 1.  Three
configurations of 3 steps: the float wire, the packed wire at b=4 and the
packed wire with the adaptive schedule on the grid (2, 4, 8), whose
absolute thresholds give the workers different widths.  All run
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
from repro.core.strategy import StrategyConfig
from repro.launch.train import init_train_state, make_train_step
from repro.models import init_params
from repro.optim import sgd

cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                          param_dtype=jnp.float32, compute_dtype=jnp.float32)
# jax.make_mesh gives Explicit axes on jax 0.9, under which the embedding
# gather of models/stack.py raises; a Mesh of Auto axes runs the step
mesh = Mesh(np.array(jax.devices()).reshape(C.TRAIN_W, 1), ("data", "model"))
abstract = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
names = {jax.tree_util.keystr(p, simple=True, separator="."): l.shape
         for p, l in jax.tree_util.tree_flatten_with_path(abstract)[0]}
params0 = C.numpy_params(names)
batch = jax.device_put({k: jnp.asarray(v, jnp.int32)
                        for k, v in C.train_batch(cfg.vocab).items()},
                       NamedSharding(mesh, P("data", None)))
out = {}
for config in C.TRAIN_CONFIGS:
    sched = (BitSchedule(kind="radius", grid=C.GRID,
                         thresholds=C.TRAIN_THRESHOLDS)
             if config == "packed_adaptive" else None)
    strat = StrategyConfig(**C.TRAIN_STRATEGY, bit_schedule=sched,
                           criterion=CriterionConfig(**C.TRAIN_CRITERION),
                           eta_schedule=EtaSchedule(**C.TRAIN_ETA))
    opt = sgd()
    state = init_train_state(jax.random.PRNGKey(0), cfg, mesh, strat, opt,
                             ("data",))
    state = state._replace(params=jax.tree.map(jnp.asarray, params0),
                           opt_state=opt.init(params0))
    step = jax.jit(make_train_step(
        cfg, mesh, strat, opt, lr=C.TRAIN_LR, worker_axes=("data",),
        wire="float" if config == "float" else "packed",
        microbatch=C.TRAIN_MICROBATCH))
    rec = {"loss": [], "uploads": [], "bits": [], "grad_sq": [],
           "bits_spent": []}
    for _ in range(C.TRAIN_STEPS):
        state, met = step(state, batch)
        rec["loss"].append(float(met.loss))
        rec["uploads"].append(int(met.uploads))
        rec["bits"].append(float(met.bits))
        rec["grad_sq"].append(float(met.grad_sq))
        rec["bits_spent"].append(np.asarray(state.comm.bits_spent))
    for k, v in rec.items():
        out[f"{config}/{k}"] = np.asarray(v)
    out[f"{config}/total_uploads"] = np.asarray(state.comm.total_uploads)
    for k, v in C.flat_names(jax.tree.map(np.asarray, state.params)).items():
        out[f"{config}/params/{k}"] = v
np.savez(os.path.join(os.environ["OUT"], "train_jax.npz"), **out)
'''


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
    assert w.keys() == g.keys() and len(w) == 12
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


GATED = [
    (dict(strategy=dict(lazy_rule="lasg_wk")), "Lazy rules and SVRG"),
    (dict(strategy=dict(grad_mode="svrg")), "Lazy rules and SVRG"),
    (dict(strategy=dict(participation="bernoulli")), "Participation"),
    (dict(strategy=dict(defense=object())), "Robustness"),
    (dict(strategy=dict(aggregator="median")), "Robustness"),
    (dict(strategy=dict(compressor="topk")),
     "Sharded step: compressors and error feedback"),
    (dict(strategy=dict(error_feedback=True)),
     "Sharded step: compressors and error feedback"),
    (dict(hierarchical=True), "Pods and hierarchical workers"),
    (dict(worker_axes=("pod", "data")), "Pods and hierarchical workers"),
    (dict(model_parallel=2), "Tensor parallelism"),
]


@pytest.mark.parametrize("kw,item", GATED, ids=[i for _, i in GATED])
def test_unported_branches_name_their_roadmap_item(kw, item):
    cfg = smoke_config(get_config("stablelm-1.6b"))
    strat = StrategyConfig(kind="laq", bits=4, **kw.pop("strategy", {}))
    workers = WorkerGroup(None, 4, 0, "gloo")
    with pytest.raises(NotImplementedError, match=item):
        make_train_step(cfg, workers, strat, sgd(), lr=1e-2, wire="packed",
                        **kw)


@pytest.mark.parametrize("strategy,wire", [
    (dict(kind="gd"), "packed"), (dict(bits=1), "packed"),
    (dict(bits=4), "bytes")])
def test_invalid_wires_are_refused(strategy, wire):
    cfg = smoke_config(get_config("stablelm-1.6b"))
    with pytest.raises(ValueError):
        make_train_step(cfg, WorkerGroup(None, 4, 0, "gloo"),
                        StrategyConfig(**strategy), sgd(), lr=1e-2,
                        wire=wire)
