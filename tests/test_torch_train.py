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
slack, or the configuration's own in ``torch_dist_cases.TRAIN_CRITERIA``)
keeps some workers and not others after step 1.  The configurations
(``torch_dist_cases``), 3 steps each, are split into four groups, each
run by its own reference subprocess and its own four ranks in its own
file, so that the tier-1 run puts them on different workers:

- this file (``TRAIN_BASE``): the float wire, the packed wire at b=4, the
  packed wire with the adaptive schedule on the grid (2, 4, 8), whose
  absolute thresholds give the workers different widths, and the packed
  wire at b=4 on smoke qwen3-moe-30b-a3b (15 leaves; its router's aux
  enters the loss and the gradient through ``lm_loss``) and on smoke
  zamba2-2.7b (29 leaves: the Mamba2 blocks and the shared attention
  block);
- ``test_torch_train_lazy.py`` (``TRAIN_RULES``): the lazy rules and
  SVRG, and the compressors with error feedback on the float wire;
- ``test_torch_train_bf16.py`` (``TRAIN_BF16``): five of these again with
  ``qhat`` and ``server_agg`` stored in bfloat16;
- ``test_torch_train_defended.py`` (``TRAIN_DEFENDED``): both wires with
  bernoulli participation and the defense.

All run ``microbatch=2`` and the 1/t stepsize.  The reference's state is
built around the test's parameters (``init_comm_state``): lasg_ps and
lasg_wk2 snapshot the initial iterate, SVRG anchors at it.

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
from torch_threads import one_thread  # noqa: F401

CONFIGS = C.TRAIN_BASE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.run_train(str(tmp_path_factory.mktemp("sharded_step")), CONFIGS)


@pytest.mark.parametrize("config", CONFIGS)
def test_uploads_bits_and_widths_match_reference(runs, config):
    C.check_uploads_bits_and_widths(runs, config)


def test_adaptive_workers_take_different_widths(runs):
    """Worker bits of the adaptive run's first step: 32 per radius + the
    width byte + b per coordinate, for more than one b."""
    want, _ = runs
    first = want["packed_adaptive/bits_spent"][0]
    assert len(set(first.tolist())) > 1, first


@pytest.mark.parametrize("config", CONFIGS)
def test_loss_and_params_match_reference(runs, config):
    C.check_loss_and_params(runs, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_state_dtypes_after_every_step(runs, config):
    C.check_state_dtypes(runs, config)


def test_packed_and_float_wires_give_bitwise_equal_params(runs):
    _, got = runs
    C.check_wires_bitwise(got, "float", "packed",
                          ("loss", "uploads", "bits", "grad_sq",
                           "bits_spent"))


@pytest.mark.parametrize("config", CONFIGS)
def test_every_rank_holds_the_same_params(runs, config):
    C.check_every_rank_holds_the_same_params(runs, config)


# (make_train_step keywords, exception or None, message, id).  The ids
# name the branches the sharded step lacked before participation, the
# defense, the lazy rules, SVRG, the compressors and bfloat16 state were
# ported (``RoundEngine`` refuses bfloat16 state, as the reference's
# engine cannot run it: ``test_torch_faults.py``):
# "Participation", the two "Robustness" cases and the two compressor cases
# are now the reference's own refusals (repro/launch/train.py), raised as
# ValueError with its reasons; the two "Lazy rules and SVRG" cases and
# "state_bf16" build a step (exception None).
GATED = [
    (dict(strategy=dict(lazy_rule="lasg_wk2")), None, None,
     "Lazy rules and SVRG"),
    (dict(strategy=dict(grad_mode="svrg")), None, None,
     "Lazy rules and SVRG"),
    (dict(strategy=dict(participation="delay", max_delay=2)), ValueError,
     "simulated-engine-only", "Participation"),
    (dict(strategy=dict(faults=FaultConfig(crash_p=0.1))), ValueError,
     "fault injection", "Robustness"),
    (dict(strategy=dict(aggregator="median")), ValueError,
     "trimmed_mean/median", "Robustness"),
    (dict(strategy=dict(compressor="topk")), ValueError,
     "require wire='float'", "Sharded step: compressors and error feedback"),
    (dict(strategy=dict(error_feedback=True)), ValueError,
     "require wire='float'", "Sharded step: compressors and error feedback"),
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
    (dict(strategy=dict(state_bf16=True)), None, None, "state_bf16"),
]


@pytest.mark.parametrize("kw,exc,match", [g[:3] for g in GATED],
                         ids=[g[3] for g in GATED])
def test_unported_branches_name_their_roadmap_item(kw, exc, match):
    """What the sharded step does not run raises: NotImplementedError
    naming the ROADMAP item of a branch not ported yet, ValueError with
    the reference's reason where the reference refuses it too.  A branch
    ported since builds its step on the packed wire."""
    cfg = smoke_config(get_config("stablelm-1.6b"))
    strat = StrategyConfig(kind="laq", bits=4, **kw.pop("strategy", {}))
    workers = WorkerGroup(None, 4, 0, "gloo")
    if exc is None:
        make_train_step(cfg, workers, strat, sgd(), lr=1e-2, wire="packed",
                        **kw)
        return
    with pytest.raises(exc, match=match):
        make_train_step(cfg, workers, strat, sgd(), lr=1e-2, wire="packed",
                        **kw)


@pytest.mark.parametrize("strategy", [
    dict(compressor="topk"), dict(compressor="randk"),
    dict(compressor="topk", error_feedback=True),
    dict(compressor="randk", error_feedback=True),
    dict(error_feedback=True)], ids=["topk", "randk", "ef_topk", "ef_randk",
                                     "ef"])
def test_the_float_wire_takes_the_compressors(strategy):
    cfg = smoke_config(get_config("stablelm-1.6b"))
    make_train_step(cfg, WorkerGroup(None, 4, 0, "gloo"),
                    StrategyConfig(kind="laq", bits=4, **strategy), sgd(),
                    lr=1e-2, wire="float")


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


def _planted(rng, n=4000):
    """float32 normals with a quarter of the entries replaced by +-0,
    +-inf, NaN and two finite values."""
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.25],
                       np.float32)
    a = rng.standard_normal(n).astype(np.float32)
    idx = rng.integers(0, n, n // 4)
    a[idx] = special[rng.integers(0, len(special), len(idx))]
    return a


@pytest.mark.parametrize("step,period,mu_unset", [
    (0, 2, False), (1, 2, False), (2, 2, False), (3, 5, False),
    (0, 3, True)], ids=["refresh", "hold", "refresh_again", "hold_period5",
                        "first_refresh_mu_unset"])
def test_apply_svrg_streaming_matches_jitted_reference(step, period,
                                                       mu_unset):
    """The streaming SVRG stage against the reference's under jax.jit, with
    -0, +-inf and NaN planted in the parameters, the anchor, the gradient
    and mu, at refresh 1 and 0 (and at the first refresh with mu unset,
    the reference's zeros).  The anchor gradient is ``theta * 0.5 + ga``.
    Every output is bitwise equal where neither side is NaN, and NaN at
    the same entries: the sign of a NaN that two NaNs or ``0 * inf`` make
    is the platform's choice.  The refresh is arithmetic, so a select
    (``p if r else t``) differs from the reference on these inputs."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core.engine import apply_svrg_streaming as ref_svrg
    from repro.core.strategy import StrategyConfig as RefStrategy
    from repro.core.strategy import SvrgState as RefSvrg
    from repro_torch.core.engine import apply_svrg_streaming
    from repro_torch.core.strategy import SvrgState

    rng = np.random.default_rng(11 + step + 7 * period)
    p, t, g, m, ga = (_planted(rng) for _ in range(5))
    if mu_unset:
        m = np.zeros_like(m)

    def ref(p, t, m, g, k):
        return ref_svrg(RefSvrg({"w": t}, {"w": m}), {"w": p}, {"w": g},
                        lambda th: {"w": th["w"] * 0.5 + ga}, k,
                        RefStrategy(grad_mode="svrg", svrg_period=period))

    want_g, want_c, want_sv = jax.jit(ref)(p, t, m, g, jnp.int32(step))
    tt = lambda a: torch.from_numpy(a.copy())
    got_g, got_c, got_sv = apply_svrg_streaming(
        SvrgState({"w": tt(t)}, None if mu_unset else {"w": tt(m)}),
        {"w": tt(p)}, {"w": tt(g)},
        lambda th: {"w": th["w"] * 0.5 + tt(ga)}, step,
        StrategyConfig(grad_mode="svrg", svrg_period=period))
    for name, w, gt in (("grads", want_g, got_g), ("corr", want_c, got_c),
                        ("theta_anchor", want_sv.theta_anchor,
                         got_sv.theta_anchor),
                        ("mu_anchor", want_sv.mu_anchor, got_sv.mu_anchor)):
        w, gt = np.asarray(w["w"]), gt["w"].numpy()
        np.testing.assert_array_equal(np.isnan(gt), np.isnan(w),
                                      err_msg=name)
        ok = ~np.isnan(w)
        np.testing.assert_array_equal(gt[ok].view(np.uint32),
                                      w[ok].view(np.uint32), err_msg=name)
    r = step % period == 0
    select = np.where(r, p, t)
    want_anchor = np.asarray(want_sv.theta_anchor["w"])
    assert (select.view(np.uint32) != want_anchor.view(np.uint32)).any()


@pytest.mark.parametrize("strategy", [dict(lazy_rule="lasg_wk2"),
                                      dict(grad_mode="svrg")],
                         ids=["lasg_wk2", "svrg"])
def test_reference_refuses_float32_iterates_of_a_bf16_model(strategy):
    """lasg_wk2's stale iterate and SVRG's anchor are float32 trees, and
    the reference takes a gradient there under the model's compute dtype:
    with bfloat16 params its layer scan refuses the carry, which the
    activations' promotion to float32 changes.  So the card's bfloat16
    runs of these strategies have no oracle, and the CPU comparisons above
    hold float32 models.  (The port's ``layers.linear`` casts the weight
    to the activations' dtype and runs them.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config as ref_config
    from repro.configs import smoke_config as ref_smoke
    from repro.core.strategy import StrategyConfig as RefStrategy
    from repro.launch.train import init_train_state as ref_init
    from repro.launch.train import make_train_step as ref_step
    from repro.optim import sgd as ref_sgd

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cfg = ref_smoke(ref_config("stablelm-1.6b"))     # bfloat16 params
    assert cfg.param_dtype == jnp.bfloat16
    strat = RefStrategy(kind="laq", bits=4, **strategy)
    state = ref_init(jax.random.PRNGKey(0), cfg, mesh, strat, ref_sgd(),
                     ("data",))
    tok = jnp.zeros((2, C.TRAIN_SEQ + 1), jnp.int32)
    step = jax.jit(ref_step(cfg, mesh, strat, ref_sgd(), lr=C.TRAIN_LR,
                            worker_axes=("data",), wire="float"))
    with pytest.raises(TypeError, match="carry"):
        step(state, {"tokens": tok[:, :-1], "targets": tok[:, 1:]})


def _bf16_planted(rng, n=2048):
    """float32 normals with a quarter of them on bfloat16 rounding ties
    (low half 0x8000, under odd and even upper halves), and +-0, +-inf,
    NaN, float32 subnormals, bfloat16 subnormals and a subnormal tie
    planted."""
    a = rng.standard_normal(n).astype(np.float32)
    u = a.view(np.uint32)
    tie = rng.choice(n, n // 4, replace=False)
    u[tie] = (u[tie] & 0xFFFF0000) | 0x8000
    special = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0x00000001, 0x80012345, 0x00010000,
                        0x00018000, 0x80038000, 0x00007FFF],
                       np.uint32).view(np.float32)
    a[rng.choice(n, 100, replace=False)] = special[rng.integers(0, 11, 100)]
    return a


def _bits_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(np.isnan(got.astype(np.float32)),
                                  np.isnan(want.astype(np.float32)),
                                  err_msg=what)
    ok = ~np.isnan(want.astype(np.float32))
    view = np.uint16 if got.itemsize == 2 else np.uint32
    np.testing.assert_array_equal(got.view(view)[ok], want.view(view)[ok],
                                  err_msg=what)


@pytest.mark.parametrize("kind,backend,opt", [("gd", "reference", "sgd"),
                                              ("laq", "reference", "sgd"),
                                              ("laq", "fused", "sgd"),
                                              ("laq", "fused", "momentum")])
def test_bf16_state_commit_and_server_recursion_match_jitted_reference(
        kind, backend, opt):
    """One forced upload (``worker_update``) with a bfloat16 ``qhat`` and
    the server recursion with a bfloat16 ``server_agg``, against the
    reference's under ``jax.jit``, bit for bit: ``qhat_new`` (bfloat16,
    ``q_new`` rounded to nearest even), the float32 ``agg =
    f32(server_agg) + delta`` that the optimizer reads, the stored
    ``agg_store`` and the update (sgd, and momentum, which has a
    state).  The planted values put ``q_new``
    (the dense kind sends ``q_new = g``), ``agg`` and the stored copies on
    ties, +-0, +-inf, NaN and subnormals; the quantized kind takes finite
    gradients, whose radius is finite.  NaN is compared as NaN: its
    payload is the platform's."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core.strategy import StrategyConfig as RefStrategy
    from repro.core.strategy import worker_update as ref_update
    from repro import optim as ref_optim
    from repro_torch.core.strategy import worker_update
    from repro_torch.launch.train import _server_update
    from repro_torch.optim import optimizers as optim

    rng = np.random.default_rng({"gd": 1, "laq": 2}[kind]
                                + (backend == "fused") + (opt != "sgd"))
    g, sa = _bf16_planted(rng), _bf16_planted(rng)
    # normal parameters: XLA's CPU update flushes a subnormal parameter
    p = rng.standard_normal(g.size).astype(np.float32)
    if kind != "gd":
        g = np.where(np.isfinite(g), g, np.float32(0.5))
    qh = _bf16_planted(rng)
    qh = np.where(np.isfinite(qh), qh, np.float32(-1.0)) if kind != "gd" \
        else qh
    qh16 = np.asarray(jnp.asarray(qh).astype(jnp.bfloat16))
    sa16 = np.asarray(jnp.asarray(sa).astype(jnp.bfloat16))
    lr, t_bar = 0.1, 100
    common = dict(kind=kind, bits=4, wire_backend=backend, state_bf16=True)

    def ref(g, qh, sa, p):
        wu = ref_update({"w": g}, {"w": qh}, jnp.float32(0.0),
                        jnp.int32(t_bar), jnp.float32(0.0),
                        jnp.zeros(10, jnp.float32), lr, 1,
                        RefStrategy(**common), step=jnp.int32(0))
        agg = sa.astype(jnp.float32) + wu.delta_masked["w"]
        o = getattr(ref_optim, opt)()
        new_p, _ = o.update({"w": agg}, o.init({"w": p}), {"w": p}, lr)
        return wu.qhat_new["w"], agg, agg.astype(sa.dtype), new_p["w"]

    want = jax.jit(ref)(g, qh16, sa16, p)
    tt = lambda a: torch.from_numpy(np.array(a))
    to16 = lambda a: tt(a.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)
    wo = worker_update({"w": tt(g)}, {"w": to16(qh16)}, torch.zeros(()),
                       t_bar, torch.zeros(10), lr, 1,
                       StrategyConfig(**common), step=0)
    assert wo.committed
    delta, server = wo.delta_masked, {"w": to16(sa16)}
    o = getattr(optim, opt)()
    new_p, _, _ = _server_update(o, server, [delta], o.init({"w": tt(p)}),
                                 {"w": tt(p)}, lr)
    b16 = lambda t: t.view(torch.int16).numpy().view(np.uint16)
    for what, got, w in (("qhat_new", b16(wo.qhat_new["w"]), want[0]),
                         ("agg", delta["w"].numpy(), want[1]),
                         ("agg_store", b16(server["w"]), want[2]),
                         ("params", new_p["w"].numpy(), want[3])):
        w = np.asarray(w)
        if w.dtype != np.float32:
            w = w.view(np.uint16)
            _bits_equal(got.view(np.float16), w.view(np.float16), what)
        else:
            _bits_equal(got, w, what)
