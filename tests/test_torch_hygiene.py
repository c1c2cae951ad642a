"""Port hygiene: the port imports no JAX and nothing of the JAX package, its
entry points refuse to fall back to the CPU on their own, and the kernel
wrappers refuse operands the CUDA kernels cannot take."""
import ast
import pathlib

import pytest
import torch

from repro_torch import random
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.simulated import run_stochastic
from repro_torch.data.synthetic import lm_worker_corpus
from repro_torch.kernels import ops
from repro_torch.models.model import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "benchmarks_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py"])


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_file_imports_no_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = smoke_config(get_config("stablelm-1.6b"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        lm_worker_corpus(0, 2, 2, 8, cfg.vocab)
    assert init_params(0, cfg, device="cpu")["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        random.PRNGKey(0)
    with pytest.raises(RuntimeError, match="cuda"):
        random.uniform(random.PRNGKey(0), (3,))
    assert random.uniform(random.PRNGKey(0, device="cpu"),
                          (3,)).device.type == "cpu"

    def loss(params, data):
        x, y = data
        return torch.sum(torch.square(x @ params["w"] - y))

    data = (torch.ones(2, 4, 3), torch.zeros(2, 4))
    kw = dict(steps=2, alpha=0.1, batch=2)
    with pytest.raises(RuntimeError, match="cuda"):
        run_stochastic(loss, {"w": torch.zeros(3)}, data, "qsgd", **kw)
    res = run_stochastic(loss, {"w": torch.zeros(3)}, data, "qsgd",
                         device="cpu", **kw)
    assert res.params["w"].device.type == "cpu"


def test_kernel_wrappers_refuse_bad_operands():
    g = torch.zeros(16, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ops.absmax(g, g)
    f = torch.zeros(16)
    with pytest.raises(ValueError, match="elements"):
        ops.absmax(f, torch.zeros(8))
    with pytest.raises(ValueError, match="R must be"):
        ops.quantize_pack_fused(f, f, torch.zeros(2), 8)
    with pytest.raises(ValueError, match="bits"):
        ops.quantize_pack_fused(f, f, torch.zeros(()), 3)
    meta = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.absmax(meta, meta)


def test_port_files_cover_the_new_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/optim/optimizers.py",
                 "benchmarks_torch/bits_sweep.py",
                 "src/repro_torch/core/faults.py",
                 "src/repro_torch/core/defense.py",
                 "src/repro_torch/checkpoint/ckpt.py",
                 "src/repro_torch/core/replica.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/publish.py",
                 "benchmarks_torch/serve_frontier.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/configs/qwen3_8b.py",
                 "src/repro_torch/configs/yi_6b.py",
                 "src/repro_torch/configs/yi_9b.py",
                 "src/repro_torch/configs/chameleon_34b.py",
                 "src/repro_torch/configs/musicgen_medium.py",
                 "src/repro_torch/configs/qwen3_moe_30b_a3b.py",
                 "src/repro_torch/configs/phi3p5_moe_42b.py",
                 "src/repro_torch/models/mamba2.py",
                 "src/repro_torch/configs/mamba2_130m.py",
                 "src/repro_torch/configs/zamba2_2p7b.py",
                 "benchmarks_torch/common.py",
                 "benchmarks_torch/tables.py",
                 "benchmarks_torch/table2_gradient.py",
                 "benchmarks_torch/table3_stochastic.py"):
        assert want in names, want


def test_moe_entry_points_refuse_a_missing_card():
    """A MoE model's parameters and cache live on the card unless told
    ``device="cpu"``; its loss runs where its parameters are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.models.model import init_cache, lm_loss
    cfg = smoke_config(get_config("qwen3-moe-30b-a3b"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 1, 8)
    params = init_params(0, cfg, device="cpu")
    assert params["blocks"]["moe"]["w_gate"].device.type == "cpu"
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    loss = lm_loss(params, {"tokens": tokens, "targets": tokens}, cfg)
    assert loss.device.type == "cpu"


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_mamba_entry_points_refuse_a_missing_card(arch):
    """A Mamba2 model's parameters, its caches and ``lm_batches`` live on
    the card unless told ``device="cpu"``; its loss and prefill run where
    its parameters are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.mamba2 import init_mamba_cache
    from repro_torch.models.model import init_cache, lm_loss, prefill
    cfg = smoke_config(get_config(arch))
    for fn in (lambda: init_params(0, cfg), lambda: init_cache(cfg, 1, 8),
               lambda: init_mamba_cache(cfg, 1, cfg.n_layers),
               lambda: lm_batches(0, 1, 8, cfg.vocab)):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
    params = init_params(0, cfg, device="cpu")
    assert params["blocks"]["mamba"]["w_x"].device.type == "cpu"
    tokens = next(lm_batches(0, 1, 8, cfg.vocab, device="cpu"))["tokens"]
    loss = lm_loss(params, {"tokens": tokens, "targets": tokens}, cfg)
    assert loss.device.type == "cpu"
    _, cache = prefill(params, tokens, cfg, 12)
    assert cache["mamba"]["ssm"].device.type == "cpu"


def test_serving_entry_points_refuse_a_missing_card():
    """The cache, the publisher's trainer and the serving benchmark live on
    the card unless told ``device="cpu"``; prefill, decode, the publisher
    and the replicas run where their parameters are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from benchmarks_torch import serve_frontier
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    from repro_torch.core.replica import (PublishConfig, init_publisher,
                                          init_replica, publish)
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.launch.publish import trainer_rounds
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.models.model import init_cache, prefill

    cfg = smoke_config(get_config("stablelm-1.6b"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        init_kv_cache(cfg, 1, 8, cfg.n_layers)
    assert init_cache(cfg, 1, 8, device="cpu")["attn"]["k"].device.type == "cpu"
    params = init_params(0, cfg, device="cpu")
    _, cache = prefill(params, torch.zeros((1, 4), dtype=torch.int64), cfg, 8)
    assert cache["attn"]["k"].device.type == "cpu"

    def loss(params, data):
        return torch.sum(torch.square(params["x"] - data))

    engine = RoundEngine(FullBatchSource(loss, torch.ones(2, 3)),
                         StrategyConfig(kind="laq", bits=4), alpha=0.1)
    p0 = {"x": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="cuda"):
        next(trainer_rounds(engine, p0, 1))
    p1 = next(trainer_rounds(engine, p0, 1, device="cpu"))
    pcfg = PublishConfig(wire_backend="fused")
    msg, st = publish(pcfg, init_publisher(p0, pcfg), p1)
    assert st.theta_pub["x"].device.type == "cpu" and msg is not None
    assert init_replica(p1).params["x"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        serve_frontier.run(tiny=True)
    assert serve_frontier.main(["--tiny"]) == 1


def test_benchmark_and_chip_script_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib.util

    from benchmarks_torch import bits_sweep
    with pytest.raises(RuntimeError, match="CUDA"):
        bits_sweep.run()
    assert bits_sweep.main() == 1
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() == 1


def test_sharded_step_runs_where_its_parameters_are():
    """The sharded step has no device of its own: its state lives where
    the caller's parameters do, and init_params refuses a missing card."""
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.launch.mesh import WorkerGroup
    from repro_torch.launch.train import init_train_state
    from repro_torch.optim.optimizers import sgd
    cfg = smoke_config(get_config("stablelm-1.6b"))
    state = init_train_state(init_params(0, cfg, device="cpu"),
                             WorkerGroup(None, 1, 0, "gloo"),
                             StrategyConfig(kind="laq", bits=4), sgd())
    assert state.comm.qhat[0]["embed"].device.type == "cpu"
    assert WorkerGroup(None, 4, 0, "gloo").transport("cuda") == (
        "gloo, staged through pinned host memory")
    assert WorkerGroup(None, 1, 0, "nccl").transport("cuda") == "nccl"


def test_engine_and_watchdog_refuse_a_missing_card(tmp_path):
    """``RoundEngine`` and ``run_with_watchdog`` put their carry on the card
    unless told ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.defense import WatchdogConfig, run_with_watchdog
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    from repro_torch.core.strategy import StrategyConfig

    def loss(params, data):
        return torch.sum(torch.square(params["x"] - data))

    engine = RoundEngine(FullBatchSource(loss, torch.ones(2, 3)),
                         StrategyConfig(kind="laq", bits=4), alpha=0.1)
    p0 = {"x": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="cuda"):
        engine.init_carry(p0)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.run(p0, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        run_with_watchdog(engine, p0, 2, ckpt_path=str(tmp_path / "a.npz"))
    res, log, _ = run_with_watchdog(engine, p0, 2,
                                    ckpt_path=str(tmp_path / "b.npz"),
                                    wd=WatchdogConfig(chunk=1), device="cpu")
    assert log["rollbacks"] == [] and res.loss.shape == (2,)
