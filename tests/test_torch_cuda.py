"""The hand-written CUDA wire kernels against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These are small, quick cases (the first call builds the kernels with
``nvcc``); ``chip_smoke.py`` holds the kernels at the model's own leaf
shapes.  Kernels 5, 6, 3 and 8 (``quantize_codes_fused``,
``quantize_codes_adaptive``, ``quantize_pack``, ``dequant_acc``) are
bitwise throughout, kernel 8 in the Pallas kernel's order (acc first);
the sharded step runs on one NCCL worker, and the participation and
robustness layer runs on the card against the CPU (uploads, bits and
rejections equal; the watchdog's log equal; a checkpoint resume equal to
the unbroken run).  R, codes, packed bytes, delta and q_new are bitwise; the moments
agree to rtol 1e-5, because the kernel sums per thread in float64 and the
plain version reduces in float32.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda

LENGTHS = {"empty": (0, 0), "one": (1, 0), "seven": (7, 0),
           "ragged": (3 * 4096 + 1239, 0), "unaligned": (100_003, 1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(dev, n, shift, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    g = torch.randn(n + shift, generator=gen, device=dev) * 1e-3
    qh = g + torch.randn(n + shift, generator=gen, device=dev) * 1e-4
    return g[shift:], qh[shift:]        # shift=1: operands off 16-byte alignment


def _check_against_plain(g, qh, bits):
    before = (ops.absmax.launches, ops.quantize_pack_fused.launches)
    R = ops.absmax(g, qh)
    got = ops.quantize_pack_fused(g, qh, R, bits)
    torch.cuda.synchronize()
    assert (ops.absmax.launches, ops.quantize_pack_fused.launches) == (
        before[0] + 1, before[1] + 1)
    R_ref = ref.absmax_ref(g, qh)
    assert torch.equal(R, R_ref) or (R.isnan() and R_ref.isnan())
    want = ref.quantize_pack_fused_ref(g, qh, R, bits)
    for name, a, b in zip(("packed", "delta", "q_new"), got[:3], want[:3]):
        assert a.shape == b.shape and torch.equal(a, b), name
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, equal_nan=True)
    return R, got


@pytest.mark.parametrize("case", LENGTHS)
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_kernels_match_plain_versions(cuda, bits, case):
    n, shift = LENGTHS[case]
    g, qh = _pair(cuda, n, shift, seed=bits * 31 + n)
    _check_against_plain(g, qh, bits)


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_zero_radius_sends_midpoint_codes(cuda, bits):
    g, _ = _pair(cuda, 4096 + 5, 0, seed=bits)
    R, (packed, delta, q_new, _, inn) = _check_against_plain(g, g.clone(), bits)
    assert float(R) == 0.0 and not delta.any() and float(inn) == 0.0
    assert torch.equal(q_new, g)
    mid = 2 ** (bits - 1)
    byte = sum(mid << (bits * j) for j in range(8 // bits))
    assert bool((packed == byte).all())


def test_nan_radius_propagates(cuda):
    g, qh = _pair(cuda, 50_000, 0, seed=3)
    g[12_345] = float("nan")
    R, (_, delta, q_new, err, _) = _check_against_plain(g, qh, 8)
    assert R.isnan() and not delta.any() and err.isnan()
    assert torch.equal(q_new, qh)


def test_non_contiguous_operand_is_refused(cuda):
    g = torch.zeros(64, 2, device=cuda)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        ops.absmax(g, g)


def _adaptive_check(g, qh, grid, sel):
    before = ops.quantize_pack_adaptive.launches
    R = ops.absmax(g, qh)
    onehot = torch.eye(len(grid))[sel]
    got = ops.quantize_pack_adaptive(g, qh, R, onehot, grid)
    torch.cuda.synchronize()
    assert ops.quantize_pack_adaptive.launches == before + 1
    want = ref.quantize_pack_adaptive_ref(g, qh, R, grid, sel)
    for name, a, b in zip(("packed", "delta", "q_new"), got[:3], want[:3]):
        assert a.shape == b.shape and torch.equal(a, b), name
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, equal_nan=True)
    return R, got


@pytest.mark.parametrize("case", LENGTHS)
@pytest.mark.parametrize("grid,sel", [((2, 4, 8), 0), ((2, 4, 8), 1),
                                      ((2, 4, 8), 2), ((2, 4), 0),
                                      ((2, 4), 1), ((4,), 0)])
def test_adaptive_kernel_matches_plain_version(cuda, grid, sel, case):
    n, shift = LENGTHS[case]
    g, qh = _pair(cuda, n, shift, seed=7 * sel + n)
    R, got = _adaptive_check(g, qh, grid, sel)
    fixed = ops.quantize_pack_fused(g, qh, R, grid[sel])
    for a, b in zip(got[1:], fixed[1:]):    # a pinned width is kernel 2
        assert torch.equal(a, b)
    if grid[sel] == max(grid):
        assert torch.equal(got[0], fixed[0])


def test_adaptive_kernel_zero_radius_and_nan(cuda):
    g, _ = _pair(cuda, 4096 + 5, 0, seed=1)
    R, (packed, delta, q_new, _, _) = _adaptive_check(g, g.clone(), (2, 4), 0)
    assert float(R) == 0.0 and not delta.any() and torch.equal(q_new, g)
    assert bool((packed == (2 | 2 << 4)).all())     # midpoint 2 in 4-bit lanes
    g, qh = _pair(cuda, 50_000, 0, seed=3)
    g[777] = float("nan")
    R, (_, delta, q_new, err, _) = _adaptive_check(g, qh, (2, 4, 8), 1)
    assert R.isnan() and not delta.any() and err.isnan()


SPARSE_LENGTHS = {"empty": (0, 0), "seven": (7, 0), "ragged": (3 * 4096 + 1239, 0),
                  "unaligned": (100_003, 1)}


def _sparse_check(v, lo, hi, bits):
    before = ops.sparse_quantize_pack.launches
    got = ops.sparse_quantize_pack(v, lo, hi, bits)
    torch.cuda.synchronize()
    assert ops.sparse_quantize_pack.launches == before + 1
    want = ref.sparse_quantize_pack_ref(v, lo, hi, bits)
    for name, a, b in zip(("packed", "codes", "deq"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    return got


@pytest.mark.parametrize("case", SPARSE_LENGTHS)
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_sparse_kernel_matches_plain_version(cuda, bits, case):
    from repro_torch.core.compressors import sparse_grid
    n, shift = SPARSE_LENGTHS[case]
    v, _ = _pair(cuda, n, shift, seed=bits + n)
    lo, hi = sparse_grid(v, bits)
    _sparse_check(v, lo, hi, bits)


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_sparse_kernel_edge_grids(cuda, bits):
    v, _ = _pair(cuda, 20_000, 0, seed=bits)
    same = torch.where(v < 0, -1.0, 1.0) * 2e-3          # lo == hi
    lo = torch.tensor(2e-3, device=cuda)
    _, codes, deq = _sparse_check(same, lo, lo, bits)
    assert bool((codes & (2 ** (bits - 1) - 1) == 0).all())
    assert torch.equal(deq, same)
    tiny = v.clone()                                     # lo far below step
    tiny[0] = 1e-30
    a = tiny.abs()
    _sparse_check(tiny, a.amin(), a.amax(), bits)


# --- kernels 5, 6, 3 and 8 ------------------------------------------------

def _codes_check(g, qh, bits):
    before = (ops.quantize_codes_fused.launches, ops.quantize_pack.launches)
    R = ops.absmax(g, qh)
    codes = ops.quantize_codes_fused(g, qh, R, bits)
    payload = ops.quantize_pack(g, qh, R, bits)
    torch.cuda.synchronize()
    assert (ops.quantize_codes_fused.launches,
            ops.quantize_pack.launches) == (before[0] + 1, before[1] + 1)
    for got, want, names in (
            (codes, ref.quantize_codes_ref(g, qh, R, bits), ("codes", "delta")),
            (payload, ref.quantize_pack_payload_ref(g, qh, R, bits),
             ("packed", "delta"))):
        for name, a, b in zip(names, got, want):
            assert a.shape == b.shape and torch.equal(a, b), name
    return R, codes, payload


@pytest.mark.parametrize("case", LENGTHS)
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_codes_and_payload_kernels_match_plain_versions(cuda, bits, case):
    n, shift = LENGTHS[case]
    g, qh = _pair(cuda, n, shift, seed=bits * 13 + n)
    _, _, (packed, _) = _codes_check(g, qh, bits)
    assert packed.numel() == -(-n // 4096) * 4096 * bits // 8


@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_codes_kernels_zero_radius_and_nan(cuda, bits):
    g, _ = _pair(cuda, 4096 + 5, 0, seed=bits)
    R, (codes, delta), _ = _codes_check(g, g.clone(), bits)
    assert float(R) == 0.0 and not delta.any()
    assert bool((codes == 2 ** (bits - 1)).all())
    g, qh = _pair(cuda, 50_000, 0, seed=3)
    g[4321] = float("nan")
    R, (codes, delta), _ = _codes_check(g, qh, bits)
    assert R.isnan() and not delta.any()


@pytest.mark.parametrize("case", LENGTHS)
@pytest.mark.parametrize("sel", (0, 1, 2))
def test_adaptive_codes_kernel_is_kernel_5_at_the_width(cuda, sel, case):
    grid = (2, 4, 8)
    n, shift = LENGTHS[case]
    g, qh = _pair(cuda, n, shift, seed=sel + n)
    R = ops.absmax(g, qh)
    before = dict(ops.quantize_codes_adaptive.launches_by_width)
    got = ops.quantize_codes_adaptive(g, qh, R, torch.eye(3)[sel], grid)
    torch.cuda.synchronize()
    after = ops.quantize_codes_adaptive.launches_by_width
    assert after[grid[sel]] == before.get(grid[sel], 0) + 1
    want = ref.quantize_codes_adaptive_ref(g, qh, R, grid, sel)
    fixed = ops.quantize_codes_fused(g, qh, R, grid[sel])
    for a, b, c in zip(got, want, fixed):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("W", (1, 2, 4, 9))
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
@pytest.mark.parametrize("padded", (True, False))
def test_dequant_acc_kernel_matches_plain_version(cuda, bits, W, padded):
    n = 3 * 4096 + 1239
    nbytes = -(-n // 4096) * 4096 * bits // 8 if padded else -(-n * bits // 8)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(bits * 100 + W)
    packed = torch.randint(0, 256, (W, nbytes), generator=gen, device=cuda,
                           dtype=torch.uint8)
    R = torch.rand(W, generator=gen, device=cuda)
    R[W // 2] = 0.0
    keep = (torch.arange(W, device=cuda) % 3 != 1).float()
    acc = torch.randn(n, generator=gen, device=cuda)
    for a in (None, acc):
        before = ops.dequant_acc.launches
        got = ops.dequant_acc(packed, R, keep, bits, n, a)
        torch.cuda.synchronize()
        assert ops.dequant_acc.launches == before + 1
        assert torch.equal(got, ref.dequant_acc_ref(packed, R, keep, bits, n,
                                                    a))


def test_dequant_acc_kernel_keeps_both_orders(cuda):
    """The kernel adds acc first, then worker by worker; the reference
    backend's order (acc last) gives other bits on planted values."""
    from repro_torch.core.wire import FusedWire, ReferenceWire
    packed = torch.zeros((4, 4096), dtype=torch.uint8, device=cuda)
    R = torch.full((4,), 2.0 ** -24, device=cuda)
    keep = torch.ones(4, device=cuda)
    acc = torch.full((6,), -1.0, device=cuda)
    fused = FusedWire().dequant_acc(packed, R, keep, 8, 6, acc)
    assert bool((fused == -1.0).all())
    assert torch.equal(fused, ref.dequant_acc_ref(packed, R, keep, 8, 6, acc))
    plain = ReferenceWire().dequant_acc(packed, R, keep, 8, 6, acc)
    assert bool((plain == -1.0 - 2.0 ** -22).all())
    no_acc = FusedWire().dequant_acc(packed, R, keep, 8, 6)
    assert torch.equal(no_acc, ReferenceWire().dequant_acc(packed, R, keep,
                                                           8, 6))


def test_dequant_acc_refuses_more_workers_than_the_kernel_takes(cuda):
    from repro_torch.kernels import quant_pack
    W = quant_pack.library().max_workers + 1
    packed = torch.zeros((W, 8), dtype=torch.uint8, device=cuda)
    ones = torch.ones(W, device=cuda)
    with pytest.raises(ValueError, match="workers"):
        ops.dequant_acc(packed, ones, ones, 8, 8)


def test_sharded_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One NCCL worker: three packed-wire steps of smoke stablelm on the
    card and on the CPU (through a gloo group of one) give the same
    uploads and bits, and losses to rtol 1e-4."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.launch.mesh import init_workers
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    strat = StrategyConfig(kind="laq", bits=4, per_leaf_radius=True,
                           wire_backend="fused")
    gen = torch.Generator()
    gen.manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    runs = {}
    for backend, dev in (("gloo", "cpu"), ("nccl", "cuda")):
        workers = init_workers(backend, 1, 0, dist.FileStore(
            str(tmp_path / backend), 1))
        try:
            batch = {"tokens": tok[:, :-1].to(dev), "targets":
                     tok[:, 1:].to(dev)}
            params = tree_map(lambda t: t.to(dev),
                              init_params(0, cfg, device="cpu"))
            state = init_train_state(params, workers, strat, sgd())
            step = make_train_step(cfg, workers, strat, sgd(), lr=1e-2,
                                   wire="packed", microbatch=2)
            rec = []
            for _ in range(3):
                state, m = step(state, batch)
                rec.append((m.uploads, float(m.bits), float(m.loss)))
            runs[dev] = rec
        finally:
            dist.destroy_process_group()
    for (u1, b1, l1), (u2, b2, l2) in zip(runs["cuda"], runs["cpu"]):
        assert (u1, b1) == (u2, b2)
        assert abs(l1 - l2) <= 1e-4 * abs(l2)


@pytest.mark.parametrize("partitionable", (True, False))
def test_random_draws_on_the_card_equal_the_cpu(cuda, partitionable):
    """``repro_torch.random`` is integer work: the same bits on the card and
    the CPU, in both layouts."""
    from repro_torch import random
    with random.threefry_partitionable(partitionable):
        for seed in (0, 7, 2**32 - 1):
            draws = {}
            for dev in ("cpu", "cuda"):
                k = random.fold_in(random.PRNGKey(seed, device=dev), 3)
                draws[dev] = (random.split(k, 3), random.random_bits(k, (1001,)),
                              random.uniform(k, (5, 7)),
                              random.randint(k, (999,), 0, 12),
                              random.randint(k, (9,), -5, 2**31 - 1),
                              random.bernoulli(k, 0.9, (33,)))
            for a, b in zip(draws["cuda"], draws["cpu"]):
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kind", ("slaq", "slaq_ps", "qsgd", "ssgd"))
def test_run_stochastic_on_the_card_equals_the_cpu(cuda, kind):
    """A small Table 3 regression: the same minibatches, uploads and bits
    on the card as on the CPU; floats to rtol 1e-4 (other reductions)."""
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.simulated import run_stochastic
    from repro_torch.core.strategy import StrategyConfig
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(6, 12, 8, generator=gen)
    Y = X @ torch.linspace(-1.0, 1.0, 8) + 0.3 * torch.randn(6, 12,
                                                             generator=gen)

    def loss(params, data):
        x, y = data
        return 0.5 * torch.sum(torch.square(x @ params["w"] - y)) / 72

    cfg = StrategyConfig(kind="laq", bits=4, wire_backend="fused",
                         criterion=CriterionConfig(D=10, xi=0.08, t_bar=20))
    runs = {dev: run_stochastic(loss, {"w": torch.zeros(8)}, (X, Y), kind,
                                steps=30, alpha=0.3, batch=4, bits=4, seed=2,
                                laq_cfg=cfg, device=dev)
            for dev in ("cpu", "cuda")}
    a, b = runs["cuda"], runs["cpu"]
    for f in ("cum_uploads", "cum_bits", "mean_bits"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    torch.testing.assert_close(a.loss, b.loss, rtol=1e-4, atol=1e-6)


# The participation and robustness layer on the card: the quadratic of
# test_engine_parity.py (10 workers, p=20) on the fused wire, each case on
# the card and on the CPU.  Uploads, bits, widths and every worker's
# rejections equal; floats to rtol 1e-4 (other reductions).
ROBUST_CASES = {
    "bernoulli": dict(participation="bernoulli", participation_p=0.5,
                      participation_seed=3),
    "markov": dict(participation="markov", participation_p=0.7,
                   markov_sojourn=3.0, participation_seed=1),
    "delay": dict(participation="delay", max_delay=2),
    "bitflip_gate": dict(faults=dict(corrupt_p=0.3, corrupt_kind="bitflip",
                                     bitflip_frac=0.5, fault_seed=4),
                         defense=dict(validate=True, gate_mult=1.5)),
    "scale_clip_crash": dict(faults=dict(corrupt_p=0.25, corrupt_kind="scale",
                                         corrupt_scale=-40.0, crash_p=0.1,
                                         fault_seed=7),
                             defense=dict(validate=True, gate_mult=4.0,
                                          clip_mult=4.0)),
    "nan_no_reconcile": dict(faults=dict(corrupt_p=0.2, corrupt_kind="nan",
                                         crash_p=0.1, fault_seed=1),
                             defense=dict(reconcile_crashes=False)),
    "trimmed_mean": dict(faults=dict(corrupt_p=0.15, corrupt_kind="scale",
                                     corrupt_scale=-40.0),
                         aggregator="trimmed_mean", trim_frac=0.2),
    "median": dict(aggregator="median"),
}


def _quadratic(dev):
    gen = torch.Generator().manual_seed(0)
    c = torch.randn(10, 20, generator=gen)
    a = 0.5 + torch.rand(10, 20, generator=gen)

    def loss(params, data):
        cc, aa = data
        return 0.5 * torch.sum(aa * torch.square(params["x"] - cc)) / 10

    return loss, (c.to(dev), a.to(dev))


def _robust_engine(dev, kw):
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.defense import DefenseConfig
    from repro_torch.core.engine import FullBatchSource, RoundEngine
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.strategy import StrategyConfig
    kw = dict(kw)
    if "faults" in kw:
        kw["faults"] = FaultConfig(**kw["faults"])
    if "defense" in kw:
        kw["defense"] = DefenseConfig(**kw["defense"])
    loss, data = _quadratic(dev)
    cfg = StrategyConfig(kind="laq", bits=4, wire_backend="fused",
                         criterion=CriterionConfig(D=10, xi=0.08, t_bar=20),
                         **kw)
    return RoundEngine(FullBatchSource(loss, data), cfg, alpha=0.3)


@pytest.mark.parametrize("case", ROBUST_CASES)
def test_robust_engine_on_the_card_equals_the_cpu(cuda, case):
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = _robust_engine(dev, ROBUST_CASES[case])
        runs[dev] = eng.run_from(eng.init_carry({"x": torch.zeros(20)},
                                                device=dev), 30)
    (ca, a), (cb, b) = runs["cuda"], runs["cpu"]
    for f in ("cum_uploads", "cum_bits", "mean_bits"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    torch.testing.assert_close(a.loss, b.loss, rtol=1e-4, atol=1e-6,
                               equal_nan=True)
    ra, rb = ca[1].defense.rejects, cb[1].defense.rejects
    assert (ra is None and rb is None) or torch.equal(ra, rb)
    assert ca[0]["x"].device.type == "cuda"


def test_watchdog_on_the_card_equals_the_cpu(cuda, tmp_path):
    from repro_torch.core.defense import (DefenseConfig, WatchdogConfig,
                                          run_with_watchdog)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = _robust_engine(dev, dict(faults=dict(corrupt_p=0.1,
                                                   corrupt_kind="inf")))

        def escalate(engine):
            return type(engine)(engine.source, engine.cfg._replace(
                defense=DefenseConfig(validate=True)), alpha=engine.alpha)

        out[dev] = run_with_watchdog(
            eng, {"x": torch.zeros(20)}, 40, ckpt_path=str(tmp_path / dev),
            wd=WatchdogConfig(chunk=10), escalate=escalate, device=dev)
    (ra, la, ca), (rb, lb, cb) = out["cuda"], out["cpu"]
    assert la == lb and la["rollbacks"]
    assert torch.equal(ra.cum_bits, rb.cum_bits)
    assert torch.equal(ca[1].defense.rejects, cb[1].defense.rejects)


def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
    eng = _robust_engine("cuda", ROBUST_CASES["scale_clip_crash"])
    p0 = {"x": torch.zeros(20)}
    _, whole = eng.run_from(eng.init_carry(p0, device="cuda"), 16)
    carry, first = eng.run_from(eng.init_carry(p0, device="cuda"), 8)
    save_checkpoint(str(tmp_path / "ck.npz"), carry, 8)
    carry, step = load_checkpoint(str(tmp_path / "ck.npz"),
                                  eng.init_carry(p0, device="cuda"))
    assert step == 8 and carry[1].qhat[0]["x"].device.type == "cuda"
    _, second = eng.run_from(carry, 8)
    for f in ("cum_uploads", "cum_bits", "loss"):
        assert torch.equal(torch.cat([getattr(first, f), getattr(second, f)]),
                           getattr(whole, f)), f


def test_serve_on_the_card_equals_the_cpu(cuda):
    """Smoke stablelm in float32: prefill and 8 decode steps fed the CPU's
    greedy tokens give logits within 1e-4 of the CPU's and the same greedy
    ids; ``jit_serve``'s greedy pair free-running gives the same ids."""
    import dataclasses

    from repro_torch import random
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import jit_serve
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_config(get_config("stablelm-1.6b")),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = {"cpu": init_params(0, cfg, device="cpu")}
    params["cuda"] = tree_map(lambda l: l.to(cuda), params["cpu"])
    prompts = random.randint(random.PRNGKey(1, device="cpu"), (4, 24), 0,
                             cfg.vocab).long()
    out = {d: prefill(params[d], prompts.to(d), cfg, 32)
           for d in ("cpu", "cuda")}
    for step in range(9):
        a, b = out["cuda"][0].cpu(), out["cpu"][0]
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        ids = torch.argmax(b[:, -1:], -1) % cfg.vocab
        assert torch.equal(torch.argmax(a[:, -1:], -1) % cfg.vocab, ids)
        if step < 8:
            out = {d: decode_step(params[d], out[d][1], ids.to(d), cfg)
                   for d in ("cpu", "cuda")}
    seqs = {}
    for d in ("cpu", "cuda"):
        pre, dec = jit_serve(cfg, 32)
        tok, cache = pre(params[d], prompts.to(d))
        seq = [tok]
        for _ in range(8):
            tok, cache = dec(params[d], cache, tok)
            seq.append(tok)
        seqs[d] = torch.cat(seq, 1).cpu()
    assert seqs["cuda"].dtype == torch.int32
    assert torch.equal(seqs["cuda"], seqs["cpu"])


@pytest.mark.parametrize("policy", ("b4", "adaptive"))
def test_publisher_on_the_card_equals_the_cpu(cuda, policy):
    """The micro LM's trainer runs 10 rounds on the CPU; the fused-wire
    publisher and two replicas (max_delay 1) replay it on the card and on
    the CPU: kinds, widths and bits equal, theta_pub and replica 0 bitwise,
    and the card launches kernels 1 and 2."""
    from benchmarks_torch.serve_frontier import _train_trajectory
    from repro_torch.core.adaptive import BitSchedule
    from repro_torch.core.replica import (PublishConfig, init_publisher,
                                          publish)
    from repro_torch.launch.publish import ReplicaFleet
    from repro_torch.tree import tree_leaves, tree_map

    pcfg = {"b4": PublishConfig(bits=4, threshold=0.35, max_staleness=1,
                                wire_backend="fused"),
            "adaptive": PublishConfig(threshold=0.0, wire_backend="fused",
                                      bit_schedule=BitSchedule(
                                          kind="radius", grid=(2, 4, 8),
                                          threshold_mode="rel",
                                          thresholds=(0.05, 0.5)))}[policy]
    params0, traj = _train_trajectory(10, torch.device("cpu"))
    runs = {}
    before = (ops.absmax.launches, ops.quantize_pack_fused.launches)
    for d in ("cpu", "cuda"):
        st = init_publisher(tree_map(lambda l: l.to(d), params0), pcfg)
        fleet = ReplicaFleet(tree_map(lambda l: l.to(d), params0), 2, pcfg,
                             max_delay=1)
        rows = []
        for params in traj:
            msg, st = publish(pcfg, st, tree_map(lambda l: l.to(d), params))
            fleet.deliver(msg)
            rows.append((type(msg).__name__, getattr(msg, "width", None),
                         st.bits_sent))
        runs[d] = (rows, st.theta_pub, fleet.replicas[0].params)
    assert ops.absmax.launches > before[0]
    assert ops.quantize_pack_fused.launches > before[1]
    assert runs["cuda"][0] == runs["cpu"][0]
    for x, y in zip(runs["cuda"][1:], runs["cpu"][1:]):
        assert all(torch.equal(u.cpu(), v) for u, v in zip(tree_leaves(x),
                                                         tree_leaves(y)))


def _smoke(cuda, arch):
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = {"cpu": init_params(0, cfg, device="cpu")}
    params["cuda"] = tree_map(lambda l: l.to(cuda), params["cpu"])
    return cfg, params


def _laq_card_vs_cpu(cuda, arch, leaves):
    """12 deterministic LAQ rounds (b=8, fused wire, lm_frontier's
    criterion and 1/t stepsize, alpha 0.02) of a smoke model in float32
    on the card and on the CPU: the same uploads and bits, losses to rtol
    1e-4, and the card launches kernels 1 and 2 once per leaf, worker and
    round."""
    from repro_torch.core.adaptive import EtaSchedule
    from repro_torch.core.criterion import CriterionConfig
    from repro_torch.core.engine import AccumulatingSource, RoundEngine
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.data.synthetic import lm_worker_corpus
    from repro_torch.models.model import lm_worker_loss

    cfg, params = _smoke(cuda, arch)
    strat = StrategyConfig(kind="laq", bits=8, per_leaf_radius=True,
                           wire_backend="fused",
                           criterion=CriterionConfig(D=10, xi=0.08, t_bar=100),
                           eta_schedule=EtaSchedule("inv_t", t0=30.0))
    corpus = lm_worker_corpus(0, 4, 2, 32, cfg.vocab, device="cpu")
    runs = {}
    before = (ops.absmax.launches, ops.quantize_pack_fused.launches)
    for d in ("cpu", "cuda"):
        src = AccumulatingSource(lm_worker_loss(cfg, 4),
                                 {k: v.to(d) for k, v in corpus.items()},
                                 deterministic=True, accum=2, scale=1.0)
        runs[d] = RoundEngine(src, strat, alpha=0.02).run(params[d], 12,
                                                          device=d)
    assert (ops.absmax.launches - before[0],
            ops.quantize_pack_fused.launches - before[1]) == (
                (12 * 4 * leaves,) * 2)
    a, b = runs["cuda"], runs["cpu"]
    assert torch.equal(a.cum_uploads, b.cum_uploads)
    assert torch.equal(a.cum_bits, b.cum_bits)
    assert int(b.cum_uploads[-1]) < 4 * 12
    torch.testing.assert_close(a.loss, b.loss, rtol=1e-4, atol=0)


def _serve_card_vs_cpu(cuda, arch):
    """Prefill of 4 x 24 tokens and 8 decode steps fed the CPU's greedy
    tokens give logits within 1e-4 of the CPU's and the same greedy ids."""
    from repro_torch import random
    from repro_torch.models.model import decode_step, prefill

    cfg, params = _smoke(cuda, arch)
    prompts = random.randint(random.PRNGKey(1, device="cpu"), (4, 24), 0,
                             cfg.vocab).long()
    out = {d: prefill(params[d], prompts.to(d), cfg, 32)
           for d in ("cpu", "cuda")}
    for step in range(9):
        a, b = out["cuda"][0].cpu(), out["cpu"][0]
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        ids = torch.argmax(b[:, -1:], -1) % cfg.vocab
        assert torch.equal(torch.argmax(a[:, -1:], -1) % cfg.vocab, ids)
        if step < 8:
            out = {d: decode_step(params[d], out[d][1], ids.to(d), cfg)
                   for d in ("cpu", "cuda")}


def test_moe_laq_on_the_card_equals_the_cpu(cuda):
    """Smoke qwen3-moe (alpha 0.02, as in ``tests/test_torch_moe.py``)."""
    _laq_card_vs_cpu(cuda, "qwen3-moe-30b-a3b", 15)


def test_moe_serve_on_the_card_equals_the_cpu(cuda):
    """Smoke qwen3-moe: the prefill takes the capacity path, decode the
    dense path."""
    _serve_card_vs_cpu(cuda, "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("arch,leaves", [("mamba2-130m", 20),
                                         ("zamba2-2.7b", 29)])
def test_mamba_laq_on_the_card_equals_the_cpu(cuda, arch, leaves):
    """The smoke Mamba2 models (alpha 0.02, as in
    ``tests/test_torch_lm.py``)."""
    _laq_card_vs_cpu(cuda, arch, leaves)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_mamba_serve_on_the_card_equals_the_cpu(cuda, arch):
    """The smoke Mamba2 models: the chunked SSD in the prefill, the
    recurrent step and the shared block's KV rows in decode."""
    _serve_card_vs_cpu(cuda, arch)


@pytest.mark.parametrize("partitionable", (True, False))
def test_normal_and_permutation_on_the_card_equal_the_cpu(cuda,
                                                          partitionable):
    """``random.normal`` (float32 bits) and ``random.permutation`` (two
    shuffle rounds at 4001), hashed on the card and, from a CPU key, in
    numpy, equal on both devices."""
    from repro_torch import random
    with random.threefry_partitionable(partitionable):
        for n in (7, 1024, 1025, 200_001):
            a = random.normal(random.PRNGKey(3, device="cuda"), (n,))
            b = random.normal(random.PRNGKey(3, device="cpu"), (n,))
            assert a.is_cuda
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
        for n in (600, 4001):
            assert torch.equal(
                random.permutation(random.PRNGKey(1, device="cuda"), n).cpu(),
                random.permutation(random.PRNGKey(1, device="cpu"), n))


@pytest.mark.parametrize("kind", ("qgd", "laq"))
def test_paper_tables_data_on_the_card_equal_the_cpu(cuda, kind):
    """The tables' dataset and the NN's initial weights drawn on the card,
    bitwise equal to the CPU draw; 5 rounds of the fused-wire NN QGD and
    LAQ equal in uploads and bits, the loss to rtol 1e-5 (the paper-table
    tests' tolerance)."""
    from benchmarks_torch import common
    from repro_torch.core.simulated import run_gradient_based
    from repro_torch.core.strategy import StrategyConfig
    (cw, cf), (pw, pf) = (common.make_dataset(device=d)
                          for d in ("cuda", "cpu"))
    for a, b in zip(cw + cf, pw + pf):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    runs = {}
    for dev, (w, _) in (("cuda", (cw, cf)), ("cpu", (pw, pf))):
        cfg = StrategyConfig(kind=kind, bits=8, wire_backend="fused",
                             criterion=common.PAPER_CRITERION)
        runs[dev] = run_gradient_based(common.nn_loss(600),
                                       common.nn_init(device=dev), w, cfg,
                                       steps=5, alpha=2.0, device=dev)
    assert torch.equal(runs["cuda"].cum_uploads, runs["cpu"].cum_uploads)
    assert torch.equal(runs["cuda"].cum_bits, runs["cpu"].cum_bits)
    torch.testing.assert_close(runs["cuda"].loss.cpu(), runs["cpu"].loss,
                               rtol=1e-5, atol=0)
