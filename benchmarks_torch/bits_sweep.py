"""Paper supp on the port: communication cost against the quantization
width b, and the wire-kernel micro-benchmark, port of
``benchmarks/bits_sweep.py``.

    PYTHONPATH=src python -m benchmarks_torch.bits_sweep \\
        [--device cuda|cpu] [--wire reference|fused]

The sweep (:func:`run_sweep`): LAQ at b in ``SWEEP_BITS`` for
``SWEEP_STEPS`` rounds on the logistic-regression workers of
``common.make_dataset``, each row with its bits, rounds and final loss,
and the claim that the bits grow with b.  ``--wire fused`` sends the
quantize step through the CUDA wire kernels (``absmax`` and
``quantize_pack_fused``) on the card.

The kernel rows (:func:`run_kernels`, on the card only): the payload-only
quantize + pack (kernel 3, ``ops.quantize_pack``) and the receive side
over W=4 payloads (kernel 8, ``ops.dequant_acc``) at n = 2^20 for b in
{4, 8}.  Data come from a seeded ``torch.Generator`` on the card: the
gradient is N(0, 1), qhat zero and R its infinity norm, as in the
reference.  Each row is the mean of 20 launches timed with CUDA events
after 3 warm-up launches, and records the device it ran on.  Each
kernel's output is held bitwise against its plain version first.

With ``--device cpu`` this runs the sweep only: no kernel time is taken
on the CPU.  The card is the default device: without one, and without
``--device cpu``, this exits non-zero.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.core.simulated import run_gradient_based
from repro_torch.core.strategy import StrategyConfig
from repro_torch.device import resolve_device

from .common import PAPER_CRITERION, logreg_init, logreg_loss, make_dataset
from .tables import table_main

SWEEP_BITS = (2, 4, 8)
SWEEP_STEPS = 400
SWEEP_ALPHA = 2.0
N = 1 << 20
W = 4
TIMED, WARMUP = 20, 3


def time_ms(fn, iters: int = TIMED, warmup: int = WARMUP) -> float:
    """Mean ms of one call of ``fn`` over ``iters`` launches (CUDA events,
    after ``warmup`` launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_sweep(out_rows, results, *, device="cuda", wire="reference",
              traces=None):
    """The bits sweep's rows into ``results``; returns its claim check.
    ``traces``, when given, receives each width's :class:`RunResult`."""
    dev = resolve_device(device)
    traces = {} if traces is None else traces
    workers, full = make_dataset(device=dev)
    loss_fn = logreg_loss(full[0].shape[0])
    sweep = {}
    for b in SWEEP_BITS:
        cfg = StrategyConfig(kind="laq", bits=b, criterion=PAPER_CRITERION,
                             wire_backend=wire)
        r = run_gradient_based(loss_fn, logreg_init(device=dev), workers,
                               cfg, steps=SWEEP_STEPS, alpha=SWEEP_ALPHA,
                               device=dev)
        traces[f"bits_sweep/b{b}"] = r
        sweep[b] = results[f"bits_sweep/b{b}"] = dict(
            bits=float(r.cum_bits[-1]), rounds=int(r.cum_uploads[-1]),
            final_loss=float(r.loss[-1]))
        out_rows.append((f"bits_sweep_b{b}", sweep[b]["bits"],
                         f"rounds={sweep[b]['rounds']};"
                         f"loss={sweep[b]['final_loss']:.2e}"))
    results["bits_sweep/claims"] = checks = {
        "fewer bits per round with smaller b":
            sweep[2]["bits"] < sweep[4]["bits"] < sweep[8]["bits"]}
    return checks


def run(out_rows, results, *, device="cuda", wire="reference", traces=None):
    """The sweep, then on the card the kernel rows (keyed by their names in
    ``results``); returns the sweep's claim check."""
    checks = run_sweep(out_rows, results, device=device, wire=wire,
                       traces=traces)
    if resolve_device(device).type == "cuda":
        for row in run_kernels():
            results[f"bits_sweep/{row['name']}"] = row
    return checks


def run_kernels(seed: int = 0) -> list:
    """The kernel rows, one dict per kernel and width."""
    from repro_torch.kernels import ops, ref

    if not torch.cuda.is_available():
        raise RuntimeError("benchmarks_torch.bits_sweep needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    g = torch.randn(N, generator=gen, device=dev)
    qh = torch.zeros(N, device=dev)
    R = g.abs().amax()
    device = torch.cuda.get_device_name(dev)
    rows = []
    for bits in (4, 8):
        pk, delta = ops.quantize_pack(g, qh, R, bits)
        want = ref.quantize_pack_payload_ref(g, qh, R, bits)
        if not (torch.equal(pk, want[0]) and torch.equal(delta, want[1])):
            raise AssertionError(f"quantize_pack b={bits} differs from its "
                                 "plain version")
        rows.append(dict(name=f"kernel_quantize_pack_b{bits}_n1M",
                         ms=time_ms(lambda: ops.quantize_pack(g, qh, R, bits)),
                         device=device))
        pks = torch.stack([pk] * W)
        Rs = R.reshape(1).repeat(W)
        keep = torch.ones(W, device=dev)
        got = ops.dequant_acc(pks, Rs, keep, bits, N)
        if not torch.equal(got, ref.dequant_acc_ref(pks, Rs, keep, bits, N)):
            raise AssertionError(f"dequant_acc b={bits} differs from its "
                                 "plain version")
        rows.append(dict(name=f"kernel_dequant_acc_b{bits}_W{W}_n1M",
                         ms=time_ms(lambda: ops.dequant_acc(pks, Rs, keep,
                                                            bits, N)),
                         device=device))
    return rows


def main(argv=None) -> int:
    return table_main("bits_sweep", run, argv)


if __name__ == "__main__":
    sys.exit(main())
