"""Wire-kernel micro-benchmark of the port, the kernel half of
``benchmarks/bits_sweep.py``: the payload-only quantize + pack (kernel 3,
``ops.quantize_pack``) and the receive side over W=4 payloads (kernel 8,
``ops.dequant_acc``) at n = 2^20 for b in {4, 8}.

    PYTHONPATH=src python -m benchmarks_torch.bits_sweep

Data come from a seeded ``torch.Generator`` on the card: the gradient is
N(0, 1), qhat zero and R its infinity norm, as in the reference.  Each row
is the mean of 20 launches timed with CUDA events after 3 warm-up
launches, and records the device it ran on.  Each kernel's output is held
bitwise against its plain version first.  The LAQ half of the reference
(the bits sweep on the logistic-regression workers) needs the reference's
``classification_dataset``, drawn with ``jax.random.normal`` and
``permutation``, which ``repro_torch.random`` does not draw yet: it waits
for the torch Table 2 benchmark (ROADMAP queue 1).

Without a CUDA device this exits non-zero: no number here is taken on the
CPU.
"""
from __future__ import annotations

import json
import sys

import torch

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


def run(seed: int = 0) -> list:
    """The benchmark's rows, one dict per kernel and width."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bits_sweep: torch.cuda.is_available() is False; this "
              "benchmark runs on a CUDA device only", file=sys.stderr)
        return 1
    for row in run():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
