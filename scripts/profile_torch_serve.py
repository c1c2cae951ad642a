"""Where the port's serving steps spend their time on the GPU.

    python3 scripts/profile_torch_serve.py [--arch stablelm-1.6b]
        [--layers N] [--param-dtype bfloat16|float32] [--steps 8] [--top 15]

Serves ``chip_smoke.py`` phase 10's setting: stablelm-1.6b at its
published widths and depth (24 layers), bfloat16 compute, random weights
from seed 0, prompts of 8 x 512 tokens, ``max_len`` 576, through
``launch/serve.py``'s greedy steps.  ``--param-dtype float32 --layers 8``
is phase 10b's replica (its float32 weights are cast to bfloat16 in every
product); ``--arch qwen3-moe-30b-a3b`` is phase 11b's whole MoE model (48
layers), ``--arch zamba2-2.7b`` phase 12b's whole hybrid (54 Mamba2
layers and 9 applications of the shared block).  After a warm-up
session it times the prefill and ``--steps`` decode steps on the host
clock (each closed by ``torch.cuda.synchronize()``), then profiles one
prefill and ``--steps`` decode steps under ``torch.profiler`` (CPU + CUDA
activities): wall time, the device's busy share (the union of the kernels'
intervals over the wall time), the kernel count, and the top operators
by device time.

Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import jit_serve  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402

BATCH, PROMPT, MAX_LEN = 8, 512, 576


def busy_share(prof, wall_ms: float):
    """Union of the device kernels' intervals over ``wall_ms``, and the
    kernel count."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0 if cur is None else cur[1] - cur[0]
    return busy / 1e3 / wall_ms, len(spans)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the config's)")
    ap.add_argument("--param-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers,
                              param_dtype=getattr(torch, args.param_dtype))
    params = init_params(0, cfg, device="cuda")
    prompts = random.randint(random.PRNGKey(1, device="cuda"),
                             (BATCH, PROMPT), 0, cfg.vocab).long()
    pre, dec = jit_serve(cfg, MAX_LEN)

    def session():
        tok, cache = pre(params, prompts)
        for _ in range(args.steps):
            tok, cache = dec(params, cache, tok)
        torch.cuda.synchronize()

    session()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = pre(params, prompts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(args.steps):
        tok, cache = dec(params, cache, tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{cfg.name}, {cfg.n_layers} layers, {args.param_dtype} params, "
          f"bfloat16 compute, {BATCH}x{PROMPT} prompts: prefill "
          f"{(t1 - t0) * 1e3:.2f} ms, decode {(t2 - t1) * 1e3 / args.steps:.3f}"
          f" ms per step (mean of {args.steps})")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name in ("prefill", "decode"):
        if name == "prefill":
            def run():
                return pre(params, prompts)
        else:
            _, cache = pre(params, prompts)
            torch.cuda.synchronize()

            def run():
                t, c = tok, cache
                for _ in range(args.steps):
                    t, c = dec(params, c, t)
                return t
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        share, n = busy_share(prof, wall)
        steps = 1 if name == "prefill" else args.steps
        print(f"== profiled {name} ({steps} call(s)): {wall:.2f} ms wall, "
              f"device busy {100 * share:.1f}%, {n} kernels")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=args.top,
                                        max_name_column_width=50))
    return 0


if __name__ == "__main__":
    sys.exit(main())
