"""The command line shared by the paper-table modules
(``table2_gradient``, ``table3_stochastic``)."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def table_main(name: str, run, argv=None) -> int:
    """Parse ``[--device cuda|cpu] [--wire reference|fused]``, run the table
    and print one JSON line per row, one per claim and the seconds taken.
    Returns 0 when every claim holds, 1 otherwise or without a CUDA device
    when the card is asked for (the default)."""
    ap = argparse.ArgumentParser(prog=f"python -m benchmarks_torch.{name}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--wire", choices=("reference", "fused"),
                    default="reference")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{name}: torch.cuda.is_available() is False; pass --device "
              "cpu to run on the CPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, results = [], {}
    t0 = time.perf_counter()
    checks = run(rows, results, device=args.device, wire=args.wire)
    seconds = time.perf_counter() - t0
    for key, row in results.items():
        if not key.endswith("/claims"):
            print(json.dumps({"row": key, **row}))
    for claim, ok in checks.items():
        print(f"{'PASS' if ok else 'FAIL'} {claim}")
    print(json.dumps({"table": name, "device": args.device,
                      "wire": args.wire, "seconds": round(seconds, 3)}))
    return 0 if all(checks.values()) else 1
