#!/usr/bin/env python
"""Where a pytest run's time went, from its junit report.

    python scripts/junit_times.py REPORT.xml [--top N]

Prints the run's counts, the summed test time (setup, call and teardown of
every test, as junit records them, across all workers), the share of it
spent in the port's files (``tests/test_torch_*.py``), the time of each
port file, and the ``N`` slowest files and tests.  Under ``pytest -n``
the summed time exceeds the wall time: it adds the workers' times.
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def summarize(path: str, top: int = 5) -> dict:
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    files, tests = collections.Counter(), []
    for tc in suite.iter("testcase"):
        name = tc.get("classname", "").replace(".", "/") + ".py"
        t = float(tc.get("time", 0.0))
        files[name] += t
        tests.append((t, f"{name}::{tc.get('name')}"))
    port = {k: v for k, v in files.items() if "/test_torch_" in k}
    return dict(
        counts={k: int(suite.get(k, 0)) for k in ("tests", "errors",
                                                  "failures", "skipped")},
        summed_s=sum(files.values()), port_s=sum(port.values()),
        port_files=dict(sorted(port.items(), key=lambda kv: -kv[1])),
        slowest_files=files.most_common(top),
        slowest_tests=sorted(tests, reverse=True)[:top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("report")
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args(argv)
    s = summarize(args.report, args.top)
    c = s["counts"]
    print(f"{c['tests']} tests: {c['errors']} errors, {c['failures']} "
          f"failures, {c['skipped']} skipped")
    print(f"summed test time {s['summed_s']:.1f} s, of it the port's files "
          f"{s['port_s']:.1f} s")
    for name, t in s["port_files"].items():
        print(f"  {t:8.1f}  {name}")
    print("slowest files:")
    for name, t in s["slowest_files"]:
        print(f"  {t:8.1f}  {name}")
    print("slowest tests:")
    for t, name in s["slowest_tests"]:
        print(f"  {t:8.1f}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
