"""Seconds of the sharded step's reference side, one JAX subprocess per
group of configurations, the four groups at once (not a test):

    PYTHONPATH=src python tests/train_reference_probe.py [XLA_FLAG ...]

Each subprocess runs ``torch_dist_cases.TRAIN_JAX_SIDE`` on its group,
as ``run_train`` starts it but without the gloo ranks; extra XLA flags
(``--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1``
pins XLA's CPU threads) are added to its ``XLA_FLAGS``.  Prints each
group's wall seconds as it ends.
"""
import os
import subprocess
import sys
import tempfile
import time

import torch_dist_cases as C

GROUPS = {"base": C.TRAIN_BASE, "lazy": tuple(C.TRAIN_RULES),
          "bf16": C.TRAIN_BF16, "defended": C.TRAIN_DEFENDED}


def main(extra_flags) -> int:
    flags = " ".join(["--xla_force_host_platform_device_count=4",
                      *extra_flags])
    tests = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, configs in GROUPS.items():
            out = os.path.join(tmp, name)
            os.mkdir(out)
            env = dict(os.environ, JAX_PLATFORMS="cpu", OUT=out,
                       TESTS_DIR=tests, CONFIGS=",".join(configs),
                       XLA_FLAGS=flags)
            with open(os.path.join(out, "stderr"), "w") as err:
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-c", C.TRAIN_JAX_SIDE], env=env,
                    stdout=subprocess.DEVNULL, stderr=err),
                    time.perf_counter())
        rc = 0
        while procs:
            for name, (p, t0) in list(procs.items()):
                if p.poll() is None:
                    continue
                print(f"{name}: {time.perf_counter() - t0:.1f} s, exit "
                      f"{p.returncode}", flush=True)
                if p.returncode:
                    with open(os.path.join(tmp, name, "stderr")) as err:
                        print(err.read()[-2000:])
                rc |= p.returncode
                del procs[name]
            time.sleep(0.5)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
