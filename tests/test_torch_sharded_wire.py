"""The port's streamed packed wire (``launch/train.py`` ``_packed_aggregate``)
against the reference's, bitwise: the aggregate and each worker's q_new.

The reference runs inside ``shard_map`` over the ``data`` axis of four
forced host CPU devices, in a subprocess (the first two devices for the
two-worker cases).  The port runs on gloo ranks spawned from this test,
four and then two.  Cases (``tests/torch_dist_cases.py``): four workers
(the gather exchange) and two (the peer swap); b in {2, 4, 8}; the
adaptive grid (2, 4, 8) with different widths on different workers;
per-leaf and global radius; skip masks; a leaf whose last dim 8/b does not
divide (shipped as raw codes).  Tolerance: none, every array bitwise.
"""
import os

import numpy as np
import pytest

import torch_dist_cases as C
from repro_torch.launch.train import exchange_mode
from torch_threads import one_thread  # noqa: F401

JAX_SIDE = r'''
import os, sys
sys.path.insert(0, os.environ["TESTS_DIR"])
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import torch_dist_cases as C
from repro import compat
from repro.core.adaptive import BitSchedule
from repro.core.strategy import StrategyConfig
from repro.launch.train import _packed_aggregate

out = {}
for name, (W, bits, _, skip, widths) in C.WIRE_CASES.items():
    grads, qhat = C.wire_case_inputs(name)
    sched = (BitSchedule(kind="radius", grid=C.GRID, thresholds=(1e-3, 1e-2))
             if bits == "adaptive" else None)
    strat = StrategyConfig(**C.wire_strategy_kwargs(name), bit_schedule=sched)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    adaptive = widths is not None

    def one(g, q, s, w):
        sq = lambda t: jax.tree.map(lambda x: x[0], t)
        agg, q_new = _packed_aggregate(sq(g), sq(q), s[0], strat, "data",
                                       width=w[0] if adaptive else None)
        un = lambda t: jax.tree.map(lambda x: x[None], t)
        return un(agg), un(q_new)

    fn = jax.jit(compat.shard_map(one, mesh=mesh, in_specs=(P("data"),) * 4,
                                  out_specs=(P("data"), P("data")),
                                  axis_names={"data"}, check_vma=False))
    agg, q_new = fn(grads, qhat, jnp.asarray(skip, bool),
                    jnp.asarray(widths if adaptive else (0,) * W,
                                jnp.float32))
    for k in C.WIRE_SHAPES:
        out[f"{name}/agg/{k}"] = np.asarray(agg[k])
        out[f"{name}/q_new/{k}"] = np.asarray(q_new[k])
np.savez(os.path.join(os.environ["OUT"], "wire_jax.npz"), **out)
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_wire"))
    jax_side = C.run_jax(JAX_SIDE, out)
    try:
        C.spawn_ranks("rank_packed_aggregate", 4, out)
        C.spawn_ranks("rank_packed_aggregate", 2, out)
    finally:
        C.finish(jax_side, "the reference's _packed_aggregate")
    want = np.load(os.path.join(out, "wire_jax.npz"))
    got = {(W, m): np.load(os.path.join(out, f"wire_{W}_{m}.npz"))
           for W in (2, 4) for m in range(W)}
    return want, got


@pytest.mark.parametrize("name", C.WIRE_CASES)
def test_packed_aggregate_matches_reference_bitwise(results, name):
    want, got = results
    W = C.WIRE_CASES[name][0]
    for m in range(W):
        for k in C.WIRE_SHAPES:
            for field in ("agg", "q_new"):
                key = f"{name}/{field}/{k}"
                np.testing.assert_array_equal(got[W, m][key], want[key][m],
                                              err_msg=f"worker {m} {key}")


def test_exchange_mode_per_worker_count():
    assert [exchange_mode(w) for w in (1, 2, 3, 4, 8)] == [
        "gather", "permute", "gather", "gather", "gather"]
