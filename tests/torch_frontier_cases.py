"""The checks that ``tests/test_torch_lasg_frontier.py`` and
``tests/test_torch_participation_frontier.py`` share: a frontier of the
port against the JAX module's on the CPU."""
import numpy as np

KERNELS = ("absmax", "quantize_pack_fused")
COUNTS = ("cum_uploads", "cum_bits")


def arrays(r):
    """A run's per-round loss and counts as numpy arrays."""
    return {f: np.asarray(getattr(r, f)) for f in ("loss",) + COUNTS}


def count_calls(mp, ops, calls):
    """Wrap the wrappers of kernels 1 and 2 (``ops.absmax`` and
    ``ops.quantize_pack_fused``) with ``mp`` so that each call adds one to
    ``calls[name]``: on the card each call is one launch, and the launch
    counters count only those."""
    for name in KERNELS:
        def counted(*a, _f=getattr(ops, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        mp.setattr(ops, name, counted)


def assert_frontier(module, got, checks, got_tr, want, want_tr, want_rows,
                    loss_rtol, float_keys):
    """Every run's per-round counts equal JAX's and its loss within
    ``loss_rtol(run)``; the claims equal JAX's, in order; every row's
    entries equal ``want_rows``' (those of ``float_keys`` within
    ``loss_rtol(row)``)."""
    assert list(got_tr) == list(want_tr)
    for run, w in want_tr.items():
        g = got_tr[run]
        for f in COUNTS:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f"{run} {f}")
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss_rtol(run),
                                   err_msg=f"{run} loss")
    claims = want[f"{module}/claims"]
    assert list(checks) == list(claims)
    assert checks == got[f"{module}/claims"] == claims
    assert (sorted(k for k in got if not k.endswith("/claims"))
            == sorted(want_rows))
    for row, w in want_rows.items():
        g = got[row]
        assert sorted(g) == sorted(w), row
        for k, v in w.items():
            if k in float_keys:
                np.testing.assert_allclose(g[k], v, rtol=loss_rtol(row),
                                           err_msg=f"{row}/{k}")
            else:
                assert g[k] == v, (row, k, g[k], v)
