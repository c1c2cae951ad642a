"""One intra-op thread for the port's CPU tests.

Every ``tests/test_torch_*.py`` module imports :func:`one_thread`

    from torch_threads import one_thread  # noqa: F401

and pytest then applies it, autouse and of module scope, to every test of
that module.  The port's tests make many small torch calls.  The tier-1
command runs six pytest workers on the machine's eight cores, and with a
pool of intra-op threads each, a worker spends its time spinning on
threads that are not scheduled: beside five other workers a reduced paper
table took 520 s, not 10, ``serve_frontier --tiny`` 722 s against 18 s at
one thread alone, and smoke qwen3-moe's LAQ rounds 163 s against 27 s.
The program's own thread use (``repro_torch``, the benchmarks, the card's
host) is left as torch sets it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run the module's torch calls at ``torch.set_num_threads(1)``, and
    restore the count after its last test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
