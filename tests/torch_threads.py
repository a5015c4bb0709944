"""One torch thread in a port test module that a pytest-xdist worker
runs.

Under ``-n 6`` each worker's torch would start an OpenMP team as wide as
the machine for every op, and six such teams on one host spend most of
their time waiting on each other: the port's files took 3311 worker-
seconds so, against 1361 with one thread (``-n 6 --dist loadfile`` over
``tests/test_torch_*.py``; ROADMAP B2.6).  A module imports the fixture
(``from torch_threads import one_torch_thread  # noqa: F401``) and runs
with one thread and ``OMP_NUM_THREADS=1`` for the processes it starts;
both are restored after it.  Outside xdist nothing changes.  A module
whose tolerances were measured at the machine's thread count keeps it
(``test_torch_gluon.py``: an Adam step within 2e-5 of the reference's
misses by one element at one thread).
"""
import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    if "PYTEST_XDIST_WORKER" not in os.environ:
        yield
        return
    import torch

    prev_n, prev_env = torch.get_num_threads(), \
        os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(prev_n)
        if prev_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev_env
