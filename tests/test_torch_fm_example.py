"""``example/sparse/factorization_machine.py``'s local mode at
``num_features=1000`` against the port's copy
(``factorization_machine_torch.py``): the reference's 20 losses within
1e-5, with the hand update and with SGD's lazy row-sparse update.

The reference runs with its eager jit cache off: with it on, it compiles
the CSR product again at each new number of nonzeros, which every batch
has (~30 s against ~4 s, the same losses bit for bit).
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_fm_losses():
    import mxnet_tpu as rmx

    ref = _load(os.path.join(REPO, "example", "sparse",
                             "factorization_machine.py"), "fm_reference")
    prev = rmx.nd.set_eager_jit(False)
    try:
        return ref.run(num_features=1000, steps=20, log_every=0)
    finally:
        rmx.nd.set_eager_jit(prev)


@pytest.mark.parametrize("lazy", [False, True], ids=["hand", "lazy-sgd"])
def test_fm_example_local_mode_matches_reference(reference_fm_losses, lazy):
    port = _load(os.path.join(REPO, "example", "sparse",
                              "factorization_machine_torch.py"), "fm_port")
    losses = port.run(num_features=1000, steps=20, log_every=0,
                      lazy_update=lazy, ctx=mx.cpu())
    assert len(losses) == 20 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, reference_fm_losses, rtol=1e-5,
                               atol=1e-5)
