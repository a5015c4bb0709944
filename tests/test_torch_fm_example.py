"""``example/sparse/factorization_machine.py``'s local mode at
``num_features=1000`` against the port's copy
(``factorization_machine_torch.py``): the reference's 20 losses within
1e-5, with the hand update and with SGD's lazy row-sparse update.

The reference's run takes ~30 s: its eager jit compiles the CSR product
again at each new number of nonzeros, which every batch has.
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_fm_losses():
    ref = _load(os.path.join(REPO, "example", "sparse",
                             "factorization_machine.py"), "fm_reference")
    return ref.run(num_features=1000, steps=20, log_every=0)


@pytest.mark.parametrize("lazy", [False, True], ids=["hand", "lazy-sgd"])
def test_fm_example_local_mode_matches_reference(reference_fm_losses, lazy):
    port = _load(os.path.join(REPO, "example", "sparse",
                              "factorization_machine_torch.py"), "fm_port")
    losses = port.run(num_features=1000, steps=20, log_every=0,
                      lazy_update=lazy, ctx=mx.cpu())
    assert len(losses) == 20 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, reference_fm_losses, rtol=1e-5,
                               atol=1e-5)
