"""DenseNet-121 of the port against the reference on the CPU, by
test_torch_model_zoo_vision.py's helpers and rule (logits and every
gradient within 1e-4 of the larger of 1 and the magnitude, predict mode)
at 29 x 29, the smallest input it takes, batch 2."""
from test_torch_model_zoo_vision import _compare
from torch_threads import one_torch_thread  # noqa: F401


def test_densenet121_matches_reference():
    _compare("densenet121", (2, 3, 29, 29))
