"""Inception-v3 of the port against the reference on the CPU, by
test_torch_model_zoo_vision.py's helpers and rule (logits and every
gradient within 1e-4 of the larger of 1 and the magnitude, predict mode)
at 299 x 299, the smallest input it takes (its last pooling is 8 x 8),
batch 1."""
from test_torch_model_zoo_vision import _compare
from torch_threads import one_torch_thread  # noqa: F401


def test_inception_v3_matches_reference():
    _compare("inceptionv3", (1, 3, 299, 299))
