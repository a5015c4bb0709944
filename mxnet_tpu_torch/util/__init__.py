"""Utilities (counterpart of ``mxnet_tpu/util/``): ``test_utils`` and the
reference's helpers of ``mx.util``."""
import os

from . import test_utils  # noqa: F401

__all__ = ["test_utils", "makedirs", "get_gpu_count", "get_gpu_memory"]


def makedirs(d):
    os.makedirs(d, exist_ok=True)


def get_gpu_count():
    from ..context import num_gpus

    return num_gpus()


def get_gpu_memory(gpu_dev_id=0):
    """(free, total) bytes of card ``gpu_dev_id`` (reference:
    mx.util.get_gpu_memory); (0, 0) without a card."""
    import torch

    if not torch.cuda.is_available():
        return (0, 0)
    return torch.cuda.mem_get_info(gpu_dev_id)
