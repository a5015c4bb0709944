"""Gluon's data path of the port: so far the device prefetcher
(``PrefetchIterator``).  Dataset, Sampler and DataLoader are not ported
yet."""
from .prefetcher import PrefetchIterator, device_put_batch

__all__ = ["PrefetchIterator", "device_put_batch"]
