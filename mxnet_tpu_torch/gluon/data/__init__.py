"""Gluon's data path of the port (counterpart of
``mxnet_tpu/gluon/data/``): datasets, samplers, the DataLoader with thread
or process workers, the device prefetcher and ``vision``."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from .prefetcher import *  # noqa: F401,F403
from . import vision

from .dataset import __all__ as _d
from .sampler import __all__ as _s
from .dataloader import __all__ as _l
from .prefetcher import __all__ as _p

__all__ = list(_d) + list(_s) + list(_l) + list(_p) + ["vision"]
