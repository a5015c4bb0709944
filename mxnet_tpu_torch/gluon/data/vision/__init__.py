from . import transforms
from .datasets import *  # noqa: F401,F403
from .datasets import __all__ as _d

__all__ = list(_d) + ["transforms"]
