"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): the ResNets and ``get_model``."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from . import resnet as _resnet

__all__ = list(_resnet_all) + ["get_model"]


def get_model(name, **kwargs):
    """The model zoo network called ``name`` (e.g. "resnet50_v1")."""
    name = name.lower()
    if not name.startswith("resnet") or name not in _resnet_all:
        raise MXNetError(f"model {name!r} is not in the port's zoo "
                         f"(resnet*_v1/v2 only)")
    return getattr(_resnet, name)(**kwargs)
