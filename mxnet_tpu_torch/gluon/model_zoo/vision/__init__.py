"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ResNet v1/v2, AlexNet, VGG (with
and without BatchNorm), SqueezeNet 1.0/1.1, MobileNet v1 and v2,
DenseNet and Inception-v3, and ``get_model`` over the reference's names."""
import sys as _sys

from ....base import MXNetError
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
# the modules (the star imports put each family's constructor of the same
# name, e.g. ``alexnet``, in the package's namespace)
_a, _d, _i, _m, _r, _s, _v = (_sys.modules[f"{__name__}.{f}"] for f in (
    "alexnet", "densenet", "inception", "mobilenet", "resnet", "squeezenet",
    "vgg"))

__all__ = list(_r.__all__) + list(_a.__all__) + list(_v.__all__) + \
    list(_s.__all__) + list(_m.__all__) + list(_d.__all__) + \
    list(_i.__all__) + ["get_model"]

# the reference's registry: every constructor by its lower-case name
_models = {n: getattr(_r, n) for n in _r.__all__
           if n.startswith("resnet") and n[6].isdigit()}
_models["alexnet"] = _a.alexnet
_models.update({n: getattr(_v, n) for n in _v.__all__
                if n.startswith("vgg") and n[3].isdigit()})
_models.update({n: getattr(_m, n) for n in _m.__all__
                if n.startswith("mobilenet")})
_models.update({n: getattr(_s, n) for n in _s.__all__
                if n.startswith("squeezenet") and n[10].isdigit()})
_models.update({n: getattr(_d, n) for n in _d.__all__
                if n.startswith("densenet") and n[8].isdigit()})
_models["inceptionv3"] = _i.inception_v3


def get_model(name, **kwargs):
    """The model zoo network called ``name`` (e.g. "resnet50_v1",
    "mobilenet_v2_1_0", "inceptionv3")."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"model {name} not found; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
