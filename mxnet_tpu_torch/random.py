"""Random state (counterpart of ``mxnet_tpu/random.py``): ``seed()``, one
explicit ``torch.Generator`` per device, ``get_state`` / ``set_state`` over
them, and the ``uniform`` / ``normal`` / ``randint`` helpers.  Every random
draw of the port (the samplers, the initializers, dropout, the random image
ops) takes its generator from :func:`generator`; nothing uses torch's
global generator.  The streams are torch's (Philox on the card), not the
reference's threefry keys: a seed fixes the draws of each package, not the
same draws in both.

``seed`` and ``set_state`` replace generator objects, and a CUDA graph
captured by a hybridized block draws from the generator it was captured
with: :func:`epoch` counts the replacements, and a block whose cache was
built at another epoch drops it."""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["seed", "generator", "get_state", "set_state", "epoch",
           "uniform", "normal", "randint"]


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.generators = {}     # torch.device -> torch.Generator


_S = _RngState()
_EPOCH = [0]     # generator replacements, in every thread


def epoch():
    """How many times ``seed``/``set_state`` replaced or reseeded the
    generators."""
    return _EPOCH[0]


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def seed(seed_state, ctx="all"):
    """Seed the generator of ``ctx`` (a Context), or of every device with
    ``ctx="all"`` (reference: mx.random.seed)."""
    _EPOCH[0] += 1
    if ctx == "all":
        _S.seed = int(seed_state)
        _S.generators.clear()
        return
    generator(ctx.device).manual_seed(int(seed_state))


def generator(device):
    """The generator of ``device``, created from the current seed at first
    use."""
    key = _key(device)
    gen = _S.generators.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_S.seed)
        _S.generators[key] = gen
    return gen


def _renew(device):
    """Replace ``device``'s generator by a fresh one at the same state (a
    CUDA-graph capture that ends in an error can leave a generator it
    registered unusable outside a capture); graphs captured with the old
    one are rebuilt (``epoch``)."""
    key = _key(device)
    old = _S.generators.get(key)
    if old is None:
        return
    gen = torch.Generator(device=key)
    gen.set_state(old.get_state())
    _S.generators[key] = gen
    _EPOCH[0] += 1


def get_state():
    """A JSON-able snapshot of this thread's random state: the seed and
    each created generator's state bytes, by device.  With
    :func:`set_state` the draws that follow replay bit for bit on the same
    devices (a checkpoint's resume)."""
    return {"seed": _S.seed,
            "generators": {str(dev): gen.get_state().tolist()
                           for dev, gen in _S.generators.items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot (None: back to the unseeded
    default, seed 0)."""
    if state is not None and not isinstance(state, dict):
        raise MXNetError("set_state takes a state of this package's "
                         "get_state(); the reference's (its threefry key "
                         "words) cannot seed torch's generators")
    _EPOCH[0] += 1
    _S.generators.clear()
    if state is None:
        _S.seed = 0
        return
    _S.seed = int(state["seed"])
    for dev, words in state["generators"].items():
        gen = torch.Generator(device=_key(dev))
        gen.set_state(torch.tensor(words, dtype=torch.uint8))
        _S.generators[_key(dev)] = gen


def uniform(low=0, high=1, shape=None, dtype="float32", ctx=None, out=None):
    from .ndarray import ndarray as _nd

    return _nd.invoke("random_uniform", [], {"low": low, "high": high,
                                             "shape": shape or (1,),
                                             "dtype": dtype},
                      out=out, ctx=ctx)


def normal(loc=0, scale=1, shape=None, dtype="float32", ctx=None, out=None):
    from .ndarray import ndarray as _nd

    return _nd.invoke("random_normal", [], {"loc": loc, "scale": scale,
                                            "shape": shape or (1,),
                                            "dtype": dtype},
                      out=out, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    from .ndarray import ndarray as _nd

    return _nd.invoke("random_randint", [], {"low": low, "high": high,
                                             "shape": shape or (1,),
                                             "dtype": dtype},
                      out=out, ctx=ctx)
