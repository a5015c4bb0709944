"""The port's public names against the reference's, module by module and
on the main classes: every public name the reference defines (in the
module or its submodules; names it imports from elsewhere do not count)
must exist in the port, unless ``KNOWN`` lists it with the slice that
brings it or the reason it has no counterpart.  A name the port gains
must leave ``KNOWN``: the test fails on a stale entry too.
"""
import ast
import importlib
import inspect

import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from torch_threads import one_torch_thread  # noqa: F401

A6 = "the next multi-GPU slice (ROADMAP A6)"
A8 = "the rest of A8 (ROADMAP)"
NONE = "no counterpart in a process-per-device torch design"

KNOWN = {
    "": {"engine": A8, "graph": A8, "np": A8, "npx": A8, "numpy": A8,
         "numpy_extension": A8, "operator": A8, "rnn": A8, "runtime": A8},
    "contrib": {"onnx": A8, "quantization": A8, "svrg_optimization": A8,
                "text": A8},
    "parallel.collectives": {"fetch_global": NONE, "place_global": NONE,
                             "shard_map": NONE},
    "lifecycle": {"elastic_resharder": A6},
    "autograd": {"Entry": NONE, "Node": NONE, "record_callback_node": NONE,
                 "record_op": NONE},
    "gluon.data": {"stage_leaf": NONE},
    "gluon.Parameter": {"list_ctx": A6},
    "nd.NDArray": {"handle": A8, "to_dlpack_for_read": A8,
                   "to_dlpack_for_write": A8},
}

MODULES = ["", "nd", "ndarray", "gluon", "gluon.nn", "gluon.contrib.nn",
           "gluon.data", "gluon.loss", "kv", "kvstore", "parallel",
           "parallel.collectives", "parallel.distributed", "parallel.mesh",
           "parallel.bucketing", "parallel.zero", "parallel.planner",
           "parallel.planner.rules", "parallel.planner.hbm",
           "parallel.planner.plan", "parallel.tensor_parallel",
           "parallel.pipeline_parallel", "parallel.context_parallel",
           "parallel.expert_parallel", "parallel.data_parallel",
           "contrib", "contrib.amp",
           "optimizer", "lifecycle", "checkpoint", "guard", "autograd",
           "sym", "mod", "io", "random", "init", "lr_scheduler", "metric",
           "telemetry_agg", "profiler", "image", "recordio", "callback",
           "model", "monitor", "util"]
CLASSES = ["gluon.Parameter", "nd.NDArray", "gluon.Block",
           "gluon.HybridBlock", "gluon.Trainer", "kv.KVStore"]


def _get(root, path):
    obj = root
    for part in [p for p in path.split(".") if p]:
        if not hasattr(obj, part) and inspect.ismodule(obj):
            importlib.import_module(f"{obj.__name__}.{part}")
        obj = getattr(obj, part)
    return obj


def _bound_in_init(pkg):
    """The names a package's ``__init__.py`` binds itself (imports,
    definitions): a submodule some other import attached later is not
    one of the package's names."""
    with open(pkg.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            # ``from .a import b as c`` binds c, and the import system
            # binds the submodules a (and b, if it is one)
            for a in node.names:
                names.update({a.name.split(".")[0], a.asname or a.name})
            if isinstance(node, ast.ImportFrom) and node.level and \
                    node.module:
                names.add(node.module.split(".")[0])
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _own_names(obj):
    """Public names ``obj`` defines itself: in a module, the objects
    whose defining module is it or one of its submodules (a submodule
    only where the package's ``__init__`` binds it)."""
    names = set()
    bound = _bound_in_init(obj) if hasattr(obj, "__path__") else None
    for n in dir(obj):
        if n.startswith("_"):
            continue
        if inspect.ismodule(obj):
            v = getattr(obj, n)
            if inspect.ismodule(v) and bound is not None and n not in bound:
                continue
            home = v.__name__ if inspect.ismodule(v) else \
                getattr(v, "__module__", None)
            if not isinstance(home, str) or not (
                    home == obj.__name__ or home.startswith(
                        obj.__name__ + ".")):
                continue
        names.add(n)
    return names


@pytest.mark.parametrize("path", MODULES + CLASSES,
                         ids=lambda p: p or "mx")
def test_port_has_the_reference_public_names(path):
    ref, port = _get(rmx, path), _get(mx, path)
    missing = _own_names(ref) - set(dir(port))
    known = KNOWN.get(path, {})
    assert missing == set(known), (
        f"unexpected: {sorted(missing - set(known))}; "
        f"stale in KNOWN: {sorted(set(known) - missing)}")
    for reason in known.values():
        assert reason in (A6, A8, NONE)


def test_the_c16_names_work():
    assert mx.contrib.amp.init is not None
    assert mx.NDArray is mx.nd.NDArray
    assert mx.nd.current_context() == mx.current_context()
    a = mx.nd.ones((2,), ctx=mx.cpu())
    assert a.as_nd_ndarray() is a
    p = mx.gluon.Parameter("w", shape=(2, 3))
    r = rmx.gluon.Parameter("w", shape=(2, 3))
    v, rv = p.var(), r.var()
    assert v.name == rv.name == "w"
    assert v.list_arguments() == rv.list_arguments()
    assert mx.kv is mx.kvstore and mx.kv.create("dist").type == "dist"
