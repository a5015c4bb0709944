"""Symbol: the staged-graph frontend, ``mx.sym`` (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is a Python DAG over the same op table that drives ``mx.nd.*``:
one definition of every op, no second kernel surface.  ``evaluate``
interprets the DAG with the table's torch functions, so torch autograd
differentiates it (the Executor's backward, a SymbolBlock under
``record()``) and an ``_contrib_flash_attention`` node on CUDA tensors
launches the Hopper kernel.  ``infer_shape`` runs each op's function on
``device="meta"`` tensors (the reference's ``jax.eval_shape``); an op
that cannot run there (no meta kernel: CTC; a draw from a generator) runs
once on zeros on the CPU with a throwaway generator, the attention has its
rule (:data:`_SHAPE_RULES`), and the two ops whose output shape depends on
their values (``boolean_mask``, ``where_index``) raise, as in the
reference.

The JSON is the reference's nnvm schema (``nodes``/``arg_nodes``/
``heads``, the ``__shape__``/``__nout__``/``__const__`` attrs), so a file
written by either package loads in the other.

``SymbolTracer`` is the export seam: an NDArray whose tensor is a meta
tensor (its shape and dtype) and which carries a graph head.  While
``ndarray._SYMTRACE["on"]``, ``invoke`` hands every call with a tracer
input to :func:`trace_invoke`, which adds a node; NDArray's methods reach
``invoke`` and so trace too, and the few that would touch the tensor
itself (indexing, in-place writes, host reads) are overridden here to
trace or to raise.
"""
from __future__ import annotations

import ast
import functools
import json
import threading
from contextlib import contextmanager

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..ndarray.ndarray import NDArray
from ..ops.registry import OP_TABLE, get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "constant", "evaluate", "SymbolTracer", "trace_invoke",
           "populate_namespace"]

# ops whose outputs write back into an aux-state input during training
# (input index -> output index); aux classification derives from these
# slots (Symbol._aux_var_ids), never from name suffixes
_STATE_OPS = {"BatchNorm": ((3, 1), (4, 2))}

# ops told that they run in training mode by evaluate(training=True)
_TRAINING_OPS = ("BatchNorm", "Dropout", "RNN")

# parameter inputs auto-created as variables when omitted at call sites:
# mx.sym.FullyConnected(data, num_hidden=10) makes fc0_weight / fc0_bias
_OP_PARAM_VARS = {
    "FullyConnected": lambda a: ["weight"] + ([] if a.get("no_bias") else ["bias"]),
    "Convolution": lambda a: ["weight"] + ([] if a.get("no_bias") else ["bias"]),
    "Deconvolution": lambda a: ["weight"] + ([] if a.get("no_bias", True) else ["bias"]),
    "BatchNorm": lambda a: ["gamma", "beta", "moving_mean", "moving_var"],
    "Embedding": lambda a: ["weight"],
    "LayerNorm": lambda a: ["gamma", "beta"],
    "GroupNorm": lambda a: ["gamma", "beta"],
    "InstanceNorm": lambda a: ["gamma", "beta"],
    "RNN": lambda a: ["parameters", "state"] + (
        ["state_cell"] if str(a.get("mode", "lstm")) == "lstm" else []),
}

# fused/derived ops inheriting a base op's param-shape rules
_OP_SHAPE_HINT_ALIASES = {}


def _param_shape_hints(op, attrs, data_shape):
    """Backward shape inference for auto-created parameter variables (the
    meta run is forward-only, so the param-bearing ops get these hints)."""
    op = _OP_SHAPE_HINT_ALIASES.get(op, op)
    a = attrs
    if op == "FullyConnected":
        nh = int(a["num_hidden"])
        in_units = (int(_np.prod(data_shape[1:])) if a.get("flatten", True)
                    else data_shape[-1])
        return {"weight": (nh, in_units), "bias": (nh,)}
    if op in ("Convolution", "Deconvolution"):
        k = a["kernel"]
        k = (k,) if isinstance(k, int) else tuple(k)
        nf = int(a["num_filter"])
        g = int(a.get("num_group", 1))
        # channel-last layouts (NHWC...) keep the channels, and the
        # weight's input channels, last
        cl = str(a.get("layout") or "").endswith("C")
        c = data_shape[-1] if cl else data_shape[1]
        if op == "Convolution":
            w = (nf,) + k + (c // g,) if cl else (nf, c // g) + k
        else:
            w = (c,) + k + (nf // g,) if cl else (c, nf // g) + k
        return {"weight": w, "bias": (nf,)}
    if op == "BatchNorm":
        c = data_shape[a.get("axis", 1)]
        return {k: (c,) for k in ("gamma", "beta", "moving_mean", "moving_var",
                                  "running_mean", "running_var")}
    if op == "Embedding":
        return {"weight": (int(a["input_dim"]), int(a["output_dim"]))}
    if op in ("LayerNorm", "GroupNorm", "InstanceNorm"):
        ax = a.get("axis", -1) if op == "LayerNorm" else 1
        c = data_shape[ax]
        return {"gamma": (c,), "beta": (c,)}
    if op == "RNN":
        from ..ops.nn import rnn_param_size

        nh = int(a["state_size"])
        nl = int(a.get("num_layers", 1))
        bi = _attr_true(a.get("bidirectional"))
        ndir = 2 if bi else 1
        t, n, c = data_shape  # TNC layout
        total = rnn_param_size(str(a.get("mode", "lstm")), c, nh, nl, bi)
        return {"parameters": (total,), "state": (nl * ndir, n, nh),
                "state_cell": (nl * ndir, n, nh)}
    return {}


# label-var shape back-inference for the legacy loss heads
_LABEL_SHAPE_FROM_DATA = {
    "SoftmaxOutput": lambda ds: tuple(ds[:-1]),
    "LinearRegressionOutput": lambda ds: tuple(ds),
    "LogisticRegressionOutput": lambda ds: tuple(ds),
    "MAERegressionOutput": lambda ds: tuple(ds),
}

# arity resolution for nout='dynamic' ops when building graphs without shapes
_DYNAMIC_NOUT = {
    "split": lambda attrs, nin: int(attrs.get("num_outputs", 1)),
    "SliceChannel": lambda attrs, nin: int(attrs.get("num_outputs", 1)),
    "slice_channel": lambda attrs, nin: int(attrs.get("num_outputs", 1)),
    "topk": lambda attrs, nin: 2 if attrs.get("ret_typ") == "both" else 1,
    "amp_multicast": lambda attrs, nin: nin,
}


def _attr_true(v):
    """Symbol attrs may arrive as python bools or JSON strings."""
    return v in (True, "True", "true", "1", 1)


def _proposal_nout(attrs, nin):
    return 2 if _attr_true(attrs.get("output_score")) else 1


for _k in ("_contrib_Proposal", "Proposal", "proposal"):
    _DYNAMIC_NOUT[_k] = _proposal_nout


def _rnn_nout(attrs, nin):
    if not _attr_true(attrs.get("state_outputs")):
        return 1
    return 3 if str(attrs.get("mode", "lstm")) == "lstm" else 2


for _k in ("RNN", "rnn"):
    _DYNAMIC_NOUT[_k] = _rnn_nout


class _NameManager(threading.local):
    def __init__(self):
        self.counters = {}

    def get(self, hint):
        hint = hint.lower()
        n = self.counters.get(hint, 0)
        self.counters[hint] = n + 1
        return f"{hint}{n}"


_NAMER = _NameManager()


class _Node:
    """One graph node: an op application or a variable (op=None).
    ``_on`` caches a constant's tensor by device, made before any CUDA
    graph captures the node (a capture cannot copy from host memory)."""

    __slots__ = ("op", "name", "attrs", "inputs", "nout", "value", "_on")

    def __init__(self, op, name, attrs=None, inputs=(), nout=1, value=None):
        self.op = op              # op name (str) | None for variable/constant
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)  # [(Node, out_index)]
        self.nout = nout
        self.value = value        # constants only: a numpy array
        self._on = {}

    @property
    def is_var(self):
        return self.op is None and self.value is None

    @property
    def is_const(self):
        return self.op is None and self.value is not None

    def const_tensor(self, device):
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.as_tensor(self.value, device=device)
        return t


def _resolve_nout(opname, attrs, nin):
    od = get_op(opname)
    if od.nout == "dynamic":
        fn = _DYNAMIC_NOUT.get(opname)
        if fn is None:
            raise MXNetError(
                f"op {opname!r} has dynamic arity; cannot stage symbolically")
        return fn(attrs, nin)
    return od.nout


def _topo(heads):
    """Topological order of all nodes reachable from head (node, idx) pairs."""
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


# --------------------------------------------------------------------------
# output shapes and dtypes of one op application, without running it
# --------------------------------------------------------------------------
def _flash_attention_rule(q, k, v, **attrs):
    return q.new_empty(tuple(q.shape[:-1]) + (v.shape[-1],))


# ops whose function refuses meta tensors and whose output shape is known
# without running them (the attention runs only on CUDA and CPU tensors)
_SHAPE_RULES = {"_contrib_flash_attention": _flash_attention_rule}

# ops whose output shape depends on their input values (a nonzero count):
# no shape can be inferred, as the reference's eval_shape cannot either
_VALUE_SHAPED = ("boolean_mask", "where_index")


@contextmanager
def _generator_scope(generator):
    """``generator`` as the port's generator of its device for the
    duration (None: the port's own)."""
    if generator is None:
        yield
        return
    from .. import random as _random

    key = _random._key(generator.device)
    old = _random._S.generators.get(key)
    _random._S.generators[key] = generator
    try:
        yield
    finally:
        if old is None:
            _random._S.generators.pop(key, None)
        else:
            _random._S.generators[key] = old


def _out_avals(od, in_avals, attrs):
    """Meta tensors of ``od``'s outputs for inputs shaped like ``in_avals``
    (tensors of any device; only shape and dtype are read).  A list."""
    if od.name in _VALUE_SHAPED:
        raise MXNetError(f"{od.name}: its output shape depends on its input "
                         f"values and cannot be inferred")
    metas = [torch.empty(tuple(a.shape), dtype=a.dtype, device="meta")
             for a in in_avals]
    kw = dict(attrs)
    if od.creation:
        kw["device"] = torch.device("meta")
    rule = _SHAPE_RULES.get(od.name)
    try:
        out = rule(*metas, **kw) if rule is not None else od.fn(*metas, **kw)
    except (NotImplementedError, RuntimeError, MXNetError):
        # no meta kernel, or a draw from a generator: run on zeros on the
        # CPU (shapes that depend on values fail here as in the reference)
        zeros = [torch.zeros(tuple(a.shape), dtype=a.dtype) for a in in_avals]
        if od.creation:
            kw["device"] = torch.device("cpu")
        # a fresh CPU generator, so that a shape run of a sampler leaves
        # the user's stream untouched
        with torch.no_grad(), _generator_scope(torch.Generator()):
            out = od.fn(*zeros, **kw)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [torch.empty(tuple(o.shape), dtype=o.dtype, device="meta")
            for o in outs]


class Symbol:
    """A symbolic multi-output handle onto the staged graph."""

    __slots__ = ("_heads",)

    def __init__(self, heads):
        self._heads = list(heads)   # [(node, out_index)]

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def list_outputs(self):
        outs = []
        for node, idx in self._heads:
            if node.nout == 1:
                outs.append(f"{node.name}_output" if node.op else node.name)
            else:
                outs.append(f"{node.name}_output{idx}")
        return outs

    @staticmethod
    def _aux_var_ids(nodes):
        """Variables feeding an aux-state input slot of a state op: by graph
        position, so a parameter whose name merely ends in running_mean is
        never misfiled."""
        aux = set()
        for n in nodes:
            for in_idx, _ in _STATE_OPS.get(n.op, ()):
                if in_idx < len(n.inputs):
                    inp, _ = n.inputs[in_idx]
                    if inp.is_var:
                        aux.add(id(inp))
        return aux

    def list_arguments(self):
        nodes = _topo(self._heads)
        aux = self._aux_var_ids(nodes)
        return [n.name for n in nodes if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self):
        nodes = _topo(self._heads)
        aux = self._aux_var_ids(nodes)
        return [n.name for n in nodes if n.is_var and id(n) in aux]

    def list_inputs(self):
        return [n.name for n in _topo(self._heads) if n.is_var]

    def attr(self, key):
        if len(self._heads) == 1:
            v = self._heads[0][0].attrs.get(key)
            return None if v is None else str(v)
        return None

    def attr_dict(self):
        out = {}
        for n in _topo(self._heads):
            if n.attrs:
                out[n.name] = {k: str(v) for k, v in n.attrs.items()}
        return out

    def _set_attr(self, **kwargs):
        for node, _ in self._heads:
            node.attrs.update(kwargs)

    def optimize_for(self, backend, args=None, aux=None, ctx=None, **kwargs):
        """The subgraph backends' partitioning passes wait for the port of
        the graph tier (ROADMAP.md A8)."""
        raise MXNetError("Symbol.optimize_for is not ported yet: the "
                         "subgraph passes come with the graph tier "
                         "(ROADMAP.md A8)")

    def get_internals(self):
        nodes = _topo(self._heads)
        heads = []
        for n in nodes:
            for i in range(n.nout):
                heads.append((n, i))
        return Symbol(heads)

    def get_children(self):
        kids = []
        for node, _ in self._heads:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    def __getitem__(self, index):
        if isinstance(index, str):
            matches = [i for i, name in enumerate(self.list_outputs())
                       if name == index or name.rsplit("_output", 1)[0] == index]
            if not matches:
                raise MXNetError(f"no output named {index!r}")
            return Symbol([self._heads[matches[0]]])
        if isinstance(index, slice):
            return Symbol(self._heads[index])
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (Symbol([h]) for h in self._heads)

    def __repr__(self):
        name = self.name
        return f"<Symbol {name if name else 'Grouped'}>"

    def __copy__(self):
        return self.__class__(self._heads)

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # ------------------------------------------------------------------
    # composition
    # ------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if args:
            raise MXNetError("compose only supports keyword arguments "
                             "(name=symbol)")
        subst = {}
        for k, v in kwargs.items():
            if not isinstance(v, Symbol) or len(v._heads) != 1:
                raise MXNetError("compose values must be single-output Symbols")
            subst[k] = v._heads[0]
        return Symbol([_substitute(h, subst, {}) for h in self._heads])

    # ------------------------------------------------------------------
    # shape/type inference (each op's function on meta tensors)
    # ------------------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError(f"infer_shape failed: {e}") from e

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known = {}
        if args:
            for name, shape in zip(arg_names, args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})

        # propagate shapes node by node in topological order
        shapes = dict(known)
        nodes = _topo(self._heads)
        for n in nodes:
            if n.is_const:
                shapes[n.name] = tuple(n.value.shape)
            elif n.is_var and n.name not in shapes:
                declared = n.attrs.get("__shape__")
                if declared is not None:
                    shapes[n.name] = tuple(declared)
        progressed = True
        while progressed:
            progressed = False
            for n in nodes:
                if n.op is None:
                    continue
                key = id(n)
                if key in shapes:
                    continue
                # label shapes back-infer from the data input for the
                # legacy loss-output ops, so predict-time binds need no
                # label_shapes
                if n.op in _LABEL_SHAPE_FROM_DATA and len(n.inputs) >= 2:
                    d0, lab = n.inputs[0][0], n.inputs[1][0]
                    ds = (shapes.get(d0.name) if d0.op is None
                          else shapes.get((id(d0), n.inputs[0][1])))
                    if ds is not None and lab.op is None \
                            and lab.name not in shapes:
                        shapes[lab.name] = _LABEL_SHAPE_FROM_DATA[n.op](ds)
                        progressed = True
                # backward-infer auto-created param-var shapes from data shape
                if n.op in _OP_PARAM_VARS and n.inputs:
                    d0 = n.inputs[0][0]
                    ds = (shapes.get(d0.name) if d0.op is None
                          else shapes.get((id(d0), n.inputs[0][1])))
                    if ds is not None:
                        hints = _param_shape_hints(n.op, _clean_attrs(n.attrs), ds)
                        for inp, _ in n.inputs[1:]:
                            if inp.op is None and inp.name not in shapes:
                                for pname, shp in hints.items():
                                    if (inp.name == pname
                                            or inp.name.endswith("_" + pname)
                                            or inp.name.endswith("." + pname)):
                                        shapes[inp.name] = shp
                                        progressed = True
                                        break
                in_shapes = []
                ok = True
                for inp, idx in n.inputs:
                    if inp.op is None:
                        s = shapes.get(inp.name)
                    else:
                        s = shapes.get((id(inp), idx))
                    if s is None:
                        ok = False
                        break
                    in_shapes.append(s)
                if not ok:
                    continue
                od = get_op(n.op)
                avals = [torch.empty(s, dtype=torch.float32, device="meta")
                         for s in in_shapes]
                try:
                    outs = _out_avals(od, avals, _clean_attrs(n.attrs))
                except Exception as e:
                    if partial:
                        continue
                    raise MXNetError(
                        f"shape inference failed at node {n.name} ({n.op}): {e}"
                    ) from e
                for i, o in enumerate(outs):
                    shapes[(id(n), i)] = tuple(o.shape)
                shapes[key] = True
                progressed = True

        def get_shape(n, idx=0):
            if n.op is None:
                return shapes.get(n.name)
            return shapes.get((id(n), idx))

        arg_shapes = [shapes.get(nm) for nm in arg_names]
        aux_shapes = [shapes.get(nm) for nm in aux_names]
        out_shapes = [get_shape(n, i) for n, i in self._heads]
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            # variable shapes are inferred forward only (and the hints
            # above); callers must give every input shape
            missing = [nm for nm, s in zip(arg_names, arg_shapes) if s is None]
            if missing:
                return None, None, None
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        # everything defaults to float32, as in the reference
        arg_types = [_np.float32] * len(self.list_arguments())
        out_types = [_np.float32] * len(self._heads)
        aux_types = [_np.float32] * len(self.list_auxiliary_states())
        return arg_types, out_types, aux_types

    # ------------------------------------------------------------------
    # serialization (nnvm JSON schema)
    # ------------------------------------------------------------------
    def tojson(self):
        nodes = _topo(self._heads)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            entry = {"op": n.op if n.op else "null", "name": n.name,
                     "inputs": [[nid[id(inp)], idx, 0] for inp, idx in n.inputs]}
            attrs = {k: _attr_str(v) for k, v in n.attrs.items()}
            if n.is_const:
                attrs["__value__"] = json.dumps(n.value.tolist())
                attrs["__dtype__"] = str(n.value.dtype)
                attrs["__const__"] = "1"
            if n.op and n.nout != 1:
                attrs["__nout__"] = str(n.nout)
            if attrs:
                entry["attrs"] = attrs
            if n.op is None:
                arg_nodes.append(i)
            jnodes.append(entry)
        heads = [[nid[id(n)], idx, 0] for n, idx in self._heads]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10600],
                                     "framework": ["str", "mxnet_tpu_torch"]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ------------------------------------------------------------------
    # evaluation / binding
    # ------------------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, dict(kwargs))
        return ex.forward()

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor

        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, **kwargs):
        from ..executor import Executor
        from ..ndarray import zeros

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("simple_bind needs enough shapes to infer all "
                             f"arguments; got {kwargs}")
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        # type_dict: dtypes by name; the others take the first given one
        # (the reference's infer_type propagates the inputs' type through
        # a float graph), float32 without any
        type_dict = dict(type_dict or {})
        default = next(iter(type_dict.values()), "float32")

        def new(name, shape):
            return zeros(shape, ctx=ctx, dtype=type_dict.get(name, default))

        args = {}
        shared = shared_exec.arg_dict if shared_exec is not None else None
        for name, shape in zip(arg_names, arg_shapes):
            if shared is not None and name in shared and name not in kwargs:
                args[name] = shared[name]
            else:
                args[name] = new(name, shape)
        aux = {}
        shared_aux = shared_exec.aux_dict if shared_exec is not None else None
        for name, shape in zip(aux_names, aux_shapes):
            if shared_aux is not None and name in shared_aux:
                aux[name] = shared_aux[name]
            else:
                aux[name] = new(name, shape)
        args_grad = None
        if grad_req != "null":
            args_grad = {n: new(n, s) for n, s in zip(arg_names, arg_shapes)}
        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux)

    # ------------------------------------------------------------------
    # operator sugar (mirrors NDArray's)
    # ------------------------------------------------------------------
    def _binary(self, op, other, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _sym_invoke(op, [a, b], {})
        attrs = {"scalar": float(other), "reverse": reverse}
        return _sym_invoke(op + "_scalar", [self], attrs)

    def __add__(self, o):
        return self._binary("broadcast_add", o)

    def __radd__(self, o):
        return self._binary("broadcast_add", o, reverse=True)

    def __sub__(self, o):
        return self._binary("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binary("broadcast_sub", o, reverse=True)

    def __mul__(self, o):
        return self._binary("broadcast_mul", o)

    def __rmul__(self, o):
        return self._binary("broadcast_mul", o, reverse=True)

    def __truediv__(self, o):
        return self._binary("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binary("broadcast_div", o, reverse=True)

    def __pow__(self, o):
        return self._binary("broadcast_power", o)

    def __neg__(self):
        return _sym_invoke("negative", [self], {})

    def __getstate__(self):
        return {"json": self.tojson()}

    def __setstate__(self, state):
        self._heads = load_json(state["json"])._heads

    def reshape(self, shape):
        return _sym_invoke("reshape", [self], {"shape": shape})

    def transpose(self, axes=None):
        return _sym_invoke("transpose", [self], {"axes": axes})


def _encode_slices(v):
    """slice objects (from _slice_key indexing nodes) are not literals:
    encode them as tagged tuples so JSON attrs round-trip."""
    if isinstance(v, slice):
        return ("__slice__", v.start, v.stop, v.step)
    if isinstance(v, tuple):
        return tuple(_encode_slices(x) for x in v)
    if isinstance(v, list):
        return [_encode_slices(x) for x in v]
    return v


def _decode_slices(v):
    if isinstance(v, tuple):
        if len(v) == 4 and v[0] == "__slice__":
            return slice(v[1], v[2], v[3])
        return tuple(_decode_slices(x) for x in v)
    if isinstance(v, list):
        return [_decode_slices(x) for x in v]
    return v


def _attr_str(v):
    return repr(_encode_slices(v)) if not isinstance(v, str) else v


def _parse_attr(s):
    try:
        return _decode_slices(ast.literal_eval(s))
    except (ValueError, SyntaxError):
        return s


def _clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if not k.startswith("__")}


def _substitute(head, subst, memo):
    node, idx = head
    if node.is_var and node.name in subst:
        return subst[node.name]
    if id(node) in memo:
        return (memo[id(node)], idx)
    if node.op is None:
        memo[id(node)] = node
        return (node, idx)
    new = _Node(node.op, node.name, node.attrs,
                [_substitute(h, subst, memo) for h in node.inputs],
                nout=node.nout, value=node.value)
    memo[id(node)] = new
    return (new, idx)


# --------------------------------------------------------------------------
# construction API
# --------------------------------------------------------------------------
def var(name, attr=None, shape=None, dtype=None, init=None, stype=None,
        lr_mult=None, wd_mult=None, **kwargs):
    """Create a symbolic variable (reference: mx.sym.Variable)."""
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        # per-variable initializer override (InitDesc.attrs)
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


Variable = var


def constant(value, name=None):
    value = _np.asarray(value)
    name = name or _NAMER.get("_const")
    return Symbol([(_Node(None, name, {}, value=value), 0)])


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for entry in data["nodes"]:
        attrs = {k: _parse_attr(v) for k, v in entry.get("attrs", {}).items()}
        op = entry["op"]
        if op == "null":
            if attrs.pop("__const__", None):
                # the value as written (a JSON list): literal_eval parsed
                # it already, and json.loads of that list would fail (it
                # does in the reference's loader, ROADMAP.md C13)
                value = entry["attrs"]["__value__"]
                attrs.pop("__value__")
                value = _np.asarray(json.loads(value),
                                    dtype=attrs.pop("__dtype__", "float32"))
                nodes.append(_Node(None, entry["name"], attrs, value=value))
            else:
                nodes.append(_Node(None, entry["name"], attrs))
        else:
            inputs = [(nodes[nid], idx) for nid, idx, _ in entry["inputs"]]
            nout = int(attrs.pop("__nout__", 0)) or _resolve_nout(
                op, attrs, len(inputs))
            nodes.append(_Node(op, entry["name"], attrs, inputs, nout=nout))
    heads = [(nodes[nid], idx) for nid, idx, _ in data["heads"]]
    return Symbol(heads)


# --------------------------------------------------------------------------
# symbolic invoke: builds a graph node (the staged twin of ndarray.invoke)
# --------------------------------------------------------------------------
def _sym_invoke(opname, inputs, attrs, name=None):
    od = get_op(opname)
    attrs = {k: v for k, v in attrs.items()
             if v is not None or k in ("axis", "a_min", "a_max")}
    in_heads = []
    for a in inputs:
        if a is None:
            continue
        if isinstance(a, Symbol):
            if len(a._heads) != 1:
                raise MXNetError(
                    f"op {opname}: grouped symbol cannot be an input")
            in_heads.append(a._heads[0])
        else:
            in_heads.append(constant(a)._heads[0])
    name = name or _NAMER.get(od.name)
    # auto-create parameter variables for the param-bearing layer ops
    pv = _OP_PARAM_VARS.get(od.name)
    if pv is not None:
        wanted = pv(attrs)
        have = len(in_heads) - 1  # first input is data
        for pname in wanted[max(have, 0):]:
            in_heads.append((_Node(None, f"{name}_{pname}", {}), 0))
    nout = _resolve_nout(od.name, attrs, len(in_heads))
    node = _Node(od.name, name, attrs, in_heads, nout=nout)
    if nout == 1 or od.name in _STATE_OPS:
        # state ops (BatchNorm) expose only the primary output as the
        # chainable head: the extra outputs are running-stat updates the
        # interpreter writes back into aux states
        return Symbol([(node, 0)])
    return Symbol([(node, i) for i in range(nout)])


# --------------------------------------------------------------------------
# interpreter: evaluate head values given a feed dict of input values
# --------------------------------------------------------------------------
def evaluate(heads, feed, generator=None, training=False,
             collect_state=False, device=None, monitor=None):
    """Evaluate graph heads with the op table's torch functions.

    feed: dict name -> torch tensor for every variable (args + aux).
    generator: the ``torch.Generator`` the graph's random ops draw from
    (default: the port's generator of their device).  device: where
    constants and creation ops go (default: the first fed tensor's).
    monitor: a callable (output name, tensor) called on each node's
    outputs (``Executor.set_monitor_callback``).
    Returns (outputs, state_updates) where state_updates maps an aux var
    name to its new value (BatchNorm moving stats under training).  Runs
    with torch autograd as the caller's grad mode says; under
    ``amp.init()`` each op's inputs are cast by the policy, as ``invoke``
    casts them.
    """
    from ..ndarray.ndarray import _AMP

    if device is None:
        device = next((v.device for v in feed.values()
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = {}            # (id(node), idx) -> tensor
    state_updates = {}
    with _generator_scope(generator):
        for n in _topo(heads):
            if n.op is None:
                if n.is_const:
                    vals[(id(n), 0)] = n.const_tensor(device)
                else:
                    if n.name not in feed:
                        raise MXNetError(f"unbound variable {n.name!r}")
                    vals[(id(n), 0)] = feed[n.name]
                continue
            od = get_op(n.op)
            in_vals = [vals[(id(inp), idx)] for inp, idx in n.inputs]
            attrs = _clean_attrs(n.attrs)
            if training and n.op in _TRAINING_OPS:
                attrs["training"] = True
            if od.creation:
                attrs["device"] = device
            fn = functools.partial(od.fn, **attrs)
            if _AMP["on"]:
                # the imperative invoke's mixed-precision cast policy:
                # without it SymbolBlock/Executor graphs would run in full
                # precision under amp.init()
                fn = _AMP["wrap"](od, fn)
            out = fn(*in_vals)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, v in enumerate(outs):
                vals[(id(n), i)] = v
                if monitor is not None:
                    monitor(f"{n.name}_output" if n.nout == 1 else
                            f"{n.name}_output{i}", v)
            if collect_state and training and n.op in _STATE_OPS:
                for in_idx, out_idx in _STATE_OPS[n.op]:
                    if in_idx < len(n.inputs):
                        aux_node = n.inputs[in_idx][0]
                        if aux_node.op is None:
                            state_updates[aux_node.name] = outs[out_idx]
    outputs = [vals[(id(n), i)] for n, i in heads]
    return outputs, state_updates


# --------------------------------------------------------------------------
# symbolic tracing of imperative code (the HybridBlock.export seam)
# --------------------------------------------------------------------------
class SymbolTracer(NDArray):
    """An NDArray whose tensor is a meta tensor (the value's shape and
    dtype) and which carries a graph head: imperative ``forward`` code
    runs unmodified, and each op it calls becomes a node."""

    __slots__ = ("_symhead", "_ctx")

    @classmethod
    def new(cls, head, aval, ctx=None):
        """A tracer for graph head ``head`` (node, output index) with the
        value's meta tensor ``aval``."""
        self = object.__new__(cls)
        self._data = aval
        self._grad = None
        self._grad_req = "null"
        self._symhead = head            # (node, idx)
        self._ctx = ctx
        return self

    @property
    def context(self):
        return self._ctx

    ctx = context

    def asnumpy(self):
        # asscalar, item, tolist, bool(), float() read through here
        raise MXNetError(
            "cannot read a value during symbolic export tracing: "
            "remove asnumpy()/asscalar()/item() calls from forward()")

    def _set(self, value):
        raise MXNetError("cannot write into an array during symbolic "
                         "export tracing")

    def __setitem__(self, key, value):
        self._set(value)

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError("attach_grad during symbolic export tracing")

    def copyto(self, other):
        raise MXNetError("copyto during symbolic export tracing")

    def as_in_context(self, ctx):
        return self

    as_in_ctx = as_in_context

    def detach(self):
        return trace_invoke("BlockGrad", [self], {})

    def copy(self):
        return trace_invoke("_copy", [self], {})

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage during symbolic export "
                             "tracing")
        return self

    # the reference tracer's forms, so that both packages write the
    # same attrs (a scalar as a float, a reshape's shape as given)
    def _binary(self, op, other, reverse=False):
        if isinstance(other, (NDArray, _np.ndarray, list, tuple)):
            args = [other, self] if reverse else [self, other]
            return trace_invoke(op, args, {})
        return trace_invoke(op + "_scalar", [self],
                            {"scalar": float(other), "reverse": reverse})

    def _inplace(self, op, o):
        # x += y rebinds the name to a new node, as x = x + y
        return self._binary(op, o)

    def __getitem__(self, key):
        return trace_invoke("_slice_key", [self], {"key": key})

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return trace_invoke("reshape", [self], {"shape": tuple(shape)})

    def astype(self, dtype, copy=True):
        return trace_invoke("Cast", [self],
                            {"dtype": "bfloat16" if str(dtype) ==
                             "bfloat16" else str(_np.dtype(dtype))})

    def __repr__(self):
        return f"<SymbolTracer {self.shape} {self.dtype}>"



def _const_value(a):
    if isinstance(a, NDArray):
        t = a._data.detach()
        if t.is_meta:
            raise MXNetError(
                "an array computed outside the op table reached an op "
                "during symbolic export tracing (a route that does not go "
                "through ndarray.invoke): the export would miss it")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return _np.asarray(a)


def trace_invoke(opname, args, attrs, out=None):
    """Build a graph node from NDArray/SymbolTracer inputs during export
    tracing; NDArray and array-like inputs become constants.  The outputs'
    shapes and dtypes come from the op's function on meta tensors."""
    if out is not None:
        raise MXNetError(f"op {opname}: out= during symbolic export tracing")
    od = get_op(opname)
    attrs = {k: v for k, v in attrs.items()
             if v is not None or k in ("axis", "a_min", "a_max")}
    in_heads, in_avals = [], []
    ctx = None
    for a in args:
        if a is None:
            continue
        if isinstance(a, SymbolTracer):
            in_heads.append(a._symhead)
            in_avals.append(a._data)
            ctx = ctx or a._ctx
        else:
            v = _const_value(a)
            node = _Node(None, _NAMER.get("_const"), {}, value=v)
            in_heads.append((node, 0))
            in_avals.append(torch.empty(v.shape, dtype=torch_dtype(v.dtype),
                                        device="meta"))
    name = _NAMER.get(od.name)
    out_avals = _out_avals(od, in_avals, attrs)
    multi = od.nout != 1
    node = _Node(od.name, name, attrs, in_heads, nout=len(out_avals))
    if not multi:
        return SymbolTracer.new((node, 0), out_avals[0], ctx)
    return [SymbolTracer.new((node, i), av, ctx)
            for i, av in enumerate(out_avals)]


def _input_slot_names(od):
    """Ordered array-input names for keyword binding: 'data' aliases the
    first slot; param-bearing ops use their canonical param names."""
    import inspect

    sig = [p for p in inspect.signature(od.fn).parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                         p.VAR_POSITIONAL)]
    return [p.name for p in sig]


def _make_symbol_function(od):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        sym_kw = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
        sym_inputs = list(args)
        if sym_kw:
            # bind keyword symbol inputs by slot name, never by keyword
            # appearance order
            pv = _OP_PARAM_VARS.get(od.name)
            order = ["data"] + pv(attrs) if pv is not None else None
            if order is None:
                order = _input_slot_names(od)
                if order:
                    order = ["data"] + order[1:]  # first slot answers 'data'
            unresolved = [k for k in sym_kw if k not in order]
            if unresolved and len(sym_kw) == 1:
                sym_inputs.extend(sym_kw.values())
            elif unresolved:
                raise MXNetError(
                    f"op {od.name}: cannot map keyword inputs {unresolved} "
                    f"to input slots {order}; pass them positionally")
            else:
                for k in order:
                    if k in sym_kw:
                        sym_inputs.append(sym_kw[k])
        return _sym_invoke(od.name, sym_inputs, attrs, name=name)

    fn.__name__ = od.name
    fn.__doc__ = (od.fn.__doc__ or "") + "\n\n(symbolic form)"
    return fn


def populate_namespace(ns):
    """Generate the mx.sym.* op surface from the shared op table."""
    seen = set()
    for name, od in OP_TABLE.items():
        if id(od) in seen and name in ns:
            continue
        seen.add(id(od))
        ns[name] = _make_symbol_function(od)
        for alias in od.aliases:
            ns.setdefault(alias, ns[name])
    return ns
