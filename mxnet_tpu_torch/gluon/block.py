"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A Block is a ``torch.nn.Module``: child Blocks are its submodules, and each
Parameter it holds as an attribute is registered in its ``_parameters``
once the data exists, so ``parameters()``, ``state_dict()`` and ``.to()``
work as on any module.  Names follow the reference: each Block gets a
prefix from a per-class counter (process-global outside a
``name_scope()``, per parent inside one), and its Parameters are named
``prefix + attribute``.

``hybridize()`` caches the forward of a HybridBlock called at the top
(not from inside another cached forward), as the reference caches a
jit-compiled op: one entry a key (the inputs' shapes, dtypes and devices,
train and record mode, the AMP target and ``_cache_version``), built from
the block's functionalized forward (:mod:`._cached_op`).  On CUDA tensors
an entry is a captured CUDA graph, forward and, under ``record()``,
backward; on CPU tensors it runs the functionalized forward as it is.  The
first call while parameter shapes are deferred runs eagerly and resolves
them.  ``hybridize()`` empties the cache.  So does, at the next call,
any parameter tensor or storage replaced by another (``cast``,
``initialize(force_reinit=True)``, ``reset_ctx``, ``.to()``), any
``grad_req`` changed (a graph captures which parameters it
differentiates) and a reseed of the port's generators
(``random.seed``/``set_state``), since a graph draws from the generator
it was captured with.  ``set_data`` and ``load_parameters`` write in place
and need no new entry.  ``export`` and ``SymbolBlock`` are not ported.
"""
from __future__ import annotations

import re
import threading
import time
import weakref
from contextlib import contextmanager

import numpy as _np
import torch

from .. import autograd as _ag
from .. import ndarray as _F
from .. import _tree
from .. import random as _random
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import cpu as _cpu
from ..ndarray.ndarray import _AMP, NDArray
from . import _cached_op
from . import parameter as _parameter
from .parameter import (_TRACE, DeferredInitializationError, Parameter,
                        ParameterDict, load_params)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope(threading.local):
    def __init__(self):
        self.counters = {}
        self.scope_stack = []   # active name_scope() (prefix, counters)

    def next_name(self, hint):
        if self.scope_stack:
            prefix, counters = self.scope_stack[-1]
        else:
            prefix, counters = "", self.counters
        n = counters.get(hint, 0)
        counters[hint] = n + 1
        return f"{prefix}{hint}{n}_"


_NAME_SCOPE = _BlockScope()

# > 0 while a hybridized block's first call runs eagerly (deferred
# shapes): the hybridized blocks it calls run eagerly too, instead of each
# building a cache of its own
_EAGER = threading.local()


class Block(torch.nn.Module):
    """Base container (reference: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        if prefix is not None:
            # an explicit prefix is relative to the enclosing name_scope
            scope = _NAME_SCOPE.scope_stack[-1][0] if \
                _NAME_SCOPE.scope_stack else ""
            self._prefix = scope + prefix
        else:
            self._prefix = _NAME_SCOPE.next_name(self._alias())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else \
            self._prefix

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return {k: v for k, v in self._modules.items() if v is not None}

    @contextmanager
    def name_scope(self):
        """Names of blocks created inside are prefixed with this block's
        prefix, numbered per block instance."""
        if not hasattr(self, "_scope_counters"):
            self._scope_counters = {}
        _NAME_SCOPE.scope_stack.append((self._prefix, self._scope_counters))
        try:
            yield
        finally:
            _NAME_SCOPE.scope_stack.pop()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            value._attach(self, name)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    def collect_params(self, select=None):
        """All Parameters of self and its descendants, in creation order
        (reference semantics)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """{structural name: Parameter}: attribute paths such as
        ``model.layers.0.self_attn.q_proj.weight``, which do not depend on
        the global name counters (reference: the same method)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter to ``filename`` (the ``.params``
        container) under its structural name, so that a net of the same
        architecture in either package loads it whatever its block
        counters."""
        from ..ndarray.serialization import save as _save

        _save(filename, {k: v.data() for k, v in
                         self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Read a :meth:`save_parameters` file (from either package) into
        the parameters of the same structural names; see
        :func:`.parameter.load_params` for the options."""
        from ..ndarray.serialization import load as _load

        load_params(self._collect_params_with_prefix(),
                    _load(filename, ctx=_cpu()), filename, ctx,
                    allow_missing, ignore_extra, cast_dtype, dtype_source)

    # legacy aliases
    save_params = save_parameters
    load_params = load_parameters

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, the first CUDA card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter of self and its descendants to ``dtype``
        (reference: Block.cast); the next cached call sees the new
        tensors and empties the cache."""
        for child in self._children.values():
            child.cast(dtype)
        for _, p in self._params.items():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """Hybridize every HybridBlock child (reference: Block.hybridize)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        for p in self._reg_params.values():
            p._sync_device()
        return out

    def summary(self, *inputs):
        """Run ``inputs`` through the block and print a row for each
        child: its name, type, output shape and the number of its own
        parameters, then their total (reference: Block.summary)."""
        rows = {}

        def make_hook(name):
            def hook(blk, inp, out):
                if name in rows:
                    return
                shape = out.shape if hasattr(out, "shape") else \
                    [o.shape for o in out] \
                    if isinstance(out, (list, tuple)) else "?"
                n_params = sum(int(_np.prod(p.shape)) for p in
                               blk._reg_params.values() if p._shape_known())
                rows[name] = (name or "self", type(blk).__name__, shape,
                              n_params)
            return hook

        handles = [child.register_forward_hook(make_hook(name))
                   for name, child in self._children.items()]
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        header = f"{'Layer':<24}{'Type':<20}{'Output shape':<24}" \
            f"{'Params':<12}"
        print(header)
        print("-" * len(header))
        total = 0
        for name in self._children:
            if name not in rows:
                continue
            name, typ, shape, n = rows[name]
            print(f"{name:<24}{typ:<20}{str(shape):<24}{n:<12}")
            total += n
        print("-" * len(header))
        print(f"Total params (shown layers): {total}")

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block with ``hybrid_forward(F, x, *args, **params)``: F is the
    ``nd`` namespace and the registered parameters come as keywords.
    ``hybridize()`` caches its forward (module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = {}
        self._cache_version = 0
        self._cached_plist = None
        self._bound = None        # (rebinds, rng epoch, tensors) validated

    def _bump_cache_version(self):
        self._cache_version += 1
        self._cached_graph = {}
        self._cached_plist = None
        self._bound = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Cache the forward from the next call on (module docstring).
        ``static_alloc`` and ``static_shape`` are accepted, as no-ops: a
        CUDA graph's memory and shapes are static anyway (reference: the
        same flags, no-ops there too)."""
        self._active = active
        self._bump_cache_version()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from the input shapes;
        parametric layers override this."""
        raise MXNetError(
            f"{type(self).__name__} has deferred-init parameters but does "
            f"not implement infer_shape; give explicit in_units/in_channels")

    def _resolve_params(self, *args):
        kwargs = {}
        for name, p in self._reg_params.items():
            try:
                kwargs[name] = p.data()
            except DeferredInitializationError:
                self.infer_shape(*args)
                p._finish_deferred_init()
                kwargs[name] = p.data()
        return kwargs

    def _update_running_state(self, param, new_value_nd):
        """Write a non-differentiable state update (BatchNorm moving
        stats): collected under ``functionalize``, else written in place."""
        tc = _TRACE.ctx
        if tc is not None:
            tc.state_updates.append((param, new_value_nd._data))
        else:
            with _ag.pause():
                param.data()._set(new_value_nd)

    def forward(self, x, *args):
        if self._active and _TRACE.ctx is None and \
                not getattr(_EAGER, "depth", 0):
            return self._call_cached_op(x, *args)
        return self.hybrid_forward(_F, x, *args,
                                   **self._resolve_params(x, *args))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- the cached forward ----------------------------------------------
    def _valid_params(self):
        """The parameters, sorted by name, after dropping the cache if,
        since it was built, a parameter's tensor or its storage was
        replaced, its ``requires_grad`` changed (``grad_req``) or the
        generators were reseeded; None while a shape is deferred.  The
        check runs when ``parameter._REBINDS`` or ``random.epoch()`` has
        moved, which every such path makes it do."""
        plist = self._cached_plist
        if plist is None:
            plist = sorted(self.collect_params().items())
            if any(p._nd is None for _, p in plist):
                return None
            self._cached_plist = plist
        stamp = (_parameter._REBINDS[0], _random.epoch())
        if self._bound is None or self._bound[0] != stamp:
            bound = [(t, t.data_ptr(), t.requires_grad)
                     for t in (p._nd._data for _, p in plist)]
            if self._bound is not None and (
                    self._bound[0][1] != stamp[1] or any(
                        a[0] is not b[0] or a[1:] != b[1:]
                        for a, b in zip(self._bound[1], bound))):
                self._bump_cache_version()
                self._cached_plist = plist
            self._bound = (stamp, bound)
        return plist

    def _call_cached_op(self, *args):
        """The reference's ``_call_cached_op``: look the key up, build the
        entry if it is new, run it."""
        # the input signature, for export() without example inputs
        self._last_input_shapes = tuple(
            (a.shape, a._data.dtype, a.context) for a in args
            if isinstance(a, NDArray))
        plist = self._valid_params()
        if plist is None:        # deferred shapes: this call runs eagerly
            _EAGER.depth = getattr(_EAGER, "depth", 0) + 1
            try:
                return self.hybrid_forward(_F, *args,
                                           **self._resolve_params(*args))
            finally:
                _EAGER.depth -= 1
        leaves, spec = _tree.flatten(args)
        recording = _ag.is_recording()
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device,
                            t.requires_grad) for t in leaves),
               _ag.is_training(), recording, self._cache_version,
               _AMP["target"] if _AMP["on"] else None)
        entry = self._cached_graph.get(key)
        if entry is None:
            entry = self._build_cache(key, plist, leaves, spec)
        outs, out_spec = entry(leaves, recording)
        return _tree.unflatten(out_spec, outs, NDArray._wrap)

    def _build_cache(self, key, plist, leaves, spec):
        """The reference's ``_build_cache``: the entry for ``key``, and its
        compile event (cause ``new_block`` for the first entry, else
        ``new_signature``; the build's seconds)."""
        from ..parallel.functional import functionalize

        t0 = time.perf_counter()
        cause = "new_signature" if self._cached_graph else "new_block"
        # through a weak proxy: the entry is the block's, and must not keep
        # the block (and its graphs' memory) alive once the net is dropped
        apply_fn, _ = functionalize(weakref.proxy(self),
                                    train_mode=_ag.is_training(),
                                    with_state=True)
        device = leaves[0].device if leaves else \
            plist[0][1]._nd._data.device
        if device.type == "cuda":
            entry = _cached_op.GraphForward(self.name, apply_fn, plist,
                                            leaves, spec, key[3])
            kind = "cuda_graph"
        else:
            entry = _cached_op.FunctionalForward(apply_fn, plist, spec)
            kind = "functional"
        self._cached_graph[key] = entry
        _telemetry.compile_event("block", self.name,
                                 time.perf_counter() - t0, cause, graph=kind)
        return entry

    # -- export (the deploy files) -----------------------------------------
    def _trace_to_symbol(self, *args):
        """Trace ``forward`` with SymbolTracer proxies into (Symbol,
        arg_params, aux_params).  ``args``: NDArrays, or (shape, torch
        dtype, Context) triples; the inputs are named ``data`` (one) or
        ``data0``, ``data1``, ... and the parameters by their structural
        names, as in the reference."""
        from ..ndarray import ndarray as _ndmod
        from ..symbol.symbol import Symbol, SymbolTracer, _Node

        def aval(shape, dtype):
            return torch.empty(tuple(shape), dtype=dtype, device="meta")

        plist = sorted(self._collect_params_with_prefix().items())
        param_map = {}
        for name, p in plist:
            d = p.data()
            param_map[p] = SymbolTracer.new((_Node(None, name, {}), 0),
                                            aval(d.shape, d._data.dtype),
                                            d.context)
        in_tracers = []
        for i, a in enumerate(args):
            name = "data" if len(args) == 1 else f"data{i}"
            shape, dtype, ctx = (a.shape, a._data.dtype, a.context) \
                if isinstance(a, NDArray) else a
            in_tracers.append(SymbolTracer.new((_Node(None, name, {}), 0),
                                               aval(shape, dtype), ctx))
        prev = _TRACE.ctx
        _TRACE.ctx = _parameter._TraceContext(param_map)
        _ndmod._SYMTRACE["on"] = True
        try:
            with _ag._scope(recording=False, training=False):
                out = self.forward(*in_tracers)
        finally:
            _ndmod._SYMTRACE["on"] = False
            _TRACE.ctx = prev
        outs = out if isinstance(out, (list, tuple)) else [out]
        sym = Symbol([o._symhead for o in outs])
        # arguments and aux states by graph position, not by name
        aux_names = set(sym.list_auxiliary_states())
        arg_params, aux_params = {}, {}
        for name, p in plist:
            (aux_params if name in aux_names else arg_params)[name] = p.data()
        return sym, arg_params, aux_params

    def export(self, path, epoch=0, *example_inputs):
        """Write the deploy files ``path-symbol.json`` and
        ``path-{epoch:04d}.params`` (reference: HybridBlock.export),
        loadable by ``SymbolBlock.imports`` and ``mx.mod.Module.load`` of
        either package.  The input signature is ``example_inputs``, else
        the last hybridized call's.  The reference's serving manifest
        (``path-artifact.json``) is not written: it comes with the port of
        ``serving/artifact.py`` (ROADMAP.md A1.7)."""
        example = example_inputs or getattr(self, "_last_input_shapes", None)
        if not example:
            raise MXNetError(
                "export needs an input signature: call hybridize() and run a "
                "forward pass first, or pass example inputs: "
                "net.export(path, epoch, x)")
        sym, arg_params, aux_params = self._trace_to_symbol(*example)
        from ..module.module import save_checkpoint

        save_checkpoint(path, epoch, sym, arg_params, aux_params)


class SymbolBlock(HybridBlock):
    """Run a Symbol graph as a Gluon block (reference: gluon.SymbolBlock,
    used to reload ``export``ed models).

    The forward interprets the graph with the op table's torch functions
    (``symbol.evaluate``) through ``ndarray.apply_fn``, so autograd works
    through it; a training forward writes BatchNorm's moving statistics
    back into the aux parameters, and ``hybridize()`` caches it as any
    block (a CUDA graph on the card)."""

    def __init__(self, outputs, inputs, params=None, prefix=None):
        super().__init__(prefix=prefix or "")
        from .. import symbol as _sym

        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(outputs)
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._sym = outputs
        self._input_names = [s.name if hasattr(s, "name") else str(s)
                             for s in inputs]
        arg_names = outputs.list_arguments()
        aux_names = outputs.list_auxiliary_states()
        self._sym_aux_names = list(aux_names)
        self._sym_param_names = [n for n in arg_names
                                 if n not in self._input_names] + aux_names
        for n in self._sym_param_names:
            grad_req = "null" if n in aux_names else "write"
            self.params.get(n, grad_req=grad_req, allow_deferred_init=True)
        if params:
            for n, v in params.items():
                key = n.replace("arg:", "").replace("aux:", "")
                if key in self._sym_param_names:
                    self._set_symbol_param(key, v, None)

    def _set_symbol_param(self, key, value, ctx):
        from .. import initializer as _init

        p = self.params.get(key)
        p.shape = tuple(value.shape)
        p.dtype = value.dtype
        p.initialize(init=_init.Zero(), ctx=ctx, force_reinit=False)
        p.set_data(value)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over ``symbol_file`` with the parameters of
        ``param_file`` on ``ctx`` (default: the current context, the first
        CUDA card)."""
        from .. import symbol as _sym
        from ..ndarray.serialization import load as _load

        sym = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [_sym.var(n) for n in input_names]
        blk = SymbolBlock(sym, inputs)
        if param_file is not None:
            for k, v in _load(param_file, ctx=_cpu()).items():
                key = k.replace("arg:", "").replace("aux:", "")
                if key in blk._sym_param_names:
                    blk._set_symbol_param(key, v, ctx)
        return blk

    def hybrid_forward(self, F, *args):
        from ..ndarray.ndarray import apply_fn
        from ..symbol.symbol import evaluate

        heads = self._sym._heads
        names = self._input_names + self._sym_param_names
        pvals = [self.params.get(n).data() for n in self._sym_param_names]
        training = _ag.is_training()
        aux_names = self._sym_aux_names
        collect = training and bool(aux_names)

        def pure(*vals):
            feed = dict(zip(names, vals))
            outs, state = evaluate(heads, feed, training=training,
                                   collect_state=collect)
            if collect:
                outs = list(outs) + [state.get(n, feed[n]).detach()
                                     for n in aux_names]
            return tuple(outs) if len(outs) != 1 else outs[0]

        out = apply_fn(pure, list(args) + pvals, name="symbol_block")
        n = len(heads)
        if not collect:
            return out
        main, aux_new = out[:n], out[n:]
        for name, v in zip(aux_names, aux_new):
            self._update_running_state(self.params.get(name), v)
        return main[0] if n == 1 else list(main)
