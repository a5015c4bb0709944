"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``:
``plot_network`` and ``print_summary``).

This environment has no graphviz package/binary, so ``plot_network``
builds the DOT source itself and returns a tiny Digraph stand-in with the
same ``.source`` / ``.render()`` / ``.view()`` surface the reference's
graphviz object exposes; rendering to an image needs a ``dot`` binary at
the user's end.
"""
from __future__ import annotations

import subprocess

from .base import MXNetError

__all__ = ["plot_network", "print_summary"]

_NODE_STYLE = {
    "Convolution": ("box", "#fb8072"),
    "Deconvolution": ("box", "#fb8072"),
    "FullyConnected": ("box", "#fb8072"),
    "BatchNorm": ("box", "#bebada"),
    "LayerNorm": ("box", "#bebada"),
    "Activation": ("box", "#ffffb3"),
    "relu": ("box", "#ffffb3"),
    "Pooling": ("box", "#80b1d3"),
    "Flatten": ("box", "#fdb462"),
    "softmax": ("box", "#fccde5"),
    "null": ("oval", "#8dd3c7"),
}


class Digraph:
    """Minimal graphviz.Digraph-compatible holder for DOT source."""

    def __init__(self, source, name="plot"):
        self.source = source
        self.name = name

    def render(self, filename=None, format="dot", cleanup=False, view=False):
        filename = filename or self.name
        dot_path = f"{filename}.dot" if not filename.endswith(".dot") \
            else filename
        with open(dot_path, "w") as f:
            f.write(self.source)
        if format not in ("dot", None):
            try:
                out_path = f"{filename}.{format}"
                subprocess.run(["dot", f"-T{format}", dot_path,
                                "-o", out_path], check=True)
                return out_path
            except (FileNotFoundError, subprocess.CalledProcessError) as e:
                raise MXNetError(
                    f"rendering to {format!r} needs the graphviz 'dot' "
                    f"binary: {e}") from e
        return dot_path

    def view(self, *a, **k):  # pragma: no cover - no display here
        return self.render(*a, **k)

    def _repr_svg_(self):  # notebook convenience when dot exists
        try:
            out = subprocess.run(["dot", "-Tsvg"], input=self.source,
                                 capture_output=True, text=True, check=True)
            return out.stdout
        except Exception:
            return None


def _label(node):
    op = node.op or "null"
    a = node.attrs
    if op == "Convolution":
        return f"Convolution\\n{a.get('kernel')}/{a.get('stride')}, " \
               f"{a.get('num_filter')}"
    if op == "FullyConnected":
        return f"FullyConnected\\n{a.get('num_hidden')}"
    if op == "Pooling":
        return f"Pooling\\n{a.get('pool_type', 'max')}, {a.get('kernel')}"
    if op == "Activation":
        return f"Activation\\n{a.get('act_type')}"
    return op if op != "null" else node.name


def plot_network(symbol, title="plot", shape=None, node_attrs=None,
                 hide_weights=True, save_format="dot"):
    """Build a DOT graph of the symbol (reference: mx.viz.plot_network)."""
    from .symbol.symbol import Symbol, _topo

    if not isinstance(symbol, Symbol):
        raise MXNetError("plot_network expects a Symbol (use "
                         "block._trace_to_symbol or sym API)")
    nodes = _topo(symbol._heads)
    nid = {id(n): i for i, n in enumerate(nodes)}
    lines = [f'digraph "{title}" {{',
             "  rankdir=BT;",
             '  node [fontsize=10, style=filled];']
    weight_like = set()
    if hide_weights:
        for n in nodes:
            if n.op is None and any(n.name.endswith(sfx) for sfx in
                                    ("weight", "bias", "gamma", "beta",
                                     "running_mean", "running_var",
                                     "moving_mean", "moving_var")):
                weight_like.add(id(n))
    for n in nodes:
        if id(n) in weight_like:
            continue
        op = n.op or "null"
        shape_style, color = _NODE_STYLE.get(op, ("box", "#d9d9d9"))
        lines.append(
            f'  n{nid[id(n)]} [label="{_label(n)}", shape={shape_style}, '
            f'fillcolor="{color}"];')
    for n in nodes:
        if id(n) in weight_like:
            continue
        for inp, _ in n.inputs:
            if id(inp) in weight_like:
                continue
            lines.append(f"  n{nid[id(inp)]} -> n{nid[id(n)]};")
    lines.append("}")
    return Digraph("\n".join(lines), name=title)


def print_summary(symbol, shape=None, line_length=88):
    """Per-layer text summary (reference: mx.viz.print_summary)."""
    from .symbol.symbol import Symbol, _topo

    if not isinstance(symbol, Symbol):
        raise MXNetError("print_summary expects a Symbol")
    nodes = _topo(symbol._heads)
    header = f"{'Layer (type)':<44}{'Inputs':>40}"
    out = ["_" * line_length, header, "=" * line_length]
    for n in nodes:
        if n.op is None:
            continue
        ins = ",".join(inp.name for inp, _ in n.inputs)
        out.append(f"{n.name + ' (' + n.op + ')':<44}{ins[:40]:>40}")
    out.append("=" * line_length)
    text = "\n".join(out)
    print(text)
    return text
