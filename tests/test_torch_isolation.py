"""The port stands alone: no module of mxnet_tpu_torch/, and not
chip_smoke.py, imports JAX or the reference package ``mxnet_tpu``.

Checked twice: statically, over every import statement and every string
handed to ``__import__``/``importlib.import_module``; and at run time, by
importing the whole port in a fresh interpreter and listing what landed in
``sys.modules``.
"""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mxnet_tpu_torch")


def _forbidden(name):
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "mxnet_tpu"


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if fname in ("__import__", "import_module"):
                yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, name) for line, name in _imported_names(tree)
           if _forbidden(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_rule_allows_the_port_itself():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("mxnet_tpu") and _forbidden("mxnet_tpu.serving")
    assert not _forbidden("mxnet_tpu_torch")
    assert not _forbidden("mxnet_tpu_torch.serving.engine")


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch, mxnet_tpu_torch._kernels\n"
        "import mxnet_tpu_torch.serving\n"
        "import mxnet_tpu_torch.gluon.model_zoo.language.llama\n"
        "import mxnet_tpu_torch.gluon.model_zoo.language.bert\n"
        "import mxnet_tpu_torch.gluon.model_zoo.vision\n"
        "import mxnet_tpu_torch.parallel, mxnet_tpu_torch.contrib.amp\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "             or m.split('.')[0] == 'mxnet_tpu')\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
