"""The port stands alone: no module of mxnet_tpu_torch/, and neither
chip_smoke.py nor the port's FM example (which chip_smoke.py runs) nor
the data-parallel tests' worker module (``tests/torch_dist_pool.py``),
imports JAX, the reference package ``mxnet_tpu`` or the repo's
``tools``.

Checked twice: statically, over every import statement and every string
handed to ``__import__``/``importlib.import_module``; and at run time, by
importing the whole port in a fresh interpreter and listing what landed in
``sys.modules``, also after it loaded a ``trainer.states`` file the
reference wrote (whose pickle names the reference's classes).
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
    return top == "jax" or top.startswith("jax") or top in ("mxnet_tpu",
                                                             "tools")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "example", "sparse",
                        "factorization_machine_torch.py"),
           os.path.join(REPO, "tests", "torch_dist_pool.py")]
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
    assert _forbidden("tools.launch")
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
        "import mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.callback\n"
        "import mxnet_tpu_torch.gluon.contrib, mxnet_tpu_torch.gluon.data\n"
        "import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.contrib.nn\n"
        "import mxnet_tpu_torch.gluon._cached_op, mxnet_tpu_torch._tree\n"
        "import mxnet_tpu_torch.ndarray.contrib, mxnet_tpu_torch.context\n"
        "import mxnet_tpu_torch.io, mxnet_tpu_torch.recordio\n"
        "import mxnet_tpu_torch.image, mxnet_tpu_torch.native\n"
        "import mxnet_tpu_torch.ndarray.sparse\n"
        "import mxnet_tpu_torch.gluon.data.vision.transforms\n"
        "import mxnet_tpu_torch.symbol, mxnet_tpu_torch.symbol.contrib\n"
        "import mxnet_tpu_torch.executor, mxnet_tpu_torch.module\n"
        "import mxnet_tpu_torch.model, mxnet_tpu_torch.monitor\n"
        "import mxnet_tpu_torch.visualization, mxnet_tpu_torch.util\n"
        "import mxnet_tpu_torch.util.test_utils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "             or m.split('.')[0] == 'mxnet_tpu')\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_loading_a_reference_states_file_loads_neither(tmp_path):
    """A ``trainer.states`` the reference wrote (LAMB under a warm-up
    PolyScheduler: its pickle names ``mxnet_tpu.optimizer.optimizer.LAMB``
    and ``mxnet_tpu.lr_scheduler.PolyScheduler``) loads into the port's
    Trainer in a fresh interpreter, and neither JAX nor the reference
    lands in ``sys.modules``."""
    import numpy as np

    import mxnet_tpu as rmx

    prev = rmx.nd.set_eager_jit(False)
    try:
        net = rmx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        sched = rmx.lr_scheduler.PolyScheduler(max_update=100, base_lr=0.01,
                                               pwr=1, warmup_steps=10)
        trainer = rmx.gluon.Trainer(net.collect_params(), "lamb",
                                    {"learning_rate": 0.01,
                                     "lr_scheduler": sched})
        with rmx.autograd.record():
            loss = net(rmx.nd.array(np.ones((2, 4), "float32"))).sum()
        loss.backward()
        trainer.step(2)
        path = str(tmp_path / "trainer.states")
        trainer.save_states(path)
    finally:
        rmx.nd.set_eager_jit(prev)
    code = (
        "import sys\n"
        "import mxnet_tpu_torch as mx\n"
        "net = mx.gluon.nn.Dense(3, in_units=4)\n"
        "net.initialize(ctx=mx.cpu())\n"
        "tr = mx.gluon.Trainer(net.collect_params(), 'sgd')\n"
        f"tr.load_states({path!r})\n"
        "opt = tr.optimizer\n"
        "print(type(opt).__name__, type(opt.lr_scheduler).__name__,\n"
        "      opt.num_update)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "             or m.split('.')[0] == 'mxnet_tpu')\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["LAMB PolyScheduler 1", "[]"]
