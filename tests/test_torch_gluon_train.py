"""The Gluon training surface as a whole, held against the reference on
the CPU: GluonNLP's BERT pretraining step at a small size.

A 2-layer BertForPretraining (hidden 64, dropout 0; the reference's
weights carried over with ``load_reference_params``, LayerNorm gammas and
betas moved off 1 and 0) trains 3 steps in each package through
``gluon.Trainer("lamb")`` with a warm-up ``PolyScheduler`` and weight
decay, under ``amp.init()`` with empty op lists (fp32 compute on both
sides) and a dynamic ``LossScaler``: record -> ``amp.scale_loss`` ->
backward -> ``amp.unscale`` -> ``gluon.utils.clip_global_norm`` ->
``trainer.step``, with ``metric.Accuracy`` of the MLM and NSP heads and
``metric.Loss``.  Every multiplier stays 1 (the reference ignores
Parameter multipliers through Trainer, ROADMAP C10).  The loss, the
global norm, every parameter and the metrics agree within 1e-5 of the
larger of 1 and the reference's magnitude after each step.
"""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu.contrib import amp as ref_amp
from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.gluon.model_zoo.language import bert as port_bert
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-5
CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=32, dropout=0.0)
BATCH, SEQ, STEPS = 3, 16, 3


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.disable()
    ref_amp.disable()


def _pair():
    prev = rmx.nd.set_eager_jit(False)
    try:
        ref = ref_bert.BertForPretraining(ref_bert.BertConfig(**CFG))
        ref.initialize()
        ref(rmx.nd.zeros((1, SEQ), dtype="int32"))
        r = np.random.RandomState(9)
        for name, p in ref.collect_params().items():
            if name.endswith(("gamma", "beta")):
                base = 1.0 if name.endswith("gamma") else 0.0
                p.set_data(rmx.nd.array(
                    (base + 0.1 * r.randn(*p.shape)).astype("float32")))
    finally:
        rmx.nd.set_eager_jit(prev)
    port = port_bert.BertForPretraining(port_bert.BertConfig(**CFG))
    port.initialize(ctx=CPU)
    port(nd.zeros((1, SEQ), ctx=CPU, dtype="int32"))
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    return ref, port


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    mlm = r.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    nsp = r.randint(0, 2, (BATCH,)).astype("int32")
    return ids, mlm, nsp


class _Recipe:
    """One package's side of the recipe: the pieces a GluonNLP script
    takes from ``mx``."""

    def __init__(self, pkg, net):
        self.ref = pkg == "ref"
        self.mx = rmx if self.ref else mx
        self.amp = ref_amp if self.ref else amp
        self.net = net
        g = self.mx.gluon
        lrs = self.mx.lr_scheduler.PolyScheduler(
            max_update=10, base_lr=2e-3, pwr=1, warmup_steps=2,
            warmup_begin_lr=2e-4)
        self.amp.init("float16", target_dtype_ops=[], fp32_ops=[])
        self.trainer = g.Trainer(net.collect_params(), "lamb",
                                 {"learning_rate": 2e-3, "wd": 0.01,
                                  "lr_scheduler": lrs})
        self.amp.init_trainer(self.trainer, self.amp.LossScaler(
            init_scale=2.0 ** 10, scale_window=2))
        self.ce = g.loss.SoftmaxCrossEntropyLoss()
        m = self.mx.metric
        self.metrics = [m.Accuracy(axis=-1, name="mlm_acc"),
                        m.Accuracy(name="nsp_acc"), m.Loss()]

    def array(self, x):
        return self.mx.nd.array(x, dtype=x.dtype) if self.ref else \
            nd.array(x, ctx=CPU, dtype=x.dtype)

    def step(self, ids, mlm_labels, nsp_labels):
        ids, mlm_labels, nsp_labels = (self.array(a) for a in
                                       (ids, mlm_labels, nsp_labels))
        with self.mx.autograd.record():
            mlm, nsp = self.net(ids)
            loss = self.ce(mlm, mlm_labels).mean() + \
                self.ce(nsp, nsp_labels).mean()
            with self.amp.scale_loss(loss, self.trainer) as scaled:
                scaled.backward()
        self.amp.unscale(self.trainer)
        params = [p for p in self.net.collect_params().values()
                  if p.grad_req != "null"]
        norm = self.mx.gluon.utils.clip_global_norm(
            [p.grad() for p in params], 1.0)
        self.trainer.step(1)
        for m, label, pred in zip(self.metrics,
                                  (mlm_labels, nsp_labels, None),
                                  (mlm, nsp, loss)):
            m.update([label], [pred])
        return float(loss.asnumpy().reshape(-1)[0]), norm


def _close(port, ref, msg):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=msg)


def test_bert_lamb_recipe_matches_reference():
    ref_net, port_net = _pair()
    prev = rmx.nd.set_eager_jit(False)
    try:
        ref, port = _Recipe("ref", ref_net), _Recipe("port", port_net)
        names = list(zip(ref_net.collect_params(),
                         port_net.collect_params()))
        for step in range(STEPS):
            batch = _batch(step)
            rl, rn = ref.step(*batch)
            pl, pn = port.step(*batch)
            assert pl == pytest.approx(rl, rel=TOL, abs=TOL), step
            assert pn == pytest.approx(rn, rel=TOL), step
            assert rn > 1.0          # the clip binds
            for rname, pname in names:
                _close(port_net.collect_params()[pname].data().asnumpy(),
                       ref_net.collect_params()[rname].data().asnumpy(),
                       f"{pname} after step {step}")
        for pm, rm in zip(port.metrics, ref.metrics):
            (pname, pv), (rname, rv) = pm.get(), rm.get()
            assert pname == rname and pv == pytest.approx(rv, rel=TOL)
        assert port.trainer.step_count == ref.trainer.step_count == STEPS
        assert port.trainer.learning_rate == ref.trainer.learning_rate
        assert port.trainer._amp_loss_scaler.loss_scale == \
            ref.trainer._amp_loss_scaler.loss_scale == 2.0 ** 11
    finally:
        rmx.nd.set_eager_jit(prev)
