"""The port's op table (every family of mxnet_tpu_torch.ops and the
subgraph backend's fused ops) held against the reference on the CPU,
through both packages' ``invoke``, and the ``mx.nd`` surface over it.

Every name the reference registers runs on the same seeded numpy inputs
(``tests/test_op_sweep.py``'s SPECS, imported, plus the cases below for
what SPECS leaves thin: a tiny SSD of 36 anchors, duplicate best
anchors, tied scores in NMS, Proposal and the mining, resize up and down
in every mode, int8 products with long sums) through ``mxnet_tpu``'s
invoke and the port's: the number of outputs, each output's shape, dtype
and value, and, for a differentiable op, the gradient of every float
input under a seeded head gradient.  Values and gradients agree within
TOL = 1e-5 (fp32), scaled by the larger of 1 and the reference's largest
magnitude; integer outputs (int8, int32, detection ids and keep sets
through their -1 rows) exactly.  The samplers draw torch's streams, so
here only their shape and dtype are held (their distributions in
``tests/test_torch_random.py``).  The one stated exception is ``gamma``
for x < 0 (ROADMAP.md C8): the reference drops the sign, the port does
not.

Then the distribution of the random ops (``shuffle``, ``RNN``'s dropout,
the random flips), the helpers' signatures, ``nd.linalg`` /
``nd.contrib``, the NDArray methods, and an LSTM language-model step
(``Embedding`` -> ``RNN`` -> ``FullyConnected`` -> ``SoftmaxOutput``) at a
tiny size, in every mode, against the same step in ``mxnet_tpu.nd``.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as ref_mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu import nd as ref_nd
from mxnet_tpu.ndarray.ndarray import array as ref_array
from mxnet_tpu.ndarray.ndarray import invoke as ref_invoke
from mxnet_tpu.ops.registry import OP_TABLE as REF_TABLE
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as port_ag
from mxnet_tpu_torch import nd as port_nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.ndarray import array as _port_array
from mxnet_tpu_torch.ndarray.ndarray import invoke as port_invoke
from mxnet_tpu_torch.ops.nn import rnn_param_size
from mxnet_tpu_torch.ops.registry import OP_TABLE as PORT_TABLE
from test_op_sweep import AWAY0, DISTINCT, P, POS, S, SPECS

TOL = 1e-5
SEED = 12345
CPU = mx.cpu()
FAMILIES = ("mxnet_tpu.ops.tensor", "mxnet_tpu.ops.nn",
            "mxnet_tpu.ops.attention_ops", "mxnet_tpu.ops.flash_attention",
            "mxnet_tpu.ops.optimizer_ops", "mxnet_tpu.ops.random_ops",
            "mxnet_tpu.ops.image_ops", "mxnet_tpu.ops.detection_ops",
            "mxnet_tpu.ops.quantization_ops", "mxnet_tpu.ops.legacy_ops",
            "mxnet_tpu.subgraph")
FAMILY = sorted(n for n, od in REF_TABLE.items()
                if od.fn.__module__ in FAMILIES)


def port_array(a):
    return _port_array(a, ctx=CPU)


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    """The reference through its eager jit cache, which compiles each op
    once (op by op, jax compiles every primitive at each new shape, which
    costs more)."""
    prev = ref_nd.set_eager_jit(True)
    yield
    ref_nd.set_eager_jit(prev)


# ---------------------------------------------------------------------------
# specs beyond SPECS: the names it lacks, and the cases where trouble is
# likely (dtypes, attributes SPECS leaves at their defaults)
# ---------------------------------------------------------------------------
def _rnn_inputs(mode, T=4, N=3, C=5, H=4, layers=2, bidir=False,
                seq=False):
    nd_ = 2 if bidir else 1

    def gen(rs):
        arrs = [rs.uniform(-1, 1, (T, N, C)).astype("f"),
                rs.uniform(-0.5, 0.5, rnn_param_size(
                    mode, C, H, layers, bidir)).astype("f"),
                rs.uniform(-1, 1, (layers * nd_, N, H)).astype("f")]
        if mode == "lstm":
            arrs.append(rs.uniform(-1, 1, (layers * nd_, N, H)).astype("f"))
        if seq:
            arrs.append(np.array([T, 2, 1][:N], "f"))
        return arrs

    return gen


def _rnn_case(mode, **kw):
    shape = {k: kw.pop(k) for k in ("bidir", "seq") if k in kw}
    attrs = dict(state_size=4, num_layers=2, mode=mode,
                 bidirectional=shape.get("bidir", False),
                 use_sequence_length=shape.get("seq", False),
                 state_outputs=True)
    attrs.update(kw)
    n_float = 4 if mode == "lstm" else 3
    return S(_rnn_inputs(mode, **shape), attrs,
             grad_idx=list(range(n_float)))


EXTRA = {
    "RNN": _rnn_case("lstm"),
    "_slice_key": S(P((3, 4)), {"key": (slice(0, 2), slice(1, None))}),
    "_scatter_set_key": S(P((3, 4), (2,)), {"key": (1, slice(1, 3))}),
}
EXTRA["rnn"] = EXTRA["RNN"]

CASES = {
    # dtypes of the index outputs, and every ret_typ of topk
    "argmax_keepdims_none": ("argmax", DISTINCT((2, 4)),
                             {"axis": None, "keepdims": True}),
    "argmin_axis0": ("argmin", DISTINCT((3, 4)), {"axis": 0}),
    "argsort_descending": ("argsort", DISTINCT((2, 5)),
                           {"is_ascend": False}),
    "argsort_int32": ("argsort", DISTINCT((2, 5)), {"dtype": "int32"}),
    "argsort_ties": ("argsort", lambda rs: [np.array(
        [[1, 0, 1, 0, 1]], "f")], {"is_ascend": False}),
    "sort_descending_axis0": ("sort", DISTINCT((4, 3)),
                              {"axis": 0, "is_ascend": False}),
    "topk_value": ("topk", DISTINCT((2, 6)), {"k": 3, "ret_typ": "value"}),
    "topk_both_ascend": ("topk", DISTINCT((2, 6)),
                         {"k": 3, "ret_typ": "both", "is_ascend": True}),
    "topk_mask_axis0": ("topk", DISTINCT((5, 3)),
                        {"k": 2, "ret_typ": "mask", "axis": 0}),
    "topk_ties": ("topk", lambda rs: [np.array([[2, 1, 2, 1, 2]], "f")],
                  {"k": 2, "ret_typ": "both"}),
    "where_index_2d": ("where_index", lambda rs: [np.array(
        [[0, 1, 0], [2, 0, 3]], "f")], {}),
    "amp_multicast_mixed": ("amp_multicast", lambda rs: [
        rs.uniform(-1, 1, (2,)).astype(np.float16),
        rs.uniform(-1, 1, (3,)).astype("f")], {"num_outputs": 2}),
    "one_hot_int32_out_of_range": ("one_hot", lambda rs: [np.array(
        [0, 3, -1, 5], "f")], {"depth": 4, "dtype": "int32",
                               "on_value": 2.0, "off_value": -1.0}),
    "round_half_to_even": ("round", lambda rs: [np.array(
        [0.5, 1.5, 2.5, -0.5, -1.5, 0.49], "f")], {}),
    "gamma_positive": ("gamma", POS((3, 4), lo=0.1, hi=4.0), {}),
    "histogram_data_range": ("histogram", P((50,)), {"bin_cnt": 7}),
    "take_wrap": ("take", lambda rs: [rs.uniform(-1, 1, (4, 3)).astype("f"),
                                      np.array([[5, -1], [2, 0]], "f")],
                  {"axis": 0, "mode": "wrap"}),
    "take_axis1_clip": ("take", lambda rs: [
        rs.uniform(-1, 1, (2, 4)).astype("f"), np.array([7, -2, 1], "f")],
        {"axis": 1}),
    "slice_negative_step": ("slice", P((4, 5)),
                            {"begin": (3, None), "end": (0, None),
                             "step": (-1, 2)}),
    "pad_edge": ("pad", P((1, 2, 3, 3)),
                 {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "pad_reflect": ("pad", P((1, 2, 4, 4)),
                    {"mode": "reflect",
                     "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "clip_open_bound": ("clip", AWAY0((2, 3)), {"a_min": None,
                                                "a_max": 0.5}),
    "reverse_all_axes": ("reverse", P((2, 3)), {"axis": None}),
    "squeeze_axes": ("squeeze", P((2, 1, 3, 1)), {"axis": (1, 3)}),
    "split_squeeze": ("split", P((2, 3)), {"num_outputs": 3,
                                          "squeeze_axis": True}),
    "dot_transposed": ("dot", P((3, 2), (4, 3)),
                       {"transpose_a": True, "transpose_b": True}),
    "dot_vectors": ("dot", P((3,), (3,)), {}),
    "batch_dot_transposed": ("batch_dot", P((2, 3, 2), (2, 4, 3)),
                             {"transpose_a": True, "transpose_b": True}),
    "norm_ord1": ("norm", AWAY0((2, 3)), {"ord": 1, "axis": (0, 1)}),
    "prod_two_axes": ("prod", POS((2, 3, 2)), {"axis": (0, 2)}),
    "nansum_exclude": ("nansum", lambda rs: [np.array(
        [[1, np.nan, 2], [3, 4, np.nan]], "f")], {"axis": 1,
                                                   "exclude": True}),
    "sequence_mask_value_axis1": ("sequence_mask", lambda rs: [
        rs.uniform(-1, 1, (2, 3, 2)).astype("f"), np.array([1, 3], "f")],
        {"use_sequence_length": True, "value": -2.0, "axis": 1}),
    "scatter_nd_2d": ("scatter_nd", lambda rs: [
        rs.uniform(-1, 1, (3,)).astype("f"),
        np.array([[0, 2, 1], [1, 0, 3]], "f")], {"shape": (3, 4)}),
    # indices out of range: gathers clamp (take_along_axis fills), scatters
    # drop the write, as XLA does
    "gather_nd_out_of_range": ("gather_nd", lambda rs: [
        rs.uniform(-1, 1, (3, 2)).astype("f"),
        np.array([[5, -1, -4], [0, 3, -2]], "f")], {}),
    "scatter_nd_out_of_range": ("scatter_nd", lambda rs: [
        rs.uniform(-1, 1, (4,)).astype("f"), np.array([[1, 5, -1, -9]], "f")],
        {"shape": (4,)}),
    "index_copy_out_of_range": ("_contrib_index_copy", lambda rs: [
        rs.uniform(-1, 1, (4, 2)).astype("f"), np.array([1, 7, -1], "f"),
        rs.uniform(-1, 1, (3, 2)).astype("f")], {}),
    "batch_take_out_of_range": ("batch_take", lambda rs: [
        rs.uniform(-1, 1, (3, 4)).astype("f"), np.array([5, -1, -7], "f")],
        {}),
    "sequence_last_long_length": ("sequence_last", lambda rs: [
        rs.uniform(-1, 1, (3, 3, 2)).astype("f"), np.array([5, 0, 2], "f")],
        {"use_sequence_length": True}),
    "sequence_reverse_long_length": ("sequence_reverse", lambda rs: [
        rs.uniform(-1, 1, (3, 2, 2)).astype("f"), np.array([5, 2], "f")],
        {"use_sequence_length": True}),
    "linalg_trsm_right_transposed": ("linalg_trsm", lambda rs: [
        (np.tril(rs.uniform(0.2, 0.6, (3, 3))) + np.eye(3)).astype("f"),
        rs.uniform(-1, 1, (2, 3)).astype("f")],
        {"rightside": True, "transpose": True, "alpha": 0.5}),
    "linalg_gemm_transposed": ("linalg_gemm", P((3, 2), (4, 3), (2, 4)),
                               {"transpose_a": True, "transpose_b": True}),
    "linalg_syrk_transposed": ("linalg_syrk", P((2, 3)),
                               {"transpose": True, "alpha": 2.0}),
    "masked_softmax_empty_row": ("masked_softmax", lambda rs: [
        rs.uniform(-1, 1, (2, 3)).astype("f"),
        np.array([[0, 0, 0], [1, 0, 1]], "f")], {"temperature": 2.0}),
    # nn
    "leaky_relu_prelu": ("LeakyReLU", AWAY0((2, 3, 2), (3,)),
                         {"act_type": "prelu"}),
    "leaky_relu_elu": ("LeakyReLU", AWAY0((2, 3)),
                       {"act_type": "elu", "slope": 0.3}),
    "leaky_relu_selu": ("LeakyReLU", AWAY0((2, 3)), {"act_type": "selu"}),
    "leaky_relu_gelu": ("LeakyReLU", P((2, 3)), {"act_type": "gelu"}),
    "leaky_relu_rrelu": ("LeakyReLU", AWAY0((2, 3)), {"act_type": "rrelu"}),
    "deconvolution_strided": ("Deconvolution", P(
        (1, 4, 3, 3), (4, 3, 3, 3), (6,)),
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
         "num_filter": 6, "num_group": 2, "no_bias": False}),
    "deconvolution_nhwc": ("Deconvolution", P((1, 3, 3, 2), (2, 2, 2, 3)),
                           {"kernel": (2, 2), "stride": (2, 2),
                            "num_filter": 3, "layout": "NHWC"}),
    "deconvolution_1d": ("Deconvolution", P((2, 2, 5), (2, 3, 3)),
                         {"kernel": (3,), "stride": (2,), "dilate": (2,),
                          "num_filter": 3}),
    "upsampling_bilinear": ("UpSampling", P((1, 2, 3, 3)),
                            {"scale": 2, "sample_type": "bilinear"}),
    "bilinear_resize_down": ("BilinearResize2D", P((1, 2, 8, 9)),
                             {"height": 3, "width": 4}),
    "bilinear_resize_scale": ("BilinearResize2D", P((1, 1, 4, 6)),
                              {"scale_height": 1.5, "scale_width": 0.5}),
    "l2_normalization_channel": ("L2Normalization", AWAY0((2, 3, 2)),
                                 {"mode": "channel"}),
    "l2_normalization_spatial": ("L2Normalization", AWAY0((2, 3, 2, 2)),
                                 {"mode": "spatial"}),
    "group_norm_eps": ("GroupNorm", P((2, 6, 3), (6,), (6,)),
                       {"num_groups": 3, "eps": 1e-3}),
    "softmax_output_ignore_valid": ("SoftmaxOutput", lambda rs: [
        rs.uniform(-1, 1, (4, 3)).astype("f"), np.array([0, -1, 2, -1], "f")],
        {"use_ignore": True, "normalization": "valid", "grad_scale": 2.0}),
    "softmax_output_batch": ("SoftmaxOutput", lambda rs: [
        rs.uniform(-1, 1, (4, 3)).astype("f"), np.array([0, 1, 2, 1], "f")],
        {"normalization": "batch"}),
    "make_loss_batch": ("MakeLoss", P((3, 2)), {"normalization": "batch",
                                                "grad_scale": 0.5}),
    "ctc_loss_lengths": ("CTCLoss", lambda rs: [
        rs.uniform(-1, 1, (6, 2, 4)).astype("f"),
        np.array([[1, 2, 3], [3, 3, 0]], "f"), np.array([6, 5], "f"),
        np.array([3, 2], "f")],
        {"use_data_lengths": True, "use_label_lengths": True}),
    "ctc_loss_padding": ("CTCLoss", lambda rs: [
        rs.uniform(-1, 1, (5, 3, 4)).astype("f"),
        np.array([[1, 2], [3, 0], [2, 2]], "f")], {}),
    "grid_generator_warp": ("GridGenerator", P((2, 2, 3, 4)),
                            {"transform_type": "warp"}),
    "bilinear_sampler_outside": ("BilinearSampler", lambda rs: [
        rs.uniform(-1, 1, (2, 2, 4, 5)).astype("f"),
        rs.uniform(-1.3, 1.3, (2, 2, 3, 3)).astype("f")], {}),
    "rnn_gru": ("RNN", _rnn_inputs("gru"), dict(
        state_size=4, num_layers=2, mode="gru", state_outputs=True)),
    "rnn_tanh_bidirectional": ("RNN", _rnn_inputs("rnn_tanh", bidir=True),
                               dict(state_size=4, num_layers=2,
                                    mode="rnn_tanh", bidirectional=True,
                                    state_outputs=True)),
    "rnn_relu_output_only": ("RNN", _rnn_inputs("rnn_relu"), dict(
        state_size=4, num_layers=2, mode="rnn_relu")),
    "rnn_lstm_bidirectional_seq_len": ("RNN", _rnn_inputs(
        "lstm", bidir=True, seq=True), dict(
        state_size=4, num_layers=2, mode="lstm", bidirectional=True,
        use_sequence_length=True, state_outputs=True)),
    "rnn_gru_seq_len": ("RNN", _rnn_inputs("gru", seq=True), dict(
        state_size=4, num_layers=2, mode="gru", use_sequence_length=True,
        state_outputs=True)),
    "rnn_lstm_state_clip": ("RNN", _rnn_inputs("lstm"), dict(
        state_size=4, num_layers=2, mode="lstm", state_outputs=True,
        lstm_state_clip_min=-0.3, lstm_state_clip_max=0.2,
        lstm_state_clip_nan=True)),
}


# the families beyond tensor and nn: attributes SPECS leaves at their
# defaults, and the places where an order decides the result (ties in
# sorts and argmaxes, duplicate scatter indices)
def _grid_anchors(n=6, size=0.3):
    """n x n corner anchors of side ``size`` centred on a unit grid."""
    c = (np.arange(n) + 0.5) / n
    cy, cx = np.meshgrid(c, c, indexing="ij")
    half = size / 2
    return np.stack([cx - half, cy - half, cx + half, cy + half],
                    -1).reshape(1, -1, 4).astype("f")


def _ssd_labels(rs, batch=2, rows=4):
    """Ground-truth rows [class, x1, y1, x2, y2], the last row of each
    image padding (class -1)."""
    lo = rs.uniform(0.0, 0.6, (batch, rows, 2))
    wh = rs.uniform(0.15, 0.4, (batch, rows, 2))
    cls = rs.randint(0, 2, (batch, rows, 1)).astype("f")
    cls[:, -1] = -1
    return np.concatenate([cls, lo, lo + wh], -1).astype("f")


def _softmax_np(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype("f")


def _shared_anchor_labels(rs):
    """Two boxes whose best anchor is the same one (anchor 14 of the 6 x 6
    grid), each below the match threshold elsewhere: the force-match
    writes both to it, and the later row must win."""
    a = _grid_anchors()[0, 14]
    rows = np.array([[0, *(a + [0.01, 0.01, -0.02, -0.02])],
                     [1, *(a + [0.02, 0.0, 0.0, -0.03])],
                     [-1, 0, 0, 0, 0]], "f")
    return [_grid_anchors(), rows[None], rs.uniform(
        0, 1, (1, 3, 36)).astype("f")]


def _nms_rows(rs, n=20, batch=(2,), ties=False):
    """Rows [class, score, x1, y1, x2, y2] of heavily overlapping boxes;
    ``ties``: scores from a few levels, so many are equal."""
    shape = batch + (n,)
    lo = rs.uniform(0, 0.5, shape + (2,))
    wh = rs.uniform(0.2, 0.5, shape + (2,))
    score = rs.randint(1, 4, shape) / 4.0 if ties else \
        rs.uniform(0, 1, shape)
    cls = rs.randint(0, 3, shape)
    return [np.concatenate([cls[..., None], score[..., None], lo, lo + wh],
                           -1).astype("f")]


def _proposal_inputs(rs, n=2, h=4, w=5, anchors=6, tied=False):
    scores = np.full((n, 2 * anchors, h, w), 0.5, "f") if tied else \
        rs.uniform(0, 1, (n, 2 * anchors, h, w)).astype("f")
    deltas = rs.uniform(-0.2, 0.2, (n, 4 * anchors, h, w)).astype("f")
    info = np.array([[64, 80, 1.0]] * n, "f")
    return [scores, deltas, info]


def _rois(rs, n_img, count, side, scale=1.0):
    b = rs.randint(0, n_img, (count, 1))
    lo = rs.uniform(-1, side * 0.6, (count, 2))
    wh = rs.uniform(1, side * 0.6, (count, 2))
    return np.concatenate([b, lo, lo + wh], 1).astype("f") * \
        np.array([1, scale, scale, scale, scale], "f")


def _int8(rs, shape, lo=-127, hi=128):
    return rs.randint(lo, hi, shape).astype("int8")


CASES.update({
    # detection: a tiny SSD of 36 anchors, two images, three classes
    "multibox_prior_ssd_layer": ("_contrib_MultiBoxPrior", P((1, 2, 5, 5)),
                                 {"sizes": (0.2, 0.272),
                                  "ratios": (1, 2, 0.5, 3, 1 / 3),
                                  "clip": True}),
    "multibox_prior_steps": ("_contrib_MultiBoxPrior", P((1, 2, 3, 4)),
                             {"sizes": (0.5,), "ratios": (1, 2),
                              "steps": (0.3, 0.25), "offsets": (0.4, 0.6)}),
    "multibox_target_tiny_ssd": ("_contrib_MultiBoxTarget", lambda rs: [
        _grid_anchors(), _ssd_labels(rs), _softmax_np(
            rs.randn(2, 3, 36), 1)],
        {"overlap_threshold": 0.4, "negative_mining_ratio": 3,
         "minimum_negative_samples": 2, "negative_mining_thresh": 0.5}),
    "multibox_target_no_mining": ("_contrib_MultiBoxTarget", lambda rs: [
        _grid_anchors(), _ssd_labels(rs), rs.uniform(
            0, 1, (2, 3, 36)).astype("f")],
        {"variances": (0.2, 0.2, 0.1, 0.1)}),
    "multibox_target_shared_anchor": ("_contrib_MultiBoxTarget",
                                      _shared_anchor_labels,
                                      {"overlap_threshold": 0.95}),
    "multibox_target_tied_confidence": ("_contrib_MultiBoxTarget",
                                        lambda rs: [
        _grid_anchors(), _ssd_labels(rs), np.full((2, 3, 36), 0.5, "f")],
        {"negative_mining_ratio": 2, "minimum_negative_samples": 1}),
    "multibox_detection_tiny_ssd": ("_contrib_MultiBoxDetection",
                                    lambda rs: [
        _softmax_np(rs.randn(2, 3, 36) * 2, 1),
        rs.uniform(-0.3, 0.3, (2, 144)).astype("f"), _grid_anchors()],
        {"nms_topk": 12, "threshold": 0.2, "nms_threshold": 0.3}),
    "multibox_detection_force_suppress": ("_contrib_MultiBoxDetection",
                                          lambda rs: [
        _softmax_np(rs.randn(1, 4, 36), 1),
        rs.uniform(-0.3, 0.3, (1, 144)).astype("f"), _grid_anchors()],
        {"force_suppress": True, "clip": False, "background_id": 1}),
    "box_nms_tied_scores": ("_contrib_box_nms",
                            lambda rs: _nms_rows(rs, ties=True),
                            {"overlap_thresh": 0.3, "id_index": 0,
                             "topk": 9}),
    "box_nms_all_classes": ("_contrib_box_nms",
                            lambda rs: _nms_rows(rs, batch=(2, 3)),
                            {"overlap_thresh": 0.4, "valid_thresh": 0.2,
                             "force_suppress": True, "id_index": 0}),
    "box_nms_center_format": ("_contrib_box_nms", lambda rs: [
        np.concatenate([rs.uniform(0, 1, (1, 15, 1)),
                        rs.uniform(0.3, 0.6, (1, 15, 2)),
                        rs.uniform(0.2, 0.5, (1, 15, 2))], -1).astype("f")],
        {"coord_start": 1, "score_index": 0, "in_format": "center",
         "overlap_thresh": 0.25}),
    "box_iou_center_batched": ("_contrib_box_iou", lambda rs: [
        rs.uniform(0.2, 0.8, (2, 3, 4)).astype("f"),
        rs.uniform(0.2, 0.8, (2, 5, 4)).astype("f")], {"format": "center"}),
    "bipartite_matching_ascend": ("_contrib_bipartite_matching",
                                  P((2, 3, 4), lo=0, hi=1),
                                  {"is_ascend": True, "threshold": 0.6,
                                   "topk": 2}),
    "bipartite_matching_ties": ("_contrib_bipartite_matching", lambda rs: [
        np.array([[0.9, 0.9, 0.2], [0.9, 0.9, 0.7]], "f")],
        {"threshold": 0.1}),
    "proposal_two_images_scores": ("_contrib_Proposal",
                                   lambda rs: _proposal_inputs(rs),
                                   {"scales": (2, 4), "ratios": (0.5, 1, 2),
                                    "rpn_pre_nms_top_n": 30,
                                    "rpn_post_nms_top_n": 8,
                                    "rpn_min_size": 4, "threshold": 0.5,
                                    "output_score": True}),
    "proposal_tied_scores": ("_contrib_Proposal",
                             lambda rs: _proposal_inputs(rs, tied=True),
                             {"scales": (2, 4), "ratios": (0.5, 1, 2),
                              "rpn_pre_nms_top_n": 40,
                              "rpn_post_nms_top_n": 10, "rpn_min_size": 2,
                              "output_score": True}),
    "proposal_padded": ("_contrib_Proposal", lambda rs: _proposal_inputs(
        rs, n=1, h=2, w=2, anchors=2),
        {"scales": (8,), "ratios": (0.5, 2), "rpn_pre_nms_top_n": 6,
         "rpn_post_nms_top_n": 9, "rpn_min_size": 1, "threshold": 0.3}),
    "roi_pooling_scaled": ("ROIPooling", lambda rs: [
        rs.uniform(-1, 1, (2, 3, 8, 9)).astype("f"),
        np.concatenate([_rois(rs, 2, 5, 16), [[1, 30, 30, 40, 40]]]).astype(
            "f")], {"pooled_size": (3, 2), "spatial_scale": 0.5}),
    "roi_align_aligned": ("_contrib_ROIAlign", lambda rs: [
        rs.uniform(-1, 1, (2, 3, 8, 9)).astype("f"), _rois(rs, 2, 4, 16)],
        {"pooled_size": (3, 2), "spatial_scale": 0.5, "sample_ratio": 1,
         "aligned": True}),
    "roi_align_sampled": ("_contrib_ROIAlign", lambda rs: [
        rs.uniform(-1, 1, (1, 2, 7, 7)).astype("f"), _rois(rs, 1, 3, 7)],
        {"pooled_size": 2, "sample_ratio": 3}),
    "psroi_pooling_groups": ("_contrib_PSROIPooling", lambda rs: [
        rs.uniform(-1, 1, (2, 18, 7, 8)).astype("f"), _rois(rs, 2, 4, 14)],
        {"output_dim": 2, "pooled_size": 3, "spatial_scale": 0.5,
         "sample_per_part": 3}),
    "deformable_conv_groups": ("_contrib_DeformableConvolution",
                               lambda rs: [
        rs.uniform(-1, 1, (2, 4, 6, 6)).astype("f"),
        rs.uniform(-1.5, 1.5, (2, 2 * 2 * 9, 3, 3)).astype("f"),
        rs.uniform(-1, 1, (4, 2, 3, 3)).astype("f"),
        rs.uniform(-1, 1, (4,)).astype("f")],
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
         "num_filter": 4, "num_group": 2, "num_deformable_group": 2}),
    "deformable_conv_dilated": ("_contrib_DeformableConvolution",
                                lambda rs: [
        rs.uniform(-1, 1, (1, 2, 7, 7)).astype("f"),
        rs.uniform(-2, 2, (1, 18, 3, 3)).astype("f"),
        rs.uniform(-1, 1, (3, 2, 3, 3)).astype("f")],
        {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 3,
         "no_bias": True}),
    # legacy
    "correlation_patch_strided": ("Correlation", P((2, 3, 9, 10),
                                                   (2, 3, 9, 10)),
                                  {"kernel_size": 3, "max_displacement": 2,
                                   "stride1": 2, "stride2": 1,
                                   "pad_size": 2}),
    "correlation_abs_difference": ("Correlation", P((1, 2, 7, 7),
                                                    (1, 2, 7, 7)),
                                   {"max_displacement": 2, "stride2": 2,
                                    "pad_size": 2, "is_multiply": False}),
    "svm_output_l1": ("SVMOutput", lambda rs: [
        rs.uniform(-1, 1, (4, 5)).astype("f"), np.array([0, 4, 2, 1], "f")],
        {"use_linear": True, "margin": 0.5,
         "regularization_coefficient": 2.0}),
    "svm_output_l2": ("SVMOutput", lambda rs: [
        rs.uniform(-1, 1, (4, 5)).astype("f"), np.array([3, 0, 2, 1], "f")],
        {"margin": 0.7, "regularization_coefficient": 0.5}),
    # interleaved attention: several heads and batch rows
    "selfatt_qk_heads": ("_contrib_interleaved_matmul_selfatt_qk",
                         P((5, 2, 36)), {"heads": 3}),
    "selfatt_valatt_heads": ("_contrib_interleaved_matmul_selfatt_valatt",
                             P((5, 2, 36), (6, 5, 5)), {"heads": 3}),
    "encdec_qk_heads": ("_contrib_interleaved_matmul_encdec_qk",
                        P((4, 2, 12), (6, 2, 24)), {"heads": 3}),
    "encdec_valatt_heads": ("_contrib_interleaved_matmul_encdec_valatt",
                            P((6, 2, 24), (6, 4, 6)), {"heads": 3}),
    # fused subgraph ops
    "fused_dense_tanh_3d": ("_sg_fused_dense_act", P((2, 3, 4), (5, 12),
                                                     (5,)),
                            {"num_hidden": 5, "act_type": "tanh"}),
    "fused_conv_sigmoid_strided": ("_sg_fused_conv_act", P(
        (2, 4, 6, 6), (6, 2, 3, 3), (6,)),
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 6,
         "num_group": 2, "act_type": "sigmoid"}),
    # image
    "image_normalize_per_channel": ("image_normalize", P((2, 3, 4, 5)),
                                    {"mean": (0.1, 0.2, 0.3),
                                     "std": (0.5, 0.25, 2.0)}),
    "image_to_tensor_uint8": ("image_to_tensor", lambda rs: [
        rs.randint(0, 256, (2, 4, 5, 3)).astype("uint8")], {}),
    "image_crop_batch": ("image_crop", P((2, 6, 7, 3)),
                         {"x0": 2, "y0": 1, "width": 4, "height": 3}),
    "image_flip_batch": ("image_flip_top_bottom", P((2, 3, 4, 3)), {}),
    # quantization
    "quantize_v2_data_range": ("_contrib_quantize_v2", P((3, 5), lo=-2,
                                                         hi=1.5), {}),
    "quantize_half_to_even": ("_contrib_quantize", lambda rs: [
        np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.5, -200.0], "f"),
        np.array([-127.0], "f"), np.array([127.0], "f")], {}),
    "requantize_data_range": ("_contrib_requantize", lambda rs: [
        rs.randint(-2 ** 20, 2 ** 20, (3, 4)).astype("int32"),
        np.array([-50.0], "f"), np.array([40.0], "f")], {}),
    "quantized_conv_grouped_bias": ("_contrib_quantized_conv", lambda rs: [
        rs.uniform(-1, 1, (2, 4, 7, 7)).astype("f"), _int8(rs, (6, 2, 3, 3)),
        rs.uniform(0.01, 0.03, (6,)).astype("f"), np.array([-0.8, 1.0], "f"),
        rs.uniform(-0.1, 0.1, (6,)).astype("f")],
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 6,
         "num_group": 2}),
    "quantized_fc_bias": ("_contrib_quantized_fully_connected", lambda rs: [
        rs.uniform(-1, 1, (3, 2, 4)).astype("f"), _int8(rs, (5, 8)),
        rs.uniform(0.01, 0.03, (5,)).astype("f"), np.array([-1.0, 0.9], "f"),
        rs.uniform(-0.1, 0.1, (5,)).astype("f")], {"num_hidden": 5}),
    # optimizer updates: the attributes SPECS leaves at their defaults
    "nag_clip_wd": ("nag_mom_update", P((4,), (4,), (4,)),
                    {"lr": 0.1, "momentum": 0.9, "wd": 0.01,
                     "rescale_grad": 2.0, "clip_gradient": 0.5}),
    "rmsprop_clip_weights": ("rmsprop_update", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        rs.uniform(0, 1, 4).astype("f")],
        {"lr": 0.5, "clip_weights": 0.3, "wd": 0.1}),
    "ftrl_wd": ("ftrl_update", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(0, 1, 4).astype("f")],
        {"lr": 0.1, "lamda1": 0.3, "wd": 0.05, "clip_gradient": 0.6}),
    "ftml_step_3": ("ftml_update", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        rs.uniform(0, 1, 4).astype("f"), rs.uniform(0, 1, 4).astype("f"),
        rs.uniform(-1, 1, 4).astype("f")],
        {"lr": 0.01, "t": 3, "wd": 0.1, "clip_grad": 0.5}),
    "signum_wd_lh": ("signum_update", P((4,), (4,), (4,)),
                     {"lr": 0.1, "wd": 0.1, "wd_lh": 0.05,
                      "clip_gradient": 0.3}),
    "lamb_phase1_step_3_uncorrected": ("lamb_update_phase1",
                                       P((4,), (4,), (4,), (4,)),
                                       {"t": 3, "bias_correction": False,
                                        "wd": 0.01}),
    "lamb_phase1_step_3": ("lamb_update_phase1", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(0, 1, 4).astype("f")],
        {"t": 3, "wd": 0.01, "rescale_grad": 0.5}),
    "lamb_phase2_bounds": ("lamb_update_phase2", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        np.array([3.0], "f"), np.array([0.5], "f")],
        {"lr": 0.01, "lower_bound": 0.1, "upper_bound": 2.0}),
    "lamb_phase2_zero_norm": ("lamb_update_phase2", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        np.array([0.0], "f"), np.array([0.5], "f")], {"lr": 0.01}),
    "multi_sgd_three": ("multi_sgd_update", P((3,), (3,), (2, 2), (2, 2),
                                             (4,), (4,)),
                        {"lrs": (0.1, 0.2, 0.3), "wds": (0.0, 0.1, 0.2),
                         "num_weights": 3, "rescale_grad": 0.5,
                         "clip_gradient": 0.4}),
    "multi_sgd_one": ("multi_sgd_update", P((3,), (3,)),
                      {"lrs": (0.1,), "wds": (0.01,), "num_weights": 1}),
    "adadelta_clip": ("adadelta_update", lambda rs: [
        rs.uniform(-1, 1, 4).astype("f"), rs.uniform(-1, 1, 4).astype("f"),
        rs.uniform(0, 1, 4).astype("f"), rs.uniform(0, 1, 4).astype("f")],
        {"rho": 0.8, "wd": 0.1, "clip_gradient": 0.5}),
    # densities: log forms and parameters with a batch shape
    "pdf_normal_log_batched": ("_random_pdf_normal", lambda rs: [
        rs.uniform(-1, 1, (2, 3, 4)).astype("f"),
        rs.uniform(-0.5, 0.5, (2, 3)).astype("f"),
        rs.uniform(0.5, 1.5, (2, 3)).astype("f")], {"is_log": True}),
    "pdf_gamma_log": ("_random_pdf_gamma", lambda rs: [
        rs.uniform(0.5, 2, (2, 5)).astype("f"),
        rs.uniform(1, 3, (2,)).astype("f"),
        rs.uniform(0.5, 2, (2,)).astype("f")], {"is_log": True}),
    "pdf_uniform_outside": ("_random_pdf_uniform", lambda rs: [
        np.array([[-0.5, 0.2, 0.9, 1.5]], "f"), np.array([0.0], "f"),
        np.array([1.0], "f")], {}),
    "pdf_dirichlet_log": ("_random_pdf_dirichlet", lambda rs: [
        _softmax_np(rs.randn(2, 3, 4), -1), rs.uniform(
            0.5, 2, (2, 4)).astype("f")], {"is_log": True}),
    "pdf_poisson_log": ("_random_pdf_poisson", lambda rs: [
        np.array([[0, 1, 3, 7]], "f"), np.array([2.5], "f")],
        {"is_log": True}),
})
for _interp, _mode in enumerate(("nearest", "bilinear", "bicubic")):
    for _way, _size in (("up", (11, 9)), ("down", (3, 4)),
                        ("mixed", (13, 3))):
        CASES[f"image_resize_{_mode}_{_way}"] = (
            "image_resize", P((2, 7, 6, 3), lo=0, hi=1),
            {"size": _size, "interp": _interp})
    CASES[f"image_resize_{_mode}_hwc_square"] = (
        "image_resize", P((8, 10, 3), lo=0, hi=1), {"size": 5,
                                                    "interp": _interp})
    # thirds: (i + 0.5) * 6 / 3 is an integer, which a reciprocal product
    # would floor one pixel short
    CASES[f"image_resize_{_mode}_thirds"] = (
        "image_resize", P((6, 6, 3), lo=0, hi=1), {"size": 3,
                                                   "interp": _interp})

# compared by shape and dtype here, by distribution below and in
# test_torch_random.py (the image ops also by value at a fixed factor)
RANDOM = {"shuffle", "random_uniform", "random_normal", "random_gamma",
          "random_exponential", "random_poisson", "random_negative_binomial",
          "random_randint", "sample_multinomial", "sample_uniform_like",
          "sample_normal_like", "bernoulli", "image_random_brightness",
          "image_random_contrast", "image_random_saturation",
          "image_random_hue", "image_random_lighting",
          "image_random_color_jitter", "image_random_flip_left_right",
          "image_random_flip_top_bottom"}


def _dtype(d):
    return d if isinstance(d, str) else np.dtype(d).name


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _scale(a):
    a = np.asarray(a, dtype=np.float64)
    finite = a[np.isfinite(a)]
    return max(1.0, float(np.abs(finite).max())) if finite.size else 1.0


def _run(side, name, arrs, kwargs, sel, head_seed, head_out=0):
    array, invoke, ag = side
    nds = [array(a) for a in arrs]
    for i in sel:
        nds[i].attach_grad()
    creation = not arrs
    kw = dict(ctx=CPU) if creation and array is port_array else {}
    if not sel:
        return _flat(invoke(name, nds, dict(kwargs), **kw)), []
    with ag.record():
        out = _flat(invoke(name, nds, dict(kwargs), **kw))
    head = np.asarray(np.random.RandomState(head_seed).randn(
        *out[head_out].shape)).astype(out[head_out].dtype)
    # a 0-d head takes the default head gradient (legacy nd arrays have
    # no 0-d form)
    out[head_out].backward(array(head) if out[head_out].shape else None)
    return out, [nds[i].grad.asnumpy() for i in sel]


REF = (ref_array, ref_invoke, ref_ag)
PORT = (port_array, port_invoke, port_ag)


def _align_svd(ref_outs, port_outs):
    """Singular vectors are fixed up to a sign per pair: turn the port's
    to the reference's."""
    u, s, vt = [o.asnumpy() for o in port_outs]
    sign = np.sign(np.sum(u * ref_outs[0].asnumpy(), axis=-2,
                          keepdims=True))
    return [u * sign, s, vt * np.swapaxes(sign, -1, -2)]


def _check(case, name, spec_inputs, kwargs, grad_idx=None, int_dtype=None,
           grad=True):
    arrs = spec_inputs(np.random.RandomState(SEED))
    if int_dtype is not None:
        arrs = [(a * 4).astype(int_dtype) for a in arrs]
    od = REF_TABLE[name]
    if grad_idx is None:
        grad_idx = [i for i, a in enumerate(arrs) if a.dtype.kind == "f"]
    sel = [i for i in grad_idx if arrs[i].dtype.kind == "f"]
    if not (grad and od.differentiable) or od.name in RANDOM or \
            int_dtype is not None:
        sel = []
    head_out = 1 if name == "linalg_svd" else 0
    ref_outs, ref_grads = _run(REF, name, arrs, kwargs, sel, SEED + 1,
                               head_out)
    port_outs, port_grads = _run(PORT, name, arrs, kwargs, sel, SEED + 1,
                                 head_out)
    assert len(port_outs) == len(ref_outs), (case, "number of outputs")
    for r, p in zip(ref_outs, port_outs):
        assert p.context == CPU, case
        assert p.shape == r.shape, (case, p.shape, r.shape)
        assert _dtype(p.dtype) == _dtype(r.dtype), (case, p.dtype, r.dtype)
    if REF_TABLE[name].name in RANDOM:
        return
    port_vals = _align_svd(ref_outs, port_outs) if name == "linalg_svd" \
        else [p.asnumpy() for p in port_outs]
    for r, p in zip(ref_outs, port_vals):
        r = r.asnumpy()
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=case)
        else:
            np.testing.assert_allclose(p, r, rtol=0, atol=TOL * _scale(r),
                                       err_msg=case)
    for i, r, p in zip(sel, ref_grads, port_grads):
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL * _scale(r),
                                   err_msg=f"{case} grad of input {i}")


def _spec(name):
    return EXTRA.get(name) or SPECS[REF_TABLE[name].name]


@pytest.mark.parametrize("name", FAMILY)
def test_op_against_reference(name):
    """Every name of the two families, on SPECS' inputs and attributes;
    an alias forward only (it is its definition's, the table test shows,
    and the definition's own name checks the gradient)."""
    spec = _spec(name)
    _check(name, name, spec.inputs, spec.kwargs, spec.grad_idx,
           grad=REF_TABLE[name].name == name)


@pytest.mark.parametrize("name", sorted(
    n for n in FAMILY if _spec(n).int_dtypes))
def test_op_on_int32_inputs(name):
    """The ops SPECS runs on int32 too: the same dtype and value."""
    spec = _spec(name)
    _check(name, name, spec.inputs, spec.kwargs, int_dtype="int32")


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_against_reference(case):
    name, inputs, kwargs = CASES[case]
    _check(case, name, inputs, kwargs)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------
def test_table_holds_both_families_with_the_references_aliases():
    """The port registers every name of every family, no name the
    reference lacks, and each name resolves to the definition it does in
    the reference (``index_array`` is ``_contrib_index_array``, whose alias
    overwrites the plain registration there; ``crop`` is ``image_crop``)."""
    assert set(FAMILY) == set(REF_TABLE) == set(PORT_TABLE)
    assert len(PORT_TABLE) == 412
    assert len({id(od) for od in PORT_TABLE.values()}) == 278
    for n in FAMILY:
        ref, port = REF_TABLE[n], PORT_TABLE[n]
        assert port.name == ref.name, n
        assert port.differentiable == ref.differentiable, n
        assert port.creation == ref.creation, n
        assert port.nout == ref.nout, n
        for m in FAMILY:
            if REF_TABLE[m] is ref:
                assert PORT_TABLE[m] is port, (n, m)
    assert PORT_TABLE["index_array"].name == "_contrib_index_array"
    assert port_nd.index_array is not None
    assert PORT_TABLE["index_array"] is PORT_TABLE["_contrib_index_array"]
    assert PORT_TABLE["crop"].name == "image_crop"


def test_gamma_keeps_its_sign_below_zero():
    """C8: the reference drops Gamma's sign for x < 0 (its
    ``_reflection_sign`` is always 1); the port computes the signed
    Gamma, and agrees with the reference for x > 0."""
    x = np.array([-0.5, -1.5, -2.5, -3.7, 0.5, 1.5, 4.2], "f")
    port = port_nd.gamma(port_array(x)).asnumpy()
    ref = ref_nd.gamma(ref_array(x)).asnumpy()
    want = np.array([math.gamma(float(v)) for v in x])
    np.testing.assert_allclose(port, want, rtol=1e-5)
    np.testing.assert_allclose(port[4:], ref[4:], rtol=1e-5)
    np.testing.assert_allclose(np.abs(port), ref, rtol=1e-5)
    assert (port[:4] * ref[:4] < 0).tolist() == [True, False, True, False]


def test_projection_size_raises():
    arrs = _rnn_inputs("lstm", layers=1)(np.random.RandomState(0))
    with pytest.raises(MXNetError, match="projection_size"):
        port_invoke("RNN", [port_array(a) for a in arrs],
                    dict(state_size=4, mode="lstm", projection_size=2))


def test_a_dynamic_shape_stays_on_its_device(monkeypatch):
    """where_index, boolean_mask and histogram without a range read no
    tensor back to the host (no .cpu(), .item() or .tolist())."""
    x = port_array(np.array([[0, 1.5, 0], [2, 0, -3]], "f"))

    def refuse(*a, **k):
        raise AssertionError("a host round trip")

    for attr in ("cpu", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    outs = [port_nd.where_index(x), port_nd.boolean_mask(x, x[:, 0]),
            *port_nd.histogram(x, bin_cnt=4)]
    monkeypatch.undo()
    assert [o.shape for o in outs] == [(3, 2), (1, 3), (4,), (5,)]
    assert outs[0].dtype == np.int32


# ---------------------------------------------------------------------------
# random ops: by distribution, fixed by the seed
# ---------------------------------------------------------------------------
def test_shuffle_is_a_seeded_permutation_along_axis_0():
    rows = np.arange(12, dtype="f").reshape(6, 2)
    x = port_array(rows)
    mx.random.seed(7)
    a = port_nd.shuffle(x).asnumpy()
    mx.random.seed(7)
    b = port_nd.shuffle(x).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert sorted(map(tuple, a)) == sorted(map(tuple, rows))
    # each element lands in each position about equally often
    counts = np.zeros((4, 4))
    v = port_array(np.arange(4, dtype="f"))
    mx.random.seed(0)
    draws = 4000
    for _ in range(draws):
        perm = port_nd.shuffle(v).asnumpy().astype(int)
        counts[perm, np.arange(4)] += 1
    expect = draws / 4
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 45.0, counts    # 9 degrees of freedom: p < 1e-6


def test_rnn_dropout_rate_between_layers():
    """Two rnn_relu layers of identity weights: the second layer's output
    is relu(x) * mask / keep, so the zeros count the dropped units."""
    T, N, H, p = 6, 200, 8, 0.3
    eye = np.eye(H, dtype="f").reshape(-1)
    zero = np.zeros(H * H, "f")
    params = np.concatenate([eye, zero, eye, zero, np.zeros(4 * H, "f")])
    x = np.random.RandomState(0).uniform(0.5, 1.0, (T, N, H)).astype("f")
    args = [port_array(x), port_array(params)]
    attrs = dict(state_size=H, num_layers=2, mode="rnn_relu", p=p,
                 training=True)
    mx.random.seed(3)
    out = port_invoke("RNN", args, attrs).asnumpy()
    mx.random.seed(3)
    again = port_invoke("RNN", args, attrs).asnumpy()
    np.testing.assert_array_equal(out, again)
    dropped = float((out == 0).mean())
    assert abs(dropped - p) < 0.02, dropped
    kept = out != 0
    np.testing.assert_allclose(out[kept], (x / (1 - p))[kept], rtol=1e-6)
    no_train = port_invoke("RNN", args, dict(attrs, training=False))
    np.testing.assert_allclose(no_train.asnumpy(), x, rtol=1e-6)


# ---------------------------------------------------------------------------
# the mx.nd surface: helpers, linalg / contrib, NDArray methods
# ---------------------------------------------------------------------------
HELPERS = ["concat", "stack", "add_n", "full", "empty", "arange", "eye",
           "zeros_like", "ones_like", "maximum", "minimum", "power", "dot",
           "zeros", "ones"]


@pytest.mark.parametrize("name", HELPERS)
def test_helper_signature(name):
    ref = inspect.signature(getattr(ref_nd, name))
    port = inspect.signature(getattr(port_nd, name))
    assert list(port.parameters) == list(ref.parameters), name


def _both(fn, *arrays):
    """``fn(nd, *NDArrays)`` on each package; their outputs."""
    return ([o.asnumpy() for o in _flat(fn(ref_nd, *map(ref_array,
                                                         arrays)))],
            [o.asnumpy() for o in _flat(fn(port_nd, *map(port_array,
                                                         arrays)))])


HELPER_CALLS = {
    "concat": lambda nd, a, b: nd.concat(a, b, dim=0),
    "concat_list": lambda nd, a, b: nd.concat([a, b]),
    "stack": lambda nd, a, b: nd.stack(a, b, axis=1),
    "add_n": lambda nd, a, b: nd.add_n(a, b, a),
    "zeros_like": lambda nd, a, b: nd.zeros_like(a),
    "ones_like": lambda nd, a, b: nd.ones_like(b),
    "maximum_scalar": lambda nd, a, b: nd.maximum(a, 0.1),
    "minimum_scalar_left": lambda nd, a, b: nd.minimum(0.2, b),
    "power_arrays": lambda nd, a, b: nd.power(nd.abs(a), b),
    "maximum_int_array": lambda nd, a, b: nd.maximum(
        a.astype("int32"), 2),
    "dot": lambda nd, a, b: nd.dot(a, b, transpose_b=True),
    "matmul_operator": lambda nd, a, b: a @ b.T,
}


@pytest.mark.parametrize("call", sorted(HELPER_CALLS))
def test_helper_against_reference(call):
    rs = np.random.RandomState(0)
    a = (rs.randn(2, 3) * 3).astype("f")
    b = rs.randn(2, 3).astype("f")
    ref, port = _both(HELPER_CALLS[call], a, b)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.dtype == r.dtype, call
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL * _scale(r))


def test_creation_helpers_against_reference():
    cases = [("full", ((2, 3), 1.5), {}), ("empty", ((2,),), {}),
             ("arange", (1, 7, 1.5), {"repeat": 2}),
             ("arange", (5,), {"dtype": "int32"}),
             ("eye", (3, 4, 1), {}), ("zeros", (4,), {"dtype": "int32"})]
    for name, args, kw in cases:
        r = getattr(ref_nd, name)(*args, **kw)
        p = getattr(port_nd, name)(*args, ctx=CPU, **kw)
        assert p.context == CPU
        assert p.shape == r.shape and _dtype(p.dtype) == _dtype(r.dtype)
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())


def test_two_scalars_and_sparse_dot():
    np.testing.assert_array_equal(
        port_nd.maximum(2, 3.5, ctx=CPU).asnumpy(),
        ref_nd.maximum(2, 3.5).asnumpy())

    # a CSR lhs takes the sparse product (nd.sparse), as the reference's
    # dot does; a shape that does not fit raises
    dense = np.array([[0, 2, 0], [1, 0, 3]], "f")
    rhs = np.arange(6, dtype="f").reshape(3, 2)
    csr = port_nd.sparse.csr_matrix(dense, ctx=CPU)
    np.testing.assert_array_equal(
        port_nd.dot(csr, port_array(rhs)).asnumpy(),
        ref_nd.dot(ref_nd.sparse.csr_matrix(dense), ref_array(rhs)).asnumpy())
    with pytest.raises(MXNetError):
        port_nd.dot(csr, port_array(np.ones((2, 2), "f")))


def test_linalg_and_contrib_namespaces():
    ref_linalg = {n for n in dir(ref_nd.linalg)
                  if "linalg_" + n in REF_TABLE}
    port_linalg = {n for n in dir(port_nd.linalg)
                   if "linalg_" + n in PORT_TABLE}
    assert port_linalg == ref_linalg
    assert len(port_linalg) == 9
    a = np.random.RandomState(0).uniform(0.5, 1, (3, 3)).astype("f")
    spd = a @ a.T + np.eye(3, dtype="f")
    np.testing.assert_allclose(
        port_nd.linalg.potrf(port_array(spd)).asnumpy(),
        ref_nd.linalg.potrf(ref_array(spd)).asnumpy(), rtol=0, atol=TOL)
    ported = {n[len("_contrib_"):] for n in PORT_TABLE
              if n.startswith("_contrib_")}
    for short in ported:
        assert callable(getattr(port_nd.contrib, short)), short
        assert hasattr(ref_nd.contrib, short), short
    assert {"index_copy", "index_array"} <= ported
    np.testing.assert_array_equal(
        port_nd.contrib.index_array(port_array(a)).asnumpy(),
        ref_nd.contrib.index_array(ref_array(a)).asnumpy())
    # the control-flow operators run (over apply_fn) and agree with the
    # reference; tests/test_torch_control_flow.py holds their gradients
    x, s = np.ones((3, 2), "f"), np.zeros(2, "f")
    for nd_, arr in ((port_nd, port_array), (ref_nd, ref_array)):
        out, st = nd_.contrib.foreach(lambda v, h: (v + h, v + h), arr(x),
                                      arr(s))
        wl, wst = nd_.contrib.while_loop(lambda h: h.sum() < 3,
                                         lambda h: (h, h + 1), arr(s),
                                         max_iterations=4)
        c = nd_.contrib.cond(lambda v: v.sum() > 0, lambda v: v * 2,
                             lambda v: v * 3, arr(x))
        got = [a.asnumpy() for a in (out, st, wl, wst, c)]
        if nd_ is port_nd:
            port_got = got
    for p, r in zip(port_got, got):
        np.testing.assert_array_equal(p, r)


METHOD_CALLS = {
    "abs": lambda x: x.abs(), "sign": lambda x: x.sign(),
    "sqrt": lambda x: x.abs().sqrt(), "square": lambda x: x.square(),
    "exp": lambda x: x.exp(), "log": lambda x: x.abs().log(),
    "relu": lambda x: x.relu(), "sigmoid": lambda x: x.sigmoid(),
    "tanh": lambda x: x.tanh(), "softmax": lambda x: x.softmax(axis=0),
    "log_softmax": lambda x: x.log_softmax(),
    "argmax": lambda x: x.argmax(axis=1),
    "argmin": lambda x: x.argmin(axis=0, keepdims=True),
    "argsort": lambda x: x.argsort(is_ascend=False),
    "sort": lambda x: x.sort(axis=0),
    "topk": lambda x: x.topk(k=2, ret_typ="both"),
    "max": lambda x: x.max(axis=1), "min": lambda x: x.min(),
    "nansum": lambda x: x.nansum(axis=0),
    "prod": lambda x: x.prod(axis=1, keepdims=True),
    "norm": lambda x: x.norm(axis=1),
    "clip": lambda x: x.clip(-0.5, 0.5),
    "expand_dims": lambda x: x.expand_dims(1),
    "squeeze": lambda x: x.reshape((2, 1, 3)).squeeze(),
    "swapaxes": lambda x: x.swapaxes(0, 1),
    "broadcast_to": lambda x: x[0:1].broadcast_to((4, 3)),
    "broadcast_like": lambda x: x[0:1].broadcast_like(x),
    "reshape_like": lambda x: x.reshape_like(x.T),
    "tile": lambda x: x.tile((2, 1)),
    "repeat": lambda x: x.repeat(2, axis=0),
    "pad": lambda x: x.reshape((1, 1, 2, 3)).pad(
        mode="constant", pad_width=(0, 0, 0, 0, 1, 0, 0, 2),
        constant_value=0.5),
    "split": lambda x: x.split(3, axis=1),
    "one_hot": lambda x: x.abs().argmax(axis=1).one_hot(3),
    "take": lambda x: x.take(x.abs().argmax(axis=1)),
    "dot": lambda x: x.dot(x, transpose_b=True),
    "matmul": lambda x: x @ x.T,
}


@pytest.mark.parametrize("method", sorted(METHOD_CALLS))
def test_ndarray_method_against_reference(method):
    x = np.random.RandomState(1).randn(2, 3).astype("f")
    ref = _flat(METHOD_CALLS[method](ref_array(x)))
    port = _flat(METHOD_CALLS[method](port_array(x)))
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.shape == r.shape and _dtype(p.dtype) == _dtype(r.dtype)
        np.testing.assert_allclose(p.asnumpy(), r.asnumpy(), rtol=0,
                                   atol=TOL * _scale(r.asnumpy()))


def test_ndarray_host_methods():
    x = port_array(np.array([[1.5, 2.0]], "f"))
    assert x.tolist() == [[1.5, 2.0]]
    assert x[0, 1].item() == 2.0
    assert x.as_in_ctx(CPU) is x


# ---------------------------------------------------------------------------
# the LSTM language model's step through mx.nd, tiny, in every mode
# ---------------------------------------------------------------------------
LM = dict(vocab=50, embed=8, hidden=16, layers=2, T=5, batch=3, lr=0.1)


def lm_params(mode, bidir, seed=0):
    rs = np.random.RandomState(seed)
    nd_ = 2 if bidir else 1
    V, E, H = LM["vocab"], LM["embed"], LM["hidden"]
    return {"embed": rs.uniform(-0.1, 0.1, (V, E)).astype("f"),
            "rnn": rs.uniform(-0.1, 0.1, rnn_param_size(
                mode, E, H, LM["layers"], bidir)).astype("f"),
            "fc_w": rs.uniform(-0.1, 0.1, (V, H * nd_)).astype("f"),
            "fc_b": np.zeros(V, "f")}


def lm_step(pkg, array, params, ids, labels, mode, bidir, seq_len=None,
            ctx=None):
    """One SGD step of Embedding -> RNN -> FullyConnected -> SoftmaxOutput;
    returns the probabilities, the final states and the updated
    parameters."""
    nd = pkg.nd
    p = {k: array(v) for k, v in params.items()}
    for v in p.values():
        v.attach_grad()
    nd_ = 2 if bidir else 1
    H = LM["hidden"]
    states = [nd.zeros((LM["layers"] * nd_, LM["batch"], H), ctx=ctx)]
    if mode == "lstm":
        states.append(nd.zeros(states[0].shape, ctx=ctx))
    extra = [array(seq_len)] if seq_len is not None else []
    with pkg.autograd.record():
        x = nd.Embedding(array(ids), p["embed"], input_dim=LM["vocab"],
                         output_dim=LM["embed"])
        outs = nd.RNN(x, p["rnn"], *states, *extra, state_size=H,
                      num_layers=LM["layers"], mode=mode,
                      bidirectional=bidir, state_outputs=True,
                      use_sequence_length=seq_len is not None)
        logits = nd.FullyConnected(outs[0].reshape((-1, H * nd_)),
                                   p["fc_w"], p["fc_b"],
                                   num_hidden=LM["vocab"])
        prob = nd.SoftmaxOutput(logits, array(labels.reshape(-1)),
                                normalization="batch")
    prob.backward()
    for v in p.values():
        v[:] = v - LM["lr"] * v.grad
    return ([prob.asnumpy()] + [o.asnumpy() for o in outs[1:]],
            {k: v.asnumpy() for k, v in p.items()})


@pytest.mark.parametrize("mode,bidir,seq", [
    ("lstm", False, False), ("gru", False, False),
    ("rnn_tanh", False, False), ("rnn_relu", False, False),
    ("lstm", True, False), ("lstm", False, True), ("gru", True, True)])
def test_lm_step_against_reference(mode, bidir, seq):
    rs = np.random.RandomState(1)
    ids = rs.randint(0, LM["vocab"], (LM["T"], LM["batch"])).astype("f")
    labels = rs.randint(0, LM["vocab"], (LM["T"], LM["batch"])).astype("f")
    seq_len = np.array([5, 3, 1], "f") if seq else None
    params = lm_params(mode, bidir)
    ref_out, ref_p = lm_step(ref_mx, ref_array, params, ids, labels, mode,
                             bidir, seq_len)
    port_out, port_p = lm_step(mx, port_array, params, ids, labels, mode,
                               bidir, seq_len, ctx=CPU)
    for r, p in zip(ref_out, port_out):
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL * _scale(r))
    for k in params:
        moved = np.abs(ref_p[k] - params[k]).max()
        assert moved > 0, k                  # every parameter learns
        np.testing.assert_allclose(port_p[k], ref_p[k], rtol=0,
                                   atol=TOL * _scale(ref_p[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the detection, quantization and image families: what the sweep above
# cannot show by comparison alone
# ---------------------------------------------------------------------------
def test_multibox_target_shared_anchor_takes_the_later_row():
    """Two ground-truth rows share their best anchor: XLA's scatter keeps
    the later row there, and so does the port (not the card's atomics'
    order)."""
    anchors, label, pred = _shared_anchor_labels(np.random.RandomState(0))
    iou = ref_nd.contrib.box_iou(ref_array(anchors[0]),
                                 ref_array(label[0, :2, 1:])).asnumpy()
    assert iou.argmax(axis=0).tolist() == [14, 14]
    assert (np.delete(iou, 14, axis=0) < 0.95).all()
    ref = ref_nd.contrib.MultiBoxTarget(*map(ref_array, (anchors, label,
                                                         pred)),
                                        overlap_threshold=0.95)
    port = port_nd.contrib.MultiBoxTarget(*map(port_array, (anchors, label,
                                                            pred)),
                                          overlap_threshold=0.95)
    np.testing.assert_allclose(port[0].asnumpy(), ref[0].asnumpy(),
                               rtol=0, atol=TOL)
    for r, p in zip(ref[1:], port[1:]):
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    cls_t = port[2].asnumpy()[0]
    assert cls_t[14] == 2.0 and (np.delete(cls_t, 14) == 0).all()


@pytest.mark.parametrize("topk", [1, 5, 13])
def test_box_nms_topk_sweep_equals_the_full_sweep(topk):
    """Rows past topk never keep and never suppress, so sweeping only the
    first min(N, topk) sorted rows gives what the full N-step sweep
    gives."""
    from mxnet_tpu_torch.ops import detection_ops as det

    rows = torch.from_numpy(_nms_rows(np.random.RandomState(topk), n=24,
                                      ties=True)[0])
    got = det.box_nms(rows, overlap_thresh=0.3, topk=topk, id_index=0)
    # the full sweep over all N sorted rows, the rows past topk not
    # candidates
    n = rows.shape[1]
    order = torch.sort(-rows[:, :, 1], dim=1, stable=True)[1]
    xs = torch.gather(rows, 1, order[:, :, None].expand(-1, -1, 6))
    cand = (xs[:, :, 1] > 0) & (torch.arange(n) < topk)
    iou = det._pairwise_iou(xs[:, :, 2:], xs[:, :, 2:])
    over = (iou > 0.3) & torch.ones(n, n, dtype=torch.bool).triu(1) & \
        cand[:, None, :] & (xs[:, :, None, 0] == xs[:, None, :, 0])
    keep = det.nms_keep(over, cand, n)
    want = xs.clone()
    want[:, :, :2] = torch.where(keep[..., None], xs[:, :, :2],
                                 torch.tensor(-1.0))
    assert torch.equal(got, want)
    ref = ref_nd.contrib.box_nms(ref_array(rows.numpy()), overlap_thresh=0.3,
                                 topk=topk, id_index=0).asnumpy()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_products_are_exact_where_fp32_rounds():
    """K = 2048 with every activation at the range's end: the int32 sums
    pass 2^24, where an fp32 accumulation rounds, and the port's fp32
    output equals the reference's bit for bit."""
    from mxnet_tpu_torch.ops import quantization_ops as q

    rs = np.random.RandomState(0)
    x = np.where(rs.uniform(size=(4, 2048)) < 0.9, 1.0, -1.0).astype("f")
    w = _int8(rs, (16, 2048), 90, 128)
    args = [x, w, rs.uniform(0.01, 0.02, (16,)).astype("f"),
            np.array([-1.0, 1.0], "f")]
    ref = ref_nd.contrib.quantized_fully_connected(*map(ref_array, args),
                                                   num_hidden=16).asnumpy()
    port = port_nd.contrib.quantized_fully_connected(
        *map(port_array, args), num_hidden=16).asnumpy()
    np.testing.assert_array_equal(port, ref)
    xq = torch.from_numpy(np.round(x * 127).astype("int8"))
    exact = q.int8_matmul(xq, torch.from_numpy(w))
    assert exact.abs().max() > 2 ** 24
    rounded = (xq.float() @ torch.from_numpy(w).float().t()).to(torch.int32)
    assert not torch.equal(rounded, exact)


@pytest.mark.parametrize("name,attrs", [
    ("image_random_brightness", {"min_factor": 1.3, "max_factor": 1.3}),
    ("image_random_contrast", {"min_factor": 0.6, "max_factor": 0.6}),
    ("image_random_saturation", {"min_factor": 1.7, "max_factor": 1.7}),
    ("image_random_hue", {"min_factor": 0.3, "max_factor": 0.3}),
    ("image_random_hue", {"min_factor": -0.2, "max_factor": -0.2}),
    ("image_random_lighting", {"alpha_std": 0.0}),
    ("image_random_color_jitter", {})])
def test_random_image_op_at_a_fixed_factor(name, attrs):
    """With min factor = max factor (no lighting noise, no jitter) a random
    image op is its deterministic form: the reference's value."""
    x = np.random.RandomState(2).uniform(0, 1, (2, 5, 4, 3)).astype("f")
    ref = ref_invoke(name, [ref_array(x)], dict(attrs)).asnumpy()
    port = port_invoke(name, [port_array(x)], dict(attrs)).asnumpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("name,axis", [
    ("image_random_flip_left_right", 2), ("image_random_flip_top_bottom", 1)])
def test_random_flip_is_a_fair_seeded_coin(name, axis):
    x = np.random.RandomState(3).uniform(0, 1, (2, 4, 5, 3)).astype("f")
    flipped = np.flip(x, axis)
    mx.random.seed(11)
    outs = [port_invoke(name, [port_array(x)], {}).asnumpy()
            for _ in range(400)]
    mx.random.seed(11)
    np.testing.assert_array_equal(
        port_invoke(name, [port_array(x)], {}).asnumpy(), outs[0])
    flips = [bool(np.array_equal(o, flipped)) for o in outs]
    assert all(f or np.array_equal(o, x) for f, o in zip(flips, outs))
    assert abs(sum(flips) - 200) < 50          # 5 sigma of 400 fair coins
