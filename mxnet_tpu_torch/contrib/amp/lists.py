"""AMP op lists: the reference's own (``mxnet_tpu/contrib/amp/lists.py``),
copied so the port applies the same cast policy.  Names the port's table
does not register yet are kept: they take effect once those ops are
ported.

- ``TARGET_DTYPE_OPS``: tensor-core ops whose float inputs are cast DOWN
  to the target dtype.
- ``FP32_OPS``: numerically sensitive ops whose inputs are cast UP to fp32.
- every other op runs in whatever dtype arrives (torch type promotion);
  BatchNorm accumulates its statistics in fp32 itself (ops/nn.py).
"""

TARGET_DTYPE_OPS = [
    "Convolution",
    "Deconvolution",
    "FullyConnected",
    "dot",
    "batch_dot",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
    "_contrib_flash_attention",
    "RNN",
]

FP32_OPS = [
    "softmax",
    "log_softmax",
    "softmin",
    "SoftmaxOutput",
    "SoftmaxActivation",
    "softmax_cross_entropy",
    "CTCLoss",
    "LRN",
    "L2Normalization",
    "InstanceNorm",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
    "power",
    "norm",
    "mean",
    "sum",
    "nansum",
    "prod",
    "nanprod",
    "cumsum",
    "erf",
    "erfinv",
    "gamma",
    "gammaln",
    "MakeLoss",
    "LinearRegressionOutput",
    "LogisticRegressionOutput",
    "MAERegressionOutput",
]
