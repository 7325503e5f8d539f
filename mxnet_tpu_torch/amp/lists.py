"""AMP op lists (counterpart of ``mxnet_tpu/amp/lists.py``): the op names
the funnel (``ndarray.apply_multi``) casts under a policy.

Matmul- and convolution-class ops run in the low-precision dtype (the
card's tensor cores); numerically sensitive reductions and softmax in f32;
elementwise ops in the widest of their floating inputs. The normalization
ops are in no list: they compute their statistics in f32 and read and
write the activation in its own dtype."""

# ops whose floating inputs are cast to the low-precision dtype
TARGET_DTYPE_OPS = [
    "fully_connected", "convolution", "deconvolution", "batch_dot", "dot",
    "matmul", "einsum", "flash_attention", "embedding",
]

# ops whose floating inputs are cast to f32
FP32_OPS = [
    "softmax", "log_softmax", "masked_softmax",
    "norm", "mean", "var", "std",
    "exp", "log", "log1p", "expm1", "sum", "cumsum",
]

# ops whose floating inputs are cast to the widest among them
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "maximum", "minimum", "where", "clip",
    "relu", "gelu", "silu", "tanh", "sigmoid",
]
