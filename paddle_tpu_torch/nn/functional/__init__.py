"""Functional ops — port of ``paddle_tpu/nn/functional``: activations,
``linear`` and ``dropout``, convolutions, pooling, the norms,
``scaled_dot_product_attention``, four losses and the beam-search
backtrace ``gather_tree``. Tensors in and out; no ``Tensor`` wrapper, no
``apply_op``."""
from .activation import (celu, elu, gelu, glu, hardshrink, hardsigmoid,
                         hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, maxout, mish, prelu, relu, relu6, rrelu,
                         selu, sigmoid, silu, softmax, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink, thresholded_relu)
from .attention import scaled_dot_product_attention
from .common import dropout, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .extras import gather_tree
from .loss import cross_entropy, l1_loss, mse_loss, nll_loss
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d, max_unpool2d)

__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("activation", "attention", "common", "conv",
                         "extras", "loss", "norm", "pooling")]
