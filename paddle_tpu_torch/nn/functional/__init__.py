"""Functional ops — port of ``paddle_tpu/nn/functional``: every name it
exports (activations, ``linear`` and the common ops, convolutions,
pooling, the norms, ``scaled_dot_product_attention``, the losses with
``ctc_loss``, and the extras). Tensors in and out; no ``Tensor``
wrapper, no ``apply_op``."""
from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, log_softmax, maxout, mish, prelu, relu,
                         relu6, rrelu, selu, sigmoid, silu, softmax, softplus,
                         softshrink, softsign, swish, tanh, tanhshrink,
                         thresholded_relu)
from .attention import scaled_dot_product_attention
from .common import (alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, fold, interpolate, label_smooth, linear,
                     one_hot, pad, pixel_shuffle, pixel_unshuffle,
                     sequence_mask, temporal_shift, unfold, upsample,
                     zeropad2d)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, ctc_loss, dice_loss,
                   gaussian_nll_loss, hinge_embedding_loss, huber_loss,
                   kl_div, l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   multi_label_soft_margin_loss, multi_margin_loss, nll_loss,
                   npair_loss, poisson_nll_loss, sigmoid_focal_loss,
                   smooth_l1_loss, soft_margin_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss, triplet_margin_with_distance_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm, spectral_norm)
from .extras import (affine_grid, class_center_sample, diag_embed, elu_,
                     gather_tree, grid_sample, hsigmoid_loss,
                     margin_cross_entropy, max_unpool1d, max_unpool3d,
                     pairwise_distance, relu_, rnnt_loss, softmax_,
                     sparse_attention, tanh_)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d, max_unpool2d)

__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("activation", "attention", "common", "conv",
                         "extras", "loss", "norm", "pooling")]
