"""Layers — port of ``paddle_tpu/nn/layer``: the common layers, the
containers, convolutions, pooling, norms, activations, the losses, the
recurrent layers, the transformer encoder and the extras
(``PairwiseDistance``, ``HSigmoidLoss``, ``RNNTLoss``, the unpools,
``BeamSearchDecoder`` …)."""
from .activation import (CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, ChannelShuffle,
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, Flatten, Fold, Identity, Linear, Pad1D,
                     Pad2D, Pad3D, PixelShuffle, PixelUnshuffle, Unfold,
                     Upsample, UpsamplingBilinear2D, UpsamplingNearest2D,
                     ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .extras import (BeamSearchDecoder, HSigmoidLoss, MaxUnPool1D,
                     MaxUnPool3D, PairwiseDistance, RNNTLoss, Softmax2D,
                     TripletMarginWithDistanceLoss)
from .loss import (BCELoss, BCEWithLogitsLoss, CTCLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, GaussianNLLLoss, HingeEmbeddingLoss,
                   HuberLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
                   MultiLabelSoftMarginLoss, MultiMarginLoss, NLLLoss,
                   PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                      MaxUnPool2D)
from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = [n for n in dir() if not n.startswith("_") and n[0].isupper()]
