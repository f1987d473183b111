"""Vision models — port of ``paddle_tpu/vision/models``: the ResNet
family, LeNet, AlexNet, VGG, MobileNet v1 / v2 / v3, SqueezeNet,
ShuffleNetV2, DenseNet, GoogLeNet, InceptionV3 and the OCR pair (DBNet,
CRNN), under every name the JAX package exports. Each constructor also
takes ``device`` (``place``; None: the CUDA card), ``dtype`` and
``generator``."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .lenet import LeNet
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .alexnet import AlexNet, alexnet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .ocr import CRNN, DBNet, crnn, crnn_ctc_loss, db_loss, dbnet

__all__ = [n for n in dir() if not n.startswith("_")]
