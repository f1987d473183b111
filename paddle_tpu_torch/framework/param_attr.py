"""``ParamAttr`` — a copy of ``paddle_tpu/framework/param_attr.py`` (which
imports no JAX; the port keeps its own copy rather than import the JAX
package)."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if callable(arg):
            return ParamAttr(initializer=arg)
        if arg is False:
            return False
        return ParamAttr()


class WeightNormParamAttr(ParamAttr):
    """Weight-norm reparameterization metadata (the reference's
    ``WeightNormParamAttr``); read by ``nn.utils.weight_norm``."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate, regularizer=regularizer,
                         trainable=trainable,
                         do_model_average=do_model_average,
                         need_clip=need_clip)
        self.dim = dim
