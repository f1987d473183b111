from . import lr
from .lr import (CosineAnnealingDecay, CosineAnnealingWarmRestarts, CyclicLR,
                 ExponentialDecay, InverseTimeDecay, LambdaDecay, LinearLR,
                 LinearWarmup, LRScheduler, MultiplicativeDecay,
                 MultiStepDecay, NaturalExpDecay, NoamDecay, OneCycleLR,
                 PiecewiseDecay, PolynomialDecay, ReduceOnPlateau, StepDecay)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Lars, Momentum, Optimizer, RMSProp)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "CosineAnnealingDecay", "CosineAnnealingWarmRestarts", "CyclicLR",
           "ExponentialDecay", "InverseTimeDecay", "LRScheduler",
           "LambdaDecay", "Lamb", "Lars", "LinearLR", "LinearWarmup",
           "Momentum", "MultiStepDecay", "MultiplicativeDecay",
           "NaturalExpDecay", "NoamDecay", "OneCycleLR", "Optimizer",
           "PiecewiseDecay", "PolynomialDecay", "RMSProp", "ReduceOnPlateau",
           "SGD", "StepDecay", "lr"]
