from . import lr
from .lr import CosineAnnealingDecay, LinearWarmup, LRScheduler
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "CosineAnnealingDecay", "LRScheduler",
           "LinearWarmup", "Optimizer", "lr"]
