from .engine import ParallelEngine, make_train_step, parallelize

__all__ = ["ParallelEngine", "make_train_step", "parallelize"]
