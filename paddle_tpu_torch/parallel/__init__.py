from .engine import ParallelEngine

__all__ = ["ParallelEngine"]
