from .serving import GenerationServer

__all__ = ["GenerationServer"]
