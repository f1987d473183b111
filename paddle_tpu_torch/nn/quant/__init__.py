from .quant_layers import Int8Linear

__all__ = ["Int8Linear"]
