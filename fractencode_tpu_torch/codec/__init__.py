from .quantize import quantize, dequantize, DEFAULT_S_BITS, DEFAULT_O_BITS

__all__ = ["quantize", "dequantize", "DEFAULT_S_BITS", "DEFAULT_O_BITS"]
