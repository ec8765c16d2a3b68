from .quantize import quantize, dequantize, DEFAULT_S_BITS, DEFAULT_O_BITS
from .bitstream import pack_result, unpack_result
from .bitstream_quadtree import pack_quadtree, unpack_quadtree
from .container import pack_container, unpack_container, is_container

__all__ = [
    "quantize",
    "dequantize",
    "DEFAULT_S_BITS",
    "DEFAULT_O_BITS",
    "pack_result",
    "unpack_result",
    "pack_quadtree",
    "unpack_quadtree",
    "pack_container",
    "unpack_container",
    "is_container",
]
