from .mesh import DATA_AXIS, SEARCH_AXIS, Mesh, make_mesh
from .sharded import (STRATEGIES, decode_batch_sharded, encode_batch_sharded,
                      encode_plane_sharded_image)

__all__ = [
    "make_mesh",
    "Mesh",
    "DATA_AXIS",
    "SEARCH_AXIS",
    "encode_batch_sharded",
    "decode_batch_sharded",
    "encode_plane_sharded_image",
    "STRATEGIES",
]
