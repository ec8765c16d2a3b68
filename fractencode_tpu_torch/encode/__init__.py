from .codebook import Codebook, build_codebook, extract_ranges
from .matcher import SearchResult, search_classed, solve_so
from .encoder import (EncodeResult, encode_batch, encode_batch_stacked, encode_plane,
                      encode_stats)
from .quadtree import (QuadtreeConfig, QuadtreeResult, decode_batch_quadtree_sharded,
                       decode_plane_quadtree, encode_batch_quadtree,
                       encode_batch_quadtree_sharded, encode_batch_quadtree_stacked,
                       encode_plane_quadtree)

__all__ = [
    "Codebook",
    "build_codebook",
    "extract_ranges",
    "SearchResult",
    "search_classed",
    "solve_so",
    "EncodeResult",
    "encode_plane",
    "encode_batch",
    "encode_batch_stacked",
    "encode_stats",
    "QuadtreeConfig",
    "QuadtreeResult",
    "encode_plane_quadtree",
    "encode_batch_quadtree",
    "encode_batch_quadtree_stacked",
    "encode_batch_quadtree_sharded",
    "decode_plane_quadtree",
    "decode_batch_quadtree_sharded",
]
