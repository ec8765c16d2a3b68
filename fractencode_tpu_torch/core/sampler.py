# Copied from fractencode_tpu/core/sampler.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""Isometry-aware 2x2-average downsampling as static gather tables.

The reference samples one pixel at a time: clamp the local coordinate to the
patch interior, map the 2x2 neighbourhood through the isometry, and average
the four taps (``image/sampler.h:21-38`` +
``image/transform.h:96-109``).  Per-comparison pointer chasing like that is
poison on TPU, so we precompute, per (source_size, target_size, transform),
the four *flat* tap offsets for every output pixel.  Sampling a whole domain
block then becomes one gather + one reduction over a length-4 axis, which XLA
fuses; sampling the whole codebook is a single batched gather.

Exact semantics reproduced:
  * source coordinate for output (rx, ry) is ``sx = (rx * sw) // tw`` with
    integer division (``encode/transformmatcher.h:94-95``,
    ``encode/DecodeUtils.hpp:20-21``);
  * edge clamp: if ``sx == sw - 1`` decrement (``sampler.h:32-35``);
  * the four taps are the isometry images of (sx, sy), (sx+1, sy),
    (sx, sy+1), (sx+1, sy+1) (``transform.h:96-109``);
  * value = sum of the 4 u8 taps / 4 in float => multiples of 0.25.
"""
from __future__ import annotations

import functools

import numpy as np

from .transform import NUM_TRANSFORMS, TransformType, map_xy

__all__ = [
    "tap_table",
    "all_tap_tables",
    "sample_block",
]


@functools.lru_cache(maxsize=None)
def tap_table(source_size: int, target_size: int, t: TransformType) -> np.ndarray:
    """[target_size**2, 4] flat indices into a row-major source block.

    ``sampled[p] = block_flat[tap_table(...)[p]].sum() / 4`` reproduces
    ``SamplerBilinear::sample`` at output pixel ``p = ry * tw + rx``.
    """
    sw, tw = source_size, target_size
    out = np.empty((tw * tw, 4), dtype=np.int32)
    for ry in range(tw):
        for rx in range(tw):
            sx = (rx * sw) // tw
            sy = (ry * sw) // tw
            if sx == sw - 1:
                sx -= 1
            if sy == sw - 1:
                sy -= 1
            taps = []
            for dy in (0, 1):
                for dx in (0, 1):
                    mx, my = map_xy(t, sx + dx, sy + dy, sw, sw)
                    taps.append(my * sw + mx)
            # order (0,0),(1,0),(0,1),(1,1) matches the reference offsets
            # p0..p3 (transform.h:103-106); order is irrelevant to the sum.
            out[ry * tw + rx] = [taps[0], taps[1], taps[2], taps[3]]
    return out


@functools.lru_cache(maxsize=None)
def all_tap_tables(source_size: int, target_size: int) -> np.ndarray:
    """[NUM_TRANSFORMS, target_size**2, 4] stacked tap tables."""
    return np.stack(
        [tap_table(source_size, target_size, TransformType(t)) for t in range(NUM_TRANSFORMS)]
    )


def sample_block(block: np.ndarray, target_size: int, t: TransformType) -> np.ndarray:
    """Reference-semantics downsample of one square block (numpy, for tests).

    ``block`` is [sw, sw]; returns [target_size, target_size] float64.
    """
    sw = block.shape[0]
    taps = tap_table(sw, target_size, TransformType(t))
    flat = block.reshape(-1).astype(np.float64)
    return (flat[taps].sum(axis=1) / 4.0).reshape(target_size, target_size)
