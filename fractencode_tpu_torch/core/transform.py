# Copied from fractencode_tpu/core/transform.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""The 8 dihedral isometries of the square, as index maps.

TPU-native design: instead of mapping coordinates one pixel at a time (the
reference maps each (x, y) through an 8x8 integer coefficient table,
``image/transform.h:32-41``), we precompute *flat index
permutation tables* once per (block_size, transform) at trace time with numpy,
and apply them as gathers on whole block tensors.  All shapes stay static, so
XLA can fuse the gathers into surrounding compute.

Semantics parity: ``map_xy`` reproduces ``Frac::Transform<type>::map``
(``transform.h:83-87``): local (x, y) in a w x h patch maps to

    (a*x + b*y + c*(w-1) + d*(h-1),  e*x + f*y + g*(w-1) + h_*(h-1))

with the same coefficient choices per enum value (Id, Rotate_90, Rotate_180,
Rotate_270, Flip, Flip_Rotate_90, Flip_Rotate_180, Flip_Rotate_270).
"""
from __future__ import annotations

import enum
import functools

import numpy as np

__all__ = [
    "TransformType",
    "NUM_TRANSFORMS",
    "map_xy",
    "mapped_size",
    "permutation_table",
    "all_permutation_tables",
]


class TransformType(enum.IntEnum):
    """Same enumeration order as the reference (``transform.h:16-25``)."""

    ID = 0
    ROT90 = 1
    ROT180 = 2
    ROT270 = 3
    FLIP = 4
    FLIP_ROT90 = 5
    FLIP_ROT180 = 6
    FLIP_ROT270 = 7


NUM_TRANSFORMS = len(TransformType)

# (x, y, w, h) -> (x', y').  Verified against the reference coefficient table
# (``transform.h:32-41``): e.g. ROT90 row {0,1,0,0, -1,0,1,0} means
# x' = y, y' = (w-1) - x.
_COORD_MAPS = {
    TransformType.ID: lambda x, y, w, h: (x, y),
    TransformType.ROT90: lambda x, y, w, h: (y, (w - 1) - x),
    TransformType.ROT180: lambda x, y, w, h: ((w - 1) - x, (h - 1) - y),
    TransformType.ROT270: lambda x, y, w, h: ((h - 1) - y, x),
    TransformType.FLIP: lambda x, y, w, h: (x, (h - 1) - y),
    TransformType.FLIP_ROT90: lambda x, y, w, h: (y, x),
    TransformType.FLIP_ROT180: lambda x, y, w, h: ((w - 1) - x, y),
    TransformType.FLIP_ROT270: lambda x, y, w, h: ((h - 1) - y, (w - 1) - x),
}

# Transforms that swap the patch width/height (``transform.h:47-57``).
_SWAPS_SIZE = frozenset(
    {
        TransformType.ROT90,
        TransformType.ROT270,
        TransformType.FLIP_ROT90,
        TransformType.FLIP_ROT270,
    }
)


def map_xy(t: TransformType, x, y, w: int, h: int):
    """Map local patch coordinates through isometry ``t``.

    Accepts scalars or numpy arrays for ``x``/``y``.  Mirrors
    ``Transform::map`` (``transform.h:83-87``).
    """
    return _COORD_MAPS[TransformType(t)](x, y, w, h)


def mapped_size(t: TransformType, w: int, h: int) -> tuple[int, int]:
    """Patch size after the isometry (90/270-style transforms swap axes)."""
    if TransformType(t) in _SWAPS_SIZE:
        return h, w
    return w, h


@functools.lru_cache(maxsize=None)
def permutation_table(block_size: int, t: TransformType) -> np.ndarray:
    """Flat gather indices realizing isometry ``t`` on a square block.

    For a block ``B`` flattened row-major to length ``block_size**2``::

        Bt_flat = B_flat[permutation_table(block_size, t)]

    gives ``Bt[y, x] == B[my, mx]`` where ``(mx, my) = map_xy(t, x, y)``,
    i.e. ``Bt`` viewed at local coords (x, y) reads the source pixel the
    reference would read at the transformed coordinates.
    """
    n = block_size
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    mx, my = map_xy(t, xs, ys, n, n)
    return (my * n + mx).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def all_permutation_tables(block_size: int) -> np.ndarray:
    """[NUM_TRANSFORMS, block_size**2] stacked permutation tables."""
    return np.stack(
        [permutation_table(block_size, TransformType(t)) for t in range(NUM_TRANSFORMS)]
    )
