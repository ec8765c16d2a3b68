"""Brightness-block classification (port of ``fractencode_tpu/core/classify.py``).

The reference's 24 three-way inequality chains (``Classifier2.cpp:22-50``,
including the unreachable cyclic class-5 row) are evaluated once, in numpy,
into a 4096-entry table over the 12-bit pairwise-order code of a block's four
quadrant sums; classifying a grid is then one code computation and one
tensor lookup.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tables import device_table
from .stats import quadrant_sums

__all__ = ["classify_from_quadrants", "classify_grid"]

# (class, ((i, j), (k, l), (m, n))) meaning a_i > a_j && a_k > a_l && a_m > a_n,
# 1-based quadrant indices, transcribed from Classifier2.cpp:22-50.
_CONDITIONS = [
    (0, ((1, 2), (2, 3), (3, 4))),
    (0, ((3, 1), (1, 4), (4, 2))),
    (0, ((4, 3), (3, 2), (2, 1))),
    (0, ((2, 4), (4, 1), (1, 3))),
    (1, ((1, 3), (3, 2), (2, 4))),
    (1, ((2, 1), (1, 4), (4, 3))),
    (1, ((4, 2), (2, 3), (3, 1))),
    (1, ((3, 4), (4, 1), (1, 2))),
    (2, ((1, 4), (4, 3), (3, 2))),
    (2, ((4, 1), (1, 2), (2, 3))),
    (2, ((3, 2), (2, 4), (4, 1))),
    (2, ((2, 3), (3, 1), (1, 4))),
    (3, ((1, 2), (2, 4), (4, 3))),
    (3, ((3, 1), (1, 2), (2, 4))),
    (3, ((4, 3), (3, 1), (1, 2))),
    (3, ((2, 4), (4, 3), (3, 1))),
    (4, ((2, 1), (1, 3), (3, 4))),
    (4, ((1, 3), (3, 4), (4, 2))),
    (4, ((3, 4), (4, 2), (2, 1))),
    (4, ((4, 2), (2, 1), (1, 3))),
    (5, ((1, 4), (4, 2), (2, 3))),
    (5, ((4, 1), (1, 3), (3, 4))),  # unreachable (cyclic), kept for parity
    (5, ((2, 3), (3, 4), (4, 1))),
    (5, ((3, 2), (2, 1), (1, 4))),
]

# the 6 unordered quadrant pairs; bit b of the order code is a_i > a_j and
# bit b+6 is a_j > a_i (two bits per pair: ties leave both clear)
_PAIR_I = np.array([0, 0, 0, 1, 1, 2], np.int32)
_PAIR_J = np.array([1, 2, 3, 2, 3, 3], np.int32)


def _pair_table() -> np.ndarray:
    """[2, 6]: the pairs' first and second quadrants."""
    return np.stack([_PAIR_I, _PAIR_J])


def _bit_weights() -> np.ndarray:
    """[6]: the order code's bit of each pair."""
    return 1 << np.arange(6)


@functools.lru_cache(maxsize=None)
def _order_code_table() -> np.ndarray:
    """[4096] i32: 12-bit pairwise-order code -> class, by evaluating the 24
    reference conditions in their original order (last match wins; for codes
    arising from real numbers at most one can match)."""
    tbl = np.full(4096, -1, np.int32)
    for code in range(4096):
        gt = {}
        for b in range(6):
            i, j = int(_PAIR_I[b]) + 1, int(_PAIR_J[b]) + 1
            gt[(i, j)] = bool((code >> b) & 1)
            gt[(j, i)] = bool((code >> (b + 6)) & 1)
        cls = -1
        for c, triple in _CONDITIONS:
            if all(gt[(i, j)] for (i, j) in triple):
                cls = c
        tbl[code] = cls
    return tbl


def classify_from_quadrants(quads: torch.Tensor) -> torch.Tensor:
    """[N] i32 class in {-1, 0..5} from [N, 4] quadrant sums (a1..a4)."""
    a = quads if quads.dtype == torch.float32 else quads.to(torch.int32)
    dev = quads.device
    pairs = device_table(_pair_table, device=dev)
    ai = a[..., pairs[0]]  # [N, 6]
    aj = a[..., pairs[1]]
    w = device_table(_bit_weights, device=dev, dtype=torch.int32)
    code = ((ai > aj).to(torch.int32) * w).sum(-1, dtype=torch.int32) + (
        ((aj > ai).to(torch.int32) * w).sum(-1, dtype=torch.int32) << 6)
    table = device_table(_order_code_table, device=dev, dtype=torch.int32)
    return table[code.to(torch.int64)]


def classify_grid(plane, grid, ii=None, sums2x2=None) -> torch.Tensor:
    """[num_items] classes for every block of a grid over a u8 plane
    (``Classifier2.cpp:64-68``).  ``sums2x2`` forwards a precomputed 2x2
    box-sum plane (see stats.quadrant_sums)."""
    return classify_from_quadrants(
        quadrant_sums(plane, grid, ii=ii, sums2x2=sums2x2))
