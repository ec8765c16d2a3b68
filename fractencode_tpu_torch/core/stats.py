"""Block statistics on tensors (port of ``fractencode_tpu/core/stats.py``).

All sums are exact in int32: a 255-valued 16x16 block sums to 65280, far
below 2**31, so every summation order gives the same integers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.tables import device_table
from .grid import Grid

__all__ = ["integral_image", "grid_block_sums", "block_sums_nonoverlapping",
           "quadrant_sums"]


def integral_image(plane: torch.Tensor) -> torch.Tensor:
    """[H+1, W+1] i32 exclusive-origin integral image of a u8/int plane."""
    s = torch.cumsum(torch.cumsum(plane.to(torch.int32), 0, dtype=torch.int32),
                     1, dtype=torch.int32)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def _grid_origins(grid: Grid) -> np.ndarray:
    """[2, num_items] the grid's (origin_x, origin_y)."""
    return np.stack(grid.origins())


def _window_sums(ii: torch.Tensor, grid: Grid, w: int, h: int, dx: int = 0,
                 dy: int = 0) -> torch.Tensor:
    """Sums of h x w windows at the grid's origins shifted by (dx, dy), from
    an integral image (the origins uploaded once, ``utils.tables``)."""
    ox, oy = device_table(_grid_origins, grid, device=ii.device)
    ox, oy = ox + dx, oy + dy
    return ii[oy + h, ox + w] - ii[oy, ox + w] - ii[oy + h, ox] + ii[oy, ox]


def grid_block_sums(plane: torch.Tensor, grid: Grid,
                    ii: torch.Tensor | None = None) -> torch.Tensor:
    """[num_items] i32 per-block pixel sums for a (possibly overlapping) grid."""
    if ii is None:
        ii = integral_image(plane)
    return _window_sums(ii, grid, grid.block_size, grid.block_size)


def block_sums_nonoverlapping(plane: torch.Tensor, block_size: int) -> torch.Tensor:
    """[H//b, W//b] i32 block sums for an exact non-overlapping tiling."""
    h, w = plane.shape
    b = block_size
    if h % b or w % b:
        raise ValueError(f"plane {h}x{w} is not tiled by {b}x{b} blocks")
    x = plane.to(torch.int32).reshape(h // b, b, w // b, b)
    return x.sum(dim=(1, 3), dtype=torch.int32)


def quadrant_sums(plane: torch.Tensor, grid: Grid, ii: torch.Tensor | None = None,
                  sums2x2: torch.Tensor | None = None) -> torch.Tensor:
    """[num_items, 4] i32 sums of the 4 half-size quadrants of each block.

    Quadrant order a1..a4 = top-left, top-right, bottom-left, bottom-right
    (``encode/Classifier2.cpp:55-61``).  When the grid step is a multiple of
    the half-block, every quadrant lies on the half-aligned tiling and the
    sums are strided picks of its block sums; otherwise the integral image
    serves any grid.  ``sums2x2`` optionally forwards the plane's [H/2, W/2]
    2x2 box sums, which the encoder computes once for the codebook too.
    """
    h, w = plane.shape
    half = grid.block_size // 2
    if half > 0 and grid.step % half == 0 and h % half == 0 and w % half == 0:
        if sums2x2 is not None and half % 2 == 0:
            bs = sums2x2 if half == 2 else block_sums_nonoverlapping(sums2x2, half // 2)
        else:
            bs = block_sums_nonoverlapping(plane, half)  # [H/half, W/half]
        k = grid.step // half
        ny, nx = grid.ny, grid.nx

        def pick(row0, col0):
            return bs[row0::k, col0::k][:ny, :nx].reshape(-1)

        return torch.stack([pick(0, 0), pick(0, 1), pick(1, 0), pick(1, 1)], dim=1)
    if ii is None:
        ii = integral_image(plane)
    q = [
        _window_sums(ii, grid, half, half),
        _window_sums(ii, grid, half, half, dx=half),
        _window_sums(ii, grid, half, half, dy=half),
        _window_sums(ii, grid, half, half, dx=half, dy=half),
    ]
    return torch.stack(q, dim=1)
