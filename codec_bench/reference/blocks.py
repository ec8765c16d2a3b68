"""Block geometry of the fractal codec, written from the C++ reference's
description (sebsgit/fractencode): grids, isometries, the 2x2-average
domain sampler and the 6-class brightness classifier.

Plain PyTorch and numpy; nothing here imports the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

# Classifier2.cpp:22-50: (class, three (i, j) pairs meaning a_i > a_j), over
# the quadrant sums a1..a4 = top-left, top-right, bottom-left, bottom-right;
# tested in this order, the last match wins, no match is class -1.
CONDITIONS = (
    (0, ((1, 2), (2, 3), (3, 4))), (0, ((3, 1), (1, 4), (4, 2))),
    (0, ((4, 3), (3, 2), (2, 1))), (0, ((2, 4), (4, 1), (1, 3))),
    (1, ((1, 3), (3, 2), (2, 4))), (1, ((2, 1), (1, 4), (4, 3))),
    (1, ((4, 2), (2, 3), (3, 1))), (1, ((3, 4), (4, 1), (1, 2))),
    (2, ((1, 4), (4, 3), (3, 2))), (2, ((4, 1), (1, 2), (2, 3))),
    (2, ((3, 2), (2, 4), (4, 1))), (2, ((2, 3), (3, 1), (1, 4))),
    (3, ((1, 2), (2, 4), (4, 3))), (3, ((3, 1), (1, 2), (2, 4))),
    (3, ((4, 3), (3, 1), (1, 2))), (3, ((2, 4), (4, 3), (3, 1))),
    (4, ((2, 1), (1, 3), (3, 4))), (4, ((1, 3), (3, 4), (4, 2))),
    (4, ((3, 4), (4, 2), (2, 1))), (4, ((4, 2), (2, 1), (1, 3))),
    (5, ((1, 4), (4, 2), (2, 3))), (5, ((4, 1), (1, 3), (3, 4))),
    (5, ((2, 3), (3, 4), (4, 1))), (5, ((3, 2), (2, 1), (1, 4))),
)


def isometry(t: int, x, y, w: int):
    """transform.h: local (x, y) of a w x w patch under isometry t (0 Id,
    1 Rot90, 2 Rot180, 3 Rot270, 4 Flip, 5 FlipRot90, 6 FlipRot180,
    7 FlipRot270) -> the (x, y) it reads."""
    e = w - 1
    return [(x, y), (y, e - x), (e - x, e - y), (e - y, x),
            (x, e - y), (y, x), (e - x, y), (e - y, e - x)][t]


def sample_taps(sw: int, tw: int, t_count: int) -> np.ndarray:
    """[T, tw*tw, 4] flat offsets (y * sw + x) into a sw x sw block of the
    four pixels averaged into each output pixel (sampler.h): output (rx, ry)
    reads the 2x2 cell at sx = rx * sw // tw (one less at the edge), mapped
    through the isometry."""
    out = np.empty((t_count, tw * tw, 4), np.int64)
    for t in range(t_count):
        for ry in range(tw):
            for rx in range(tw):
                sx, sy = rx * sw // tw, ry * sw // tw
                sx -= sx == sw - 1
                sy -= sy == sw - 1
                taps = [isometry(t, sx + dx, sy + dy, sw) for dy in (0, 1) for dx in (0, 1)]
                out[t, ry * tw + rx] = [my * sw + mx for mx, my in taps]
    return out


def grid_origins(width: int, height: int, size: int, step: int):
    """(x, y) int64 origins of every size x size block at the step, row-major
    with x fastest (partition2.hpp)."""
    nx = (width - size) // step + 1
    ny = (height - size) // step + 1
    ys, xs = torch.meshgrid(torch.arange(ny) * step, torch.arange(nx) * step, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def classes(plane: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """[N] int64 brightness class (-1..5) of every block of the grid."""
    h, w = plane.shape
    ii = torch.nn.functional.pad(plane.long().cumsum(0).cumsum(1), (1, 0, 1, 0))
    ox, oy = (v.to(plane.device) for v in grid_origins(w, h, size, step))
    q = size // 2

    def box(x, y):
        return ii[y + q, x + q] - ii[y, x + q] - ii[y + q, x] + ii[y, x]

    a = {1: box(ox, oy), 2: box(ox + q, oy), 3: box(ox, oy + q), 4: box(ox + q, oy + q)}
    cls = torch.full_like(ox, -1)
    for c, ((i, j), (k, l), (m, n)) in CONDITIONS:
        cls = torch.where((a[i] > a[j]) & (a[k] > a[l]) & (a[m] > a[n]), c, cls)
    return cls


def search_classes(plane: torch.Tensor, size: int, step: int, classed: bool) -> torch.Tensor:
    """[N] int64 class of every block of the grid as the search prunes by it:
    the brightness classes where the configuration's ``use_classifier`` is
    on, and class 0 for every block where it is off, so that one class holds
    every range and every column (the full search)."""
    if classed:
        return classes(plane, size, step)
    ox, _ = grid_origins(plane.shape[1], plane.shape[0], size, step)
    return torch.zeros(ox.shape, dtype=torch.int64, device=plane.device)


def range_blocks(plane: torch.Tensor, tw: int, dtype=torch.float64) -> torch.Tensor:
    """[R, tw*tw] range blocks, r = ry * (W // tw) + rx, pixels row-major."""
    h, w = plane.shape
    x = plane.to(dtype).reshape(h // tw, tw, w // tw, tw)
    return x.permute(0, 2, 1, 3).reshape(-1, tw * tw)


def domain_vectors(plane: torch.Tensor, sw: int, step: int, tw: int, t_count: int,
                   dtype=torch.float64, chunk: int = 65536) -> torch.Tensor:
    """[D, T, tw*tw] every domain block sampled under the first T isometries,
    in ``dtype`` (multiples of 0.25: exact in float64)."""
    h, w = plane.shape
    flat = plane.reshape(-1).to(dtype)
    ox, oy = grid_origins(w, h, sw, step)
    base = (oy * w + ox).to(plane.device)
    local = torch.from_numpy(sample_taps(sw, tw, t_count)).to(plane.device)
    offs = (local // sw) * w + local % sw  # [T, n, 4] image offsets
    out = torch.empty((base.shape[0], t_count, tw * tw), dtype=dtype, device=plane.device)
    for d0 in range(0, base.shape[0], chunk):
        b = base[d0:d0 + chunk, None, None, None]
        out[d0:d0 + chunk] = flat[b + offs[None]].sum(-1) * 0.25
    return out
