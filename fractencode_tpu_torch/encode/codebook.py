"""Domain codebook construction (port of ``fractencode_tpu/encode/codebook.py``).

Every (domain, isometry) is sampled once per image into ``C[D, T, K]`` plus
its per-vector sums.  Values are multiples of 0.25 in [0, 255], exact in
f32.  The sums come from the exact integers sum(4B) and sum((4B)^2), each
rounded once: SumB is exact in f32 up to K = 256 and float64 above
(``sum_dtype``), SumB2 exact in f32 only up to K = 16, so above that it is
the correctly rounded value, the same on every device and in every
summation order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import Grid
from ..core.sampler import all_tap_tables
from ..ops.matcher_kernels import inv_var_b, key_sum_sq, sum_dtype
from ..utils.tables import device_table

__all__ = ["Codebook", "build_codebook", "extract_ranges", "range_sums"]


@dataclasses.dataclass
class Codebook:
    """Sampled domain pool."""

    values: torch.Tensor  # [D, T, K] f32 — sampled (domain, isometry) vectors
    sum: torch.Tensor  # [D, T] f32 (float64 above K = 256) — per-vector sums (SumB)
    sum_sq: torch.Tensor  # [D, T] f32 — per-vector sums of squares (SumB2)
    grid: Grid  # domain grid
    inv_var: torch.Tensor  # [D, T] f32 guarded 1/var_b


def _block_pixel_offsets(block_size: int, stride: int) -> np.ndarray:
    """[block_size**2] flat image offsets of a block's pixels, row-major."""
    ys, xs = np.mgrid[0:block_size, 0:block_size]
    return (ys * stride + xs).reshape(-1).astype(np.int64)


def _half_origins(grid: Grid, width: int) -> np.ndarray:
    """[D] flat index of each domain's origin in the [H/2, W/2] half image."""
    ox, oy = grid.origins()
    return (oy.astype(np.int64) // 2) * (width // 2) + ox // 2


def build_codebook(plane_f32: torch.Tensor, domain_grid: Grid, target_size: int,
                   num_transforms: int, half: torch.Tensor | None = None) -> Codebook:
    """Sample all domain blocks under the first ``num_transforms`` isometries.

    ``plane_f32`` is the [H, W] image as f32 (exact u8 values).  When the
    geometry is even-aligned, every 4-tap average is one pixel of the 2x2-box
    half image (``half``, computed here if not given), so the codebook is one
    gather from it; otherwise a block gather plus four tap gathers.  Both
    paths give the same values.
    """
    # imported here: the decoder imports encode.encoder, which imports this module
    from ..decode.decoder import _half_res_taps, half_res_image

    h, w = plane_f32.shape
    dev = plane_f32.device
    sw = domain_grid.block_size

    # gather indices are built on the device from the small origin and tap
    # tables (the full [D, T, K] index would be a 33 MB copy at 2048^2),
    # each uploaded once (utils.tables)
    if _half_res_taps(sw, target_size, w) is not None and domain_grid.step % 2 == 0:
        taps = device_table(_half_res_taps, sw, target_size, w,
                            device=dev)[:num_transforms]  # [T, K]
        if half is None:
            half = half_res_image(plane_f32)
        origin_half = device_table(_half_origins, domain_grid, w, device=dev)  # [D]
        values = half.reshape(-1)[origin_half[:, None, None] + taps[None]]
    else:
        flat = plane_f32.reshape(-1)
        origins = device_table(Grid.flat_origins, domain_grid, w, device=dev)
        blocks = flat[origins[:, None]
                      + device_table(_block_pixel_offsets, sw, w, device=dev)[None, :]]
        taps = device_table(all_tap_tables, sw, target_size,
                            device=dev)[:num_transforms]  # [T, K, 4]
        acc = blocks[:, taps[:, :, 0]]
        for j in range(1, 4):
            acc = acc + blocks[:, taps[:, :, j]]
        values = acc * 0.25  # [D, T, K]

    n = float(target_size * target_size)
    b4 = torch.round(values * 4.0).to(torch.int32)  # exact integers 4B <= 1020
    sums = b4.sum(-1, dtype=torch.int64).to(sum_dtype(n)) * 0.25
    sb2_16 = (b4 * b4).sum(-1, dtype=torch.int64)  # <= n * 1020^2
    return Codebook(values=values, sum=sums,
                    sum_sq=sb2_16.to(torch.float32) * 0.0625, grid=domain_grid,
                    inv_var=inv_var_b(sums, key_sum_sq(sb2_16, n), n))


def range_sums(ranges: torch.Tensor):
    """(SumA, SumA2) of [R, n] range blocks, exact: f32 up to n = 256, where
    every partial sum is an integer below 2^24, and float64 above
    (``sum_dtype``)."""
    r = ranges.to(sum_dtype(ranges.shape[-1]))
    return r.sum(-1), (r * r).sum(-1)


def extract_ranges(plane_f32: torch.Tensor, target_size: int) -> torch.Tensor:
    """[R, K] f32 range blocks of the non-overlapping range grid, row-major
    block order (``partition2.hpp:123-133``): r = ry * (W // tw) + rx."""
    h, w = plane_f32.shape
    tw = target_size
    if h % tw or w % tw:
        raise ValueError(f"plane {h}x{w} is not tiled by {tw}x{tw} ranges")
    x = plane_f32.reshape(h // tw, tw, w // tw, tw)
    return x.permute(0, 2, 1, 3).reshape(-1, tw * tw)
