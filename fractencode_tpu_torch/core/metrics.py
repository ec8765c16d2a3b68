"""Distance metrics (port of ``fractencode_tpu/core/metrics.py``).

As in the reference (``metrics.h:36,49``), the "RMS" of the decoder and the
thresholds is an MSE with no square root.
"""
from __future__ import annotations

import torch

__all__ = ["plane_mse", "psnr"]


def plane_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MSE between two same-shape u8 planes, as an f32 scalar.

    The squared differences are summed exactly in int64 (the JAX package
    splits an i32 sum into hi/lo halves only to avoid i32 wrap); the one
    rounding is the final division.
    """
    d = a.to(torch.int64) - b.to(torch.int64)
    total = (d * d).sum()
    return (total.to(torch.float64) / float(a.numel())).to(torch.float32)


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB between two u8 planes."""
    mse = torch.clamp(plane_mse(a, b), min=1e-12)
    return 10.0 * torch.log10(peak * peak / mse)
