# Copied from fractencode_tpu/image/yuv.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""RGB <-> YUV420 plane conversion, vectorized.

Same (BT.601-flavoured) coefficients as the reference
(``image/ImageIO.cpp:50-52,79-81``).  Differences by design:
the reference allocates 64-byte-aligned strides + 32 padding for SIMD
(``ImageIO.cpp:19-23``); on TPU planes are dense arrays and XLA handles
layout, so stride == width.

Chroma subsampling parity: the reference writes U/V at (x//2, y//2) for every
source pixel, so the *last* pixel of each 2x2 cell wins (no averaging,
``ImageIO.cpp:54-55``) — replicated here by taking the bottom-right sample of
each 2x2 cell.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rgb_to_yuv420", "yuv420_to_rgb"]


def _clamp_u8(x: np.ndarray) -> np.ndarray:
    # Reference clamp: truncating cast after range clip (ImageIO.cpp:11-13).
    return np.clip(x, 0.0, 255.0).astype(np.uint8)


def rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[H, W, 3] u8 -> (Y [H, W], U [H/2, W/2], V [H/2, W/2]) u8 planes."""
    h, w = rgb.shape[:2]
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.169 * r - 0.331 * g + 0.499 * b + 128.0
    v = 0.499 * r - 0.418 * g - 0.0813 * b + 128.0
    # last-sample-wins 2x2 subsampling (ImageIO.cpp:54-55)
    u_sub = u[1 : h : 2, 1 : w : 2] if h > 1 and w > 1 else u[:1, :1]
    v_sub = v[1 : h : 2, 1 : w : 2] if h > 1 and w > 1 else v[:1, :1]
    return _clamp_u8(y), _clamp_u8(u_sub), _clamp_u8(v_sub)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(Y, U, V) u8 planes -> [H, W, 3] u8 (coefficients ImageIO.cpp:79-81)."""
    h, w = y.shape
    yp = y.astype(np.float64)
    up = np.repeat(np.repeat(u.astype(np.float64), 2, axis=0), 2, axis=1)[:h, :w] - 128.0
    vp = np.repeat(np.repeat(v.astype(np.float64), 2, axis=0), 2, axis=1)[:h, :w] - 128.0
    r = yp + 1.402 * vp
    g = yp - 0.344 * up - 0.714 * vp
    b = yp + 1.772 * up
    return np.stack([_clamp_u8(r), _clamp_u8(g), _clamp_u8(b)], axis=-1)
