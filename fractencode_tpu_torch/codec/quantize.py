# Copied from fractencode_tpu/codec/quantize.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""Uniform scalar quantization of the (s, o) transform parameters.

Semantics port of ``Frac::Quantizer`` (``encode/Quantizer.hpp:7-45``):
``quantized`` floors into ``2**bits`` buckets over [min, max] (clamped to the
top bucket); ``value`` reconstructs the bucket midpoint.  The reference only
used this for CLI statistics with 5 contrast bits / 7 brightness bits
(``main.cpp:120-138``); here it is the real codec stage feeding the
bitstream, vectorized over all ranges.
"""
from __future__ import annotations

import numpy as np

__all__ = ["quantize", "dequantize", "DEFAULT_S_BITS", "DEFAULT_O_BITS"]

DEFAULT_S_BITS = 5  # main.cpp:120
DEFAULT_O_BITS = 7  # main.cpp:121


def quantize(values: np.ndarray, vmin: float, vmax: float, bits: int) -> np.ndarray:
    """[N] float -> [N] uint32 bucket indices (Quantizer.hpp:25-30)."""
    if not vmax > vmin:
        # degenerate range: everything lands in bucket 0
        return np.zeros(np.shape(values), dtype=np.uint32)
    step = abs(vmax - vmin) / (1 << bits)
    q = np.floor((np.clip(values, vmin, vmax) - vmin) / step)
    return np.minimum(q, (1 << bits) - 1).astype(np.uint32)


def dequantize(q: np.ndarray, vmin: float, vmax: float, bits: int) -> np.ndarray:
    """[N] bucket indices -> [N] float bucket midpoints (Quantizer.hpp:31-36)."""
    if not vmax > vmin:
        return np.full(np.shape(q), vmin, dtype=np.float64)
    step = abs(vmax - vmin) / (1 << bits)
    return np.asarray(q, dtype=np.float64) * step + vmin + step / 2
