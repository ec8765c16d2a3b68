"""The benchmark's frozen arithmetic: the card's published peaks, a search's
bound (the operations and bytes it needs, from shapes and the reference's
classes), and the union of device intervals.

``search_bytes`` and ``bound`` are copies of ``chip_smoke.py``'s; the peaks
are NVIDIA's data sheet figures for the H100 SXM (dense, no sparsity) at its
700 W power limit.
"""
from __future__ import annotations

import torch

PEAK_INT8_OPS = 1979e12  # int8 tensor-core operations a second
PEAK_BYTES = 3.35e12  # HBM3 bytes a second


def width(n: int) -> int:
    """K, the search kernels' int8 operand width for ranges of n pixels: the
    least of 16, 64 and 256 at or above n, and above 256 n rounded up to a
    multiple of 256."""
    return next(k for k in (16, 64, 256) if n <= k) if n <= 256 else -(-n // 256) * 256


def search_bytes(rows: int, cols: int, k: int, sums: bool, masked: bool = False) -> int:
    """The bytes a search must move, each input read once and each output
    written once: per range its K int8 values, its (q, idx), and its SumA
    and SumA2 (``sums``: the 'general' key or the frontier) and class (the
    class mask); per column its 2K int8 values, SumB and the key's aux, and
    its class (the class mask)."""
    cls = 4 if masked else 0
    return rows * (k + 8 + (8 if sums else 0) + cls) + cols * (2 * k + 8 + cls)


def bound_s(pairs: int, n: int, nbytes: int) -> float:
    """The least seconds the card could take for ``pairs`` (range, column)
    pairs of 2n int8 operations each, moving ``nbytes``: the larger of the
    operations over the int8 peak and the bytes over the memory peak."""
    return max(2 * n * pairs / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def needed_pairs(range_class: torch.Tensor, column_class: torch.Tensor) -> int:
    """The same-class (range, column) pairs a classed search needs:
    sum over classes of ranges x columns."""
    r = torch.bincount(range_class + 1, minlength=8)
    c = torch.bincount(column_class + 1, minlength=8)
    return int((r * c).sum())


def union_seconds(intervals, start: float, end: float) -> float:
    """Seconds of [start, end] covered by the union of ``intervals``
    ((begin, end) pairs in seconds, in any order, overlapping or not)."""
    return end - start - sum(e - b for b, e in gaps(intervals, start, end))


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The (begin, end) stretches of [start, end] that no interval covers,
    in order."""
    out, at = [], start
    for b, e in sorted(intervals):
        b, e = max(b, start), min(e, end)
        if e <= b:
            continue
        if b > at:
            out.append((at, b))
        at = max(at, e)
    if end > at:
        out.append((at, end))
    return out
