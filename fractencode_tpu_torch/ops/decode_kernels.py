"""The decoder step's hand-written CUDA kernel (``csrc/decode_step.cu``).

One application of the whole map set, from the u8 image of one scale to the
u8 image of the next step, in one launch: for each output pixel the sample
of its range's (domain, isometry), ``s*v + o``, a clamp and a floor.  It
replaces no TPU kernel (the JAX package's step is XLA-lowered); its plain
version is the torch step, ``decode.decoder._decode_step_torch``, which the
CPU takes and which the card tests hold it against bitwise.

Every table kind of ``decode.decoder.build_decode_tables`` ("cb", "half",
"full") gives the same samples: sample k of a range under isometry t is the
sum of the 2x2 tap cell whose min corner lies ``cell_corners(...)[t, k]``
bytes past the domain's origin, over 4.  So the kernel reads one [8, K]
table for every geometry the port decodes (both pyramid scales, every range
size, the quadtree's levels) and the maps as the result holds them.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ..core.sampler import all_tap_tables

__all__ = ["cell_corners", "decode_step_cuda"]


@functools.lru_cache(maxsize=None)
def cell_corners(source_size: int, target_size: int, width: int) -> np.ndarray:
    """[NUM_TRANSFORMS, K] i32: the flat offset, in an image ``width``
    pixels wide, of the min corner of each sample's 2x2 tap cell, for a
    domain anchored at offset 0.  Raises where a sample's four taps
    (``all_tap_tables``) are not such a cell."""
    my, mx = np.divmod(all_tap_tables(source_size, target_size), source_size)
    my0, mx0 = my.min(axis=2), mx.min(axis=2)
    cell = np.sort((my - my0[..., None]) * 2 + (mx - mx0[..., None]), axis=2)
    if not (cell == np.arange(4)).all():
        raise ValueError(f"the taps of ({source_size}, {target_size}) are not 2x2 cells")
    return (my0.astype(np.int64) * width + mx0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """``fe_decode_step`` (its library built and loaded on first use)."""
    from ._build import load_library

    fn = load_library("decode_step").fe_decode_step
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def decode_step_cuda(img, domain_idx, transform, s, o, cells, *, target_size: int,
                     domain_cols: int, domain_step: int, o_is_mean: bool = False):
    """One decoder step on the card: the u8 [H, W] image after ``img`` (u8
    [H, W], H and W multiples of ``target_size``) under the maps
    ``domain_idx``, ``transform`` (i32 [R], isometry ids below 8), ``s``,
    ``o`` (f32 [R]; ``o`` the range's mean with ``o_is_mean``), with
    ``cells`` = ``cell_corners(source, target_size, W)`` on the device and
    the domains on a grid of ``domain_cols`` columns at ``domain_step``
    pixels.  Launches ``csrc/decode_step.cu`` on the current stream (and
    adds one to ``decode_step_cuda.launches[(target_size, o_is_mean)]``);
    raises ``ValueError`` for inputs it does not take."""
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h, w = img.shape if img.dim() == 2 else (-1, -1)
    ts = target_size
    if h <= 0 or ts <= 0 or h % ts or w % ts or h * w >= 2 ** 31:
        raise ValueError(f"image {tuple(img.shape)}: not a 2-D plane of whole "
                         f"{ts}x{ts} ranges below 2^31 pixels")
    nyr, nxr = h // ts, w // ts
    _check("img", img, torch.uint8, (h, w), dev)
    _check("domain_idx", domain_idx, torch.int32, (nyr * nxr,), dev)
    _check("transform", transform, torch.int32, (nyr * nxr,), dev)
    _check("s", s, torch.float32, (nyr * nxr,), dev)
    _check("o", o, torch.float32, (nyr * nxr,), dev)
    _check("cells", cells, torch.int32, (8, ts * ts), dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        out = torch.empty((h, w), dtype=torch.uint8, device=dev)
        err = fn(img.data_ptr(), domain_idx.data_ptr(), transform.data_ptr(), s.data_ptr(),
                 o.data_ptr(), cells.data_ptr(), nyr, nxr, ts, domain_cols, domain_step,
                 int(o_is_mean), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step kernel launch failed: CUDA error {err}")
    decode_step_cuda.launches[(ts, bool(o_is_mean))] += 1
    return out


# launch counts by (range size, o_is_mean)
decode_step_cuda.launches = collections.Counter()
