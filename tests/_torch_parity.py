"""Shared inputs and converters for the port's parity tests (test_torch_*.py).

Both packages see the same numpy inputs; results cross over as numpy arrays.
"""
import dataclasses
import os

import numpy as np
import torch

from fractencode_tpu_torch.bridge import ARRAY_FIELDS as RESULT_ARRAYS
from fractencode_tpu_torch.bridge import META_FIELDS as RESULT_META

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def lenna128() -> np.ndarray:
    from fractencode_tpu_torch.image import load_gray

    return load_gray(os.path.join(GOLDEN, "lenna128_input.png"))


def random_plane(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, n), dtype=np.uint8)


def planes() -> dict:
    """The parity planes: the in-repo Lenna crop and random 64/96/128 planes."""
    return {"lenna128": lenna128(), "rand64": random_plane(64, 1),
            "rand96": random_plane(96, 2), "rand128": random_plane(128, 3)}


def bits(x) -> np.ndarray:
    """Raw bits of an array or tensor, so float comparisons are bitwise
    (+0.0 vs -0.0 and NaN payloads count as different)."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.bool_:
        return a.view(np.uint8)
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.itemsize == 4 else np.int64)
    return a.astype(np.int64)


def assert_bitwise(a, b, what=""):
    ba, bb = bits(a), bits(b)
    assert ba.shape == bb.shape, (what, ba.shape, bb.shape)
    bad = int((ba != bb).sum())
    assert bad == 0, f"{what}: {bad} of {ba.size} entries differ"


def jax_result_to_port(rj, device="cpu"):
    """The JAX package's EncodeResult as the port's (through bridge.py)."""
    from fractencode_tpu_torch.bridge import result_from_numpy

    arrays = {f: np.asarray(getattr(rj, f)) for f in RESULT_ARRAYS}
    meta = {f: getattr(rj, f) for f in RESULT_META}
    return result_from_numpy(arrays, meta, device)


def assert_results_equal(rj, rt):
    """Every per-range field of a JAX and a port EncodeResult, bitwise."""
    for f in RESULT_ARRAYS:
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f)
    for f in RESULT_META:
        assert getattr(rj, f) == getattr(rt, f), f
    for a, b in zip(rj.domain_origins(), rt.domain_origins()):
        assert_bitwise(a, b, "domain_origins")
    assert rj.num_ranges == rt.num_ranges
    for g in ("domain_grid", "range_grid"):  # two Grid classes: compare fields
        assert dataclasses.astuple(getattr(rj, g)) == dataclasses.astuple(getattr(rt, g))


# decoder-step geometries, (source, target, domain step, isometries, plane
# size): the grid default and its half scale, the quadtree's three levels
# (ranges 16/8/4 px, domains 4x at half-domain steps) at full and half
# scale, BASELINE config 1, 32 px ranges, and the "full" table kind's (an odd
# domain step; 3 and 5 px ranges, whose taps lie on odd corners)
DECODE_STEP_GEOMETRIES = {
    "grid": (16, 4, 8, 4, 64), "grid_half": (8, 2, 4, 4, 32),
    "qt16": (64, 16, 32, 8, 128), "qt16_half": (32, 8, 16, 8, 64),
    "qt8": (32, 8, 16, 8, 64), "qt8_half": (16, 4, 8, 8, 32),
    "qt4": (16, 4, 8, 8, 64), "qt4_half": (8, 2, 4, 8, 32),
    "config1": (16, 8, 8, 8, 64), "odd_step": (8, 4, 3, 8, 64),
    "ts32": (64, 32, 32, 8, 128), "ts3": (6, 3, 3, 8, 63), "ts5": (10, 5, 5, 8, 60),
}


def decode_step_case(geometry: str, seed: int, o_is_mean: bool = False, size=None):
    """Numpy inputs of one decode step at ``DECODE_STEP_GEOMETRIES[geometry]``
    (on an n = ``size`` plane if given): (img u8 [n, n], domain_idx i32,
    transform i32, s f32, o f32).  s and o drive samples past 0 and 255 (o
    the range's mean level with ``o_is_mean``), and a quarter of the ranges
    are invalid (s = o = 0)."""
    sw, ts, step, t_n, n = DECODE_STEP_GEOMETRIES[geometry]
    n = size or n
    rng = np.random.default_rng(seed)
    r = (n // ts) ** 2
    nd = ((n - sw) // step + 1) ** 2
    img = rng.integers(0, 256, size=(n, n), dtype=np.uint8)
    dom = rng.integers(0, nd, size=r).astype(np.int32)
    tr = rng.integers(0, t_n, size=r).astype(np.int32)
    s = rng.uniform(-1.5, 1.5, size=r).astype(np.float32)
    o = (rng.uniform(0, 255, size=r) if o_is_mean
         else rng.uniform(-300, 500, size=r)).astype(np.float32)
    invalid = rng.random(r) < 0.25
    s[invalid] = 0.0
    o[invalid] = 0.0
    return img, dom, tr, s, o


def mean_maps(samples: torch.Tensor):
    """(s, o) numpy f32 maps for ``o_is_mean`` that see the last bit of each
    range's mean m, the sum of the range's ``samples`` [R, K] times f32(1/K)
    (the JAX package's): s = 1, o = m on even ranges, s = -1, o = 255 - m on
    odd ones.  A sample v that is a whole number then comes out as v or
    255 - v, one grey level lower where a step's mean is one ulp above m
    (even ranges) or below it (odd ranges)."""
    samples = samples.cpu().numpy()
    mean = samples.sum(-1) * (np.float32(1.0) / np.float32(samples.shape[-1]))
    odd = np.arange(len(mean)) % 2 == 1
    s = np.where(odd, -1.0, 1.0).astype(np.float32)
    o = np.where(odd, np.float32(255.0) - mean, mean).astype(np.float32)
    return s, o
