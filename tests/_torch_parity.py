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
