# Copied from fractencode_tpu/image/io.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""Host-side image IO.

Equivalent of the reference's stb_image-based ``ImageIO``
(``image/ImageIO.{hpp,cpp}``): load any PNG/JPEG to YUV420
planes, save grayscale planes or 3-plane YUV images back to PNG.  PIL is the
host decoder (stb_image's role); all device work consumes dense numpy planes.
"""
from __future__ import annotations

import numpy as np

from .yuv import rgb_to_yuv420, yuv420_to_rgb

__all__ = ["load_planes", "load_gray", "save_plane", "save_yuv"]


def _imread_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_planes(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an image file to (Y, U, V) u8 planes (YUV420)."""
    return rgb_to_yuv420(_imread_rgb(path))


def load_gray(path: str) -> np.ndarray:
    """Load an image file to its Y (luma) plane, like the reference's
    grayscale path (``main.cpp:189-190`` encodes plane 0 only)."""
    return load_planes(path)[0]


def save_plane(plane: np.ndarray, path: str) -> None:
    """Save a u8 plane as a grayscale PNG (``ImageIO.cpp:99-102``)."""
    from PIL import Image

    Image.fromarray(np.asarray(plane, dtype=np.uint8), mode="L").save(path)


def save_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray, path: str) -> None:
    """Save YUV420 planes as an RGB PNG (``ImageIO.cpp:86-97``)."""
    from PIL import Image

    Image.fromarray(yuv420_to_rgb(y, u, v), mode="RGB").save(path)
