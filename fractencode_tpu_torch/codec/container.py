# Copied from fractencode_tpu/codec/container.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""Multi-plane container framing for color bitstreams.

The reference decodes each of the three YUV planes and saves RGB
(``main.cpp:192-200``, ``image/ImageIO.cpp:86-97``) but never
serialized anything; rounds 1-3 of this framework wrote ``--color`` output as
three *bare* concatenated per-plane streams, which a decoder cannot split
without re-parsing stream internals.  This tiny container fixes that: an
explicit plane count plus per-plane byte lengths, so ``--decode-file`` can
reconstruct every plane (uniform-grid FTC1 or quadtree FTQ1, mixed freely)
and hand the YUV triple to ``save_yuv``.

Layout (little-endian):

    magic 'FTCC' | u16 version | u16 n_planes | u32 byte_len * n_planes |
    plane 0 bytes | plane 1 bytes | ...

A truncated file, a length table that disagrees with the actual size, or a
plane count outside {1, 3} fails loudly with ``ValueError``.
"""
from __future__ import annotations

import struct

__all__ = ["pack_container", "unpack_container", "is_container"]

_MAGIC = b"FTCC"
_VERSION = 1
_HDR_FMT = "<4sHH"


def is_container(data: bytes) -> bool:
    return data[:4] == _MAGIC


def pack_container(planes: list[bytes]) -> bytes:
    """Frame per-plane bitstreams (each FTC1/FTQ1) into one container blob."""
    if len(planes) not in (1, 3):
        raise ValueError(f"container supports 1 or 3 planes, got {len(planes)}")
    head = struct.pack(_HDR_FMT, _MAGIC, _VERSION, len(planes))
    lengths = struct.pack(f"<{len(planes)}I", *(len(p) for p in planes))
    return head + lengths + b"".join(planes)


def unpack_container(data: bytes) -> list[bytes]:
    """Split a container blob back into its per-plane bitstreams."""
    hdr = struct.calcsize(_HDR_FMT)
    if len(data) < hdr:
        raise ValueError("truncated container header")
    magic, version, n_planes = struct.unpack(_HDR_FMT, data[:hdr])
    if magic != _MAGIC:
        raise ValueError("not a container stream")
    if version != _VERSION:
        raise ValueError(f"unsupported container version {version}")
    if n_planes not in (1, 3):
        raise ValueError(f"container plane count must be 1 or 3, got {n_planes}")
    table_end = hdr + 4 * n_planes
    if len(data) < table_end:
        raise ValueError("truncated container length table")
    lengths = struct.unpack(f"<{n_planes}I", data[hdr:table_end])
    if table_end + sum(lengths) != len(data):
        raise ValueError(
            f"container length table ({sum(lengths)} payload bytes) does not "
            f"match file size ({len(data) - table_end} present)"
        )
    out, pos = [], table_end
    for n in lengths:
        out.append(data[pos : pos + n])
        pos += n
    return out
