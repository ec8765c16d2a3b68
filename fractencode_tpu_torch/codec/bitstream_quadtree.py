# Copied from fractencode_tpu/codec/bitstream_quadtree.py, with two changes:
# pack_quadtree reads the port's QuadtreeResult (tensors on any device), and
# unpack_quadtree builds it on ``device`` (default: the card) without jax.
# Importing any fractencode_tpu module imports jax (fractencode_tpu/__init__.py
# imports the encoder).
"""Bitstream for quadtree encodes.

Layout: magic 'FTQ1', header (image dims + level geometry + per-level
quantizer ranges), then per level:
  * the acceptance bitmap (one bit per grid position — this IS the tree
    structure, no pointers needed because every level is a full grid), then
  * packed (domain_idx, transform, s_q, o_q) for the accepted blocks only.

Uses the same robust-range 5/7-bit quantization as the uniform stream.
When ``pack_quadtree`` is given the source ``plane``, 'o' is stored as each
accepted block's target mean and the decoder applies ``s*(D - mean(D)) + o``
(the mean-centred parameterization of the uniform stream,
``bitstream.pack_result`` — bounds o-quantization error to ~step/2 gray
levels instead of letting s-error multiply full-magnitude pixels).
"""
from __future__ import annotations

import struct

import numpy as np

from .bitstream import _bit_width, _bits_to_ints, _ints_to_bits, host
from .quantize import DEFAULT_O_BITS, DEFAULT_S_BITS, dequantize, quantize

__all__ = ["pack_quadtree", "unpack_quadtree"]

_MAGIC = b"FTQ1"
# v2: per-item payload uses the SAME layout as the uniform stream
# (valid bit | dom | transform | s_q | o_q) so both formats share the native
# C++ packer (native/bitpack.cpp); the valid bit is constant 1 here (only
# accepted blocks are stored) at a cost of 1 bit per leaf.
# v3: adds a flags field (bit 0 = mean-centred o).
# v4 (round 4): acceptance bitmaps are framed entropy streams
# (codec/entropy.py) and per-level payloads may be per-field Huffman streams
# (flags bit 1); v3 files remain readable.
# v5 (round 5): implied acceptance maps (flags bit 4).  The selection
# cascade guarantees structure the full bitmaps wasted bits on: a block
# under an accepted coarser leaf is never accepted, and the finest level
# accepts EXACTLY the uncovered remainder.  So each non-final level
# transmits one bit per *uncovered* position only, and the final level
# transmits nothing (measured at 1024^2: ~78k -> ~13k bits of map).
# v3/v4 files remain readable.
_VERSION = 5
_FLAG_O_IS_MEAN = 1
_FLAG_ENTROPY = 2
# round 5: flat-block short-circuit in the per-level entropy streams
# (see bitstream._FLAG_FLAT_SC — same scheme, same error-neutrality bound)
_FLAG_FLAT_SC = 8
# round 5 (v5): acceptance maps transmit only the undetermined bits
_FLAG_IMPLIED_ACC = 16
_NT_SHIFT = 8  # v5: flags bits 8-11: num_transforms (0 = legacy -> 8)
_NT_SHIFT_V34 = 4  # v3/v4 files carried num_transforms in bits 4-7
# magic, version, flags, nlevels, width, height, sbits, obits
_HDR_FMT = "<4sHHHIIHH"
_LVL_FMT = "<HHHIffff"  # range, domain, step, naccept, smin, smax, omin, omax


def pack_quadtree(result, s_bits: int = DEFAULT_S_BITS,
                  o_bits: int = DEFAULT_O_BITS, plane=None,
                  entropy: bool = True,
                  flat_scale: float = 0.35) -> bytes:
    """Serialize a ``QuadtreeResult``.  With ``plane`` (the source image),
    o is stored mean-centred (see module docstring) — measured >5 dB at the
    default bit budget, same as the uniform stream.  ``entropy=True``
    Huffman-codes acceptance maps and per-field leaf streams
    (``codec/entropy.py``) and keeps whichever whole-file form is smaller
    (per-stream table overhead can beat the savings on small pyramids);
    the header flag records which was written.  Quantization/means are
    computed once and only the payload *assembly* differs between the two
    candidate forms (the flag is whole-file because it also switches the
    acceptance-map framing)."""
    o_is_mean = plane is not None
    if o_is_mean:
        p = host(plane, np.float64)
        h, w = p.shape
    want_entropy = entropy and s_bits <= 8 and o_bits <= 8
    from .entropy import encode_stream
    from .bitstream import _entropy_pack_fields
    from .native import pack_items_native

    nt = getattr(result.levels[0], "num_transforms", 8) if result.levels else 8

    # Implied-acceptance analysis (v5): verify the selection-cascade
    # structure (children of accepted leaves never accepted; final level
    # accepts exactly the uncovered remainder; levels refine by exactly 2x)
    # and precompute the per-level uncovered masks.  Falls back to full
    # bitmaps when a hand-built result violates it.
    implied_ok = bool(result.levels)
    uncov_masks = []
    cov = None
    for i, lvl in enumerate(result.levels):
        nyb = result.height // lvl.range_size
        nxb = result.width // lvl.range_size
        a = host(lvl.accepted)
        if cov is None:
            u = np.ones(nyb * nxb, bool)
        elif nyb == cov.shape[0] * 2 and nxb == cov.shape[1] * 2:
            u = ~np.repeat(np.repeat(cov, 2, 0), 2, 1).reshape(-1)
        else:
            implied_ok = False
            break
        if (a & ~u).any() or (
            i == len(result.levels) - 1 and not np.array_equal(a, u)
        ):
            implied_ok = False
            break
        uncov_masks.append(u)
        cov = (~u | a).reshape(nyb, nxb)

    def header(extra_flags: int) -> bytes:
        return struct.pack(_HDR_FMT, _MAGIC, _VERSION,
                           (_FLAG_O_IS_MEAN if o_is_mean else 0)
                           | extra_flags
                           | (nt << _NT_SHIFT),
                           len(result.levels),
                           result.width, result.height, s_bits, o_bits)

    e_base = _FLAG_ENTROPY | (_FLAG_IMPLIED_ACC if implied_ok else 0)
    raw_parts = [header(0)]
    ent_parts = [header(e_base)] if want_entropy else None
    # third candidate: entropy + flat short-circuit (s_bits <= 7 so the
    # flat symbol 1 << s_bits fits the byte alphabet)
    flat_parts = (
        [header(e_base | _FLAG_FLAT_SC)]
        if want_entropy and s_bits <= 7 and flat_scale > 0 else None
    )
    for lvl_i, lvl in enumerate(result.levels):
        acc = host(lvl.accepted)
        sel = np.where(acc)[0]
        s = host(lvl.s, np.float64)[sel]
        if o_is_mean:
            rs = lvl.range_size
            means = (
                p.reshape(h // rs, rs, w // rs, rs)
                .transpose(0, 2, 1, 3)
                .reshape(-1, rs * rs)
                .mean(axis=1)
            )
            o = means[sel]
        else:
            o = host(lvl.o, np.float64)[sel]
        dom = host(lvl.domain_idx, np.uint32)[sel]
        tr = host(lvl.transform, np.uint32)[sel]

        if len(sel):
            s_min, s_max = (float(x) for x in np.percentile(s, [0.5, 99.5]))
            o_min, o_max = (float(x) for x in np.percentile(o, [0.5, 99.5]))
        else:
            s_min = s_max = o_min = o_max = 0.0

        nx = (result.width - lvl.domain_size) // lvl.domain_step + 1
        ny = (result.height - lvl.domain_size) // lvl.domain_step + 1
        d_bits = _bit_width(nx * ny)

        lvl_hdr = struct.pack(_LVL_FMT, lvl.range_size, lvl.domain_size,
                              lvl.domain_step, len(sel),
                              s_min, s_max, o_min, o_max)
        raw_parts.append(lvl_hdr)
        acc_bytes = np.packbits(acc.astype(np.uint8))
        raw_parts.append(acc_bytes.tobytes())
        if want_entropy:
            if implied_ok:
                # only undetermined bits; the final level is fully implied
                if lvl_i == len(result.levels) - 1:
                    acc_stream = b""
                else:
                    acc_stream = encode_stream(
                        np.packbits(acc[uncov_masks[lvl_i]].astype(np.uint8)))
            else:
                # framed full map (fine-level maps are mostly zeros)
                acc_stream = encode_stream(acc_bytes)
        else:
            acc_stream = b""
        if ent_parts is not None:
            ent_parts.append(lvl_hdr)
            ent_parts.append(acc_stream)
        if flat_parts is not None:
            flat_parts.append(lvl_hdr)
            flat_parts.append(acc_stream)
        if len(sel):
            s_q = quantize(s, s_min, s_max, s_bits)
            o_q = quantize(o, o_min, o_max, o_bits)
            if ent_parts is not None:
                ones_b = np.ones(len(sel), bool)
                ent_parts.append(_entropy_pack_fields(dom, tr, s_q, o_q,
                                                      ones_b, d_bits))
            if flat_parts is not None:
                ones_b = np.ones(len(sel), bool)
                bucket = (s_max - s_min) / (1 << s_bits)
                flat = np.abs(s) <= flat_scale * bucket if s_max > s_min \
                    else np.zeros(len(sel), bool)
                flat_parts.append(_entropy_pack_fields(
                    dom, tr, s_q, o_q, ones_b, d_bits,
                    flat=flat, flat_sym=1 << s_bits))
            ones = np.ones(len(sel), np.uint8)
            payload = pack_items_native(dom, tr, s_q, o_q, ones, d_bits, 3,
                                        s_bits, o_bits)
            if payload is None:  # no compiler available: numpy fallback
                bits = np.concatenate(
                    [
                        ones[:, None],
                        _ints_to_bits(dom, d_bits),
                        _ints_to_bits(tr, 3),
                        _ints_to_bits(s_q, s_bits),
                        _ints_to_bits(o_q, o_bits),
                    ],
                    axis=1,
                )
                payload = np.packbits(bits.reshape(-1)).tobytes()
            raw_parts.append(payload)
    candidates = [b"".join(raw_parts)]
    if ent_parts is not None:
        candidates.append(b"".join(ent_parts))
    if flat_parts is not None:
        candidates.append(b"".join(flat_parts))
    return min(candidates, key=len)


def unpack_quadtree(data: bytes, device=None):
    """Deserialize to a ``QuadtreeResult`` with dequantized (midpoint) s, o,
    its tensors on ``device`` (default: the card; see
    ``encoder.default_device``)."""
    import torch

    from ..encode.encoder import default_device
    from ..encode.quadtree import QuadtreeLevel, QuadtreeResult

    device = default_device(device)
    t = lambda x: torch.from_numpy(x).to(device)

    off = struct.calcsize(_HDR_FMT)
    magic, version, flags, nlevels, width, height, s_bits, o_bits = (
        struct.unpack(_HDR_FMT, data[:off])
    )
    if magic != _MAGIC or version not in (3, 4, _VERSION):
        raise ValueError("bad quadtree bitstream header")
    if not (1 <= s_bits <= 16 and 1 <= o_bits <= 16 and width and height):
        raise ValueError("corrupt quadtree header fields")
    o_is_mean = bool(flags & _FLAG_O_IS_MEAN)
    use_entropy = version >= 4 and bool(flags & _FLAG_ENTROPY)
    framed_acc = version >= 4 and use_entropy
    flat_sym = (
        (1 << s_bits)
        if (version >= 5 and use_entropy and flags & _FLAG_FLAT_SC)
        else None
    )
    implied_acc = (version >= 5 and use_entropy
                   and bool(flags & _FLAG_IMPLIED_ACC))
    if version >= 5:
        num_transforms = ((flags >> _NT_SHIFT) & 0xF) or 8
    else:
        num_transforms = ((flags >> _NT_SHIFT_V34) & 0xF) or 8

    levels = []
    cov = None  # implied-acc coverage state, [nyb, nxb] bool
    for lvl_i in range(nlevels):
        lvl_size = struct.calcsize(_LVL_FMT)
        if len(data) < off + lvl_size:
            raise ValueError("truncated quadtree level header")
        (range_size, domain_size, domain_step, naccept,
         s_min, s_max, o_min, o_max) = struct.unpack(
            _LVL_FMT, data[off : off + lvl_size]
        )
        off += lvl_size
        # corrupt geometry fields must fail loudly, not divide by zero or
        # fabricate absurd grids
        if (range_size == 0 or domain_step == 0
                or width % range_size or height % range_size
                or domain_size > width or domain_size > height):
            raise ValueError("corrupt quadtree level geometry")
        nyb = height // range_size
        nxb = width // range_size
        n_blocks = nyb * nxb
        if naccept > n_blocks:
            raise ValueError("corrupt quadtree acceptance count")
        if implied_acc:
            from .entropy import decode_stream

            if cov is None:
                uncov = np.ones(n_blocks, bool)
            else:
                if nyb != cov.shape[0] * 2 or nxb != cov.shape[1] * 2:
                    raise ValueError("implied acceptance: bad level geometry")
                uncov = ~np.repeat(np.repeat(cov, 2, 0), 2, 1).reshape(-1)
            if lvl_i == nlevels - 1:
                acc = uncov
            else:
                n_und = int(uncov.sum())
                ub, off = decode_stream(data, off,
                                        expect_count=(n_und + 7) // 8)
                acc = np.zeros(n_blocks, bool)
                acc[uncov] = np.unpackbits(ub, count=n_und).astype(bool)
            cov = (~uncov | acc).reshape(nyb, nxb)
        elif framed_acc:
            from .entropy import decode_stream

            acc_bytes, off = decode_stream(data, off,
                                           expect_count=(n_blocks + 7) // 8)
            acc = np.unpackbits(acc_bytes, count=n_blocks).astype(bool)
        else:
            bm_bytes = -(-n_blocks // 8)
            acc = np.unpackbits(
                np.frombuffer(data[off : off + bm_bytes], np.uint8),
                count=n_blocks,
            ).astype(bool)
            off += bm_bytes
        if naccept != int(acc.sum()):
            raise ValueError(
                f"acceptance map count {int(acc.sum())} != header {naccept}")

        nx = (width - domain_size) // domain_step + 1
        ny = (height - domain_size) // domain_step + 1
        d_bits = _bit_width(nx * ny)
        item_bits = 1 + d_bits + 3 + s_bits + o_bits
        dom = np.zeros(n_blocks, np.int32)
        tr = np.zeros(n_blocks, np.int32)
        s = np.zeros(n_blocks, np.float32)
        o = np.zeros(n_blocks, np.float32)
        if naccept and use_entropy:
            from .bitstream import _entropy_unpack_fields

            dom_v, tr_v, s_qv, o_qv, _, off = _entropy_unpack_fields(
                data, off, naccept, d_bits, all_valid=True,
                flat_sym=flat_sym)
        elif naccept:
            nbytes = -(-naccept * item_bits // 8)
            from .native import unpack_items_native

            native = unpack_items_native(data[off : off + nbytes], naccept,
                                         d_bits, 3, s_bits, o_bits)
            if native is not None:
                dom_v, tr_v, s_qv, o_qv, _ = native
            else:
                bits = np.unpackbits(
                    np.frombuffer(data[off : off + nbytes], np.uint8),
                    count=naccept * item_bits,
                ).reshape(naccept, item_bits)
                p = 1  # skip the constant valid bit
                dom_v = _bits_to_ints(bits[:, p : p + d_bits]); p += d_bits
                tr_v = _bits_to_ints(bits[:, p : p + 3]); p += 3
                s_qv = _bits_to_ints(bits[:, p : p + s_bits]); p += s_bits
                o_qv = _bits_to_ints(bits[:, p : p + o_bits])
            off += nbytes
        if naccept:
            if flat_sym is not None:
                flat_v = s_qv == flat_sym
                s_v = np.where(
                    flat_v, 0.0,
                    dequantize(np.minimum(s_qv, flat_sym - 1),
                               s_min, s_max, s_bits))
            else:
                s_v = dequantize(s_qv, s_min, s_max, s_bits)
            o_v = dequantize(o_qv, o_min, o_max, o_bits)
            sel = np.where(acc)[0]
            dom[sel] = dom_v
            tr[sel] = tr_v
            s[sel] = s_v
            o[sel] = o_v

        levels.append(
            QuadtreeLevel(
                domain_idx=t(dom),
                transform=t(tr),
                s=t(s),
                o=t(o),
                error=torch.zeros(n_blocks, dtype=torch.float32, device=device),
                accepted=t(acc),
                range_size=range_size,
                domain_size=domain_size,
                domain_step=domain_step,
                o_is_mean=o_is_mean,
                num_transforms=num_transforms,
            )
        )
    return QuadtreeResult(levels=levels, width=width, height=height)
