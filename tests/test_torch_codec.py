"""Port parity, the codec layer (``fractencode_tpu_torch/codec/``): the FTC1,
FTQ1 and FTCC bitstreams against the JAX package's on the CPU.

  * Given the same result (the JAX package's, carried across by bridge.py),
    both packers write the same bytes, with and without the source plane.
  * Each package decodes the other's files to the same pixels.
  * End to end, a grid encode's stream is byte-identical to the JAX
    package's (the encodes are bitwise equal).  A quadtree's need not be:
    its 16 px level's s and o differ by ~1e-5 by design (ROADMAP.md, parity
    contract, K = 256), so that level's percentile quantizer ranges in the
    FTQ1 header can differ; its 8 and 4 px levels decode to the same fields
    and its 16 px level to fields within one quantizer bucket.
  * Corrupt files fail where the JAX package's reader fails (the JAX
    package's container test and corruption fuzz, with their seeds, on the
    in-repo Lenna crop).
  * The native packer is built into build/native/, never into native/.
"""
import functools
import hashlib
import os
import struct

import numpy as np
import pytest

from _torch_parity import assert_bitwise, jax_result_to_port, lenna128
from test_torch_keys256 import O_ATOL, O_RTOL, S_ATOL, S_RTOL
from test_torch_quadtree import _jax_levels_numpy, _jax_quadtree, _port_quadtree

import fractencode_tpu as J
import fractencode_tpu.codec as jc
import fractencode_tpu.codec.bitstream_quadtree as jcq
import fractencode_tpu.decode as jd
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch as T
import fractencode_tpu_torch.codec as tc
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import quadtree_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("domain_idx", "transform", "s", "o", "valid")
LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "accepted")
CONFIGS = {"default": (J.EncoderConfig(), T.EncoderConfig()),
           "compat": (J.REFERENCE_COMPAT(), T.REFERENCE_COMPAT()),
           "nocls": (J.EncoderConfig(use_classifier=False),
                     T.EncoderConfig(use_classifier=False))}


@functools.lru_cache(maxsize=None)
def _encodes(cname):
    """(JAX result, port result) of lenna128 on the uniform grid."""
    jcfg, tcfg = CONFIGS[cname]
    img = lenna128()
    return J.encode_plane(img, jcfg), T.encode_plane(img, tcfg, device="cpu")


def _jax_quadtree_in_port(rj):
    return quadtree_from_numpy(_jax_levels_numpy(rj), rj.width, rj.height, "cpu")


def _assert_fields_equal(a, b, fields, what=""):
    for f in fields:
        assert_bitwise(np.asarray(getattr(a, f)), getattr(b, f), f"{what}{f}")


@pytest.mark.parametrize("plane", [False, True], ids=["so", "mean"])
@pytest.mark.parametrize("cname", ["default", "compat"])
def test_ftc1_bytes_match_jax_packer(cname, plane):
    """pack_result on the JAX result, as the port's, writes the JAX bytes."""
    rj, _ = _encodes(cname)
    img = lenna128() if plane else None
    assert tc.pack_result(jax_result_to_port(rj), plane=img) == \
        jc.pack_result(rj, plane=img)


@pytest.mark.parametrize("plane", [False, True], ids=["so", "mean"])
def test_ftq1_bytes_match_jax_packer(plane):
    rj = _jax_quadtree("lenna128", 50.0)
    img = lenna128() if plane else None
    assert tc.pack_quadtree(_jax_quadtree_in_port(rj), plane=img) == \
        jcq.pack_quadtree(rj, plane=img)


@pytest.mark.parametrize("cname", ["default", "compat"])
def test_each_decodes_the_others_ftc1(cname):
    """The JAX file unpacks in the port to the JAX package's fields and
    decodes to its pixels; the port's file (the same bytes here, from the
    port's own encode) unpacks in the JAX package to the port's fields."""
    rj, rt = _encodes(cname)
    img = lenna128()
    dcfg = (J.DecoderConfig(), T.DecoderConfig())
    blob_j, blob_t = jc.pack_result(rj, plane=img), tc.pack_result(rt, plane=img)
    uj, ut = jc.unpack_result(blob_j), tc.unpack_result(blob_j, device="cpu")
    _assert_fields_equal(uj, ut, FIELDS)
    assert (uj.o_is_mean, uj.num_transforms) == (ut.o_is_mean, ut.num_transforms) == \
        (True, rj.num_transforms)
    oj, ij, mj = jd.decode_plane(uj, dcfg[0])
    ot, it, mt = T.decode_plane(ut, dcfg[1])
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert (int(ij), float(mj)) == (it, mt)
    _assert_fields_equal(jc.unpack_result(blob_t), tc.unpack_result(blob_t, device="cpu"),
                         FIELDS)


def test_each_decodes_the_others_ftq1():
    rj, rt = _jax_quadtree("lenna128", 50.0), _port_quadtree("lenna128", 50.0)
    img = lenna128()
    for blob in (jcq.pack_quadtree(rj, plane=img), tc.pack_quadtree(rt, plane=img)):
        uj, ut = jcq.unpack_quadtree(blob), tc.unpack_quadtree(blob, device="cpu")
        for lj, lt in zip(uj.levels, ut.levels, strict=True):
            _assert_fields_equal(lj, lt, LEVEL_FIELDS, f"{lj.range_size} px ")
            assert lj.o_is_mean and lt.o_is_mean
        oj, ij, mj = jq.decode_plane_quadtree(uj, J.DecoderConfig())
        ot, it, mt = tq.decode_plane_quadtree(ut, T.DecoderConfig())
        assert_bitwise(np.asarray(oj), ot, "pixels")
        assert (int(ij), float(mj)) == (it, mt)


@pytest.mark.parametrize("plane", [False, True], ids=["so", "mean"])
@pytest.mark.parametrize("cname", ["default", "compat", "nocls"])
def test_grid_stream_matches_jax_end_to_end(cname, plane):
    """Each package encodes and packs lenna128 itself: the same bytes."""
    rj, rt = _encodes(cname)
    img = lenna128() if plane else None
    assert tc.pack_result(rt, plane=img) == jc.pack_result(rj, plane=img)


def test_quadtree_stream_matches_jax_end_to_end():
    """Each package encodes and packs lenna128 as a quadtree itself: the
    acceptance maps, the 8 and 4 px levels' decoded fields and the 16 px
    level's winners equal; its quantizer ranges to the K = 256 tolerance of
    s and o, and its dequantized s and o within one quantizer bucket plus
    the ranges' difference (a level with one leaf has a range of width 0:
    its only value is stored as the range's end)."""
    img = lenna128()
    rj, rt = _jax_quadtree("lenna128", 50.0), _port_quadtree("lenna128", 50.0)
    bj, bt = jcq.pack_quadtree(rj, plane=img), tc.pack_quadtree(rt, plane=img)
    uj, ut = tc.unpack_quadtree(bj, device="cpu"), tc.unpack_quadtree(bt, device="cpu")
    assert int(ut.levels[0].accepted.sum()) > 0, "vacuous: no 16 px leaf"
    off = struct.calcsize(jcq._HDR_FMT)
    for lj, lt in zip(uj.levels, ut.levels, strict=True):
        if lj.range_size < 16:
            _assert_fields_equal(lj, lt, LEVEL_FIELDS, f"{lj.range_size} px ")
            continue
        _assert_fields_equal(lj, lt, ("domain_idx", "transform", "accepted"), "16 px ")
        # the level's quantizer ranges: header, then (range, domain, step,
        # naccept, s_min, s_max, o_min, o_max)
        hj = struct.unpack_from(jcq._LVL_FMT, bj, off)
        ht = struct.unpack_from(jcq._LVL_FMT, bt, off)
        assert hj[:4] == ht[:4]
        for f, lo, bits, (rtol, atol) in (("s", 4, 5, (S_RTOL, S_ATOL)),
                                          ("o", 6, 7, (O_RTOL, O_ATOL))):
            np.testing.assert_allclose(ht[lo:lo + 2], hj[lo:lo + 2], rtol=rtol, atol=atol,
                                       err_msg=f"16 px {f} range")
            bucket = max(hj[lo + 1] - hj[lo], ht[lo + 1] - ht[lo]) / (1 << bits)
            shift = max(abs(hj[lo] - ht[lo]), abs(hj[lo + 1] - ht[lo + 1]))
            diff = np.abs(getattr(lj, f).numpy() - getattr(lt, f).numpy())
            assert (diff <= (bucket + shift) * (1 + 1e-6)).all(), f
    assert rj.num_leaves == rt.num_leaves


def test_container_roundtrip_and_validation():
    """tests/test_codec.py's container test on the port's copy, and the same
    bytes as the JAX package's."""
    from fractencode_tpu.codec.container import pack_container as j_pack

    from fractencode_tpu_torch.codec.container import (is_container, pack_container,
                                                       unpack_container)

    planes = [b"FTC1" + bytes(range(50)), b"FTC1" + bytes(20), b"FTQ1" + bytes(7)]
    blob = pack_container(planes)
    assert blob == j_pack(planes)
    assert is_container(blob)
    assert unpack_container(blob) == planes
    one = pack_container(planes[:1])
    assert unpack_container(one) == planes[:1]
    with pytest.raises(ValueError):
        pack_container(planes[:2])  # only 1 or 3 planes
    with pytest.raises(ValueError, match="length table"):
        unpack_container(blob[:-3])  # truncated payload
    with pytest.raises(ValueError, match="length table"):
        unpack_container(blob + b"x")  # trailing garbage
    with pytest.raises(ValueError):
        unpack_container(b"FTCC\x01\x00")  # truncated before plane count
    with pytest.raises(ValueError, match="not a container"):
        unpack_container(b"NOPE" + bytes(20))


def _outcome(unpack, blob, check):
    """'ok' (and the result) or 'rejected', as the JAX package's fuzz
    tests classify a decode."""
    try:
        r = unpack(bytes(blob))
        check(r)
        return "ok", r
    except (ValueError, AssertionError, IndexError, struct.error):
        return "rejected", None


def _same_outcome(j_unpack, t_unpack, blob, check, fields):
    (oj, rj), (ot, rt) = _outcome(j_unpack, blob, check), _outcome(t_unpack, blob, check)
    assert oj == ot
    if oj == "ok":
        for a, b in zip(getattr(rj, "levels", [rj]), getattr(rt, "levels", [rt])):
            _assert_fields_equal(a, b, fields)
    return oj


def test_bitstream_corruption_fuzz():
    """tests/test_codec.py::test_bitstream_corruption_fuzz (its rng seed,
    1234) on lenna128: every corruption fails in the port exactly where it
    fails in the JAX package, and decodes to the same fields where it does
    not."""
    from fractencode_tpu.codec.bitstream import _FLAG_ENTROPY, _HDR_FMT

    rng = np.random.default_rng(1234)
    img = lenna128()
    rj, _ = _encodes("default")
    blob = bytearray(jc.pack_result(rj, plane=img))
    hdr = struct.calcsize(_HDR_FMT)
    assert struct.unpack(_HDR_FMT, bytes(blob[:hdr]))[2] & _FLAG_ENTROPY
    n = rj.num_ranges

    def check(r):
        assert r.domain_idx.shape == (n,)

    t_unpack = lambda b: tc.unpack_result(b, device="cpu")
    same = lambda b: _same_outcome(jc.unpack_result, t_unpack, b, check, FIELDS)
    evil = bytearray(blob)
    struct.pack_into("<I", evil, hdr + 1, 0xFFFFFFFF)
    assert same(evil) == "rejected"
    for cut in (hdr - 4, hdr + 3, len(blob) // 2, len(blob) - 3):
        assert same(blob[:cut]) == "rejected"
    outcomes = set()
    for _ in range(80):
        pos = int(rng.integers(hdr, len(blob)))
        old = blob[pos]
        blob[pos] = old ^ int(rng.integers(1, 256))
        outcomes.add(same(blob))
        blob[pos] = old
    assert outcomes <= {"ok", "rejected"} and "rejected" in outcomes


def test_quadtree_corruption_fuzz():
    """tests/test_codec.py::test_quadtree_corruption_fuzz (seed 1234) on
    lenna128: the same outcome in both packages for every corruption."""
    rng = np.random.default_rng(1234)
    img = lenna128()
    rj = _jax_quadtree("lenna128", 50.0)
    blob = bytearray(jcq.pack_quadtree(rj, plane=img))
    hdr = struct.calcsize(jcq._HDR_FMT)
    n_levels = len(rj.levels)

    def check(r):
        assert len(r.levels) == n_levels

    t_unpack = lambda b: tc.unpack_quadtree(b, device="cpu")
    same = lambda b: _same_outcome(jcq.unpack_quadtree, t_unpack, b, check, LEVEL_FIELDS)
    for cut in (hdr - 2, hdr + 3, len(blob) // 3, len(blob) // 2, len(blob) - 2):
        assert same(blob[:cut]) == "rejected", cut
    evil = bytearray(blob)
    struct.pack_into("<H", evil, hdr, 0)
    assert same(evil) == "rejected"
    outcomes = set()
    for _ in range(120):
        pos = int(rng.integers(0, len(blob)))
        old = blob[pos]
        blob[pos] = old ^ int(rng.integers(1, 256))
        outcomes.add(same(blob))
        blob[pos] = old
    assert outcomes <= {"ok", "rejected"} and "rejected" in outcomes


def test_native_builds_into_build_dir():
    """The port's native packer compiles native/bitpack.cpp into build/native/
    and leaves native/ as it was; its bytes equal the numpy fallback's."""
    from fractencode_tpu_torch.codec import bitstream, native

    tracked = os.path.join(REPO, "native", "_bitpack.so")
    digest = lambda: hashlib.sha256(open(tracked, "rb").read()).hexdigest()
    before = digest(), os.path.getmtime(tracked)
    lib = native.get_lib()
    assert lib is not None, "g++ is there, so the library must build"
    assert native._library().exists() and native._library().parent == native.BUILD_DIR
    assert str(native.BUILD_DIR).startswith(os.path.join(REPO, "build"))
    assert (digest(), os.path.getmtime(tracked)) == before
    rng = np.random.default_rng(5)
    n, d_bits = 300, 11
    fields = (rng.integers(0, 1 << d_bits, n), rng.integers(0, 8, n),
              rng.integers(0, 32, n), rng.integers(0, 128, n))
    valid = rng.random(n) < 0.9
    packed = native.pack_items_native(*fields, valid, d_bits, 3, 5, 7)
    bits = np.concatenate([valid.astype(np.uint8)[:, None]] + [
        bitstream._ints_to_bits(np.asarray(f, np.uint32), w)
        for f, w in zip(fields, (d_bits, 3, 5, 7))], axis=1)
    assert packed == np.packbits(bits.reshape(-1)).tobytes()
    back = native.unpack_items_native(packed, n, d_bits, 3, 5, 7)
    for a, b in zip(back, (*fields, valid)):
        assert np.array_equal(a, b)
