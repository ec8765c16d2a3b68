"""Port parity at every range size, end to end on the CPU: ``encode_plane``
at 2x2 ranges (--source 8 --target 2, n = 4) and 6x6 ones (--source 12
--target 6, n = 36), with and without the classifier, and
``encode_plane_quadtree`` from 8 px down to 2 px and from 32 px down to 2 px
(levels of n = 1024, 256, 64, 16 and 4), against the JAX package: the
results, the decoded pixels and the FTC1/FTQ1 files.

The JAX side runs its Pallas kernels (``backend='pallas'``, interpret mode
on the CPU), the route the port follows where a range matches a domain
exactly under several isometries (ROADMAP.md, parity contract: its jnp
oracle takes the first of them, its kernels and the port the last; 2x2
ranges of lenna128 have such matches).

Rules (ROADMAP.md, parity contract; test_torch_range_sizes.py): at n <= 64
everything is bitwise, the files too.  The 16 px level (n = 256) holds to
test_torch_quadtree.py's tolerances and the 32 px one (n = 1024) to
test_torch_range_sizes.py's N_WIDE ones, winners and leaves exactly; both
packages then decode the JAX package's result to the same pixels, and pack
it to the same bytes.
"""
import functools

import numpy as np
import pytest

from _torch_parity import assert_bitwise, assert_results_equal, jax_result_to_port, lenna128
from test_torch_quadtree import (ERR_ATOL, ERR_RTOL, O_ATOL, O_RTOL, S_ATOL, S_RTOL,
                                 _jax_levels_numpy, smooth_plane)
from test_torch_range_sizes import (N_WIDE_O_ATOL, N_WIDE_O_RTOL, N_WIDE_Q_RTOL,
                                    N_WIDE_S_ATOL, N_WIDE_S_RTOL, jax_general_sampling)

import fractencode_tpu as J
import fractencode_tpu.codec as jc
import fractencode_tpu.codec.bitstream_quadtree as jcq
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch as T
import fractencode_tpu_torch.codec as tc
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import quadtree_from_numpy

LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")
# (source, target) of the grid cases
GRIDS = {4: (8, 2), 36: (12, 6)}
DECODE = dict(pyramid=True)


def _plane(size: int) -> np.ndarray:
    return np.ascontiguousarray(lenna128()[:size, :size])


@functools.lru_cache(maxsize=None)
def _grid(n: int, classifier: bool):
    source, target = GRIDS[n]
    img = _plane(120 if n == 36 else 128)
    kw = dict(source_size=source, target_size=target, use_classifier=classifier)
    return img, J.encode_plane(img, J.EncoderConfig(backend="pallas", **kw)), \
        T.encode_plane(img, T.EncoderConfig(**kw), device="cpu")


@pytest.mark.parametrize("classifier", [True, False], ids=["classed", "dense"])
@pytest.mark.parametrize("n", sorted(GRIDS))
def test_grid_encode_matches_jax(n, classifier):
    """Every field of the EncodeResult bitwise, then the decoded pixels,
    iteration count and MSE of each package's decode of its own result."""
    img, rj, rt = _grid(n, classifier)
    assert_results_equal(rj, rt)
    oj, ij, mj = J.decode_plane(rj, J.DecoderConfig(**DECODE))
    ot, it, mt = T.decode_plane(rt, T.DecoderConfig(**DECODE))
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert (int(ij), float(mj)) == (it, mt)


@pytest.mark.parametrize("plane", [False, True], ids=["so", "mean"])
@pytest.mark.parametrize("n", sorted(GRIDS))
def test_grid_file_matches_jax(n, plane):
    """Each package encodes and packs the plane itself: the same FTC1 bytes,
    and the port decodes the JAX package's file to the same fields."""
    img, rj, rt = _grid(n, True)
    src = img if plane else None
    blob = jc.pack_result(rj, plane=src)
    assert tc.pack_result(rt, plane=src) == blob
    assert tc.pack_result(jax_result_to_port(rj), plane=src) == blob
    uj, ut = jc.unpack_result(blob), tc.unpack_result(blob, device="cpu")
    for f in ("domain_idx", "transform", "s", "o", "valid"):
        assert_bitwise(np.asarray(getattr(uj, f)), getattr(ut, f), f)


@functools.lru_cache(maxsize=None)
def _quadtree(max_size: int):
    """(plane, JAX result, port result): lenna128 from 8 px, a smooth plane
    (test_torch_quadtree.smooth_plane, whose 32 px blocks meet the
    threshold) from 32 px."""
    img = _plane(128) if max_size == 8 else smooth_plane(128, 5)
    qj = jq.QuadtreeConfig(min_size=2, max_size=max_size)
    qt = tq.QuadtreeConfig(min_size=2, max_size=max_size)
    with jax_general_sampling():
        rj = jq.encode_plane_quadtree(img, J.EncoderConfig(backend="pallas"), qj)
    return img, rj, tq.encode_plane_quadtree(img, T.EncoderConfig(), qt, device="cpu")


def _port_of(rj):
    return quadtree_from_numpy(_jax_levels_numpy(rj), rj.width, rj.height, "cpu")


def test_quadtree_to_2px_matches_jax():
    """8 px down to 2 px (n = 64, 16, 4): every level bitwise, the decoded
    pixels and the FTQ1 bytes of each package's own encode."""
    img, rj, rt = _quadtree(8)
    assert [l.range_size for l in rt.levels] == [8, 4, 2]
    assert int(rt.levels[-1].accepted.sum()) > 0, "vacuous: no 2 px leaf"
    for lj, lt in zip(rj.levels, rt.levels, strict=True):
        for f in LEVEL_FIELDS:
            assert_bitwise(np.asarray(getattr(lj, f)), getattr(lt, f), f"{lj.range_size} px {f}")
    oj, ij, mj = jq.decode_plane_quadtree(rj, J.DecoderConfig(**DECODE))
    ot, it, mt = tq.decode_plane_quadtree(rt, T.DecoderConfig(**DECODE))
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert (int(ij), float(mj)) == (it, mt)
    assert tc.pack_quadtree(rt, plane=img) == jcq.pack_quadtree(rj, plane=img)


def test_quadtree_32_to_2px_matches_jax():
    """32 px down to 2 px: leaves and winners of every level exactly; s, o
    and error bitwise at 8, 4 and 2 px, to the K = 256 tolerances at 16 px
    and to the N_WIDE ones at 32 px; then the JAX package's result, carried
    across, decodes to its pixels and packs to its bytes in the port."""
    img, rj, rt = _quadtree(32)
    assert [l.range_size for l in rt.levels] == [32, 16, 8, 4, 2]
    assert int(rt.levels[0].accepted.sum()) > 0, "vacuous: no 32 px leaf"
    tols = {16: dict(s=(S_RTOL, S_ATOL), o=(O_RTOL, O_ATOL), error=(ERR_RTOL, ERR_ATOL)),
            32: dict(s=(N_WIDE_S_RTOL, N_WIDE_S_ATOL), o=(N_WIDE_O_RTOL, N_WIDE_O_ATOL),
                     error=(N_WIDE_Q_RTOL, 0.0))}
    for lj, lt in zip(rj.levels, rt.levels, strict=True):
        what = f"{lj.range_size} px"
        for f in ("domain_idx", "transform", "accepted"):
            assert_bitwise(np.asarray(getattr(lj, f)), getattr(lt, f), f"{what} {f}")
        for f in ("s", "o", "error"):
            a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
            if lj.range_size <= 8:
                assert_bitwise(a, b, f"{what} {f}")
            else:
                rtol, atol = tols[lj.range_size][f]
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{what} {f}")
    assert rj.num_leaves == rt.num_leaves
    rx = _port_of(rj)
    oj, ij, mj = jq.decode_plane_quadtree(rj, J.DecoderConfig(**DECODE))
    ot, it, mt = tq.decode_plane_quadtree(rx, T.DecoderConfig(**DECODE))
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert (int(ij), float(mj)) == (it, mt)
    assert tc.pack_quadtree(rx, plane=img) == jcq.pack_quadtree(rj, plane=img)
