"""Port parity, the encode without the classifier (``--noclassifier``) on
the CPU: ``encode_plane(use_classifier=False)`` and its decodes against the
JAX package's jnp oracle and Pallas route (K3 interpreted), and the quadtree
without the classifier against the JAX quadtree.

The parity rules of test_torch_dense.py apply (ROADMAP.md, parity
contract): at K = 64 a winner whose JAX SumB2 is not correctly rounded
takes s, o and distance to a tolerance; at K = 256 (the quadtree's 16 px
level) s, o and error are held to test_torch_quadtree.py's tolerances.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_bitwise, assert_results_equal
from test_torch_dense import PLANES
from test_torch_matcher import _jax_inputs
from test_torch_quadtree import (ERR_ATOL, ERR_RTOL, LEVEL_FIELDS, O_ATOL, O_RTOL,
                                 PLANES as QT_PLANES, S_ATOL, S_RTOL, _LevelByLevel)

import fractencode_tpu as J
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import config_from_jax_fields

# BASELINE config 1: 16 px domains, 8 px ranges (K = 64), all 8 isometries
CONFIGS = {"default": {}, "compat": None, "t8": dict(num_transforms=8),
           "config1": dict(target_size=8, num_transforms=8)}


def _jcfg(cname, **kw):
    if CONFIGS[cname] is None:
        return J.REFERENCE_COMPAT(use_classifier=False, **kw)
    return J.EncoderConfig(use_classifier=False, **CONFIGS[cname], **kw)


def _inexact_sum_sq_columns(img, jcfg):
    """[D, T] bool: the JAX codebook's SumB2 is not the correctly rounded
    value (K = 64 parity rule above)."""
    cb = _jax_inputs(jnp.asarray(img), jcfg)[3]
    exact = (np.round(np.asarray(cb.values, np.float64) * 4) ** 2).sum(-1) / 16
    return exact.astype(np.float32) != np.asarray(cb.sum_sq)


def _assert_encode_parity(img, rj, rt, jcfg):
    """Every EncodeResult field bitwise, but for the K = 64 rule: ranges
    whose winning column's JAX SumB2 is inexact take s, o and distance to
    2e-5 relative."""
    inexact = _inexact_sum_sq_columns(img, jcfg)
    loose = inexact[np.asarray(rj.domain_idx), np.asarray(rj.transform)]
    assert not loose.any() or jcfg.target_size == 8, "only K = 64 sums are inexact"
    keep = ~loose
    for f in ("domain_idx", "transform", "valid"):
        assert_bitwise(getattr(rj, f), getattr(rt, f), f)
    for f in ("s", "o", "distance"):
        a, b = np.asarray(getattr(rj, f)), getattr(rt, f).numpy()
        assert_bitwise(a[keep], b[keep], f)
        np.testing.assert_allclose(b[loose], a[loose], rtol=2e-5, atol=0, err_msg=f)
    if not loose.any():
        assert_results_equal(rj, rt)


@pytest.mark.parametrize("cname", sorted(CONFIGS))
@pytest.mark.parametrize("pname", ["lenna128", "rand64", "rand96"])
def test_encode_matches_jax(pname, cname):
    """encode_plane(use_classifier=False) against the JAX package's jnp
    oracle: every range valid; every field bitwise (K = 64 rule above: two
    lenna128 ranges under config 1)."""
    jcfg = _jcfg(cname, backend="jnp")
    img = PLANES[pname]
    rj = J.encode_plane(img, jcfg)
    rt = T.encode_plane(img, config_from_jax_fields(jcfg), device="cpu")
    assert rt.valid.all()
    _assert_encode_parity(img, rj, rt, jcfg)


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_encode_matches_jax_pallas(cname):
    """The same against the JAX package's Pallas route (K3 interpreted),
    then the flat and pyramid decodes: identical pixels, iteration counts
    and MSE."""
    jcfg = _jcfg(cname, backend="pallas")
    img = PLANES["lenna128"]
    rj = J.encode_plane(img, jcfg)
    rt = T.encode_plane(img, config_from_jax_fields(_jcfg(cname, backend="jnp")),
                        device="cpu")
    _assert_encode_parity(img, rj, rt, jcfg)
    for pyramid in (False, True):
        oj, ij, mj = J.decode_plane(rj, J.DecoderConfig(pyramid=pyramid))
        ot, it, mt = T.decode_plane(rt, T.DecoderConfig(pyramid=pyramid))
        if cname != "config1":  # the two config-1 ranges above differ in s, o
            assert_bitwise(oj, ot, "pixels")
            assert (int(ij), np.float32(mj)) == (it, np.float32(mt))
        else:
            assert abs(int(ij) - it) <= 1
            assert np.abs(np.asarray(oj).astype(int) - ot.numpy()).max() <= 1


@functools.lru_cache(maxsize=None)
def _quadtrees(pname):
    cfg = dict(use_classifier=False)
    rj = jq.encode_plane_quadtree(QT_PLANES[pname], J.EncoderConfig(**cfg),
                                  jq.QuadtreeConfig(), reporter=_LevelByLevel())
    rt = tq.encode_plane_quadtree(QT_PLANES[pname], T.EncoderConfig(**cfg),
                                  tq.QuadtreeConfig(), device="cpu")
    return rj, rt


@pytest.mark.parametrize("pname", ["lenna128", "smooth128"])
def test_quadtree_matches_jax(pname):
    """The quadtree without the classifier (the dense search post-masked by
    coverage): 8 and 4 px levels bitwise; the 16 px level's winners and
    leaves bitwise, s, o and error to the K = 256 tolerances of
    test_torch_quadtree.py; then the decodes, to one gray level on fewer
    than 0.1% of the pixels."""
    rj, rt = _quadtrees(pname)
    assert [l.range_size for l in rj.levels] == [l.range_size for l in rt.levels]
    for lj, lt in zip(rj.levels, rt.levels):
        for f in LEVEL_FIELDS:
            a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
            if lj.range_size < 16 or f in ("domain_idx", "transform", "accepted"):
                assert_bitwise(a, b, f"{lj.range_size} px {f}")
        if lj.range_size == 16:
            tols = dict(s=(S_RTOL, S_ATOL), o=(O_RTOL, O_ATOL), error=(ERR_RTOL, ERR_ATOL))
            for f, (rtol, atol) in tols.items():
                np.testing.assert_allclose(getattr(lt, f).numpy(),
                                           np.asarray(getattr(lj, f)),
                                           rtol=rtol, atol=atol, err_msg=f)
    assert rj.num_leaves == rt.num_leaves
    assert int(rt.levels[0].accepted.sum()) > 0, "vacuous: no 16 px leaf"
    oj, ij, _ = jq.decode_plane_quadtree(rj, J.DecoderConfig(pyramid=True))
    ot, it, _ = tq.decode_plane_quadtree(rt, T.DecoderConfig(pyramid=True))
    # the 16 px leaves' s and o differ in the last bits, which can move a
    # pixel that lands on a rounding boundary by one gray level
    diff = np.abs(np.asarray(oj).astype(int) - ot.numpy().astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, ((diff > 0).sum(), diff.max())
    assert abs(int(ij) - it) <= 1
