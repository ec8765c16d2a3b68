"""Port parity, the quadtree under the 'raw' key (``--quadtree --compat``),
with and without the classifier: ``encode_plane_quadtree`` and its decode
against the JAX package on the CPU (its jnp oracle, level by level).  The
helpers here serve the 'general' key (``--smax 0.9``) and ``--rms 10`` too,
in test_torch_quadtree_smax.py, test_torch_quadtree_compat_rms.py and
test_torch_quadtree_smax_rms.py (one file per pair of configs: the JAX
package compiles each level of each config, ~15 s a config).

The parity rules of ROADMAP.md: the 8 and 4 px levels (K = 64 and 16)
bitwise, but for the 'general' key's error (the search distance), which
XLA's contracted multiply-adds move in the last bits (1e-3, as
test_torch_matcher.py::test_general_rank_mode); the 16 px level (K = 256),
where the JAX package ranks and solves in f32 and the port from exact
integers, equal in winners and leaves, with s, o and the per-pixel error to
the tolerances below; the decoded pixels bitwise.
"""
import functools

import numpy as np
import pytest

from _torch_parity import assert_bitwise, lenna128
from test_torch_keys256 import O_ATOL, O_RTOL, Q_RTOL, S_ATOL, S_RTOL, smooth_wave
from test_torch_quadtree import LEVEL_FIELDS, _jax_levels_numpy, _LevelByLevel

import fractencode_tpu as J
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import config_from_jax_fields, quadtree_from_numpy

PLANES = {"lenna128": lenna128(), "wave128": smooth_wave(128, 13)}
# the per-pixel error at 16 px is the search distance in per-pixel units,
# so it takes the keys' relative tolerance (and an absolute floor near 0)
ERR_RTOL, ERR_ATOL = Q_RTOL, 1e-4
CONFIGS = {"compat": lambda **kw: J.REFERENCE_COMPAT(**kw),
           "smax": lambda **kw: J.EncoderConfig(s_max=0.9, **kw)}


@functools.lru_cache(maxsize=None)
def encodes(pname, cname, classifier, threshold=0.0):
    """(JAX result, port result) of one plane under one config."""
    jcfg = CONFIGS[cname](use_classifier=classifier, rms_threshold=threshold)
    img = PLANES[pname]
    rj = jq.encode_plane_quadtree(img, jcfg, jq.QuadtreeConfig(), reporter=_LevelByLevel())
    rt = tq.encode_plane_quadtree(img, config_from_jax_fields(jcfg), tq.QuadtreeConfig(),
                                  device="cpu")
    return rj, rt


def assert_levels_match(rj, rt, general=False):
    """8 and 4 px levels bitwise (the 'general' key's error to 1e-3); at 16
    px winners and leaves bitwise, s, o and error to tolerance; the same
    leaves in all."""
    assert [l.range_size for l in rj.levels] == [l.range_size for l in rt.levels] == [16, 8, 4]
    tols = dict(s=(S_RTOL, S_ATOL), o=(O_RTOL, O_ATOL), error=(ERR_RTOL, ERR_ATOL))
    for lj, lt in zip(rj.levels, rt.levels):
        for f in LEVEL_FIELDS:
            a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
            if general and lj.range_size < 16 and f == "error":
                assert_bitwise(np.isfinite(a), np.isfinite(b), f"{lj.range_size} px finite")
                fin = np.isfinite(a)
                np.testing.assert_allclose(b[fin], a[fin], rtol=1e-3, atol=1e-3,
                                           err_msg=f"{lj.range_size} px error")
            elif lj.range_size < 16 or f not in tols:
                assert_bitwise(a, b, f"{lj.range_size} px {f}")
            else:
                fin = np.isfinite(a)
                assert_bitwise(fin, np.isfinite(b), f"16 px {f} finite")
                np.testing.assert_allclose(b[fin], a[fin], rtol=tols[f][0], atol=tols[f][1],
                                           err_msg=f"16 px {f}")
        assert (lj.domain_size, lj.domain_step, lj.num_transforms) == \
            (lt.domain_size, lt.domain_step, lt.num_transforms)
    assert rj.num_leaves == rt.num_leaves


def assert_decodes_match(rj, rt, pyramid):
    """The JAX encode decodes to the same pixels in both packages (carried
    across by bridge.py), and each package's decode of its own encode gives
    the same pixels and iterations on these planes."""
    jd = J.DecoderConfig(pyramid=pyramid)
    td = config_from_jax_fields(jd)
    oj, ij, mj = jq.decode_plane_quadtree(rj, jd)
    rx = quadtree_from_numpy(_jax_levels_numpy(rj), rj.width, rj.height, "cpu")
    ox, ix, mx = tq.decode_plane_quadtree(rx, td)
    assert_bitwise(np.asarray(oj), ox, "pixels of the JAX encode")
    assert (int(ij), float(mj)) == (ix, mx)
    ot, it, _ = tq.decode_plane_quadtree(rt, td)
    assert_bitwise(np.asarray(oj), ot, "pixels of each package's own encode")
    assert int(ij) == it


def check_encode(pname, cname, classifier, threshold=0.0):
    rj, rt = encodes(pname, cname, classifier, threshold)
    assert_levels_match(rj, rt, general=cname == "smax")


def check_decode(cname, classifier, threshold=0.0):
    """Decoded pixels on the wave, whose leaves are not all 4 px: the flat
    reference decode for --compat, the pyramid for --smax (as the CLI runs
    each)."""
    rj, rt = encodes("wave128", cname, classifier, threshold)
    assert sum(int(l.accepted.sum()) for l in rt.levels[:2]) > 0, "vacuous: all 4 px"
    assert_decodes_match(rj, rt, pyramid=cname != "compat")


@pytest.mark.parametrize("classifier", [True, False], ids=["cls", "nocls"])
@pytest.mark.parametrize("pname", ["lenna128", "wave128"])
def test_quadtree_matches_jax(pname, classifier):
    check_encode(pname, "compat", classifier)


@pytest.mark.parametrize("classifier", [True, False], ids=["cls", "nocls"])
def test_decode_matches_jax(classifier):
    check_decode("compat", classifier)
