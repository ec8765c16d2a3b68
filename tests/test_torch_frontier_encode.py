"""Port parity, the early-accept frontier through the whole encode: the
EncodeResult, the quadtree and the 'general' key against the JAX package's
jnp oracle, and the plain K1 and K3 against the JAX Pallas kernels in
interpret mode, on the CPU.  The planes and configs are those of
test_torch_frontier.py.  Parity rules of ROADMAP.md: K <= 64 bitwise for
the 'ls' and 'raw' keys; at K = 256 (the quadtree's 16 px level) the JAX
package ranks in f32 and the port in exact integers, so there winners and
leaves must agree and s, o, error match to test_torch_quadtree's
tolerances (a hit test within an ulp of the threshold could fall
differently there; none does on these planes); the 'general' key to >= 99%
of winners.
"""
import numpy as np
import pytest

from _torch_parity import assert_bitwise, assert_results_equal, lenna128
from test_torch_dense import _jax_dense, _port_dense
from test_torch_frontier import PLANES, _jcfg
from test_torch_matcher import _jax_search, _port_inputs
from test_torch_quadtree import (ERR_ATOL, ERR_RTOL, LEVEL_FIELDS, O_ATOL, O_RTOL,
                                 S_ATOL, S_RTOL, _LevelByLevel)

import fractencode_tpu as J
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.matcher as tm
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu.ops.matcher_pallas import DEFAULT_BM, DEFAULT_BR
from fractencode_tpu_torch.bridge import config_from_jax_fields


@pytest.mark.parametrize("cname", ["default", "compat"])
def test_encode_matches_jax(cname):
    """The whole EncodeResult with --rms 10 (and --compat), bitwise against
    encode_plane(backend='jnp')."""
    jcfg = (J.REFERENCE_COMPAT if cname == "compat" else J.EncoderConfig)(
        backend="jnp", rms_threshold=10.0)
    img = PLANES["smooth96"]
    assert_results_equal(J.encode_plane(img, jcfg),
                         T.encode_plane(img, config_from_jax_fields(jcfg), device="cpu"))


@pytest.mark.parametrize("key", ["ls", "raw"])
def test_plain_classed_matches_pallas(key):
    """The plain K1 with the frontier against fused_search_pairs in
    interpret mode, on the same layout (the JAX block sizes): (q, idx) of
    every sorted row that holds a range bitwise.  The layout's padding rows
    (ai = 0, sums 0) are left out: with the frontier the port does not
    search them (they keep (-3e38, 0)), while the TPU kernel does; their
    results are discarded either way."""
    jcfg = _jcfg(key, 16, 4, True, 10.0)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["smooth64"]
    _, _, (_, idx_j, q_j) = _jax_search(img, jcfg)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, block_r=DEFAULT_BR,
                         block_m=DEFAULT_BM)
    q_t, idx_t = tm.classed_kernel(pt, 16, 256, tcfg)
    rows = pt["rpos"].numpy()
    assert_bitwise(np.asarray(q_j)[rows], q_t[rows], "q")
    assert_bitwise(np.asarray(idx_j)[rows], idx_t[rows], "idx")


@pytest.mark.parametrize("key", ["ls", "raw"])
def test_plain_dense_matches_pallas(key):
    """The plain K3 with the frontier against fused_search in interpret
    mode (M not a multiple of the JAX block_m): (q, idx) bitwise."""
    jcfg = _jcfg(key, 16, 4, False, 10.0)
    img = PLANES["smooth64"]
    kw = dict(threshold=10.0, t_n=4)
    q_j, idx_j = _jax_dense(img, jcfg, False, **kw)
    q_t, idx_t = _port_dense(img, config_from_jax_fields(jcfg), False, **kw)
    assert_bitwise(q_j, q_t, "q")
    assert_bitwise(idx_j, idx_t, "idx")


def test_quadtree_matches_jax():
    """--quadtree with rms_threshold 10 against the JAX quadtree (level by
    level, its jnp oracle): 8 and 4 px levels bitwise; the 16 px level's
    winners and leaves bitwise, s, o and error to the K = 256 tolerances."""
    img = PLANES["smooth64"]
    rj = jq.encode_plane_quadtree(img, J.EncoderConfig(rms_threshold=10.0),
                                  jq.QuadtreeConfig(), reporter=_LevelByLevel())
    rt = tq.encode_plane_quadtree(img, T.EncoderConfig(rms_threshold=10.0),
                                  tq.QuadtreeConfig(), device="cpu")
    assert rj.num_leaves == rt.num_leaves
    tols = dict(s=(S_RTOL, S_ATOL), o=(O_RTOL, O_ATOL), error=(ERR_RTOL, ERR_ATOL))
    for lj, lt in zip(rj.levels, rt.levels, strict=True):
        for f in LEVEL_FIELDS:
            a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
            if lj.range_size < 16 or f not in tols:
                assert_bitwise(a, b, f"{lj.range_size} px {f}")
            else:
                np.testing.assert_allclose(b, a, rtol=tols[f][0], atol=tols[f][1],
                                           err_msg=f)
    # the threshold moved winners at the levels (non-vacuous)
    r0 = tq.encode_plane_quadtree(img, T.EncoderConfig(), tq.QuadtreeConfig(),
                                  device="cpu")
    assert any(bool((l.domain_idx != l0.domain_idx).any())
               for l, l0 in zip(rt.levels, r0.levels))


def test_general_rank_mode():
    """The 'general' key (s_max 0.9) with the frontier, classifier on and
    off: the rule of test_torch_matcher.py::test_general_rank_mode, at least
    99% of winners equal to the JAX oracle's."""
    img = lenna128()
    for cls in (True, False):
        kw = dict(s_max=0.9, rms_threshold=10.0, use_classifier=cls)
        rj = J.encode_plane(img, J.EncoderConfig(backend="jnp", **kw))
        rt = T.encode_plane(img, T.EncoderConfig(**kw), device="cpu")
        same = (np.asarray(rj.domain_idx) == rt.domain_idx.numpy()) & \
            (np.asarray(rj.transform) == rt.transform.numpy())
        assert same.mean() >= 0.99, same.mean()
