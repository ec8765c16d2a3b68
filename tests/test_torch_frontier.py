"""Port parity, the early-accept frontier (``rms_threshold > 0``, ``--rms``):
the search with the frontier (the plain K1 with the classifier, the plain K3
without) and the port's dense oracle ``search`` / ``select_best``, against
the JAX package's oracle on the CPU.  test_torch_frontier_encode.py holds
the whole encode, the quadtree and the JAX Pallas kernels.

The planes are smooth (test_torch_quadtree.smooth_plane), so that many
ranges meet the thresholds early in the scan and the frontier changes
winners.  Thresholds: 10.0, and 7.3, which f32 does not hold exactly (both
packages compare with f32(threshold)).  The parity rule of ROADMAP.md for
K <= 64 applies: bitwise for the 'ls' and 'raw' keys.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise
from test_torch_matcher import _jax_inputs, _port_inputs
from test_torch_quadtree import smooth_plane

import fractencode_tpu as J
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu_torch.bridge import config_from_jax_fields

PLANES = {"smooth64": smooth_plane(64, 21), "smooth96": smooth_plane(96, 22)}
FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid", "key")
_j_search = jax.jit(jm.search, static_argnames="cfg")


def _jcfg(key, k, t_n, classifier, threshold, **kw):
    """The JAX config of one case: 'ls' (the default) or 'raw'
    (REFERENCE_COMPAT), K = 16 (16 -> 4) or 64 (16 -> 8)."""
    kw.update(num_transforms=t_n, use_classifier=classifier, rms_threshold=threshold,
              target_size={16: 4, 64: 8}[k], backend="jnp")
    return J.REFERENCE_COMPAT(**kw) if key == "raw" else J.EncoderConfig(**kw)


def _port_search(img, tcfg):
    """The port's search on its own inputs: class-blocked (K1) with the
    classifier, dense (K3) without."""
    ranges, sa, sa2, cb, rcls, dcls = _port_inputs(img, tcfg)
    if tcfg.use_classifier:
        return tm.search_classed(ranges, sa, sa2, cb, rcls, dcls, tcfg)
    return tm.search_dense(ranges, sa, sa2, cb, None, None, tcfg)


def _jax_args(img, jcfg):
    """The JAX search's inputs, built under a config of the geometry alone
    (one compile per geometry)."""
    geometry = J.EncoderConfig(source_size=jcfg.source_size,
                               target_size=jcfg.target_size,
                               num_transforms=jcfg.num_transforms)
    return _jax_inputs(jnp.asarray(img), geometry)


@functools.lru_cache(maxsize=None)
def _jax_result(pname, jcfg):
    return _j_search(*_jax_args(PLANES[pname], jcfg), jcfg)


def _assert_search_equal(rj, rt, fields=FIELDS):
    for f in fields:
        assert_bitwise(getattr(rj, f), getattr(rt, f), f)


CASES = [(key, k, t_n, cls) for key in ("ls", "raw") for k in (16, 64)
         for t_n in (4, 8) for cls in (True, False)]


@pytest.mark.parametrize("threshold", [10.0, 7.3])
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c[0]}{c[1]}-t{c[2]}-{'cls' if c[3] else 'nocls'}")
def test_search_matches_jax(case, threshold):
    """The port's search (K1's plain version with the classifier, K3's
    without) against the JAX package's oracle ``search``: every field and
    the key bitwise."""
    key, k, t_n, cls = case
    jcfg = _jcfg(key, k, t_n, cls, threshold)
    _assert_search_equal(_jax_result("smooth64", jcfg),
                         _port_search(PLANES["smooth64"], config_from_jax_fields(jcfg)))


@pytest.mark.parametrize("cls", [True, False])
@pytest.mark.parametrize("key", ["ls", "raw"])
def test_three_isometries_match_oracle(key, cls):
    """T = 3 (groups cross the kernels' chunks and the class layout's tiles,
    block_m % T != 0): the port's search and the port's oracle against the
    JAX oracle, bitwise."""
    jcfg = _jcfg(key, 16, 3, cls, 10.0)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["smooth96"]
    rj = _jax_result("smooth96", jcfg)
    _assert_search_equal(rj, _port_search(img, tcfg))
    ranges, sa, sa2, cb, rcls, dcls = _port_inputs(img, tcfg)
    _assert_search_equal(rj, tm.search(ranges, sa, sa2, cb, rcls, dcls, tcfg))


@pytest.mark.parametrize("cname", ["default", "compat"])
def test_oracle_matches_jax_with_masks(cname):
    """The port's ``search`` against the JAX package's, with domain_mask and
    range_mask, the classifier on: every field and the key bitwise."""
    jcfg = _jcfg("raw" if cname == "compat" else "ls", 16, 4, True, 10.0)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["smooth96"]
    args = _jax_args(img, jcfg)
    rng = np.random.default_rng(4)
    dmask = rng.random(args[3].values.shape[0]) < 0.8
    rmask = rng.random(args[0].shape[0]) < 0.7
    rj = _j_search(*args, jcfg, domain_mask=jnp.asarray(dmask),
                   range_mask=jnp.asarray(rmask))
    ranges, sa, sa2, cb, rcls, dcls = _port_inputs(img, tcfg)
    rt = tm.search(ranges, sa, sa2, cb, rcls, dcls, tcfg,
                   domain_mask=torch.from_numpy(dmask), range_mask=torch.from_numpy(rmask))
    _assert_search_equal(rj, rt)
    # the class-blocked search with the same masks agrees too
    rc = tm.search_classed(ranges, sa, sa2, cb, rcls, dcls, tcfg,
                           domain_mask=torch.from_numpy(dmask),
                           range_mask=torch.from_numpy(rmask))
    _assert_search_equal(rj, rc)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [7.3, 10.0])
def test_select_best_matches_jax(threshold, seed):
    """select_best on random [RC, D, T] distances and keys drawn from a few
    values (many ties, between and within domains), with hits planted in the
    middle of groups: winners equal to the JAX package's."""
    rng = np.random.default_rng(seed)
    rc, d, t = 300, 12, 5
    dist = rng.choice(np.float32([2.0, 7.3, 8.0, 10.0, 12.0, 20.0, 3e38]), (rc, d, t))
    dist[np.arange(rc), rng.integers(0, d, rc), rng.integers(1, t - 1, rc)] = 5.0
    key = rng.integers(-4, 4, (rc, d, t)).astype(np.float32)
    for k in (None, key):
        wj = jax.jit(jm.select_best, static_argnums=1)(
            jnp.asarray(dist), threshold, None if k is None else jnp.asarray(k))
        wt = tm.select_best(torch.from_numpy(dist), threshold,
                            None if k is None else torch.from_numpy(k))
        for a, b, what in zip(wj, wt, ("win_d", "win_t")):
            assert_bitwise(a, b, what)


@pytest.mark.parametrize("t_n", [4, 3])
def test_classed_search_independent_of_tiles(t_n):
    """The class-blocked search with the frontier gives the same result with
    block_m 128 and 256 (and block_r 8 and 128), and equals the oracle."""
    tcfg = T.EncoderConfig(num_transforms=t_n, rms_threshold=10.0)
    args = _port_inputs(PLANES["smooth96"], tcfg)
    ref = tm.search(*args, tcfg)
    for block_r, block_m in ((128, 128), (8, 256), (128, 256)):
        _assert_search_equal(ref, tm.search_classed(*args, tcfg, block_r=block_r,
                                                    block_m=block_m))


@pytest.mark.parametrize("case", [("ls", True), ("ls", False), ("raw", True), ("raw", False)])
def test_frontier_is_not_vacuous(case):
    """Against the search without the threshold, some winners change, and
    every changed winner is within the threshold."""
    key, cls = case
    jcfg = _jcfg(key, 16, 4, cls, 10.0)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["smooth96"]
    on = _port_search(img, tcfg)
    off = _port_search(img, dataclasses.replace(tcfg, rms_threshold=0.0))
    changed = (on.domain_idx != off.domain_idx) | (on.transform != off.transform)
    assert int(changed.sum()) > 0, "vacuous: the frontier changed no winner"
    assert bool((on.distance[changed] <= np.float32(10.0)).all())
    assert bool((on.key <= off.key).all())  # the frontier only takes candidates away


@pytest.mark.parametrize("threshold", [0.0, 10.0])
def test_classed_padding_rows_and_pairs_scanned(threshold):
    """The plain K1 through ``classed_kernel``: with the frontier the class
    layout's padding rows are not searched (they keep (-3e38, 0) and scan no
    pair), without it they are, as the TPU kernel does; the real rows'
    results do not depend on it.  ``scanned`` counts each real row's
    segment up to its frontier, and only the plain version takes it."""
    tcfg = T.EncoderConfig(rms_threshold=threshold, backend="torch")
    ranges, sa, sa2, cb, rcls, dcls = _port_inputs(PLANES["smooth96"], tcfg)
    prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, tcfg)
    scanned = torch.zeros(prep["ai_s"].shape[0], dtype=torch.int64)
    q, idx = tm.classed_kernel(prep, 16, 256, tcfg, scanned=scanned)
    rows = prep["rpos"].long()
    pad = torch.ones_like(q, dtype=torch.bool)
    pad[rows] = False
    assert int(pad.sum()) > 0
    seg = (prep["col_end"] - prep["col_tile_start"] * prep["block_m"]).long()
    full = seg[prep["tile_class"].long().repeat_interleave(prep["block_r"])]
    if threshold > 0:
        assert bool((q[pad] == -3e38).all()) and not bool(idx[pad].any())
        assert not bool(scanned[pad].any())
        assert bool((scanned[rows] <= full[rows]).all())
        assert bool((scanned[rows] < full[rows]).any())
        off = tm.classed_kernel(prep, 16, 256, dataclasses.replace(tcfg, rms_threshold=0.0))
        assert bool((q[rows] < off[0][rows]).any())  # it took some rows' best away
    else:
        assert bool((scanned == full).all())
    with pytest.raises(ValueError, match="backend='torch'"):
        tm.classed_kernel(prep, 16, 256, dataclasses.replace(tcfg, backend="auto"),
                          scanned=scanned)
