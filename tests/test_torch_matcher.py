"""Port parity, search: (s, o) solve, class layout, the plain version of the
search kernel, winner post-processing and the whole encode, bitwise against
the JAX package on the CPU (its Pallas kernel in interpret mode)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_bitwise, assert_results_equal, lenna128,
                           planes, random_plane)

import fractencode_tpu as J
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu.core.classify import classify_grid as j_classify
from fractencode_tpu.core.grid import uniform_grid
from fractencode_tpu.encode.codebook import build_codebook as j_codebook
from fractencode_tpu.encode.codebook import extract_ranges as j_ranges
from fractencode_tpu.ops.matcher_pallas import DEFAULT_BM, DEFAULT_BR
from fractencode_tpu_torch.core.classify import classify_grid as t_classify
from fractencode_tpu_torch.encode.codebook import build_codebook as t_codebook
from fractencode_tpu_torch.encode.codebook import extract_ranges as t_ranges
from fractencode_tpu_torch.encode.codebook import range_sums
from fractencode_tpu_torch.ops import matcher_kernels as mk

PLANES = planes()
CONFIGS = {"default": (J.EncoderConfig(backend="jnp"), T.EncoderConfig()),
           "compat": (J.REFERENCE_COMPAT(backend="jnp"), T.REFERENCE_COMPAT())}


@functools.partial(jax.jit, static_argnames="cfg")
def _jax_inputs(img, cfg):
    h, w = img.shape
    pf = img.astype(jnp.float32)
    dg = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(w, h, cfg.target_size, cfg.target_size)
    cb = j_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = j_ranges(pf, cfg.target_size)
    return (ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
            j_classify(img, rg), j_classify(img, dg))


def _port_inputs(img, cfg):
    p = torch.from_numpy(img)
    h, w = img.shape
    pf = p.to(torch.float32)
    dg = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(w, h, cfg.target_size, cfg.target_size)
    cb = t_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = t_ranges(pf, cfg.target_size)
    return (ranges, *range_sums(ranges), cb, t_classify(p, rg), t_classify(p, dg))


_j_prep = jax.jit(jm.classed_prep, static_argnames=("cfg", "force_no_pairs"))
_j_post = jax.jit(jm.classed_post, static_argnames="cfg")


def _jax_search(img, jcfg):
    """JAX prep + Pallas kernel (interpret mode) at the JAX block sizes."""
    args = _jax_inputs(jnp.asarray(img), jcfg)
    ranges, _, _, cb, _, _ = args
    r, k = ranges.shape
    d, t, _ = cb.values.shape
    block_r, block_m, _, _, worst, p_cap, _ = jm._classed_statics(r, d * t, jcfg)
    prep = _j_prep(*args, jcfg)
    out = jm.classed_kernel(prep, k, cb.grid.block_size ** 2, block_r, block_m,
                            p_cap, worst, jcfg, interpret=True, t_n=t)
    return args, prep, out


@pytest.mark.parametrize("so_mode", ["ls", "reference"])
def test_solve_so(so_mode):
    """s bitwise; o bitwise with the one-rounding (float64) form, against
    the jitted JAX solve whose multiply-add XLA:CPU fuses."""
    img = lenna128()
    jcfg = J.EncoderConfig(backend="jnp")
    ranges, sum_a, sum_a2, cb, _, _ = _jax_inputs(jnp.asarray(img), jcfg)
    cols = np.asarray(cb.values).reshape(-1, 16)
    a = np.asarray(ranges)
    ab = a @ cols.T  # exact: integer multiples of 0.25 below 2^24
    sb = np.broadcast_to(np.asarray(cb.sum).reshape(-1), ab.shape)
    sb2 = np.broadcast_to(np.asarray(cb.sum_sq).reshape(-1), ab.shape)
    sa = np.broadcast_to(np.asarray(sum_a)[:, None], ab.shape)
    sa2 = np.broadcast_to(np.asarray(sum_a2)[:, None], ab.shape)
    solve = jax.jit(jm.solve_so, static_argnums=(5, 6, 7))
    sj, oj = solve(sa, sa2, sb, sb2, ab.astype(np.float32), 16.0, so_mode, -1.0)
    st, ot = tm.solve_so(*(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                           for x in (sa, sa2, sb, sb2, ab)), 16.0, so_mode, -1.0)
    assert_bitwise(sj, st, "s")
    assert_bitwise(oj, ot, "o")


@pytest.mark.parametrize("cname", ["default", "compat", "t8", "t5", "t1"])
@pytest.mark.parametrize("pname", ["lenna128", "rand96"])
def test_classed_prep(pname, cname):
    """Every sorted array bitwise at the JAX block sizes; lenna128 with t5
    takes the per-column layout (block_m % T != 0).  The kernels' operands
    are contiguous (at one isometry the domain layout's reshapes are
    strided views unless copied)."""
    jcfg, tcfg = CONFIGS.get(cname, (None, None))
    if jcfg is None:
        t_n = int(cname[1:])
        jcfg, tcfg = J.EncoderConfig(num_transforms=t_n), T.EncoderConfig(num_transforms=t_n)
    img = PLANES[pname]
    pj = _j_prep(*_jax_inputs(jnp.asarray(img), jcfg), jcfg)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, block_r=DEFAULT_BR,
                         block_m=DEFAULT_BM)
    assert (pj["inv_dom"] is None) == (pt["inv_dom"] is None)
    if (pname, cname) == ("lenna128", "t5"):
        assert pj["inv_dom"] is None  # 1152 columns per tile, not a multiple of 5
    for key in ("ai_s", "ch_s", "cl_s", "sb_s", "aux_s", "b4_cols", "tile_class",
                "col_tile_start", "col_tile_count", "col_end", "rpos",
                "inv_dom", "inv_col"):
        if pj[key] is None:
            assert pt[key] is None, key
        else:
            assert_bitwise(pj[key], pt[key], key)
    for key in ("ai_s", "ch_s", "cl_s", "sb_s", "aux_s"):
        assert pt[key].is_contiguous(), key


@pytest.mark.parametrize("cname", ["default", "compat"])
@pytest.mark.parametrize("pname", ["lenna128", "rand64", "rand96"])
def test_plain_search_matches_pallas_kernel(pname, cname):
    """The plain version of K1: (q, idx) of every sorted row, padding rows
    included, bitwise against fused_search_pairs in interpret mode."""
    jcfg, tcfg = CONFIGS[cname]
    img = PLANES[pname]
    _, _, (_, idx_j, q_j) = _jax_search(img, jcfg)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, block_r=DEFAULT_BR,
                         block_m=DEFAULT_BM)
    q_t, idx_t = tm.classed_kernel(pt, 16, 256, tcfg)
    assert_bitwise(q_j, q_t, "q")
    assert_bitwise(idx_j, idx_t, "idx")


@pytest.mark.parametrize("cname", ["default", "compat"])
def test_classed_post(cname):
    """Given the same sorted kernel outputs, the unsorted winners, distances,
    s and keys are bitwise equal, and o too in the default mode.

    In the compat mode ('reference' so_mode) the JAX package's own two
    programs round o differently: its classed_post rounds the product
    ``s*sum_a`` before subtracting it from ``sum_b``, its jnp oracle fuses the
    two (~30% of the ranges of this plane differ).  The port follows the
    oracle (test_encode_matches_jax), so here o is held to that one rounding
    of the product (half an f32 ulp of s*sum_a, divided by n = 16) plus the
    final rounding of o (one f32 ulp of o)."""
    jcfg, tcfg = CONFIGS[cname]
    img = lenna128()
    args, prep, (dist_s, idx_s, q_s) = _jax_search(img, jcfg)
    ranges, sum_a, sum_a2, cb, _, _ = args
    rj = _j_post(dist_s, idx_s, q_s, prep["rpos"], prep["inv_col"], ranges, sum_a,
                 sum_a2, cb, jcfg, b4_cols=prep["b4_cols"], inv_dom=prep["inv_dom"])
    ranges_t, sa_t, sa2_t, cb_t, _, _ = _port_inputs(img, tcfg)
    t = lambda x: torch.from_numpy(np.array(x))
    rt = tm.classed_post(t(q_s), t(idx_s), t(prep["rpos"]), None, ranges_t, sa_t,
                         sa2_t, cb_t, tcfg, b4_cols=t(prep["b4_cols"]),
                         inv_dom=t(prep["inv_dom"]))
    for f in ("domain_idx", "transform", "distance", "s", "valid", "key"):
        assert_bitwise(getattr(rj, f), getattr(rt, f), f)
    if cname == "default":
        assert_bitwise(rj.o, rt.o, "o")
    else:
        prod = np.abs(rt.s.numpy() * sa_t.numpy())
        bound = np.spacing(prod.astype(np.float32)) / 32 + np.spacing(np.abs(rt.o.numpy()))
        assert (np.abs(np.asarray(rj.o) - rt.o.numpy()) <= bound).all()


@pytest.mark.parametrize("cname", ["default", "compat"])
@pytest.mark.parametrize("pname", sorted(PLANES))
def test_encode_matches_jax(pname, cname):
    """The whole EncodeResult, bitwise, against encode_plane(backend='jnp')
    (the dense oracle), with the port's own block sizes."""
    jcfg, tcfg = CONFIGS[cname]
    img = PLANES[pname]
    assert_results_equal(J.encode_plane(img, jcfg), T.encode_plane(img, tcfg, device="cpu"))


@pytest.mark.parametrize("cname", ["default", "compat"])
@pytest.mark.parametrize("blocks", [(DEFAULT_BR, DEFAULT_BM), (8, 128), (None, None)])
def test_search_block_sizes(cname, blocks):
    """Layout tiles change padding only: the search result at the JAX block
    sizes, at the smallest tiles and at the port's own equals the oracle's."""
    jcfg, tcfg = CONFIGS[cname]
    img = random_plane(96, 7)
    rj = J.encode_plane(img, jcfg)
    res = tm.search_classed(*_port_inputs(img, tcfg), tcfg, block_r=blocks[0],
                            block_m=blocks[1])
    for f in ("domain_idx", "transform", "distance", "s", "o", "valid"):
        assert_bitwise(getattr(rj, f), getattr(res, f), f)


@pytest.mark.parametrize("cfg_kw", [dict(s_max=1.0), dict(so_mode="reference")])
def test_general_rank_mode(cfg_kw):
    """The 'general' key has multiply-adds that XLA:CPU may fuse and the
    port does not, and its residual expansion cancels heavily, so keys are
    not bitwise: at least 99% of winners must agree, and distances to 1e-3
    (the cancellation amplifies last-bit differences to ~7e-4 relative on
    this plane)."""
    img = lenna128()
    rj = J.encode_plane(img, J.EncoderConfig(backend="jnp", **cfg_kw))
    rt = T.encode_plane(img, T.EncoderConfig(**cfg_kw), device="cpu")
    same = (np.asarray(rj.domain_idx) == rt.domain_idx.numpy()) & \
        (np.asarray(rj.transform) == rt.transform.numpy())
    assert same.mean() > 0.99
    np.testing.assert_allclose(rt.distance.numpy(), np.asarray(rj.distance),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cfg_kw", [
    dict(criterion="raw", so_mode="reference", source_size=64, target_size=32),
])
def test_unported_configs_raise(cfg_kw):
    """Ranges above 16x16 (n = 1024, the K-slab form) encode as the JAX
    package's do (its oracle; winners exactly, the rest to
    test_torch_range_sizes.py's n > 256 tolerances)."""
    from test_torch_range_sizes import assert_results, jax_general_sampling

    img = random_plane(128, 9)
    with jax_general_sampling():
        rj = J.encode_plane(img, J.EncoderConfig(**cfg_kw))
    rt = T.encode_plane(img, T.EncoderConfig(**cfg_kw), device="cpu")
    assert_results(1024, "raw", rj, rt)


def test_cpu_routing_and_launch_count():
    """CPU tensors route the CUDA wrapper to the plain version (no launch);
    backend='cuda' refuses CPU tensors."""
    img = random_plane(64, 4)
    before = dict(mk.search_classed_cuda.launches)
    auto = T.encode_plane(img, T.EncoderConfig(), device="cpu")
    plain = T.encode_plane(img, T.EncoderConfig(backend="torch"), device="cpu")
    assert mk.search_classed_cuda.launches == before
    for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
        assert_bitwise(getattr(auto, f), getattr(plain, f), f)
    with pytest.raises(ValueError, match="CUDA"):
        T.encode_plane(img, T.EncoderConfig(backend="cuda"), device="cpu")


@pytest.mark.parametrize("cname", ["default", "compat"])
def test_masked_search_matches_oracle(cname):
    """domain_mask parks domains in a bin no range visits; range_mask parks
    ranges whose tiles visit no columns (mask_ranges_result gives them the
    canonical fields): bitwise against the JAX oracle with the same masks."""
    jcfg, tcfg = CONFIGS[cname]
    img = random_plane(96, 8)
    args = _jax_inputs(jnp.asarray(img), jcfg)
    rng = np.random.default_rng(3)
    dmask = rng.random(args[3].values.shape[0]) < 0.8
    rmask = rng.random(args[0].shape[0]) < 0.7
    rj = jax.jit(jm.search, static_argnames="cfg")(
        *args, jcfg, domain_mask=jnp.asarray(dmask), range_mask=jnp.asarray(rmask))
    rt = tm.search_classed(*_port_inputs(img, tcfg), tcfg,
                           domain_mask=torch.from_numpy(dmask),
                           range_mask=torch.from_numpy(rmask))
    for f in ("domain_idx", "transform", "distance", "s", "o", "valid", "key"):
        assert_bitwise(getattr(rj, f), getattr(rt, f), f)
